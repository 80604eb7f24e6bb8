"""Port parity of the serving engine on the dense llama variants: for
every family of tests/test_torch_families.py, the port engine's greedy
tokens at K 1 and K 4 equal the JAX engine's (f32 weights and KV cache),
on prompts whose greedy steps all clear a top-2 log-prob margin of 1e-3
(checked, so a near tie shows as one; the f32 noise between the packages
is about 1e-6). And a context shift (models/llama.shift_kv) equals JAX
`shift_kv_impl` on gpt2 (rope_mode "none": the keys only move), qwen3
(neox) and phi3 (longrope delta tables), f32 within 1e-6."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.gguf import GGUFFile as JGGUFFile
from llama_box_tpu.models import llama as jllama
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.sampling import SamplerParams as JSamplerParams
from llama_box_tpu.server import Engine as JEngine, EngineConfig as JEngineConfig
from llama_box_tpu.server.task import CompletionsTask as JTask
from llama_box_tpu.tokenizer import Tokenizer as JTokenizer
from llama_box_tpu_torch.gguf import GGUFFile
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models.loader import load_model
from llama_box_tpu_torch.sampling import SamplerParams
from llama_box_tpu_torch.server.engine import Engine, EngineConfig
from llama_box_tpu_torch.server.task import CompletionsTask
from llama_box_tpu_torch.tokenizer import Tokenizer

from .test_torch_families import ALL_ARCHS, write_arch

N_GEN, MARGIN = 6, 1e-3


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("families_engine")
    out = {}
    for arch in ALL_ARCHS:
        out[arch] = str(d / f"{arch}.gguf")
        write_arch(out[arch], arch)
    return out


def _collect(tasks, timeout=180):
    out = []
    for t in tasks:
        while True:
            kind, payload = t.result_q.get(timeout=timeout)
            if kind == "final":
                out.append(payload)
                break
            if kind == "error":
                raise payload
    return out


# prompts whose greedy steps clear MARGIN in every family (the random
# models' logits are flat, and other prompts meet near ties)
PROMPTS = ([1, 106, 88, 120, 137, 202, 249], [1, 23, 261, 150, 102])


def _ecfg(cls, chain):
    return cls(n_slots=2, n_ctx=2 * 64, n_ubatch=16, kv_dtype="float32",
               decode_chain=chain)


def _port_tokens(path, chain):
    cfg, params = load_model(path, dtype=torch.float32, device="cpu")
    with GGUFFile(path) as g:
        tok = Tokenizer.from_gguf(g)
    eng = Engine(cfg, params, tok, _ecfg(EngineConfig, chain), device="cpu")
    eng.start()
    try:
        tasks = [CompletionsTask(list(p), SamplerParams(temp=0.0),
                                 tokenizer=tok, max_tokens=N_GEN, n_probs=2)
                 for p in PROMPTS]
        for t in tasks:
            eng.submit(t)
        return _collect(tasks)
    finally:
        eng.stop()


def _jax_tokens(path):
    cfg, params = jax_load(path, dtype=jnp.float32)
    with JGGUFFile(path) as g:
        tok = JTokenizer.from_gguf(g)
    eng = JEngine(cfg, params, tok, _ecfg(JEngineConfig, 4))
    eng.start()
    try:
        tasks = [JTask(list(p), JSamplerParams(temp=0.0), tokenizer=tok,
                       max_tokens=N_GEN) for p in PROMPTS]
        for t in tasks:
            eng.submit(t)
        return [t.generated for t in _collect(tasks)]
    finally:
        eng.stop()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_engine_greedy_matches_jax(paths, arch):
    want = _jax_tokens(paths[arch])
    for chain in (1, 4):
        finals = _port_tokens(paths[arch], chain)
        for f in finals:
            for tp in f.probs:
                p0, p1 = tp.top_probs[:2]
                assert math.log(p0) - math.log(max(p1, 1e-30)) > MARGIN, \
                    "a near tie"
        assert [f.generated for f in finals] == want, chain


@pytest.mark.parametrize("arch", ["gpt2", "qwen3", "phi3"])
def test_shift_kv_matches_jax(paths, arch):
    cfg, _ = load_model(paths[arch], dtype=torch.float32, device="cpu")
    jcfg, _ = jax_load(paths[arch], dtype=jnp.float32)
    L, S, C = cfg.n_layers, 2, 64
    rng = np.random.default_rng(11)
    k = rng.standard_normal((L, S, C, cfg.n_kv_heads, cfg.head_dim))
    v = rng.standard_normal(k.shape)
    kv = tllama.KVCache(torch.from_numpy(k).float(),
                        torch.from_numpy(v).float())
    dcos, dsin = tllama.make_delta_rope(cfg, C, device="cpu")
    tllama.shift_kv(kv, 1, 4, 16, dcos, dsin, cfg.rope_mode)
    jcos, jsin = jllama.make_delta_rope(jcfg, C)
    np.testing.assert_allclose(dcos.numpy(), np.asarray(jcos), rtol=0,
                               atol=1e-7)
    jkv = jllama.shift_kv_impl(
        jllama.KVCache(jnp.asarray(k, jnp.float32),
                       jnp.asarray(v, jnp.float32)),
        1, 4, 16, jcos, jsin, jcfg.rope_mode)
    np.testing.assert_allclose(kv.k.numpy(), np.asarray(jkv.k), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(kv.v.numpy(), np.asarray(jkv.v), rtol=0,
                               atol=0)
    if cfg.rope_mode == "none":
        assert np.array_equal(kv.k.numpy()[:, 1, 4:C - 16],
                              k[:, 1, 20:].astype(np.float32))
