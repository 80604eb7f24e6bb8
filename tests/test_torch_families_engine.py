"""Port parity of the serving engine on the dense llama variants: for
every family of tests/test_torch_families.py, the port engine's greedy
tokens at K 1 and K 4 equal the JAX engine's (f32 weights and KV cache),
on prompts whose greedy steps all clear a top-2 log-prob margin of 1e-3
(checked, so a near tie shows as one; the f32 noise between the packages
is about 1e-6); the attention families' prompts are longer than their
sliding window. And a context shift (models/llama.shift_kv) equals JAX
`shift_kv_impl` on gpt2 (rope_mode "none": the keys only move), qwen3
(neox), phi3 (longrope delta tables), gemma3 (a local rope base) and
cohere2 (unroped global layers), the last two through stacked tables
picked per layer, f32 within 1e-6."""

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

from .test_torch_families import ALL_ARCHS, ATTN_ARCHS, WINDOW, write_arch

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
# the attention families': past the window of 8, clearing MARGIN too
ATTN_PROMPTS = ([1, 192, 167, 17, 254, 64, 73, 54, 95, 51, 99, 227],
                [1, 74, 257, 50, 176, 145, 257, 174, 242, 131, 63, 55, 242,
                 59])


def _ecfg(cls, chain):
    return cls(n_slots=2, n_ctx=2 * 64, n_ubatch=16, kv_dtype="float32",
               decode_chain=chain)


def _port_tokens(path, chain, prompts):
    cfg, params = load_model(path, dtype=torch.float32, device="cpu")
    with GGUFFile(path) as g:
        tok = Tokenizer.from_gguf(g)
    eng = Engine(cfg, params, tok, _ecfg(EngineConfig, chain), device="cpu")
    eng.start()
    try:
        tasks = [CompletionsTask(list(p), SamplerParams(temp=0.0),
                                 tokenizer=tok, max_tokens=N_GEN, n_probs=2)
                 for p in prompts]
        for t in tasks:
            eng.submit(t)
        return _collect(tasks)
    finally:
        eng.stop()


def _jax_tokens(path, prompts):
    cfg, params = jax_load(path, dtype=jnp.float32)
    with JGGUFFile(path) as g:
        tok = JTokenizer.from_gguf(g)
    eng = JEngine(cfg, params, tok, _ecfg(JEngineConfig, 4))
    eng.start()
    try:
        tasks = [JTask(list(p), JSamplerParams(temp=0.0), tokenizer=tok,
                       max_tokens=N_GEN) for p in prompts]
        for t in tasks:
            eng.submit(t)
        return [t.generated for t in _collect(tasks)]
    finally:
        eng.stop()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_engine_greedy_matches_jax(paths, arch):
    prompts = ATTN_PROMPTS if arch in ATTN_ARCHS else PROMPTS
    assert arch not in ATTN_ARCHS or min(map(len, prompts)) > WINDOW
    want = _jax_tokens(paths[arch], prompts)
    for chain in (1, 4):
        finals = _port_tokens(paths[arch], chain, prompts)
        for f in finals:
            for tp in f.probs:
                p0, p1 = tp.top_probs[:2]
                assert math.log(p0) - math.log(max(p1, 1e-30)) > MARGIN, \
                    "a near tie"
        assert [f.generated for f in finals] == want, chain


@pytest.mark.parametrize("arch", ["gpt2", "qwen3", "phi3", "gemma3",
                                  "cohere2"])
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
    select = tllama.layer_is_local(cfg) if dcos.dim() == 3 else None
    assert (select is not None) == (arch in ("gemma3", "cohere2"))
    tllama.shift_kv(kv, 1, 4, 16, dcos, dsin, cfg.rope_mode, select)
    jcos, jsin = jllama.make_delta_rope(jcfg, C)
    np.testing.assert_allclose(dcos.numpy(), np.asarray(jcos), rtol=0,
                               atol=1e-7)
    jkv = jllama.shift_kv_impl(
        jllama.KVCache(jnp.asarray(k, jnp.float32),
                       jnp.asarray(v, jnp.float32)),
        1, 4, 16, jcos, jsin, jcfg.rope_mode,
        layer_select=(None if select is None
                      else jllama._layer_is_local(jcfg)))
    np.testing.assert_allclose(kv.k.numpy(), np.asarray(jkv.k), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(kv.v.numpy(), np.asarray(jkv.v), rtol=0,
                               atol=0)
    if cfg.rope_mode == "none":
        assert np.array_equal(kv.k.numpy()[:, 1, 4:C - 16],
                              k[:, 1, 20:].astype(np.float32))


def _reuse_port(path, prompts):
    cfg, params = load_model(path, dtype=torch.float32, device="cpu")
    with GGUFFile(path) as g:
        tok = Tokenizer.from_gguf(g)
    eng = Engine(cfg, params, tok, _ecfg(EngineConfig, 4), device="cpu")
    eng.start()
    try:
        out = []
        for p in prompts:      # one at a time: each meets the last's slot
            t = CompletionsTask(list(p), SamplerParams(temp=0.0),
                                tokenizer=tok, max_tokens=2)
            eng.submit(t)
            _collect([t])
            out.append(t.n_cached)
        return out, eng
    finally:
        eng.stop()


def _reuse_jax(path, prompts):
    cfg, params = jax_load(path, dtype=jnp.float32)
    with JGGUFFile(path) as g:
        tok = JTokenizer.from_gguf(g)
    eng = JEngine(cfg, params, tok, _ecfg(JEngineConfig, 4))
    eng.start()
    try:
        out = []
        for p in prompts:
            t = JTask(list(p), JSamplerParams(temp=0.0), tokenizer=tok,
                      max_tokens=2)
            eng.submit(t)
            _collect([t])
            out.append(t.n_cached)
        return out
    finally:
        eng.stop()


@pytest.mark.parametrize("arch", ["gemma2", "cohere2", "qwen3"])
def test_swa_admission_gates_reuse_as_jax(paths, arch):
    """The prefix cache's reuse a prompt is admitted with (task.n_cached)
    equals the JAX engine's: under a sliding window (gemma2, cohere2) a
    partial prefix reuse becomes 0, as it would dip below the window,
    while a whole-prompt repeat keeps its reuse; without one (qwen3) the
    partial reuse stays. No slot shares another's rows under a window
    (`_share_prefix`, the JAX rule), where qwen3 shares them."""
    a = ATTN_PROMPTS[0] + [7, 8, 9, 10]
    b = a[:12] + [40, 41, 42, 43, 44]
    got, eng = _reuse_port(paths[arch], [a, b, b])
    assert got == _reuse_jax(paths[arch], [a, b, b])
    swa = eng.cfg.swa_window > 0
    assert got == ([0, 0, len(b) - 1] if swa else [0, 12, len(b) - 1])
    # a donor slot holding a longer prefix of the prompt than `best`
    donor, best = eng.slots
    donor.cache_tokens, donor.pos = list(a), len(a)
    best.cache_tokens, best.pos = [], 0
    eng.ecfg.cache_share_min = 4
    shared = eng._share_prefix(best, a + [50], 0)
    assert shared == (0 if swa else len(a))
