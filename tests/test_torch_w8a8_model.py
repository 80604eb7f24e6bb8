"""Port parity of the w8a8 model path (`load_model(..., quantized=True)`,
QTensor projections, the fused decode kernels' plain versions) against the
JAX package, on the tiny fixture GGUF at Q4_K and at Q8_0 with the
fusion-compatible widths of tests/test_fused_decode.py (N_EMBD=128,
HEAD_DIM=32, N_FF=256), bf16 activations and bf16 KV cache.

- the loaded QTensors equal the JAX loader's bit for bit;
- params_from_numpy of the JAX tree gives the port's own forward;
- with f32 activations and cache, prefill logits within 1e-4 of JAX's
  (the int8 codes and s32 sums are the same; f32 sums run in another
  order);
- with bf16 activations, prefill and (fused) decode logits within 5e-2
  of JAX's, at |logit| up to about 2. The port rounds to bf16 at every
  point the JAX code names; XLA on the CPU keeps f32 across fused bf16
  ops (its excess-precision rewrite), and a value that differs by one
  bf16 step moves a per-row int8 code, so the logits differ by up to
  4.4e-2 here (2e-2 for bf16 weights, where no code moves);
- engine greedy tokens equal the JAX engine's, unfused and with the JAX
  fused kernels forced on (LLAMA_BOX_TPU_FORCE_FUSED, interpret mode),
  on a prompt whose greedy steps all clear a top-2 logit margin of 0.1
  (checked), twice that noise: at smaller margins the JAX fused and
  unfused paths themselves disagree on this fixture;
- the port's fused path (its default) and LLAMA_BOX_TPU_NO_FUSED give the
  same tokens."""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.fixtures.make_tiny_model as mk
from llama_box_tpu.gguf import GGUFFile as JGGUFFile
from llama_box_tpu.gguf.constants import GGMLType
from llama_box_tpu.models import llama as jllama
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.models.loader import (deinterleave_rope as j_deint,
                                         fuse_projections as j_fuse)
from llama_box_tpu.ops.qmatmul import QTensor as JQTensor
from llama_box_tpu.sampling import SamplerParams as JSamplerParams
from llama_box_tpu.server import Engine as JEngine, EngineConfig as JEngineConfig
from llama_box_tpu.server.task import CompletionsTask as JTask
from llama_box_tpu.tokenizer import Tokenizer as JTokenizer
from llama_box_tpu_torch.gguf import GGUFFile
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models.loader import (deinterleave_rope,
                                               fuse_projections, load_model,
                                               params_from_numpy)
from llama_box_tpu_torch.ops import fused_decode as tfd
from llama_box_tpu_torch.ops.qmatmul import QTensor
from llama_box_tpu_torch.sampling import SamplerParams
from llama_box_tpu_torch.server.engine import Engine, EngineConfig
from llama_box_tpu_torch.server.task import CompletionsTask
from llama_box_tpu_torch.tokenizer import Tokenizer

FMTS = ("Q4_K", "Q8_0")
S, C, T = 3, 96, 32
ATOL = 5e-2
ATOL_F32 = 1e-4
PROMPT = [1, 112, 240, 156, 12, 214, 205, 237, 51, 27, 242, 9]
N_GEN = 8
MARGIN = 0.1


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mk, "N_EMBD", 128)
        mp.setattr(mk, "HEAD_DIM", 32)
        mp.setattr(mk, "N_FF", 256)
        for fmt in FMTS:
            p = str(tmp_path_factory.mktemp("w8a8") / f"tiny-{fmt}.gguf")
            mk.write_tiny_model(p, quant=GGMLType[fmt])
            out[fmt] = p
    return out


@pytest.fixture(scope="module")
def models(paths):
    """fmt -> (jcfg, jax params, tcfg, port params), both after the rope
    de-interleave and the projection fusion the engines apply."""
    out = {}
    for fmt, p in paths.items():
        jcfg, jp = jax_load(p, dtype=jnp.bfloat16, quantized=True)
        jp, jcfg = j_deint(jp, jcfg)
        jp = j_fuse(jp, jcfg)
        tcfg, tp = load_model(p, dtype=torch.bfloat16, device="cpu",
                              quantized=True)
        tp, tcfg = deinterleave_rope(tp, tcfg)
        tp = fuse_projections(tp, tcfg)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        out[fmt] = (jcfg, jp, tcfg, tp)
    return out


def _bits(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint8) if a.dtype == np.int8 else a.view(np.uint32)


def _tbits(t):
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits(t.numpy())


@pytest.mark.parametrize("fmt", FMTS)
def test_loaded_qtensors_equal_jax(paths, fmt):
    jcfg, jp = jax_load(paths[fmt], dtype=jnp.bfloat16, quantized=True)
    tcfg, tp = load_model(paths[fmt], dtype=torch.bfloat16, device="cpu",
                          quantized=True)
    jl, tl = jp["layers"], tp["layers"]
    assert set(tl) <= set(jl)
    n_q = 0
    for key, tw in list(tl.items()) + [("output", tp["output"])]:
        jw = jp["output"] if key == "output" else jl[key]
        assert isinstance(tw, QTensor) == isinstance(jw, JQTensor), key
        if isinstance(tw, QTensor):
            n_q += 1
            assert tw.w8a8 and jw.w8a8 and tw.in_dim == jw.in_dim
            np.testing.assert_array_equal(tw.qs.numpy(), np.asarray(jw.qs))
            np.testing.assert_array_equal(_tbits(tw.scales),
                                          _bits(jw.scales))
        else:
            np.testing.assert_array_equal(_tbits(tw), _bits(jw))
    assert n_q == 7     # wq wk wv wo w_gate w_up w_down (output: 287 rows)
    np.testing.assert_array_equal(_tbits(tp["tok_embd"]),
                                  _bits(jp["tok_embd"]))


def _chunks():
    rng = np.random.default_rng(0)
    toks = rng.integers(3, 280, (2, S, T)).astype(np.int32)
    n1 = np.array([T, 20, 9], np.int32)
    p2 = np.array([T, 0, 9], np.int32)
    n2 = np.array([17, 0, 23], np.int32)
    return toks, (np.zeros(S, np.int32), n1), (p2, n2)


def _jax_prefill(jcfg, jp, kvd=jnp.bfloat16):
    kv = jllama.init_kv_cache(jcfg, S, C, kvd)
    cos, sin = jllama.make_rope(jcfg, C)
    toks, (p1, n1), (p2, n2) = _chunks()
    out = []
    for t, p, n in ((toks[0], p1, n1), (toks[1], p2, n2)):
        lg, kv = jllama.prefill_batch(jp, jcfg, jnp.asarray(t),
                                      jnp.asarray(p), jnp.asarray(n), kv,
                                      cos, sin)
        out.append(np.asarray(lg))
    return out


def _torch_prefill(tcfg, tp, kvd=torch.bfloat16):
    kv = tllama.init_kv_cache(tcfg, S, C, kvd, device="cpu")
    cos, sin = tllama.make_rope(tcfg, C, device="cpu")
    toks, (p1, n1), (p2, n2) = _chunks()
    out = []
    for t, p, n in ((toks[0], p1, n1), (toks[1], p2, n2)):
        lg, kv = tllama.prefill_batch_impl(tp, tcfg, torch.from_numpy(t),
                                           p, n, kv, cos, sin)
        out.append(lg.numpy())
    return out


@pytest.mark.parametrize("fmt", FMTS)
def test_params_from_numpy_gives_the_same_forward(models, fmt):
    jcfg, jp, tcfg, tp = models[fmt]
    tp2 = params_from_numpy(jax.tree.map(np.asarray, jp), jcfg)
    assert "smalls_all" not in tp2["layers"]
    assert set(tp2["layers"]) == set(tp["layers"])
    assert isinstance(tp2["layers"]["wqkv"], QTensor)
    a, b = _torch_prefill(tcfg, tp), _torch_prefill(tcfg, tp2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fmt", FMTS)
def test_prefill_logits(models, fmt, monkeypatch):
    jcfg, jp, tcfg, tp = models[fmt]
    monkeypatch.delenv("LLAMA_BOX_TPU_FORCE_FUSED", raising=False)
    jax.clear_caches()
    want = _jax_prefill(jcfg, jp)
    got = _torch_prefill(tcfg, tp)
    _, (_, n1), (_, n2) = _chunks()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    live = n2 > 0
    np.testing.assert_allclose(got[1][live], want[1][live], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("fmt", FMTS)
def test_prefill_logits_f32_activations(paths, fmt):
    jcfg, jp = jax_load(paths[fmt], dtype=jnp.float32, quantized=True)
    jp, jcfg = j_deint(jp, jcfg)
    jp = j_fuse(jp, jcfg)
    tcfg, tp = load_model(paths[fmt], dtype=torch.float32, device="cpu",
                          quantized=True)
    tp, tcfg = deinterleave_rope(tp, tcfg)
    tp = fuse_projections(tp, tcfg)
    want = _jax_prefill(jcfg, jp, jnp.float32)
    got = _torch_prefill(tcfg, tp, torch.float32)
    _, _, (_, n2) = _chunks()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(got[1][n2 > 0], want[1][n2 > 0], rtol=0,
                               atol=ATOL_F32)


@pytest.mark.parametrize("fmt", FMTS)
def test_decode_logits_fused(models, fmt, monkeypatch):
    """One decode step after a prefill, the JAX fused kernels forced on
    (interpret mode) and the port's fused path (its default), which the
    launch counts of the kernels' CPU plain versions do not show: the
    gates are checked in tests/test_torch_fused_decode.py."""
    jcfg, jp, tcfg, tp = models[fmt]
    toks, (p1, n1), _ = _chunks()
    nxt = np.array([[5], [7], [9]], np.int32)
    pos = n1[:, None].astype(np.int32)
    pos[1, 0] = C               # slot 1 inactive

    monkeypatch.setenv("LLAMA_BOX_TPU_FORCE_FUSED", "1")
    monkeypatch.delenv("LLAMA_BOX_TPU_NO_FUSED", raising=False)
    jax.clear_caches()
    kv_j = jllama.init_kv_cache(jcfg, S, C, jnp.bfloat16)
    cos_j, sin_j = jllama.make_rope(jcfg, C)
    _, kv_j = jllama.prefill_batch(jp, jcfg, jnp.asarray(toks[0]),
                                   jnp.asarray(p1), jnp.asarray(n1), kv_j,
                                   cos_j, sin_j)
    want, _ = jllama.forward(jp, jcfg, jnp.asarray(nxt), jnp.asarray(pos),
                             kv_j, jnp.asarray((pos[:, 0] < C).astype(
                                 np.int32)), cos_j, sin_j)
    jax.clear_caches()

    kv_t = tllama.init_kv_cache(tcfg, S, C, torch.bfloat16, device="cpu")
    cos_t, sin_t = tllama.make_rope(tcfg, C, device="cpu")
    _, kv_t = tllama.prefill_batch_impl(tp, tcfg, torch.from_numpy(toks[0]),
                                        p1, n1, kv_t, cos_t, sin_t)
    got, _ = tllama.forward_impl(tp, tcfg, torch.from_numpy(nxt), pos, kv_t,
                                 cos_t, sin_t)
    live = pos[:, 0] < C
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               rtol=0, atol=ATOL)


def _run_engine(eng, task):
    eng.start()
    try:
        eng.submit(task)
        while True:
            kind, payload = task.result_q.get(timeout=300)
            if kind == "error":
                raise payload
            if kind == "final":
                return payload
    finally:
        eng.stop()


def _jax_greedy(path):
    cfg, params = jax_load(path, dtype=jnp.bfloat16, quantized=True)
    with JGGUFFile(path) as g:
        tok = JTokenizer.from_gguf(g)
    eng = JEngine(cfg, params, tok, JEngineConfig(n_slots=2, n_ctx=128))
    return list(_run_engine(eng, JTask(
        PROMPT, JSamplerParams(temp=0.0, seed=0), tokenizer=tok,
        max_tokens=N_GEN, stream=False)).generated)


def _port_greedy(path, chain=1):
    cfg, params = load_model(path, dtype=torch.bfloat16, device="cpu",
                             quantized=True)
    with GGUFFile(path) as g:
        tok = Tokenizer.from_gguf(g)
    eng = Engine(cfg, params, tok,
                 EngineConfig(n_slots=2, n_ctx=128, decode_chain=chain),
                 device="cpu")
    final = _run_engine(eng, CompletionsTask(
        PROMPT, SamplerParams(temp=0.0, seed=0), tokenizer=tok,
        max_tokens=N_GEN, n_probs=2))
    for tp in final.probs:           # no near tie on this prompt
        assert tp.top_ids[0] == tp.token
        p0, p1 = tp.top_probs[:2]
        assert math.log(p0) - math.log(p1) > MARGIN, "a near tie"
    return list(final.generated)


def _with_env(name, value, fn):
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        jax.clear_caches()
        return fn()
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old
        jax.clear_caches()


@pytest.fixture(scope="module")
def greedy(paths):
    """(package, fmt, mode) -> greedy tokens for PROMPT, run once."""
    cache = {}

    def get(pkg, fmt, mode):
        key = (pkg, fmt, mode)
        if key not in cache:
            if pkg == "jax":
                cache[key] = _with_env(
                    "LLAMA_BOX_TPU_FORCE_FUSED",
                    "1" if mode == "fused" else None,
                    lambda: _jax_greedy(paths[fmt]))
            else:
                cache[key] = _with_env(
                    "LLAMA_BOX_TPU_NO_FUSED",
                    "1" if mode == "unfused" else None,
                    lambda: _port_greedy(paths[fmt],
                                         chain=4 if mode == "fused" else 1))
        return cache[key]
    return get


@pytest.mark.parametrize("mode", ["unfused", "fused"])
@pytest.mark.parametrize("fmt", FMTS)
def test_engine_greedy_matches_jax(greedy, fmt, mode):
    want = greedy("jax", fmt, mode)
    assert len(want) == N_GEN
    assert greedy("port", fmt, mode) == want


@pytest.mark.parametrize("fmt", FMTS)
def test_port_fused_equals_no_fused(greedy, fmt):
    before = (tfd.fused_norm_qmm.launches, tfd.fused_layer_tail.launches)
    assert greedy("port", fmt, "fused") == greedy("port", fmt, "unfused")
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (tfd.fused_norm_qmm.launches,
            tfd.fused_layer_tail.launches) == before
