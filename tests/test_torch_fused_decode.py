"""Port parity of the fused w8a8 decode kernels' plain versions
(llama_box_tpu_torch/ops/fused_decode.py) against the JAX package, on the
CPU: the JAX Pallas kernels in interpret mode, and the JAX unfused
sequence they replace.

Tolerances are the JAX tests' own (tests/test_fused_decode.py):
rtol = atol = 1e-2 for fused_norm_qmm and 2e-2 for fused_layer_tail,
plus argmax agreement. The mean of squares is summed in another order by
torch than by XLA, so one bf16 rounding of a normed value, and then one
int8 code, can flip; every other step has the same rounding points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.ops import fused_decode as jfd
from llama_box_tpu.ops.norm import rms_norm as j_rms
from llama_box_tpu.ops.qmatmul import QTensor as JQTensor, mm as jmm
from llama_box_tpu_torch.ops import fused_decode as tfd

EPS = 1e-5


def _bf16(rng, *shape, lo=None, hi=None):
    if lo is None:
        a = rng.normal(size=shape).astype(np.float32)
    else:
        a = rng.uniform(lo, hi, shape).astype(np.float32)
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _qt(rng, in_dim, out_dim):
    qs = rng.integers(-127, 127, (in_dim, out_dim), dtype=np.int8)
    sc = rng.uniform(0.005, 0.02, out_dim).astype(np.float32)
    jw = JQTensor(jnp.asarray(qs), jnp.asarray(sc), None, in_dim, in_dim,
                  packed4=False, w8a8=True)
    return jw, torch.from_numpy(qs), torch.from_numpy(sc)


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    return got, want


def test_fused_norm_qmm_plain_matches_jax():
    rng = np.random.default_rng(0)
    R, E, O = 8, 256, 512
    xj, xt = _bf16(rng, R, E)
    nj, nt = _bf16(rng, E, lo=0.5, hi=1.5)
    jw, qs, sc = _qt(rng, E, O)
    got = tfd.fused_norm_qmm_plain(xt, nt, qs, sc, eps=EPS)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (R, O)
    kern = jfd.fused_norm_qmm(xj, nj, jw.qs, jw.scales, eps=EPS,
                              interpret=True)
    unfused = jmm(j_rms(xj, nj, EPS), jw)
    for want in (kern, unfused):
        g, w = _close(got, want, 1e-2)
        assert np.array_equal(g.argmax(-1), w.argmax(-1))
    # the CPU wrapper is the plain version
    assert torch.equal(tfd.fused_norm_qmm(xt, nt, qs, sc, eps=EPS), got)


def _jax_unfused_tail(ao, x, nw, wo, gu, dn, FF, rs, act_fn):
    """models/llama._layer_tail / _ffn_block unfused (the JAX test's)."""
    attn_out = jmm(ao, wo)
    x1 = x + attn_out * rs
    h = j_rms(x1, nw, EPS)
    guv = jmm(h, gu)
    gate = guv[..., :FF].astype(jnp.float32)
    a = jfd._act_f32(gate, act_fn)
    act = (a * guv[..., FF:].astype(jnp.float32)).astype(x.dtype)
    return x1 + jmm(act, dn) * rs


def _tail_case(seed, R, HD, E, FF, act_fn, rs):
    rng = np.random.default_rng(seed)
    aoj, aot = _bf16(rng, R, HD)
    xj, xt = _bf16(rng, R, E)
    nj, nt = _bf16(rng, E, lo=0.5, hi=1.5)
    wo = _qt(rng, HD, E)
    gu = _qt(rng, E, 2 * FF)
    dn = _qt(rng, FF, E)
    got = tfd.fused_layer_tail_plain(aot, xt, wo[1], wo[2], nt, gu[1], gu[2],
                                     dn[1], dn[2], eps=EPS, rs=rs,
                                     act_fn=act_fn)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (R, E)
    kern = jfd.fused_layer_tail(aoj, xj, wo[0].qs, wo[0].scales, nj,
                                gu[0].qs, gu[0].scales, dn[0].qs,
                                dn[0].scales, eps=EPS, rs=rs, act_fn=act_fn,
                                interpret=True)
    unfused = _jax_unfused_tail(aoj, xj, nj, wo[0], gu[0], dn[0], FF, rs,
                                act_fn)
    for want in (kern, unfused):
        g, w = _close(got, want, 2e-2)
        assert np.array_equal(g.argmax(-1), w.argmax(-1))
    assert torch.equal(
        tfd.fused_layer_tail(aot, xt, wo[1], wo[2], nt, gu[1], gu[2], dn[1],
                             dn[2], eps=EPS, rs=rs, act_fn=act_fn), got)


@pytest.mark.parametrize("act_fn", ["silu", "gelu", "relu2"])
@pytest.mark.parametrize("rs", [1.0, 0.5])
def test_fused_layer_tail_plain_matches_jax(act_fn, rs):
    _tail_case(1, 8, 256, 256, 512, act_fn, rs)


def test_fused_layer_tail_plain_uneven_tiles():
    """FF not divisible by 512 (the JAX kernel's 256/128 tile fallbacks)."""
    _tail_case(2, 8, 128, 128, 384, "silu", 1.0)


def test_act_f32_matches_jax():
    x = np.linspace(-6, 6, 97).astype(np.float32)
    for act_fn in ("silu", "gelu", "relu2"):
        np.testing.assert_allclose(
            tfd._act_f32(torch.from_numpy(x), act_fn).numpy(),
            np.asarray(jfd._act_f32(jnp.asarray(x), act_fn)),
            rtol=1e-6, atol=1e-6)


def test_gates_engage_on_fixture(tmp_path, monkeypatch):
    """The port's gates accept the fused-compatible fixture (as the JAX
    test_fused_gates_engage_on_fixture), on by default and off with
    LLAMA_BOX_TPU_NO_FUSED; wider-than-64-row inputs stay unfused."""
    import tests.fixtures.make_tiny_model as mk
    from llama_box_tpu_torch.gguf.constants import GGMLType
    from llama_box_tpu_torch.models import llama as tl
    from llama_box_tpu_torch.models.loader import (fuse_projections,
                                                   load_model)

    monkeypatch.setattr(mk, "N_EMBD", 128)
    monkeypatch.setattr(mk, "HEAD_DIM", 32)
    monkeypatch.setattr(mk, "N_FF", 256)
    path = str(tmp_path / "t.gguf")
    mk.write_tiny_model(path, quant=GGMLType.Q4_K)
    cfg, params = load_model(path, dtype=torch.bfloat16, device="cpu",
                             quantized=True)
    params = fuse_projections(params, cfg)
    lp = {k: v.unbind(0)[0] for k, v in params["layers"].items()}
    x = torch.zeros((2, 1, 128), dtype=torch.bfloat16)
    monkeypatch.delenv("LLAMA_BOX_TPU_NO_FUSED", raising=False)
    assert tl._fuse_qkv_ok(cfg, lp, x)
    assert tl._fuse_tail_ok(cfg, lp, x)
    assert tl._fuse_qkv_ok(cfg, lp, torch.zeros((4, 16, 128),
                                                dtype=torch.bfloat16))
    assert not tl._fuse_tail_ok(cfg, lp, torch.zeros((5, 13, 128),
                                                     dtype=torch.bfloat16))
    assert not tl._fuse_qkv_ok(cfg, lp, x.float())
    monkeypatch.setenv("LLAMA_BOX_TPU_NO_FUSED", "1")
    assert not tl._fuse_qkv_ok(cfg, lp, x)
    assert not tl._fuse_tail_ok(cfg, lp, x)


def test_jax_gates_agree_with_the_port(tmp_path, monkeypatch):
    """With the JAX fused path forced on, the JAX gates take the same
    decisions as the port's on the same fixture and row counts."""
    import tests.fixtures.make_tiny_model as mk
    from llama_box_tpu.gguf.constants import GGMLType
    from llama_box_tpu.models import load_model as jload
    from llama_box_tpu.models import llama as jl
    from llama_box_tpu.models.loader import fuse_projections as jfuse
    from llama_box_tpu_torch.models import llama as tl
    from llama_box_tpu_torch.models.loader import (fuse_projections,
                                                   load_model)

    monkeypatch.setattr(mk, "N_EMBD", 128)
    monkeypatch.setattr(mk, "HEAD_DIM", 32)
    monkeypatch.setattr(mk, "N_FF", 256)
    path = str(tmp_path / "t.gguf")
    mk.write_tiny_model(path, quant=GGMLType.Q8_0)
    jcfg, jp = jload(path, dtype=jnp.bfloat16, quantized=True)
    jlp = jax.tree.map(lambda a: a[0], jfuse(jp, jcfg)["layers"])
    tcfg, tp = load_model(path, dtype=torch.bfloat16, device="cpu",
                          quantized=True)
    tlp = {k: v.unbind(0)[0] for k, v in
           fuse_projections(tp, tcfg)["layers"].items()}
    monkeypatch.setenv("LLAMA_BOX_TPU_FORCE_FUSED", "1")
    for shape in ((2, 1), (4, 16), (8, 8), (5, 13), (1, 65)):
        xj = jnp.zeros(shape + (128,), jnp.bfloat16)
        xt = torch.zeros(shape + (128,), dtype=torch.bfloat16)
        assert jl._fuse_qkv_ok(jcfg, jlp, None, xj) \
            == tl._fuse_qkv_ok(tcfg, tlp, xt)
        assert jl._fuse_tail_ok(jcfg, jlp, None, xj) \
            == tl._fuse_tail_ok(tcfg, tlp, xt)


# -- the CUDA kernels' split rule (ops/fused_decode._splits) -----------------
#
# The fused kernels' weights [in, out] at TinyLlama-1.1B's and Llama-3-8B's
# widths (gate|up as [E, 2 * FF]), and the GPU tests' small ones (ragged
# in-dims of 200 and 100 rows).
_WEIGHTS = {
    "tinyllama": dict(wqkv=(2048, 2560), output=(2048, 32000),
                      wo=(2048, 2048), gate_up=(2048, 11264),
                      down=(5632, 2048)),
    "llama3_8b": dict(wqkv=(4096, 6144), output=(4096, 128256),
                      wo=(4096, 4096), gate_up=(4096, 28672),
                      down=(14336, 4096)),
    "gpu_tests": dict(qkv=(256, 96), gate_up=(256, 400), down=(200, 256),
                      odd=(100, 36)),
}


def _cut(k, S):
    """The kernel's split of ceil(k / 64) tiles: split s takes tiles
    [kt * s // S, kt * (s + 1) // S)."""
    kt = -(-k // 64)
    return [kt * (s + 1) // S - kt * s // S for s in range(S)]


@pytest.mark.parametrize("model,proj", [(m, p) for m in _WEIGHTS
                                        for p in _WEIGHTS[m]])
def test_fused_split_rule(model, proj):
    import inspect
    k, n = _WEIGHTS[model][proj]
    S = tfd._splits(k, n)
    kt = -(-k // 64)
    # the weight's shape alone: no row count enters the rule
    assert list(inspect.signature(tfd._splits).parameters) == ["k", "n"]
    assert 1 <= S <= kt
    # each split a whole number of 64-row tiles (only the last tile of the
    # in-dim is ragged), at most 128 of them, covering the in-dim once
    sizes = _cut(k, S)
    assert min(sizes) >= 1 and sum(sizes) == kt and max(sizes) <= 128
    # the blocks fill a wave of 132 SMs, or the splits are at their cap
    blocks = -(-n // 128) * S
    assert blocks >= 132 or S == min(16, kt), (blocks, S)


@pytest.mark.parametrize("R", [1, 4, 9, 64])
def test_split_regions_cover_the_kernels_sums(R):
    """Each phase's region holds what csrc/w8a8_common.cuh indexes, for any
    rows a block takes (RP = 1, 2, 4 or 8): row groups x column tiles x RP
    x 128 sums and a ticket per (row group, tile); regions do not overlap
    and start zero; a single split needs none. The tail's row maxima lie
    in a buffer of their own (they are not zero after a call)."""
    dev = torch.device("cpu")
    parts = [(2048, 9), (11264, 2), (2048, 1), (96, 4)]
    regions = tfd._split_regions(dev, R, parts)
    assert tfd._split_regions(dev, R, parts) is regions   # kept per shape
    amax = tfd._row_max_buffer(dev)
    assert amax.numel() >= R and amax.dtype == torch.int32
    spans = [(amax.data_ptr(), amax.data_ptr() + 4 * amax.numel())]
    for (n, s), (acc, cnt) in zip(parts, regions):
        if s == 1:
            assert acc is None and cnt is None
            continue
        tiles = -(-n // 128)
        for rp in (1, 2, 4, 8):
            groups = -(-R // rp)
            assert acc.numel() >= groups * tiles * rp * 128
            assert cnt.numel() >= groups * tiles
        for t in (acc, cnt):
            assert t.dtype == torch.int32 and int(t.abs().sum()) == 0
            spans.append((t.data_ptr(), t.data_ptr() + 4 * t.numel()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    tfd._scratch.pop(dev, None)
    tfd._regions.clear()
    tfd._row_max.pop(dev, None)


def test_tail_xnew_plain_matches_jax_unfused():
    """The tail's xnew rows, plain, against the JAX unfused sequence's
    x + wo(ao) (bf16 rounding points as _tail_kernel's first phase)."""
    rng = np.random.default_rng(5)
    R, HD, E = 4, 256, 256
    aoj, aot = _bf16(rng, R, HD)
    xj, xt = _bf16(rng, R, E)
    jw, qs, sc = _qt(rng, HD, E)
    got = tfd.tail_xnew_plain(aot, xt, qs, sc, rs=0.5)
    want = xj + jmm(aoj, jw).astype(jnp.bfloat16) * jnp.bfloat16(0.5)
    assert got.dtype == torch.bfloat16
    _close(got, want, 1e-2)
