"""Port parity of the w8a8 weight path (llama_box_tpu_torch/gguf/repack.py,
ops/qmatmul.py) against the JAX package, on the CPU.

- repack: every format of REPACKERS, on the same raw bytes (written by the
  port's quantizer), bitwise equal to the JAX package's numpy repacker;
- pack_w8a8: codes and column scales bitwise equal, whole and in blocks
  of columns;
- w8a8_matmul_plain: the int32 sums exact and the f32 outputs equal to
  JAX `_w8a8_matmul` (both compute float(s32) * xs * ws in f32 with the
  same per-row codes);
- mm: dense weights go to a dense matmul, w8a8 QTensors to the w8a8
  matmul (cast to x's dtype), grouped QTensors on a CPU x to q_matmul_ref
  (the grouped path's parity: tests/test_torch_q4_matmul.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.gguf import repack as jrepack
from llama_box_tpu.ops import qmatmul as jq
from llama_box_tpu_torch.gguf import repack as trepack
from llama_box_tpu_torch.gguf.constants import GGMLType
from llama_box_tpu_torch.gguf.quants import quantize
from llama_box_tpu_torch.ops import qmatmul as tq

# (out, in): 256-element rows (k-quants need whole 256 blocks), < 64K
# elements so the JAX repacker takes its numpy path
SHAPE = (96, 512)
FORMATS = sorted(trepack.REPACKERS, key=lambda t: t.name)


def _raw(fmt, seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    return np.frombuffer(quantize(fmt, x), dtype=np.uint8)


def test_repackers_cover_the_jax_formats():
    assert set(trepack.REPACKERS) == set(jrepack.REPACKERS)


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda t: t.name)
def test_repack_bitwise_equal(fmt):
    raw = _raw(fmt)
    n = SHAPE[0] * SHAPE[1]
    got = trepack.repack(fmt, raw, n)
    want = jrepack.repack(fmt, raw, n)
    assert (got.group, got.qbits) == (want.group, want.qbits)
    np.testing.assert_array_equal(got.q, want.q)
    assert got.q.dtype == want.q.dtype == np.int8
    np.testing.assert_array_equal(got.scales.view(np.uint32),
                                  want.scales.view(np.uint32))
    assert (got.mins is None) == (want.mins is None)
    if got.mins is not None:
        np.testing.assert_array_equal(got.mins.view(np.uint32),
                                      want.mins.view(np.uint32))
    np.testing.assert_array_equal(trepack.dequantize_repacked(got),
                                  jrepack.dequantize_repacked(want))


@pytest.mark.parametrize("fmt", [GGMLType.Q4_K, GGMLType.Q8_0,
                                 GGMLType.Q6_K, GGMLType.Q4_1],
                         ids=lambda t: t.name)
def test_pack_w8a8_bitwise_equal(fmt):
    raw = _raw(fmt, seed=1)
    rt = trepack.repack(fmt, raw, SHAPE[0] * SHAPE[1])
    shape_in_out = (SHAPE[1], SHAPE[0])
    got = tq.pack_w8a8(rt, shape_in_out)
    want = jq.pack_w8a8(rt, shape_in_out, device=False)
    assert got.w8a8 and (got.in_dim, got.group) == (want.in_dim, want.group)
    assert tuple(got.qs.shape) == (SHAPE[1], SHAPE[0])
    np.testing.assert_array_equal(got.qs.numpy(), np.asarray(want.qs))
    np.testing.assert_array_equal(got.scales.numpy().view(np.uint32),
                                  np.asarray(want.scales).view(np.uint32))
    assert got.mins is None and want.mins is None
    # pack_repacked is the w8a8 packing in the port
    np.testing.assert_array_equal(
        tq.pack_repacked(rt, shape_in_out).qs.numpy(), got.qs.numpy())


@pytest.mark.parametrize("fmt", [GGMLType.Q8_0, GGMLType.Q4_K],
                         ids=lambda t: t.name)
def test_pack_w8a8_in_column_blocks_bitwise_equal(monkeypatch, fmt):
    """pack_w8a8 requantizes _PACK_COLS output columns at a time: blocks
    of 40 over 96 columns (the last one short, a column all zeros) give
    the JAX package's codes and scales bit for bit."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(SHAPE) * 0.05).astype(np.float32)
    x[50] = 0.0
    raw = np.frombuffer(quantize(fmt, x), dtype=np.uint8)
    rt = trepack.repack(fmt, raw, SHAPE[0] * SHAPE[1])
    shape_in_out = (SHAPE[1], SHAPE[0])
    monkeypatch.setattr(tq, "_PACK_COLS", 40)
    got = tq.pack_w8a8(rt, shape_in_out)
    want = jq.pack_w8a8(rt, shape_in_out, device=False)
    np.testing.assert_array_equal(got.qs.numpy(), np.asarray(want.qs))
    np.testing.assert_array_equal(got.scales.numpy().view(np.uint32),
                                  np.asarray(want.scales).view(np.uint32))


def _operands(rng, M, K, N, dtype=np.float32):
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0, :3] = [4.0, -4.0, 2.0]          # a row whose max is a tie point
    qs = rng.integers(-127, 128, (K, N)).astype(np.int8)
    sc = rng.uniform(0.001, 0.02, N).astype(np.float32)
    return x, qs, sc


@pytest.mark.parametrize("M", [1, 4, 37])
@pytest.mark.parametrize("xdt", ["f32", "bf16"])
def test_w8a8_matmul_plain_matches_jax(M, xdt):
    rng = np.random.default_rng(M)
    x, qs, sc = _operands(rng, M, 320, 144)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[xdt]
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(x).to(tdt)
    w = jq.QTensor(jnp.asarray(qs), jnp.asarray(sc), None, 320, 320,
                   packed4=False, w8a8=True)
    want = np.asarray(jq._w8a8_matmul(xj, w))
    got = tq.w8a8_matmul_plain(xt, torch.from_numpy(qs),
                               torch.from_numpy(sc)).numpy()
    # the integer sums are exact on both sides
    xq, _ = tq._quant_rows(xt.float())
    xf = np.asarray(xj.astype(jnp.float32))
    xs = np.maximum(np.abs(xf).max(-1, keepdims=True), 1e-12) / np.float32(127)
    codes = np.clip(np.round(xf / xs), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(xq.numpy(), codes)
    acc = codes.astype(np.int64) @ qs.astype(np.int64)
    np.testing.assert_array_equal(
        tq._int_dot(xq, torch.from_numpy(qs)).numpy(),
        acc.astype(np.float32))
    np.testing.assert_array_equal(got, want)
    # the CPU wrapper is the plain version
    np.testing.assert_array_equal(
        tq.w8a8_matmul(xt, torch.from_numpy(qs), torch.from_numpy(sc)).numpy(),
        got)


def test_w8a8_matmul_zero_rows_and_q_matmul_ref():
    rng = np.random.default_rng(3)
    x, qs, sc = _operands(rng, 3, 64, 32)
    x[1] = 0.0                           # amax 0: scale 1e-12 / 127, codes 0
    xt, qst, sct = (torch.from_numpy(a) for a in (x, qs, sc))
    got = tq.w8a8_matmul_plain(xt, qst, sct)
    assert torch.all(got[1] == 0)
    w = tq.QTensor(qst, sct, None, 64, 64, packed4=False, w8a8=True)
    ref = tq.q_matmul_ref(xt, w)
    # per-row int8 activations: within a few codes' error of the f32 product
    assert float((got - ref).abs().max()) < 0.05 * float(ref.abs().max())


def test_mm_dispatch():
    rng = np.random.default_rng(4)
    x, qs, sc = _operands(rng, 6, 64, 48)
    xb = torch.from_numpy(x).to(torch.bfloat16).reshape(2, 3, 64)
    dense = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    out = tq.mm(xb, dense)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 3, 48)
    torch.testing.assert_close(out, torch.matmul(xb, dense.to(torch.bfloat16)))
    w = tq.QTensor(torch.from_numpy(qs), torch.from_numpy(sc), None, 64, 64,
                   packed4=False, w8a8=True)
    out = tq.mm(xb, w)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 3, 48)
    want = tq.w8a8_matmul_plain(xb.reshape(6, 64), w.qs, w.scales)
    torch.testing.assert_close(out.reshape(6, 48), want.to(torch.bfloat16),
                               rtol=0, atol=0)
    grouped = tq.QTensor(w.qs, torch.ones(2, 48), None, 64, 32,
                         packed4=False)
    out = tq.mm(xb, grouped)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 3, 48)
    want = xb.reshape(6, 64).float() @ w.qs.float()
    torch.testing.assert_close(out.reshape(6, 48), want.to(torch.bfloat16),
                               rtol=0, atol=0)


def test_qtensor_unbind_and_leaves():
    qs = torch.arange(2 * 4 * 8, dtype=torch.int8).reshape(2, 4, 8)
    sc = torch.rand(2, 8)
    w = tq.QTensor(qs, sc, None, 4, 4, packed4=False, w8a8=True)
    per = w.unbind(0)
    assert len(per) == 2 and per[1].out_dim == 8 and per[1].w8a8
    assert torch.equal(per[1].qs, qs[1]) and torch.equal(per[1].scales, sc[1])
    assert per[1].qs.is_contiguous()
    assert [t.shape for t in w.leaves()] == [qs.shape, sc.shape]
