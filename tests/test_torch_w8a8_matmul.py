"""The w8a8 matmul's host side (llama_box_tpu_torch/ops/qmatmul.py) on the
CPU: the tile and split rule of csrc/w8a8_matmul.cu as a pure function of
the call's shape, the bf16 output (`out_dtype`), `mm` keeping x's dtype,
the row-quantize pass's plain form, and the plain version against JAX
`_w8a8_matmul(...).astype(bf16)` at ragged row counts. The kernels
themselves are held to the plain version bit for bit in
tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.ops import qmatmul as jq
from llama_box_tpu_torch.ops import qmatmul as tq

# TinyLlama-1.1B's projections as (in, out): wqkv, wo, gate|up, down
SERVED = {"wqkv": (2048, 2560), "wo": (2048, 2048), "gateup": (2048, 11264),
          "down": (5632, 2048)}


def _operands(rng, M, K, N):
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0, :3] = [4.0, -4.0, 2.0]          # a row whose max is a tie point
    qs = rng.integers(-127, 128, (K, N)).astype(np.int8)
    sc = rng.uniform(0.001, 0.02, N).astype(np.float32)
    return x, qs, sc


@pytest.mark.parametrize("M,want", [
    (2048, {"wqkv": (256, 1), "wo": (256, 1), "gateup": (256, 1),
            "down": (256, 1)}),
    (512, {"wqkv": (128, 3), "wo": (128, 2), "gateup": (256, 1),
           "down": (128, 2)}),
    (4, {"wqkv": (64, 8), "wo": (64, 8), "gateup": (64, 3), "down": (64, 8)}),
])
def test_w8a8_plan_at_the_served_shapes(M, want):
    got = {k: tq._w8a8_plan(M, N, K) for k, (K, N) in SERVED.items()}
    assert got == want


@pytest.mark.parametrize("M", [1, 9, 64, 65, 127, 500, 512, 1024, 2048, 8192])
@pytest.mark.parametrize("K,N", [(64, 4), (100, 100), (2048, 2560),
                                 (5632, 2048), (2048, 11264)])
def test_w8a8_plan_is_a_function_of_the_shape(M, K, N):
    """The rule reads the shape alone (no data, no state), keeps the split
    within 8 and the in-dim's steps, never splits where the tiles fill a
    wave, takes 256-row tiles only unsplit and above a wave, and sends
    what TMA cannot take (K not a multiple of 8, N of 16) to the 64-row
    mma.sync kernel."""
    tma = K % 8 == 0 and N % 16 == 0
    bm, S = tq._w8a8_plan(M, N, K, tma=tma)
    assert (bm, S) == tq._w8a8_plan(M, N, K, tma=tma)
    kp = -(-K // 16) * 16
    if M <= tq._W8_SMALL_ROWS or not tma:
        assert bm == 64 and 1 <= S <= min(8, -(-kp // 64))
        return
    assert bm in (128, 256) and 1 <= S <= min(8, -(-K // 128))
    tiles = -(-M // 128) * -(-N // 128)
    if tiles >= tq._SMS:
        assert S == 1
    else:
        assert bm == 128
    if bm == 256:
        assert S == 1


def test_w8a8_plan_without_tma_takes_the_small_kernel():
    for M in (65, 2048):
        bm, S = tq._w8a8_plan(M, 2560, 2048, tma=False)
        assert bm == 64 and 1 <= S <= 8


def test_w8a8_matmul_out_dtype_on_the_cpu():
    rng = np.random.default_rng(31)
    x, qs, sc = (torch.from_numpy(a) for a in _operands(rng, 70, 96, 40))
    f32 = tq.w8a8_matmul_plain(x, qs, sc)
    got = tq.w8a8_matmul(x, qs, sc, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.to(torch.bfloat16))
    out = torch.empty((70, 40), dtype=torch.bfloat16)
    assert tq.w8a8_matmul(x, qs, sc, out=out,
                          out_dtype=torch.bfloat16) is out
    assert torch.equal(out, f32.to(torch.bfloat16))
    assert torch.equal(tq.w8a8_matmul(x, qs, sc), f32)
    with pytest.raises(ValueError, match="out_dtype"):
        tq.w8a8_matmul(x, qs, sc, out_dtype=torch.float16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mm_keeps_the_dtype_of_x_on_a_w8a8_weight(dtype):
    rng = np.random.default_rng(32)
    x, qs, sc = _operands(rng, 6, 64, 48)
    xt = torch.from_numpy(x).to(dtype).reshape(2, 3, 64)
    w = tq.QTensor(torch.from_numpy(qs), torch.from_numpy(sc), None, 64, 64,
                   packed4=False, w8a8=True)
    out = tq.mm(xt, w)
    assert out.dtype == dtype and tuple(out.shape) == (2, 3, 48)
    want = tq.w8a8_matmul_plain(xt.reshape(6, 64), w.qs, w.scales).to(dtype)
    assert torch.equal(out.reshape(6, 48), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w8a8_quant_rows_plain(dtype):
    """The pass's CPU form: codes padded with zeros to a multiple of 16
    bytes, scales [M], both those of _quant_rows."""
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rng.standard_normal((5, 100)).astype(
        np.float32)).to(dtype)
    xq, xs = tq.w8a8_quant_rows(x)
    codes, scales = tq._quant_rows(x.float())
    assert xq.dtype == torch.int8 and tuple(xq.shape) == (5, 112)
    assert torch.equal(xq[:, :100], codes) and not xq[:, 100:].any()
    assert xs.shape == (5,) and torch.equal(xs, scales[:, 0])


@pytest.mark.parametrize("M", [65, 127, 500])
@pytest.mark.parametrize("xdt", ["f32", "bf16"])
def test_w8a8_matmul_plain_matches_jax_in_bf16(M, xdt):
    """At ragged row counts the plain version, rounded to bf16 (what mm
    and the kernels' bf16 output give), equals JAX
    `_w8a8_matmul(...).astype(bf16)`."""
    rng = np.random.default_rng(M + 7)
    x, qs, sc = _operands(rng, M, 320, 144)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[xdt]
    w = jq.QTensor(jnp.asarray(qs), jnp.asarray(sc), None, 320, 320,
                   packed4=False, w8a8=True)
    want = np.asarray(jq._w8a8_matmul(jnp.asarray(x, jdt), w).astype(
        jnp.bfloat16)).astype(np.float32)
    got = tq.w8a8_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(qs),
                         torch.from_numpy(sc), out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want)
