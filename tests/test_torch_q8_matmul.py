"""q8_matmul's host side (llama_box_tpu_torch/ops/qmatmul.py), on the CPU:
the output dtype of the wrapper, the in-dim split rule of
csrc/q_matmul.cu and the model's dispatch of a bf16 x. The kernel itself
is held against q8_matmul_plain on a card in test_torch_gpu.py; the plain
version against the JAX Pallas kernel in test_torch_q4_matmul.py."""

import numpy as np
import pytest
import torch

from llama_box_tpu_torch.ops import qmatmul as tq


def _q8(rng, K, N, group, mins):
    qs = torch.from_numpy(rng.integers(-32, 32, (K, N)).astype(np.int8))
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, (K // group, N)).astype(
        np.float32) / (18.5 * np.sqrt(K))).to(torch.bfloat16)
    mn = (sc.float() * 7.0).to(torch.bfloat16) if mins else None
    return qs, sc, mn


@pytest.mark.parametrize("M", [1, 4, 70])
@pytest.mark.parametrize("group,mins", [(16, False), (32, True)])
def test_q8_matmul_bf16_out_is_the_f32_result_rounded(M, group, mins):
    rng = np.random.default_rng(M + group)
    K, N = 256, 96
    qs, sc, mn = _q8(rng, K, N, group, mins)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    f32 = tq.q8_matmul(x, qs, sc, mn, group)
    b16 = tq.q8_matmul(x, qs, sc, mn, group, out_dtype=torch.bfloat16)
    assert f32.dtype == torch.float32 and b16.dtype == torch.bfloat16
    assert torch.equal(f32, tq.q8_matmul_plain(x, qs, sc, mn, group))
    assert torch.equal(b16, f32.to(torch.bfloat16))
    out = torch.empty(M, N, dtype=torch.bfloat16)
    assert tq.q8_matmul(x, qs, sc, mn, group, out=out,
                        out_dtype=torch.bfloat16) is out
    assert torch.equal(out, b16)
    with pytest.raises(ValueError, match="out_dtype"):
        tq.q8_matmul(x, qs, sc, mn, group, out_dtype=torch.float16)


@pytest.mark.parametrize("K,N,want", [(5632, 2048, 16),    # ffn_down
                                      (2048, 32000, 1),    # output
                                      (2048, 2560, 13),    # wqkv, int8 codes
                                      (128, 64, 2),        # in-dim bound
                                      (14336, 4096, 8)])   # Llama-3-8B down
def test_q8_splits_fill_one_wave_by_weight_shape(K, N, want):
    n_blocks = -(-N // 128)
    for M in (1, 4, 16, 64):
        s = tq._splits(M, N, K)
        assert s == want
        assert 1 <= s <= min(16, K // 64) and s * n_blocks <= 264 or s == 1
    assert tq._splits(65, N, K) == 1
    assert tq._splits(2048, N, K) == 1


def test_mm_keeps_the_dtype_of_x_on_the_cpu():
    """mm on a CPU x takes q_matmul_ref (the JAX package's CPU path) and
    returns x's dtype; only the card's path rounds inside q8_matmul."""
    rng = np.random.default_rng(3)
    qs, sc, mn = _q8(rng, 128, 32, 32, True)
    w = tq.QTensor(qs, sc, mn, 128, 32, False)
    x = torch.from_numpy(rng.standard_normal((2, 3, 128)).astype(np.float32))
    before = tq.q8_matmul.launches
    for dt in (torch.float32, torch.bfloat16):
        got = tq.mm(x.to(dt), w)
        assert got.dtype == dt and tuple(got.shape) == (2, 3, 32)
        want = tq.q_matmul_ref(x.to(dt).reshape(6, 128), w).reshape(2, 3, 32)
        assert torch.equal(got, want.to(dt))
    assert tq.q8_matmul.launches == before
