"""Port parity of the grouped residencies (llama_box_tpu_torch/ops/qmatmul.py:
pack_repacked's switches, q4_matmul_plain / q8_matmul_plain, q_matmul_ref,
mm) against the JAX package, on the CPU.

- pack_repacked: qs, scales and mins bit for bit equal to the JAX
  package's under each switch (none, LLAMA_BOX_TPU_PACKED4, _Q4_INT8,
  _Q4_F32SCALES) for Q4_K, Q4_0, Q6_K and Q8_0;
- the plain versions against JAX q_matmul_pallas(..., interpret=True) at
  the shapes of tests/test_qmatmul.py (in 512 and 2048, one and several
  tiles), both scale dtypes, B of 1, 4 and 8. Both compute the exact bf16
  products of the same bf16 weights and activations; the Pallas kernel
  sums them in f32, the plain version in float64 rounded once, so they
  differ by f32 summation noise: atol 1e-5 x max|out| (f32's 1.2e-7
  times about sqrt(in), with a margin; measured up to 9e-7 x max|out|);
- q_matmul_ref against JAX q_matmul_ref (f32 dequantization, f32 matmul
  in another order: the same 1e-5 x max|out|);
- the CPU wrappers are the plain versions and count no launch; mm sends a
  grouped weight with a CPU x to q_matmul_ref, as the JAX mm does off the
  TPU;
- q4_matmul's host side: its bf16 output is the f32 result rounded, mm
  keeps x's dtype, and its in-dim splits depend on the weight's shape
  alone (the kernel itself is held to q4_matmul_plain on a card in
  test_torch_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.ops import qmatmul as jq
from llama_box_tpu_torch.gguf.constants import GGMLType
from llama_box_tpu_torch.gguf.quants import quantize
from llama_box_tpu_torch.gguf.repack import repack
from llama_box_tpu_torch.ops import qmatmul as tq

SWITCHES = ("LLAMA_BOX_TPU_PACKED4", "LLAMA_BOX_TPU_Q4_INT8",
            "LLAMA_BOX_TPU_Q4_F32SCALES")
FORMATS = (GGMLType.Q4_K, GGMLType.Q4_0, GGMLType.Q6_K, GGMLType.Q8_0)
REL = 1e-5


def _rt(fmt, in_dim, out_dim, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(scale=0.1, size=(out_dim, in_dim)).astype(np.float32)
    raw = np.frombuffer(quantize(fmt, w), dtype=np.uint8)
    return repack(fmt, raw, in_dim * out_dim)


def _set_switch(monkeypatch, switch):
    for s in SWITCHES:
        monkeypatch.delenv(s, raising=False)
    if switch:
        monkeypatch.setenv(switch, "1")


def _bits(a):
    """numpy bit pattern of a torch tensor or a (JAX or numpy) array."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint8) if a.dtype == np.int8 else a.view(np.uint32)


def _jax_qtensor(t: tq.QTensor) -> jq.QTensor:
    """The port's QTensor as JAX arrays (bf16 through their bit pattern)."""
    def arr(x):
        if x is None:
            return None
        if x.dtype == torch.bfloat16:
            return jax.lax.bitcast_convert_type(jnp.asarray(_bits(x)),
                                                jnp.bfloat16)
        return jnp.asarray(x.numpy())
    return jq.QTensor(arr(t.qs), arr(t.scales), arr(t.mins), t.in_dim,
                      t.group, t.packed4, t.w8a8)


@pytest.mark.parametrize("switch", [None, *SWITCHES],
                         ids=lambda s: s[14:] if s else "none")
@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.name)
def test_pack_repacked_bitwise_equal(monkeypatch, fmt, switch):
    _set_switch(monkeypatch, switch)
    rt = _rt(fmt, 512, 128)
    got = tq.pack_repacked(rt, (512, 128))
    want = jq.pack_repacked(rt, (512, 128), device=False)
    assert (got.w8a8, got.packed4, got.group, got.in_dim) == (
        want.w8a8, want.packed4, want.group, want.in_dim)
    assert got.w8a8 == (switch is None)
    assert got.packed4 == (fmt in (GGMLType.Q4_K, GGMLType.Q4_0)
                           and switch in ("LLAMA_BOX_TPU_PACKED4",
                                          "LLAMA_BOX_TPU_Q4_F32SCALES"))
    np.testing.assert_array_equal(_bits(got.qs), _bits(want.qs))
    assert got.scales.dtype == (torch.bfloat16 if switch in (
        "LLAMA_BOX_TPU_PACKED4", "LLAMA_BOX_TPU_Q4_INT8") else torch.float32)
    np.testing.assert_array_equal(_bits(got.scales), _bits(want.scales))
    assert (got.mins is None) == (want.mins is None)
    if got.mins is not None:
        np.testing.assert_array_equal(_bits(got.mins), _bits(want.mins))


def test_pack_repacked_refuses_an_unpackable_width(monkeypatch):
    _set_switch(monkeypatch, "LLAMA_BOX_TPU_PACKED4")
    rt = _rt(GGMLType.Q4_0, 96, 64)        # in/2 = 48: not whole groups of 32
    with pytest.raises(ValueError, match="nibble"):
        tq.pack_repacked(rt, (96, 64))


CASES = [(fmt, 512, 256) for fmt in FORMATS] + [(GGMLType.Q4_K, 2048, 512),
                                                (GGMLType.Q6_K, 2048, 512)]


@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("switch", ["LLAMA_BOX_TPU_PACKED4",
                                    "LLAMA_BOX_TPU_Q4_F32SCALES",
                                    "LLAMA_BOX_TPU_Q4_INT8"],
                         ids=["bf16", "f32", "int8codes"])
@pytest.mark.parametrize("fmt,in_dim,out_dim", CASES,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_plain_matches_jax_pallas_interpret(monkeypatch, fmt, in_dim,
                                            out_dim, switch, B):
    _set_switch(monkeypatch, switch)
    w = tq.pack_repacked(_rt(fmt, in_dim, out_dim, seed=B), (in_dim, out_dim))
    x = np.random.default_rng(B + in_dim).standard_normal(
        (B, in_dim)).astype(np.float32)
    want = np.asarray(jq.q_matmul_pallas(jnp.asarray(x, jnp.bfloat16),
                                         _jax_qtensor(w), interpret=True))
    plain = tq.q4_matmul_plain if w.packed4 else tq.q8_matmul_plain
    got = plain(torch.from_numpy(x), w.qs, w.scales, w.mins, w.group)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, out_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=REL * np.abs(want).max())
    # the CPU wrapper is the plain version and launches nothing
    before = (tq.q4_matmul.launches, tq.q8_matmul.launches)
    np.testing.assert_array_equal(tq.q_matmul(torch.from_numpy(x), w).numpy(),
                                  got.numpy())
    assert (tq.q4_matmul.launches, tq.q8_matmul.launches) == before


@pytest.mark.parametrize("switch", ["LLAMA_BOX_TPU_PACKED4",
                                    "LLAMA_BOX_TPU_Q4_F32SCALES",
                                    "LLAMA_BOX_TPU_Q4_INT8"],
                         ids=["bf16", "f32", "int8codes"])
@pytest.mark.parametrize("fmt", FORMATS + (GGMLType.Q4_1, GGMLType.Q2_K),
                         ids=lambda f: f.name)
def test_q_matmul_ref_and_mm_match_jax(monkeypatch, fmt, switch):
    _set_switch(monkeypatch, switch)
    w = tq.pack_repacked(_rt(fmt, 512, 192, seed=3), (512, 192))
    x = np.random.default_rng(4).standard_normal((2, 3, 512)).astype(
        np.float32)
    jw = _jax_qtensor(w)
    want = np.asarray(jq.q_matmul_ref(jnp.asarray(x.reshape(6, 512)), jw))
    got = tq.q_matmul_ref(torch.from_numpy(x.reshape(6, 512)), w).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())
    # mm on a CPU x: q_matmul_ref, shaped and cast like x (JAX mm on CPU)
    want_mm = np.asarray(jq.mm(jnp.asarray(x), jw))
    got_mm = tq.mm(torch.from_numpy(x), w)
    assert got_mm.dtype == torch.float32 and tuple(got_mm.shape) == (2, 3, 192)
    np.testing.assert_allclose(got_mm.numpy(), want_mm, rtol=0,
                               atol=REL * np.abs(want_mm).max())


def test_plain_versions_round_weights_and_rows_to_bf16():
    """The plain versions are the TPU kernels' arithmetic: s*q - m in f32
    rounded to bf16, x rounded to bf16, exact products summed."""
    rng = np.random.default_rng(7)
    K, N, G = 128, 16, 32
    qs = torch.from_numpy(rng.integers(0, 256, (K // 2, N)).astype(
        np.uint8).view(np.int8))
    sc = torch.from_numpy(rng.uniform(0.001, 0.01, (K // G, N)).astype(
        np.float32))
    mn = torch.from_numpy(rng.uniform(-0.02, 0.02, (K // G, N)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((3, K)).astype(np.float32))
    b = qs.view(torch.uint8).long()
    q = torch.cat([b & 15, b >> 4]).double()
    s = sc.double().repeat_interleave(G, 0).float()
    m = mn.double().repeat_interleave(G, 0).float()
    w = ((q.float() * s) - m).to(torch.bfloat16).double()
    want = (x.to(torch.bfloat16).double() @ w).float()
    got = tq.q4_matmul_plain(x, qs, sc, mn, G)
    assert torch.equal(got, want)
    # the int8-code layout of the same codes gives the same result
    got8 = tq.q8_matmul_plain(x, q.to(torch.int8), sc, mn, G)
    assert torch.equal(got8, want)


def _q4(rng, K, N, group, mins):
    qs = torch.from_numpy(rng.integers(-128, 128, (K // 2, N)).astype(
        np.int8))
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, (K // group, N)).astype(
        np.float32) / (4.6 * np.sqrt(K))).to(torch.bfloat16)
    mn = (sc.float() * 7.5).to(torch.bfloat16) if mins else None
    return qs, sc, mn


@pytest.mark.parametrize("M", [1, 4, 70])
@pytest.mark.parametrize("mins", [True, False])
def test_q4_matmul_bf16_out_is_the_f32_result_rounded(M, mins):
    rng = np.random.default_rng(M + mins)
    K, N, G = 256, 96, 32
    qs, sc, mn = _q4(rng, K, N, G, mins)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    f32 = tq.q4_matmul(x, qs, sc, mn, G)
    b16 = tq.q4_matmul(x, qs, sc, mn, G, out_dtype=torch.bfloat16)
    assert f32.dtype == torch.float32 and b16.dtype == torch.bfloat16
    assert torch.equal(f32, tq.q4_matmul_plain(x, qs, sc, mn, G))
    assert torch.equal(b16, f32.to(torch.bfloat16))
    out = torch.empty(M, N, dtype=torch.bfloat16)
    assert tq.q4_matmul(x, qs, sc, mn, G, out=out,
                        out_dtype=torch.bfloat16) is out
    assert torch.equal(out, b16)
    with pytest.raises(ValueError, match="out_dtype"):
        tq.q4_matmul(x, qs, sc, mn, G, out_dtype=torch.float16)


def test_mm_on_a_packed_qtensor_keeps_the_dtype_of_x():
    """mm on a CPU x takes q_matmul_ref and returns x's dtype; on a card
    q_matmul hands x's dtype to the kernel for packed codes too, so the
    final cast is a no-op there (test_torch_gpu.py)."""
    rng = np.random.default_rng(5)
    qs, sc, mn = _q4(rng, 128, 32, 32, True)
    w = tq.QTensor(qs, sc, mn, 128, 32, True)
    x = torch.from_numpy(rng.standard_normal((2, 3, 128)).astype(np.float32))
    before = tq.q4_matmul.launches
    for dt in (torch.float32, torch.bfloat16):
        got = tq.mm(x.to(dt), w)
        assert got.dtype == dt and tuple(got.shape) == (2, 3, 32)
        want = tq.q_matmul_ref(x.to(dt).reshape(6, 128), w).reshape(2, 3, 32)
        assert torch.equal(got, want.to(dt))
        assert tq.q_matmul(x.to(dt).reshape(6, 128), w,
                           out_dtype=dt).dtype == dt
    assert tq.q4_matmul.launches == before


@pytest.mark.parametrize("K,N,want", [(2048, 2560, 13),      # wqkv
                                      (2048, 2048, 16),      # wo
                                      (2048, 11264, 3),      # gate|up
                                      (4096, 28672, 1),      # 8B gate|up
                                      (128, 64, 2)])         # in-dim bound
def test_q4_splits_depend_on_the_weight_shape_alone(K, N, want):
    """The packed layout takes the same rule as the int8 one: 128-column
    blocks within one wave at <= 64 rows, one split above, whatever the
    number of rows in the call."""
    for M in (1, 4, 16, 64):
        assert tq._splits(M, N, K) == want
    for M in (65, 200, 2048):
        assert tq._splits(M, N, K) == 1
