"""The hand-written CUDA kernels (llama_box_tpu_torch/csrc) against their
plain torch versions, on a CUDA card. Every test here is marked `gpu` and
skips where there is no card (the kernels have no CPU mode). This file
imports no JAX, so it runs on a machine with only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Cache positions the kernel must never read are filled with NaN (int8
caches: their scales), so a stray read shows as a non-finite output.
Tolerances: atol 1e-4 on f32 inputs (summation order); 2e-2 on bf16
inputs and int8 caches (p is rounded to bf16 at the kernel's running max,
the plain version's at the final max)."""

import numpy as np
import pytest
import torch

from llama_box_tpu_torch.ops import flash_decode as fd_mod
from llama_box_tpu_torch.ops import flash_prefill as fp_mod
from llama_box_tpu_torch.ops.flash_decode import flash_decode, flash_decode_plain
from llama_box_tpu_torch.ops.flash_prefill import (flash_prefill_batched,
                                                   flash_prefill_plain)
from .torch_cases import DECODE_CASES, PREFILL_CASES, as_t, decode_case, \
    prefill_case

BF16_ATOL = 2e-2
F32_ATOL = 1e-4
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _on(cuda, c, dtype):
    """q/rows in `dtype`; the cache in `dtype`, or int8 + bf16 scales."""
    quant = "ks" in c
    args = [as_t(c[k], dtype if k in ("q", "kr", "vr") or not quant
                 else None).to(cuda) for k in ("q", "kc", "vc", "kr", "vr")]
    sc = {} if not quant else dict(
        k_scale=as_t(c["ks"]).to(cuda, torch.bfloat16),
        v_scale=as_t(c["vs"]).to(cuda, torch.bfloat16))
    return args, sc


def _poison(c, first):
    """NaN at cache positions >= first[b] (per slot), in any layer."""
    for b, p0 in enumerate(first):
        if "ks" in c:
            c["ks"][..., b, p0:, :] = np.nan
            c["vs"][..., b, p0:, :] = np.nan
        else:
            c["kc"][..., b, p0:, :, :] = np.nan
            c["vc"][..., b, p0:, :, :] = np.nan


@pytest.mark.parametrize("name", ["causal", "window", "chunk", "softcap",
                                  "bidir", "sinks", "int8", "fresh_slot"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernel_matches_plain(cuda, name, dtype):
    kw = dict(PREFILL_CASES[name])
    win = torch.tensor(kw.pop("win", (0, 0)), dtype=torch.int32)
    softcap = kw.pop("softcap", 0.0)
    rng = np.random.default_rng(3)
    sinks = (torch.randn(4, 8) if kw.pop("sinks", False) else None)
    kw.setdefault("pos0", (200, 0))
    kw.setdefault("n_valid", (80, 33))
    c = prefill_case(rng, Hkv=4, G=8, D=64, C=256, T=80, **kw)
    _poison(c, c["meta"][:, 0])
    args, sc = _on(cuda, c, dtype)
    meta = as_t(c["meta"]).to(cuda)
    before = flash_prefill_batched.launches
    got = flash_prefill_batched(*args, meta, win, sinks=sinks,
                                softcap=softcap, **sc)
    want = flash_prefill_plain(*args, meta, win, sinks=sinks,
                               softcap=softcap, **sc)
    torch.cuda.synchronize()
    assert flash_prefill_batched.launches == before + 1
    for b, nv in enumerate(c["meta"][:, 1]):
        assert torch.isfinite(got[b, :, :, :nv]).all()
        atol = F32_ATOL if dtype == torch.float32 and "ks" not in c \
            else BF16_ATOL
        torch.testing.assert_close(got[b, :, :, :nv], want[b, :, :, :nv],
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["plain", "window", "chunk", "softcap",
                                  "sinks", "int8", "chain_rows",
                                  "layer_stacked", "fresh_slot"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(cuda, name, dtype):
    kw = dict(DECODE_CASES[name])
    win = torch.tensor(kw.pop("win", (0, 0)), dtype=torch.int32)
    softcap = kw.pop("softcap", 0.0)
    rng = np.random.default_rng(5)
    sinks = (torch.randn(4, 8) if kw.pop("sinks", False) else None)
    kw.setdefault("cpos", (200, 17))
    kw.setdefault("nv", (5, 1))
    kw.setdefault("R", 16)
    c = decode_case(rng, Hkv=4, G=8, D=64, C=256, **kw)
    _poison(c, c["meta"][:, 0] - c["meta"][:, 1] + 1)
    layer = 1 if kw.get("layers") else None
    args, sc = _on(cuda, c, dtype)
    meta = as_t(c["meta"]).to(cuda)
    before = flash_decode.launches
    got = flash_decode(*args, meta, win, layer=layer, sinks=sinks,
                       softcap=softcap, **sc)
    want = flash_decode_plain(*args, meta, win, layer=layer, sinks=sinks,
                              softcap=softcap, **sc)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    assert torch.isfinite(got).all()
    atol = F32_ATOL if dtype == torch.float32 and "ks" not in c \
        else BF16_ATOL
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


def test_head_dim_128(cuda):
    rng = np.random.default_rng(9)
    p = prefill_case(rng, Hkv=2, G=4, D=128, C=128, T=40, pos0=(64, 5),
                     n_valid=(40, 40))
    args, _ = _on(cuda, p, torch.bfloat16)
    meta = as_t(p["meta"]).to(cuda)
    win = torch.zeros(2, dtype=torch.int32)
    torch.testing.assert_close(
        flash_prefill_batched(*args, meta, win),
        flash_prefill_plain(*args, meta, win), rtol=0, atol=BF16_ATOL)
    d = decode_case(rng, Hkv=2, G=4, D=128, C=128, R=4, cpos=(90, 3),
                    nv=(4, 1))
    args, _ = _on(cuda, d, torch.bfloat16)
    meta = as_t(d["meta"]).to(cuda)
    torch.testing.assert_close(flash_decode(*args, meta, win),
                               flash_decode_plain(*args, meta, win),
                               rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("G", [8, 6])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernel_ragged_edges(cuda, dtype, quant, G):
    """T, n_valid and pos0 on no multiple of any tile (rows: 128 // G
    positions a block, keys: 64 a tile; the FMA kernel's 32), a tile
    straddling pos0; G = 6 leaves dead rows in every block."""
    rng = np.random.default_rng(31)
    c = prefill_case(rng, B=3, Hkv=4, G=G, D=64, C=256, T=77,
                     pos0=(131, 5, 0), n_valid=(77, 50, 13), quant=quant)
    _poison(c, c["meta"][:, 0])
    args, sc = _on(cuda, c, dtype)
    meta = as_t(c["meta"]).to(cuda)
    win = torch.zeros(2, dtype=torch.int32)
    got = flash_prefill_batched(*args, meta, win, **sc)
    want = flash_prefill_plain(*args, meta, win, **sc)
    torch.cuda.synchronize()
    atol = F32_ATOL if dtype == torch.float32 and not quant else BF16_ATOL
    for b, nv in enumerate(c["meta"][:, 1]):
        assert torch.isfinite(got[b, :, :, :nv]).all()
        torch.testing.assert_close(got[b, :, :, :nv], want[b, :, :, :nv],
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernel_reads_the_meta_slot(cuda, dtype, quant):
    """A fifth meta column names the cache row each batch row reads (the
    engine's one program for every slot): slots 2 and 0 of a 4-slot cache
    whose other slots are all NaN give the bits of a four-column meta on
    those slots' rows alone, and the plain version's numbers."""
    rng = np.random.default_rng(41)
    c = prefill_case(rng, B=4, Hkv=4, G=8, D=64, C=256, T=77,
                     pos0=(131, 0, 90, 5), n_valid=(77, 0, 50, 13),
                     spans=[(0, 0), (0, 0), (100, 140), (0, 0)],
                     quant=quant)
    _poison(c, c["meta"][:, 0])
    _poison(c, [256, 0, 256, 0])         # slots 1 and 3 are never read
    rows = [2, 0]
    args, sc = _on(cuda, c, dtype)
    q, kc, vc, kr, vr = args
    meta5 = np.concatenate(
        [c["meta"][rows], np.asarray(rows, np.int32)[:, None]], axis=1)
    meta5 = as_t(meta5).to(cuda)
    win = torch.zeros(2, dtype=torch.int32)
    sub = [q[rows].contiguous(), kr[rows].contiguous(),
           vr[rows].contiguous()]
    before = flash_prefill_batched.launches
    got = flash_prefill_batched(sub[0], kc, vc, sub[1], sub[2], meta5, win,
                                **sc)
    assert flash_prefill_batched.launches == before + 1
    meta4 = as_t(c["meta"][rows]).to(cuda)
    sc4 = {k: v[rows].contiguous() for k, v in sc.items()}
    alone = flash_prefill_batched(sub[0], kc[rows].contiguous(),
                                  vc[rows].contiguous(), sub[1], sub[2],
                                  meta4, win, **sc4)
    want = flash_prefill_plain(sub[0], kc, vc, sub[1], sub[2], meta5, win,
                               **sc)
    torch.cuda.synchronize()
    atol = F32_ATOL if dtype == torch.float32 and not quant else BF16_ATOL
    for i, b in enumerate(rows):
        nv = int(c["meta"][b, 1])
        assert torch.isfinite(got[i, :, :, :nv]).all()
        assert torch.equal(got[i, :, :, :nv], alone[i, :, :, :nv])
        torch.testing.assert_close(got[i, :, :, :nv], want[i, :, :, :nv],
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
def test_prefill_kernel_cold_equals_cached_prefix(cuda, quant):
    """A 300-token prompt prefilled cold gives the same output rows as the
    same prompt with its first 137 positions in the cache: bit for bit on a
    bf16 cache (tiles are aligned to absolute key positions). An int8 cache
    quantizes the prefix, so there the cached call is held to the plain
    version on the same int8 inputs, at the tolerance."""
    rng = np.random.default_rng(37)
    T, P, C = 300, 137, 512
    c = prefill_case(rng, B=2, Hkv=4, G=8, D=64, C=C, T=T, pos0=(0, 0),
                     n_valid=(T, T))
    bf = torch.bfloat16
    q, kr, vr = (as_t(c[k]).to(cuda, bf) for k in ("q", "kr", "vr"))
    kc = torch.full((2, C, 4, 64), float("nan"), device=cuda, dtype=bf)
    vc = kc.clone()
    win = torch.zeros(2, dtype=torch.int32)
    meta = torch.tensor([[0, T, 0, 0]] * 2, dtype=torch.int32, device=cuda)
    cold = flash_prefill_batched(q, kc, vc, kr, vr, meta, win)
    kc[:, :P], vc[:, :P] = kr[:, :P], vr[:, :P]
    sc = {}
    if quant:
        ks = kc.float().abs().amax(-1).clamp_min(1e-6) / 127
        vs = vc.float().abs().amax(-1).clamp_min(1e-6) / 127
        kc = (kc.float() / ks[..., None]).round().clamp(-127, 127).to(
            torch.int8)
        vc = (vc.float() / vs[..., None]).round().clamp(-127, 127).to(
            torch.int8)
        sc = dict(k_scale=ks.to(bf), v_scale=vs.to(bf))
    meta = torch.tensor([[P, T - P, 0, 0]] * 2, dtype=torch.int32,
                        device=cuda)
    warm = flash_prefill_batched(q[:, :, :, P:].contiguous(), kc, vc,
                                 kr[:, P:].contiguous(),
                                 vr[:, P:].contiguous(), meta, win, **sc)
    torch.cuda.synchronize()
    assert torch.isfinite(warm).all()
    if quant:   # the prefix went through int8: held to the plain version
        want = flash_prefill_plain(q[:, :, :, P:], kc, vc, kr[:, P:],
                                   vr[:, P:], meta, win, **sc)
        torch.testing.assert_close(warm, want, rtol=0, atol=BF16_ATOL)
    else:
        assert torch.equal(warm, cold[:, :, :, P:])


def test_cuda_tensors_never_take_the_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version reached on CUDA tensors")
    monkeypatch.setattr(fp_mod, "flash_prefill_plain", boom)
    monkeypatch.setattr(fd_mod, "flash_decode_plain", boom)
    rng = np.random.default_rng(1)
    win = torch.zeros(2, dtype=torch.int32)
    p = prefill_case(rng, Hkv=4, G=8, D=64)
    args, _ = _on(cuda, p, torch.bfloat16)
    fp_mod.flash_prefill_batched(*args, as_t(p["meta"]).to(cuda), win)
    d = decode_case(rng, Hkv=4, G=8, D=64)
    args, _ = _on(cuda, d, torch.bfloat16)
    fd_mod.flash_decode(*args, as_t(d["meta"]).to(cuda), win)
    torch.cuda.synchronize()


def test_unsupported_shapes_raise(cuda):
    """A head size no instantiation covers raises; it is not computed by
    the plain version instead."""
    rng = np.random.default_rng(2)
    win = torch.zeros(2, dtype=torch.int32)
    d = decode_case(rng, D=32)
    args, _ = _on(cuda, d, torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        flash_decode(*args, as_t(d["meta"]).to(cuda), win)


# -- the w8a8 kernels (csrc/w8a8_matmul.cu, fused_norm_qmm.cu,
# fused_layer_tail.cu) --------------------------------------------------------
#
# w8a8_matmul is held to bit equality: the codes use IEEE division and
# round-half-to-even like torch, and the s32 sums are exact in any order.
# The fused kernels sum the rms norm's squares in another order than torch,
# so one bf16 rounding and then one int8 code can move: rtol = atol = 1e-2
# (fused_norm_qmm) and 2e-2 (fused_layer_tail), the JAX tests' tolerances.

from llama_box_tpu_torch.ops import fused_decode as fdec_mod  # noqa: E402
from llama_box_tpu_torch.ops import qmatmul as qmm_mod  # noqa: E402


def _w8(rng, k, n, cuda):
    qs = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    sc = torch.from_numpy(rng.uniform(0.005, 0.02, n).astype(np.float32))
    return qs.to(cuda), sc.to(cuda)


def _x(rng, r, k, cuda, dtype=torch.bfloat16):
    return torch.from_numpy(rng.standard_normal((r, k)).astype(
        np.float32)).to(cuda, dtype)


def _guarded(shape, dtype, cuda, pad=64):
    """A NaN-filled flat buffer; returns (buffer, contiguous view of
    `shape` inside it with `pad` NaN elements on each side)."""
    n = int(np.prod(shape))
    buf = torch.full((n + 2 * pad,), float("nan"), dtype=dtype, device=cuda)
    return buf, buf[pad:pad + n].view(shape)


def _guards_intact(buf, pad=64):
    return bool(torch.isnan(buf[:pad].float()).all()
                and torch.isnan(buf[-pad:].float()).all())


@pytest.mark.parametrize("M,K,N", [(1, 64, 48), (4, 2048, 2560),
                                   (64, 100, 100), (200, 320, 144)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w8a8_matmul_matches_plain_exactly(cuda, M, K, N, dtype):
    rng = np.random.default_rng(M + K)
    x = _x(rng, M, K, cuda, dtype)
    qs, sc = _w8(rng, K, N, cuda)
    buf, out = _guarded((M, N), torch.float32, cuda)
    before = qmm_mod.w8a8_matmul.launches
    got = qmm_mod.w8a8_matmul(x, qs, sc, out=out)
    want = qmm_mod.w8a8_matmul_plain(x, qs, sc)
    torch.cuda.synchronize()
    assert qmm_mod.w8a8_matmul.launches == before + 1
    assert torch.isfinite(got).all() and _guards_intact(buf)
    assert torch.equal(got, want)


@pytest.mark.parametrize("M", [1, 4, 64, 65, 127, 500, 512, 2048])
@pytest.mark.parametrize("K", [64, 100, 2048, 5632])
@pytest.mark.parametrize("N", [4, 100, 2560, 11264])
def test_w8a8_matmul_bits_over_the_shape_grid(cuda, M, K, N):
    """Both GEMM kernels (mma.sync, and TMA with wgmma above 64 rows where
    K is a multiple of 8 and N of 16; splits and tile rows by shape) equal
    the plain version bit for bit, for bf16 and f32 rows and f32 and bf16
    outputs, with NaN guards around the output intact."""
    rng = np.random.default_rng(M * 7 + K + N)
    qs, sc = _w8(rng, K, N, cuda)
    for xdt in (torch.bfloat16, torch.float32):
        x = _x(rng, M, K, cuda, xdt)
        want = qmm_mod.w8a8_matmul_plain(x, qs, sc)
        for odt in (torch.float32, torch.bfloat16):
            buf, out = _guarded((M, N), odt, cuda)
            got = qmm_mod.w8a8_matmul(x, qs, sc, out=out, out_dtype=odt)
            torch.cuda.synchronize()
            assert _guards_intact(buf) and torch.isfinite(got.float()).all()
            assert torch.equal(got, want.to(odt)), (xdt, odt)


def test_w8a8_matmul_is_two_kernels_and_rows_do_not_depend_on_m(cuda,
                                                                tmp_path):
    """A call is the quant pass and one GEMM kernel at every width, and rows
    7..9 have the same bits in a 9-row call (mma.sync) and a 2048-row one
    (wgmma)."""
    rng = np.random.default_rng(14)
    x = _x(rng, 2048, 2048, cuda)
    qs, sc = _w8(rng, 2048, 2560, cuda)
    for M in (4, 9, 512, 2048):       # the split tickets allocated first
        qmm_mod.w8a8_matmul(x[:M], qs, sc, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    for M in (4, 9, 512, 2048):
        names, _ = _graph_kernels(lambda m=M: qmm_mod.w8a8_matmul(
            x[:m], qs, sc, out_dtype=torch.bfloat16), tmp_path)
        assert len(names) == 2 and "quant_rows" in names[0] \
            and "w8a8_gemm" in names[1], names
    full = qmm_mod.w8a8_matmul(x, qs, sc, out_dtype=torch.bfloat16)
    nine = qmm_mod.w8a8_matmul(x[:9], qs, sc, out_dtype=torch.bfloat16)
    assert torch.equal(full[7:9], nine[7:9])


@pytest.mark.parametrize("M", [4, 512, 2048])
def test_w8a8_matmul_in_a_cuda_graph(cuda, M):
    """A call captured in a CUDA graph (the programmatic launch and the
    split tickets included) and replayed twice gives the eager bits."""
    rng = np.random.default_rng(15)
    x = _x(rng, M, 2048, cuda)
    qs, sc = _w8(rng, 2048, 2560, cuda)
    eager = qmm_mod.w8a8_matmul(x, qs, sc, out_dtype=torch.bfloat16)
    out = torch.empty_like(eager)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qmm_mod.w8a8_matmul(x, qs, sc, out=out, out_dtype=torch.bfloat16)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        qmm_mod.w8a8_matmul(x, qs, sc, out=out, out_dtype=torch.bfloat16)
    for _ in range(2):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w8a8_quant_rows_matches_plain(cuda, dtype):
    """The row-quantize pass alone: codes (zero-padded) and scales equal
    the plain version's, rows kept in registers, re-read and scalar."""
    rng = np.random.default_rng(16)
    for M, K in ((9, 100), (2048, 2048), (64, 5632), (3, 8192)):
        x = _x(rng, M, K, cuda, dtype)
        xq, xs = qmm_mod.w8a8_quant_rows(x)
        pq, ps = qmm_mod.w8a8_quant_rows(x.cpu())
        assert torch.equal(xq.cpu(), pq) and torch.equal(xs.cpu(), ps), (M, K)


@pytest.mark.parametrize("R", [1, 4, 64])
@pytest.mark.parametrize("O", [96, 512])
@pytest.mark.parametrize("nw_dtype", [torch.bfloat16, torch.float32])
def test_fused_norm_qmm_matches_plain(cuda, R, O, nw_dtype):
    rng = np.random.default_rng(R * O)
    E = 256
    x = _x(rng, R, E, cuda)
    nw = torch.from_numpy(rng.uniform(0.5, 1.5, E).astype(
        np.float32)).to(cuda, nw_dtype)
    qs, sc = _w8(rng, E, O, cuda)
    buf, out = _guarded((R, O), torch.bfloat16, cuda)
    before = fdec_mod.fused_norm_qmm.launches
    got = fdec_mod.fused_norm_qmm(x, nw, qs, sc, eps=1e-5, out=out)
    want = fdec_mod.fused_norm_qmm_plain(x, nw, qs, sc, eps=1e-5)
    torch.cuda.synchronize()
    assert fdec_mod.fused_norm_qmm.launches == before + 1
    assert torch.isfinite(got.float()).all() and _guards_intact(buf)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)
    assert torch.equal(got.float().argmax(-1), want.float().argmax(-1))


@pytest.mark.parametrize("R", [1, 4, 64])
@pytest.mark.parametrize("act_fn,rs,FF", [("silu", 1.0, 384),
                                          ("gelu", 0.5, 384),
                                          ("relu2", 1.0, 200)])
def test_fused_layer_tail_matches_plain(cuda, R, act_fn, rs, FF):
    rng = np.random.default_rng(R + FF)
    HD, E = 256, 256
    ao, x = _x(rng, R, HD, cuda), _x(rng, R, E, cuda)
    nw = torch.from_numpy(rng.uniform(0.5, 1.5, E).astype(
        np.float32)).to(cuda, torch.float32 if R == 1 else torch.bfloat16)
    wo, gu, dn = _w8(rng, HD, E, cuda), _w8(rng, E, 2 * FF, cuda), \
        _w8(rng, FF, E, cuda)
    obuf, out = _guarded((R, E), torch.bfloat16, cuda)
    xbuf, xnew = _guarded((R, E), torch.bfloat16, cuda)
    abuf, act = _guarded((R, FF), torch.bfloat16, cuda)
    kw = dict(eps=1e-5, rs=rs, act_fn=act_fn)
    before = fdec_mod.fused_layer_tail.launches
    got = fdec_mod.fused_layer_tail(ao, x, *wo, nw, *gu, *dn, out=out,
                                    scratch=(xnew, act), **kw)
    want = fdec_mod.fused_layer_tail_plain(ao, x, *wo, nw, *gu, *dn, **kw)
    torch.cuda.synchronize()
    assert fdec_mod.fused_layer_tail.launches == before + 1
    for b in (obuf, xbuf, abuf):
        assert _guards_intact(b)
    assert torch.isfinite(xnew.float()).all()
    assert torch.isfinite(act.float()).all()
    assert torch.isfinite(got.float()).all()
    # phase A has no norm: its rows are the plain version's, bit for bit
    assert torch.equal(xnew, fdec_mod.tail_xnew_plain(ao, x, *wo, rs=rs))
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# The served widths: TinyLlama-1.1B's E 2048 (wqkv 2560, output 32000 wide)
# and its layer tail (HD = E = 2048, FF = 5632), R 1 to 64 rows; 9 rows take
# two row groups.

def _norm_qmm_case(rng, R, E, O, cuda):
    x = _x(rng, R, E, cuda)
    nw = torch.from_numpy(rng.uniform(0.5, 1.5, E).astype(
        np.float32)).to(cuda, torch.bfloat16)
    return (x, nw, *_w8(rng, E, O, cuda))


def _tail_case(rng, R, HD, E, FF, cuda):
    ao, x = _x(rng, R, HD, cuda), _x(rng, R, E, cuda)
    nw = torch.from_numpy(rng.uniform(0.5, 1.5, E).astype(
        np.float32)).to(cuda, torch.bfloat16)
    # scales that keep the residual stream near unit size
    wo, gu, dn = _w8(rng, HD, E, cuda), _w8(rng, E, 2 * FF, cuda), \
        _w8(rng, FF, E, cuda)
    return (ao, x, wo[0], wo[1] * 0.1, nw, gu[0], gu[1] * 0.1, dn[0],
            dn[1] * 0.1)


@pytest.mark.parametrize("R", [1, 4, 9, 64])
@pytest.mark.parametrize("O", [2560, 32000])
def test_fused_norm_qmm_served_widths(cuda, R, O):
    rng = np.random.default_rng(R + O)
    args = _norm_qmm_case(rng, R, 2048, O, cuda)
    buf, out = _guarded((R, O), torch.bfloat16, cuda)
    got = fdec_mod.fused_norm_qmm(*args, eps=1e-5, out=out)
    want = fdec_mod.fused_norm_qmm_plain(*args, eps=1e-5)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all() and _guards_intact(buf)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)
    assert torch.equal(got.float().argmax(-1), want.float().argmax(-1))


@pytest.mark.parametrize("R", [1, 4, 9, 64])
def test_fused_layer_tail_served_widths(cuda, R):
    rng = np.random.default_rng(100 + R)
    args = _tail_case(rng, R, 2048, 2048, 5632, cuda)
    obuf, out = _guarded((R, 2048), torch.bfloat16, cuda)
    xbuf, xnew = _guarded((R, 2048), torch.bfloat16, cuda)
    abuf, act = _guarded((R, 5632), torch.bfloat16, cuda)
    got = fdec_mod.fused_layer_tail(*args, eps=1e-5, out=out,
                                    scratch=(xnew, act))
    want = fdec_mod.fused_layer_tail_plain(*args, eps=1e-5)
    torch.cuda.synchronize()
    for b in (obuf, xbuf, abuf):
        assert _guards_intact(b)
    assert torch.isfinite(act.float()).all()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(xnew, fdec_mod.tail_xnew_plain(*args[:4]))
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_fused_rows_bits_do_not_depend_on_the_row_count(cuda):
    """Rows of a 16-row call (two row groups of 8) equal the same rows
    called alone (one row a block), bit for bit, in both kernels."""
    rng = np.random.default_rng(21)
    x, nw, qs, sc = _norm_qmm_case(rng, 16, 2048, 2560, cuda)
    full = fdec_mod.fused_norm_qmm(x, nw, qs, sc, eps=1e-5)
    t = _tail_case(rng, 16, 2048, 2048, 5632, cuda)
    tfull = fdec_mod.fused_layer_tail(*t, eps=1e-5)
    for r in (0, 7, 8, 15):
        one = fdec_mod.fused_norm_qmm(x[r:r + 1], nw, qs, sc, eps=1e-5)
        assert torch.equal(full[r:r + 1], one), r
        tone = fdec_mod.fused_layer_tail(t[0][r:r + 1], t[1][r:r + 1],
                                         *t[2:], eps=1e-5)
        assert torch.equal(tfull[r:r + 1], tone), r


def _graph_kernels(fn, tmp_path):
    """Names of the kernels one call of fn() runs, read without
    torch.profiler (which in a long process sometimes reports no device
    activity): the kernel nodes of a CUDA graph capturing the call, from
    its debug dump. Returns (names, graph); replaying the graph runs the
    call."""
    import re
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    path = tmp_path / "graph.dot"
    graph.debug_dump(str(path))
    nodes = re.findall(r'label="\{(\w+)\s*\n\| \{ID \| [^|]*\| ([^\\|]+)',
                       path.read_text())
    return [name for kind, name in nodes if kind == "KERNEL"], graph


def test_fused_calls_are_their_launches_and_reset_their_sums(cuda, tmp_path):
    """fused_norm_qmm is one kernel, the tail three; the split sums and
    tickets are 0 again after each call, so a second call gives the same
    bits."""
    rng = np.random.default_rng(22)
    a = _norm_qmm_case(rng, 4, 2048, 2560, cuda)
    t = _tail_case(rng, 4, 2048, 2048, 5632, cuda)
    assert fdec_mod._splits(2048, 2560) > 1
    first = fdec_mod.fused_norm_qmm(*a, eps=1e-5)
    tfirst = fdec_mod.fused_layer_tail(*t, eps=1e-5)
    torch.cuda.synchronize()
    out = {}
    names, graph = _graph_kernels(lambda: out.update(
        q=fdec_mod.fused_norm_qmm(*a, eps=1e-5)), tmp_path)
    graph.replay()
    assert len(names) == 1 and "norm_qmm_kernel" in names[0], names
    names, graph = _graph_kernels(lambda: out.update(
        t=fdec_mod.fused_layer_tail(*t, eps=1e-5)), tmp_path)
    graph.replay()
    torch.cuda.synchronize()
    assert len(names) == 3 and all("tail_phase_kernel" in n
                                   for n in names), names
    assert torch.equal(first, out["q"]) and torch.equal(tfirst, out["t"])
    assert int(fdec_mod._scratch[t[0].device].abs().sum()) == 0


def test_fused_layer_tail_in_a_cuda_graph(cuda):
    """One tail call captured in a CUDA graph (programmatic launches and
    tickets included) and replayed twice gives the eager call's bits."""
    rng = np.random.default_rng(23)
    t = _tail_case(rng, 4, 2048, 2048, 5632, cuda)
    eager = fdec_mod.fused_layer_tail(*t, eps=1e-5)
    out = torch.empty_like(eager)
    scratch = (torch.empty_like(eager),
               torch.empty((4, 5632), dtype=torch.bfloat16, device=cuda))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fdec_mod.fused_layer_tail(*t, eps=1e-5, out=out, scratch=scratch)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fdec_mod.fused_layer_tail(*t, eps=1e-5, out=out, scratch=scratch)
    for _ in range(2):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert int(fdec_mod._scratch[t[0].device].abs().sum()) == 0


def test_w8a8_rows_are_independent(cuda):
    """A row's bits do not depend on the other rows of the call."""
    rng = np.random.default_rng(11)
    x = _x(rng, 64, 256, cuda)
    nw = torch.ones(256, dtype=torch.bfloat16, device=cuda)
    qs, sc = _w8(rng, 256, 512, cuda)
    full = fdec_mod.fused_norm_qmm(x, nw, qs, sc, eps=1e-5)
    one = fdec_mod.fused_norm_qmm(x[5:6], nw, qs, sc, eps=1e-5)
    assert torch.equal(full[5:6], one)
    mm_full = qmm_mod.w8a8_matmul(x, qs, sc)
    assert torch.equal(mm_full[7:9], qmm_mod.w8a8_matmul(x[7:9], qs, sc))


def test_w8a8_cuda_tensors_never_take_the_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version reached on CUDA tensors")
    monkeypatch.setattr(qmm_mod, "w8a8_matmul_plain", boom)
    monkeypatch.setattr(fdec_mod, "fused_norm_qmm_plain", boom)
    monkeypatch.setattr(fdec_mod, "fused_layer_tail_plain", boom)
    rng = np.random.default_rng(12)
    x = _x(rng, 4, 128, cuda)
    nw = torch.ones(128, dtype=torch.bfloat16, device=cuda)
    qs, sc = _w8(rng, 128, 128, cuda)
    gu = _w8(rng, 128, 256, cuda)
    qmm_mod.w8a8_matmul(x, qs, sc)
    fdec_mod.fused_norm_qmm(x, nw, qs, sc, eps=1e-5)
    fdec_mod.fused_layer_tail(x, x, qs, sc, nw, *gu, qs, sc, eps=1e-5)
    torch.cuda.synchronize()


def test_w8a8_unsupported_shapes_raise(cuda):
    rng = np.random.default_rng(13)
    x = _x(rng, 4, 64, cuda)
    qs, sc = _w8(rng, 64, 30, cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        qmm_mod.w8a8_matmul(x, qs, sc)
    x65 = _x(rng, 65, 64, cuda)
    qs, sc = _w8(rng, 64, 32, cuda)
    with pytest.raises(ValueError, match="rows"):
        fdec_mod.fused_norm_qmm(x65, torch.ones(64, device=cuda), qs, sc,
                                eps=1e-5)


# -- the grouped kernels (csrc/q_matmul.cu: q4_matmul, q8_matmul) ---------------
#
# q4_matmul / q8_matmul against their plain versions: the same bf16 weights
# (s*q - m rounded once) and bf16 rows, the products summed in f32 by the
# tensor cores and in float64 by the plain version. Tolerance 1e-4 x
# max|out|: above f32 summation noise (about sqrt(in) x 2**-23, 1e-5 at
# in = 5632), below the 1.4e-3 that moving the weights by one bf16
# rounding (a contracted s*q - m) gives.

Q_REL = 1e-4


def _grouped(rng, K, N, group, packed, sdt, mins, cuda, codes=(-32, 32)):
    """Codes (random packed bytes, or integers in `codes`), scales and
    optional mins [K/group, N] in `sdt`, sized for outputs near 1."""
    if packed:
        qs = rng.integers(-128, 128, (K // 2, N))
        spread = 4.6
    else:
        qs = rng.integers(*codes, (K, N))
        spread = (codes[1] - codes[0]) / 3.5
    sc = rng.uniform(0.5, 1.5, (K // group, N)) / (spread * np.sqrt(K))
    mn = sc * rng.uniform(6.0, 9.0, sc.shape) if mins else None

    def t(a, dt):
        return torch.from_numpy(np.asarray(a)).to(cuda, dt)
    return (t(qs.astype(np.int8), torch.int8), t(sc.astype(np.float32), sdt),
            None if mn is None else t(mn.astype(np.float32), sdt))


def _q_fn(packed):
    return ((qmm_mod.q4_matmul, qmm_mod.q4_matmul_plain) if packed
            else (qmm_mod.q8_matmul, qmm_mod.q8_matmul_plain))


@pytest.mark.parametrize("M", [1, 4, 64, 200])
@pytest.mark.parametrize("packed,group,mins", [(True, 32, True),
                                               (True, 32, False),
                                               (False, 16, False),
                                               (False, 32, True)],
                         ids=["q4k", "q4nomin", "q6k", "q4int8"])
@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float32],
                         ids=["bf16s", "f32s"])
def test_q_matmul_matches_plain(cuda, M, packed, group, mins, sdt):
    rng = np.random.default_rng(M + group)
    K, N = 512, 320                      # 5 column tiles of 64
    x = _x(rng, M, K, cuda)
    qs, sc, mn = _grouped(rng, K, N, group, packed, sdt, mins, cuda)
    kern, plain = _q_fn(packed)
    buf, out = _guarded((M, N), torch.float32, cuda)
    before = kern.launches
    got = kern(x, qs, sc, mn, group, out=out)
    want = plain(x, qs, sc, mn, group)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert torch.isfinite(got).all() and _guards_intact(buf)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=Q_REL * float(want.abs().max()))
    b16 = kern(x, qs, sc, mn, group, out_dtype=torch.bfloat16)
    assert torch.equal(b16, got.to(torch.bfloat16))


@pytest.mark.parametrize("packed", [True, False])
def test_q_matmul_f32_rows_and_wide_in(cuda, packed):
    rng = np.random.default_rng(21)
    K, N = 5632, 4160                    # 65 column tiles, split in-dim
    x = _x(rng, 4, K, cuda, torch.float32)
    qs, sc, mn = _grouped(rng, K, N, 32, packed, torch.bfloat16, packed, cuda,
                          codes=(-127, 128))
    kern, plain = _q_fn(packed)
    got = kern(x, qs, sc, mn, 32)
    want = plain(x, qs, sc, mn, 32)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=Q_REL * float(want.abs().max()))


def test_q_matmul_rows_are_independent(cuda):
    """A row's bits depend on its own inputs only (no atomics; the in-dim
    splits depend on the weight's shape), within each regime of rows."""
    rng = np.random.default_rng(22)
    K, N = 2048, 2560
    qs, sc, mn = _grouped(rng, K, N, 32, True, torch.bfloat16, True, cuda)
    x = _x(rng, 300, K, cuda)
    full = qmm_mod.q4_matmul(x[:64], qs, sc, mn, 32)
    assert torch.equal(full[5:6], qmm_mod.q4_matmul(x[5:6], qs, sc, mn, 32))
    assert torch.equal(full[:4], qmm_mod.q4_matmul(x[:4], qs, sc, mn, 32))
    big = qmm_mod.q4_matmul(x, qs, sc, mn, 32)
    assert torch.equal(big[100:180], qmm_mod.q4_matmul(x[100:180], qs, sc,
                                                       mn, 32))
    again = qmm_mod.q4_matmul(x[:64], qs, sc, mn, 32)
    assert torch.equal(full, again)


def test_q_matmul_cuda_tensors_never_take_the_plain_version(cuda,
                                                            monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version reached on CUDA tensors")
    monkeypatch.setattr(qmm_mod, "q4_matmul_plain", boom)
    monkeypatch.setattr(qmm_mod, "q8_matmul_plain", boom)
    monkeypatch.setattr(qmm_mod, "q_matmul_ref", boom)
    rng = np.random.default_rng(23)
    x = _x(rng, 2, 3 * 128, cuda).reshape(2, 1, 384)
    for packed in (True, False):
        qs, sc, mn = _grouped(rng, 384, 64, 32, packed, torch.bfloat16,
                              packed, cuda)
        w = qmm_mod.QTensor(qs, sc, mn, 384, 32, packed)
        assert qmm_mod.mm(x, w).shape == (2, 1, 64)
    torch.cuda.synchronize()


def test_q_matmul_unsupported_shapes_raise(cuda):
    rng = np.random.default_rng(24)
    x = _x(rng, 4, 128, cuda)
    qs, sc, mn = _grouped(rng, 128, 68, 32, True, torch.bfloat16, True, cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        qmm_mod.q4_matmul(x, qs, sc, mn, 32)
    qs, sc, mn = _grouped(rng, 128, 64, 32, True, torch.bfloat16, True, cuda)
    with pytest.raises(ValueError, match="qs"):
        qmm_mod.q4_matmul(x, qs[:, :56], sc[:, :56], mn[:, :56], 32)
    with pytest.raises(ValueError, match="in=96"):
        qmm_mod.q8_matmul(_x(rng, 4, 96, cuda), *_grouped(
            rng, 96, 64, 32, False, torch.bfloat16, False, cuda), 32)


# -- q8_matmul and q4_matmul at every width -------------------------------------
#
# The pipelined kernel of both code layouts: decode widths (<= 64 rows,
# 16-row blocks, in-dim split with the sum folded into the launch) and
# prefill widths (256-row blocks, wgmma), a ragged 4160 = 32 x 128 + 64
# columns, every scale, min and x variant, f32 and bf16 outputs.


@pytest.mark.parametrize("M", [1, 4, 64, 65, 200, 2048])
@pytest.mark.parametrize("group,mins", [(16, False), (32, True)],
                         ids=["q6k", "q4int8"])
@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float32],
                         ids=["bf16s", "f32s"])
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32],
                         ids=["bf16x", "f32x"])
def test_q8_matmul_matches_plain(cuda, M, group, mins, sdt, xdt):
    rng = np.random.default_rng(M * group)
    K, N = 1024, 4160
    x = _x(rng, M, K, cuda, xdt)
    qs, sc, mn = _grouped(rng, K, N, group, False, sdt, mins, cuda,
                          codes=(-127, 128) if mins else (-32, 32))
    buf, out = _guarded((M, N), torch.float32, cuda)
    before = qmm_mod.q8_matmul.launches
    got = qmm_mod.q8_matmul(x, qs, sc, mn, group, out=out)
    want = qmm_mod.q8_matmul_plain(x, qs, sc, mn, group)
    torch.cuda.synchronize()
    assert qmm_mod.q8_matmul.launches == before + 1
    assert torch.isfinite(got).all() and _guards_intact(buf)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=Q_REL * float(want.abs().max()))
    b16 = qmm_mod.q8_matmul(x, qs, sc, mn, group, out_dtype=torch.bfloat16)
    assert torch.equal(b16, got.to(torch.bfloat16))


@pytest.mark.parametrize("N", [2048, 72])          # 8-byte code copies at 72
def test_q8_matmul_split_sum_is_one_launch(cuda, N, tmp_path):
    """At decode widths a call is one kernel (counted as the kernel nodes
    of a graph capturing it): the in-dim splits are summed by the last
    block of each tile, whose counter is 0 again afterwards."""
    rng = np.random.default_rng(41)
    K = 5632
    x = _x(rng, 4, K, cuda)
    qs, sc, mn = _grouped(rng, K, N, 16, False, torch.bfloat16, False, cuda)
    assert qmm_mod._splits(4, N, K) > 1
    first = qmm_mod.q8_matmul(x, qs, sc, mn, 16)       # counters allocated
    again = torch.empty_like(first)
    kernels, graph = _graph_kernels(
        lambda: qmm_mod.q8_matmul(x, qs, sc, mn, 16, out=again), tmp_path)
    graph.replay()
    torch.cuda.synchronize()
    assert len(kernels) == 1 and "grouped_gemm_kernel" in kernels[0], kernels
    assert torch.equal(first, again)
    cnt = qmm_mod._counters[x.device]
    assert int(cnt.abs().sum()) == 0


def test_q8_matmul_rows_are_independent(cuda):
    """A row's bits depend on its own inputs only, within each regime of
    rows (no atomics on values; the splits depend on the weight's shape)."""
    rng = np.random.default_rng(43)
    K, N = 2048, 2560
    qs, sc, mn = _grouped(rng, K, N, 32, False, torch.bfloat16, True, cuda,
                          codes=(0, 16))
    x = _x(rng, 300, K, cuda)
    f = qmm_mod.q8_matmul
    full = f(x[:64], qs, sc, mn, 32)
    assert torch.equal(full[5:6], f(x[5:6], qs, sc, mn, 32))
    assert torch.equal(full[:4], f(x[:4], qs, sc, mn, 32))
    big = f(x, qs, sc, mn, 32)
    assert torch.equal(big[100:180], f(x[100:180], qs, sc, mn, 32))
    assert torch.equal(full, f(x[:64], qs, sc, mn, 32))


def test_q8_mm_writes_the_dtype_of_x(cuda):
    """mm on a bf16 x: q8_matmul rounds to bf16 in the kernel, the same
    bits as rounding its f32 result."""
    rng = np.random.default_rng(47)
    qs, sc, mn = _grouped(rng, 512, 192, 16, False, torch.bfloat16, False,
                          cuda)
    w = qmm_mod.QTensor(qs, sc, mn, 512, 16, False)
    x = _x(rng, 6, 512, cuda).reshape(2, 3, 512)
    got = qmm_mod.mm(x, w)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 3, 192)
    want = qmm_mod.q8_matmul(x.reshape(6, 512), qs, sc, mn, 16)
    assert torch.equal(got.reshape(6, 192), want.to(torch.bfloat16))


@pytest.mark.parametrize("M", [1, 4, 64, 65, 200, 2048])
@pytest.mark.parametrize("group,mins", [(32, True), (32, False), (16, True)],
                         ids=["q4k", "q4_0", "q2k"])
@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float32],
                         ids=["bf16s", "f32s"])
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32],
                         ids=["bf16x", "f32x"])
def test_q4_matmul_matches_plain(cuda, M, group, mins, sdt, xdt):
    """Nibble-packed codes through the same kernel: the stage takes x
    columns t*32 .. and K/2 + t*32 .. and both halves' scale rows."""
    rng = np.random.default_rng(M * group + mins)
    K, N = 1024, 4160
    x = _x(rng, M, K, cuda, xdt)
    qs, sc, mn = _grouped(rng, K, N, group, True, sdt, mins, cuda)
    buf, out = _guarded((M, N), torch.float32, cuda)
    before = qmm_mod.q4_matmul.launches
    got = qmm_mod.q4_matmul(x, qs, sc, mn, group, out=out)
    want = qmm_mod.q4_matmul_plain(x, qs, sc, mn, group)
    torch.cuda.synchronize()
    assert qmm_mod.q4_matmul.launches == before + 1
    assert torch.isfinite(got).all() and _guards_intact(buf)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=Q_REL * float(want.abs().max()))
    b16 = qmm_mod.q4_matmul(x, qs, sc, mn, group, out_dtype=torch.bfloat16)
    assert torch.equal(b16, got.to(torch.bfloat16))


@pytest.mark.parametrize("N", [2048, 72])          # 8-byte code copies at 72
def test_q4_matmul_split_sum_is_one_launch(cuda, N, tmp_path):
    """At decode widths a packed call is one kernel too (the kernel nodes
    of a graph capturing it): no split-sum kernel, the counters 0 again
    afterwards, bf16 output the f32 one rounded."""
    rng = np.random.default_rng(53)
    K = 5632
    x = _x(rng, 4, K, cuda)
    qs, sc, mn = _grouped(rng, K, N, 32, True, torch.bfloat16, True, cuda)
    assert qmm_mod._splits(4, N, K) > 1
    first = qmm_mod.q4_matmul(x, qs, sc, mn, 32)
    again = torch.empty_like(first)
    kernels, graph = _graph_kernels(
        lambda: qmm_mod.q4_matmul(x, qs, sc, mn, 32, out=again), tmp_path)
    graph.replay()
    torch.cuda.synchronize()
    assert len(kernels) == 1 and "grouped_gemm_kernel" in kernels[0], kernels
    assert torch.equal(first, again)
    assert int(qmm_mod._counters[x.device].abs().sum()) == 0
    b16 = qmm_mod.q4_matmul(x, qs, sc, mn, 32, out_dtype=torch.bfloat16)
    assert torch.equal(b16, first.to(torch.bfloat16))


def test_q4_mm_writes_the_dtype_of_x(cuda):
    """mm on a bf16 x and a packed weight: q4_matmul rounds to bf16 in the
    kernel, the same bits as rounding its f32 result."""
    rng = np.random.default_rng(59)
    qs, sc, mn = _grouped(rng, 512, 192, 32, True, torch.bfloat16, True,
                          cuda)
    w = qmm_mod.QTensor(qs, sc, mn, 512, 32, True)
    x = _x(rng, 6, 512, cuda).reshape(2, 3, 512)
    got = qmm_mod.mm(x, w)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 3, 192)
    want = qmm_mod.q4_matmul(x.reshape(6, 512), qs, sc, mn, 32)
    assert torch.equal(got.reshape(6, 192), want.to(torch.bfloat16))


# -- flash decode split across the SMs ------------------------------------------


def _served_decode(rng, cuda, cpos, nv, quant, C=2048, R=16, B=4, Hkv=4,
                   G=8, D=64, win=(0, 0), Dv=None):
    """One decode call at the served shape in which the chain's rows hold
    the values the cache holds (an int8 cache: its codes times their scale,
    rounded to bf16, as the model's rows hold them), and every cache
    position at or past the chain start is NaN (int8: its scale). V's
    width is Dv (D by default)."""
    bf = torch.bfloat16
    Dv = Dv or D
    q = _x(rng, B * Hkv * G, D, cuda).reshape(B, Hkv, G, D)
    k = _x(rng, B * C * Hkv, D, cuda, torch.float32).reshape(B, C, Hkv, D)
    v = _x(rng, B * C * Hkv, Dv, cuda, torch.float32).reshape(B, C, Hkv, Dv)
    cur_k = _x(rng, B * Hkv, D, cuda).reshape(B, Hkv, D)
    cur_v = _x(rng, B * Hkv, Dv, cuda).reshape(B, Hkv, Dv)
    sc = {}
    if quant:
        ks = (k.abs().amax(-1) / 127).to(bf)
        vs = (v.abs().amax(-1) / 127).to(bf)
        kc = (k / ks.float()[..., None]).round().clamp(-127, 127).to(
            torch.int8)
        vc = (v / vs.float()[..., None]).round().clamp(-127, 127).to(
            torch.int8)
        kd = (kc.float() * ks.float()[..., None]).to(bf)
        vd = (vc.float() * vs.float()[..., None]).to(bf)
        ks, vs = ks.clone(), vs.clone()
        ks[:, cpos - nv + 1:] = float("nan")
        vs[:, cpos - nv + 1:] = float("nan")
        sc = dict(k_scale=ks, v_scale=vs)
    else:
        kc, vc = k.to(bf), v.to(bf)
        kd, vd = kc.clone(), vc.clone()
        kc[:, cpos - nv + 1:] = float("nan")
        vc[:, cpos - nv + 1:] = float("nan")
    kr = _x(rng, B * R * Hkv, D, cuda).reshape(B, R, Hkv, D)   # dead rows
    vr = _x(rng, B * R * Hkv, Dv, cuda).reshape(B, R, Hkv, Dv)
    kr[:, :nv - 1] = kd[:, cpos - nv + 1:cpos]
    vr[:, :nv - 1] = vd[:, cpos - nv + 1:cpos]
    kr[:, nv - 1], vr[:, nv - 1] = cur_k, cur_v
    meta = torch.tensor([[cpos, nv]] * B, dtype=torch.int32, device=cuda)
    return (q, kc, vc, kr, vr, meta,
            torch.tensor(win, dtype=torch.int32, device=cuda)), sc


@pytest.mark.parametrize("cpos", [17, 1023, 2040])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
def test_decode_kernel_chain_rows_give_the_cache_bits(cuda, cpos, quant):
    """The same query with nv = 16 (its last 16 keys as chain rows) and
    with nv = 1 (all but its own key in the cache) gives the same bits:
    splits and tiles follow absolute positions (greedy K=1 = K=16)."""
    out = {}
    for nv in (1, 16):
        args, sc = _served_decode(np.random.default_rng(cpos), cuda, cpos, nv,
                                  quant)
        out[nv] = flash_decode(*args, **sc)
        want = flash_decode_plain(*args, **sc)
        torch.cuda.synchronize()
        assert torch.isfinite(out[nv]).all()
        torch.testing.assert_close(out[nv], want, rtol=0, atol=BF16_ATOL)
    assert torch.equal(out[1], out[16])


def test_decode_kernel_is_one_launch_and_resets_its_counters(cuda, tmp_path):
    """A bf16 call is one kernel (the splits are merged by the block with
    the last ticket; counted as the kernel nodes of a graph capturing it);
    a second identical call gives the same bits and leaves every counter
    at 0."""
    rng = np.random.default_rng(61)
    d = decode_case(rng, B=4, Hkv=4, G=8, D=64, C=2048, R=16,
                    cpos=(1023, 1500, 17, 2040), nv=(16, 3, 16, 1))
    _poison(d, d["meta"][:, 0] - d["meta"][:, 1] + 1)
    args, _ = _on(cuda, d, torch.bfloat16)
    meta = as_t(d["meta"]).to(cuda)
    win = torch.zeros(2, dtype=torch.int32, device=cuda)
    first = flash_decode(*args, meta, win)
    out = {}
    kernels, graph = _graph_kernels(
        lambda: out.update(again=flash_decode(*args, meta, win)), tmp_path)
    graph.replay()
    torch.cuda.synchronize()
    again = out["again"]
    assert len(kernels) == 1 and "flash_decode_mma_kernel" in kernels[0], \
        kernels
    assert torch.isfinite(first).all() and torch.equal(first, again)
    torch.testing.assert_close(first, flash_decode_plain(*args, meta, win),
                               rtol=0, atol=BF16_ATOL)
    assert int(fd_mod._scratch[args[0].device][1].abs().sum()) == 0


# -- CUDA graphs: each kernel captured, the engine's programs replayed ----------


def _replays_equal_eager(call, inputs, fill, cuda):
    """call(*inputs) captured in a graph; three times, `fill(rng, inputs)`
    rewrites the inputs in place, the graph replays and its output must
    equal an eager call on the same inputs bit for bit."""
    eager = call(*inputs)                     # libraries, scratch, tickets
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = call(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    rng = np.random.default_rng(77)
    for _ in range(3):
        fill(rng, inputs)
        graph.replay()
        want = call(*inputs)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.isfinite(out.float()).all()
        assert not torch.equal(out, eager)
        eager = want


def _refill(*which):
    def fill(rng, inputs):
        for i in which:
            t = inputs[i]
            t.copy_(torch.from_numpy(rng.standard_normal(
                tuple(t.shape)).astype(np.float32)).to(t.dtype))
    return fill


def test_flash_prefill_in_a_cuda_graph(cuda):
    rng = np.random.default_rng(71)
    p = prefill_case(rng, B=4, Hkv=4, G=8, D=64, C=256, T=64,
                     pos0=(0, 40, 100, 192), n_valid=(64, 30, 1, 64))
    args, _ = _on(cuda, p, torch.bfloat16)
    meta = as_t(p["meta"]).to(cuda)
    win = torch.zeros(2, dtype=torch.int32, device=cuda)
    _replays_equal_eager(lambda *a: flash_prefill_batched(*a, meta, win),
                         args, _refill(0, 1, 3), cuda)


def test_flash_decode_in_a_cuda_graph(cuda):
    rng = np.random.default_rng(72)
    d = decode_case(rng, B=4, Hkv=4, G=8, D=64, C=2048, R=16,
                    cpos=(1023, 1500, 17, 2040), nv=(16, 3, 16, 1))
    args, _ = _on(cuda, d, torch.bfloat16)
    meta = as_t(d["meta"]).to(cuda)
    win = torch.zeros(2, dtype=torch.int32, device=cuda)
    _replays_equal_eager(lambda *a: flash_decode(*a, meta, win), args,
                         _refill(0, 1, 3), cuda)


def test_fused_norm_qmm_in_a_cuda_graph(cuda):
    rng = np.random.default_rng(73)
    a = list(_norm_qmm_case(rng, 4, 2048, 2560, cuda))
    _replays_equal_eager(lambda *t: fdec_mod.fused_norm_qmm(*t, eps=1e-5), a,
                         _refill(0), cuda)


@pytest.mark.parametrize("packed", [True, False], ids=["q4", "q8"])
@pytest.mark.parametrize("M", [4, 512])
def test_q_matmul_in_a_cuda_graph(cuda, packed, M):
    rng = np.random.default_rng(74 + M)
    K, N = 2048, 2560
    x = _x(rng, M, K, cuda)
    qs, sc, mn = _grouped(rng, K, N, 32 if packed else 16, packed,
                          torch.bfloat16, packed, cuda)
    kern, _ = _q_fn(packed)
    group = 32 if packed else 16
    _replays_equal_eager(
        lambda xx: kern(xx, qs, sc, mn, group, out_dtype=torch.bfloat16),
        [x], _refill(0), cuda)


def test_draws_on_the_card_are_the_cpu_draws(cuda):
    from llama_box_tpu_torch import sampling as ts
    for dev in ("cpu", cuda):
        st = ts.init_sampler_state(5, 10, dev)
        for b in range(5):
            ts.reset_slot(st, b, 0xFFFFFFFF - 977 * b)
        st.step.copy_(torch.tensor([0, 1, 7, 4096, 2 ** 30]))
        got = ts._draws(st, ts.STREAM_GUMBEL, 256).cpu()
        if dev == "cpu":
            want = got
    assert torch.equal(got, want)


# a tiny llama for the engine tests: E 256, head 64, FF 512, vocab 512 (byte
# fallback and letter pieces), two layers; every width the fused w8a8 gates
# and the Q4_K / Q6_K blocks take
_TINY = dict(L=2, E=256, H=4, HKV=2, D=64, FF=512, V=512)


def _tiny_gguf(path, fmt, dims=None, moe=None, mla=None):
    """The tiny llama; with `moe` (X experts, K a token, expert FF) a
    qwen3moe file whose FFNs are experts (bf16 stacks on the card); with
    `mla` (rope and nope dims, V width, q and kv ranks) a deepseek2 file
    of dense layers whose attention is multi-head latent attention (K
    width rope + nope, H heads)."""
    from llama_box_tpu_torch.gguf import GGMLType, GGUFWriter
    from llama_box_tpu_torch.tokenizer.tokenizer import TokenType
    L, E, H, HKV, D, FF, V = ((dims or _TINY)[k] for k in
                              ("L", "E", "H", "HKV", "D", "FF", "V"))
    arch = "qwen3moe" if moe else "deepseek2" if mla else "llama"
    if mla:
        HKV, D = H, mla["rope"] + mla["nope"]
    alpha = ["▁"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]
    pieces = (alpha + [a + b for a in alpha for b in alpha])[:V - 259]
    toks = ["<unk>", "<s>", "</s>"] + [f"<0x{i:02X}>" for i in range(256)] \
        + pieces
    types = [TokenType.UNKNOWN, TokenType.CONTROL, TokenType.CONTROL] \
        + [TokenType.BYTE] * 256 + [TokenType.NORMAL] * len(pieces)
    rng = np.random.default_rng(3)
    w = GGUFWriter(str(path), architecture=arch)
    a = arch
    for k, v in ((f"{a}.block_count", L), (f"{a}.context_length", 512),
                 (f"{a}.embedding_length", E),
                 (f"{a}.feed_forward_length", FF),
                 (f"{a}.attention.head_count", H),
                 (f"{a}.attention.head_count_kv", HKV),
                 (f"{a}.attention.layer_norm_rms_epsilon", 1e-5),
                 (f"{a}.rope.freq_base", 10000.0),
                 (f"{a}.rope.dimension_count", D),
                 (f"{a}.vocab_size", V), ("tokenizer.ggml.model", "llama"),
                 ("tokenizer.ggml.tokens", toks),
                 ("tokenizer.ggml.scores", np.asarray(
                     [0.0] * 259 + [-float(i) for i in range(len(pieces))],
                     np.float32)),
                 ("tokenizer.ggml.token_type", np.asarray(types, np.int32)),
                 ("tokenizer.ggml.bos_token_id", 1),
                 ("tokenizer.ggml.eos_token_id", 2),
                 ("tokenizer.ggml.unknown_token_id", 0)):
        w.add_kv(k, v)
    if moe:
        w.add_kv(f"{a}.expert_count", moe["X"])
        w.add_kv(f"{a}.expert_used_count", moe["K"])
    if mla:
        for k, v in (("attention.key_length", D),
                     ("attention.value_length", mla["dv"]),
                     ("attention.q_lora_rank", mla["q_lora"]),
                     ("attention.kv_lora_rank", mla["kv_lora"]),
                     ("rope.dimension_count", mla["rope"])):
            w.add_kv(f"{a}.{k}", v)

    def rand(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.05

    def norm_w():
        return 1.0 + rng.standard_normal(E, dtype=np.float32) * 0.02
    most, q6 = {"f16": ("F16", "F16"), "q8_0": ("Q8_0", "Q8_0"),
                "q4_k_m": ("Q4_K", "Q6_K")}[fmt]
    most, q6 = GGMLType[most], GGMLType[q6]
    w.add_tensor("token_embd.weight", rand(V, E), most)
    w.add_tensor("output_norm.weight", norm_w())
    w.add_tensor("output.weight", rand(V, E), q6)
    for i in range(L):
        w.add_tensor(f"blk.{i}.attn_norm.weight", norm_w())
        if mla:
            p, qr, kvr = f"blk.{i}.", mla["q_lora"], mla["kv_lora"]
            if qr:
                w.add_tensor(p + "attn_q_a.weight", rand(qr, E), most)
                w.add_tensor(p + "attn_q_a_norm.weight", norm_w()[:qr])
                w.add_tensor(p + "attn_q_b.weight", rand(H * D, qr), most)
            else:
                w.add_tensor(p + "attn_q.weight", rand(H * D, E), most)
            w.add_tensor(p + "attn_kv_a_mqa.weight",
                         rand(kvr + mla["rope"], E), most)
            w.add_tensor(p + "attn_kv_a_norm.weight", norm_w()[:kvr])
            w.add_tensor(p + "attn_kv_b.weight",
                         rand(H * (mla["nope"] + mla["dv"]), kvr), most)
            w.add_tensor(p + "attn_output.weight", rand(E, H * mla["dv"]),
                         most)
        else:
            w.add_tensor(f"blk.{i}.attn_q.weight", rand(H * D, E), most)
            w.add_tensor(f"blk.{i}.attn_k.weight", rand(HKV * D, E), most)
            w.add_tensor(f"blk.{i}.attn_v.weight", rand(HKV * D, E), most)
            w.add_tensor(f"blk.{i}.attn_output.weight", rand(E, H * D),
                         most)
        w.add_tensor(f"blk.{i}.ffn_norm.weight", norm_w())
        if moe:
            X, F = moe["X"], moe["FF"]
            w.add_tensor(f"blk.{i}.ffn_gate_inp.weight", rand(X, E) * 10)
            for k, shp in (("gate", (X, F, E)), ("up", (X, F, E)),
                           ("down", (X, E, F))):
                w.add_tensor(f"blk.{i}.ffn_{k}_exps.weight", rand(*shp),
                             most)
            continue
        w.add_tensor(f"blk.{i}.ffn_gate.weight", rand(FF, E), most)
        w.add_tensor(f"blk.{i}.ffn_up.weight", rand(FF, E), most)
        w.add_tensor(f"blk.{i}.ffn_down.weight", rand(E, FF), q6)
    w.write()


_FORMATS = {"bf16": ("f16", {}), "w8a8": ("q8_0", {}),
            "q4": ("q4_k_m", {"LLAMA_BOX_TPU_PACKED4": "1"})}


@pytest.fixture(scope="module", params=sorted(_FORMATS))
def tiny_model(request, tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from llama_box_tpu_torch.gguf import GGUFFile
    from llama_box_tpu_torch.models.loader import load_model
    from llama_box_tpu_torch.tokenizer import Tokenizer
    fmt, env = _FORMATS[request.param]
    path = tmp_path_factory.mktemp("tiny") / f"tiny-{fmt}.gguf"
    _tiny_gguf(path, fmt)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        cfg, params = load_model(str(path), dtype=torch.bfloat16,
                                 device="cuda",
                                 quantized=request.param != "bf16")
    with GGUFFile(str(path)) as g:
        tok = Tokenizer.from_gguf(g)
    return request.param, cfg, params, tok


def _engine(tiny, graphs, chain=16, start=False, **kw):
    from llama_box_tpu_torch.server.engine import Engine, EngineConfig
    _, cfg, params, tok = tiny
    kw = dict(dict(n_slots=4, n_ctx=4 * 256, n_ubatch=32,
                   kv_dtype="bfloat16"), **kw)
    eng = Engine(cfg, params, tok,
                 EngineConfig(decode_chain=chain, cuda_graphs=graphs, **kw),
                 device="cuda")
    eng.fuse_params()
    if start:
        eng.start()
    return eng


def _stage_decode(eng, tokens, pos):
    S = len(eng.slots)
    h = eng._dec_in.host()
    h[:] = 0
    h[S:2 * S] = eng.slot_ctx
    for b, (t, p) in enumerate(zip(tokens, pos)):
        if t is not None:
            h[b], h[S + b], h[2 * S + b] = t, p, 1
    eng._dec_in.push()


def _stage_prefill(eng, chunks, T):
    S = len(eng.slots)
    h = eng._pre_in.host()
    h[:S * (3 + T)] = 0
    tok = h[3 * S:S * (3 + T)].reshape(S, T)
    for b, (p, ids) in chunks.items():
        tok[b, :len(ids)] = ids
        h[b], h[S + b], h[2 * S + b] = p, len(ids), 1
    eng._pre_in.push(S * (3 + T))


def test_a_prompt_rows_bits_do_not_depend_on_its_cached_prefix(cuda,
                                                               tiny_model):
    """A 40-token prompt prefilled whole (slot 0, bucket 64) and the same
    prompt as 39 tokens then a one-token chunk (slot 1, the smallest
    bucket): the last row's logits are bit-equal, so a greedy prompt
    served from the prefix cache continues as it does cold. On grouped
    weights the smallest bucket is one whose pass has more rows than the
    grouped GEMM splits."""
    eng = _engine(tiny_model, False, n_ubatch=64)
    S = len(eng.slots)
    if tiny_model[0] == "q4":
        assert all(S * b > qmm_mod._SPLIT_MAX_ROWS for b in eng.buckets)
    prompt = np.random.default_rng(91).integers(300, 500, 40).tolist()
    eng._refresh_arrs()
    _stage_prefill(eng, {0: (0, prompt)}, 64)
    cold = eng._prefill_program(64)[4][0].clone()
    _stage_prefill(eng, {1: (0, prompt[:-1])}, 64)
    eng._prefill_program(64)
    T = eng._bucket(1)
    _stage_prefill(eng, {1: (39, prompt[-1:])}, T)
    cached = eng._prefill_program(T)[4][1].clone()
    assert torch.equal(cold, cached)


def test_grouped_rows_keep_their_bits_in_every_prefill_bucket(cuda,
                                                              tiny_model):
    """At TinyLlama-1.1B's wqkv widths (in 2048, out 2560, groups of 32)
    a row's q4_matmul bits are the same in the pass of every bucket an
    engine over grouped weights keeps (slots x bucket rows), so a prompt
    row prefilled in a one-token chunk (its prefix from the cache) has its
    cold bits. Calls of at most 64 rows split the in-dim and round
    otherwise: the engine keeps no bucket that makes one."""
    if tiny_model[0] != "q4":
        pytest.skip("the grouped GEMM's row regimes: grouped weights only")
    eng = _engine(tiny_model, False, n_ubatch=256)
    S = len(eng.slots)
    rng = np.random.default_rng(93)
    qs, sc, mn = _grouped(rng, 2048, 2560, 32, True, torch.bfloat16, True,
                          cuda)
    x = _x(rng, S * eng.buckets[-1], 2048, cuda)
    full = qmm_mod.q4_matmul(x, qs, sc, mn, 32)
    for b in eng.buckets:
        assert torch.equal(qmm_mod.q4_matmul(x[:S * b], qs, sc, mn, 32),
                           full[:S * b]), b


def test_engine_programs_replay_the_eager_bits(cuda, tiny_model):
    """The prefill program (bucket 32, slot 2 idle) and a 16-step decode
    chain, each run three times (eager first use, capture + replay,
    replay) on an engine with graphs and on one without: every output,
    the KV cache and the sampler state equal bit for bit after each run,
    and the graph engine captured one graph per key."""
    engines = [_engine(tiny_model, g) for g in (True, False)]
    rng = np.random.default_rng(81)
    chunks = {b: (0, rng.integers(300, 500, n).tolist())
              for b, n in ((0, 32), (1, 20), (3, 7))}
    for it in range(3):
        outs = []
        for eng in engines:
            _stage_prefill(eng, chunks, 32)
            eng._refresh_arrs()
            pre = eng.graphs.run(("prefill", 32),
                                 lambda e=eng: e._prefill_program(32))
            tok0 = pre[0].cpu().tolist()
            _stage_decode(eng, [tok0[0], tok0[1], None, tok0[3]],
                          [32, 20, 0, 7])
            dec = eng.graphs.run(("decode", 16, False, 64),
                                 lambda e=eng: e._decode_program(
                                     16, samp_extras=False, samp_kcap=64))
            torch.cuda.synchronize()
            outs.append([t.clone() for t in (*pre, *dec)]
                        + [t.clone() for t in eng.kv if t is not None]
                        + [t.clone() for t in eng.sstate])
        for a, b in zip(*outs):
            assert torch.equal(a, b), it
    assert engines[0].graphs.n_graphs == 2
    assert engines[1].graphs.n_graphs == 0


def test_a_graphs_outputs_survive_the_other_graphs_replays(cuda,
                                                          tiny_model):
    """Two prefill buckets and three decode chains captured in turn; then
    each one replays and keeps its outputs while every other one replays
    after it: no replay writes over another graph's outputs. The engine
    reads them after other programs ran (the newest chain's last tokens
    start the next chain, dispatched after a new request's prefill; a
    speculative pass's carry starts the next pass)."""
    eng = _engine(tiny_model, True)
    rng = np.random.default_rng(95)
    progs = {}
    for T in (16, 32):
        ids = rng.integers(300, 500, T).tolist()

        def run(T=T, ids=ids):
            _stage_prefill(eng, {0: (0, ids), 2: (0, ids[:T // 2])}, T)
            eng._refresh_arrs()
            return eng.graphs.run(("prefill", T),
                                  lambda: eng._prefill_program(T))
        progs["prefill", T] = run
    for K in (1, 4, 16):
        def run(K=K):
            _stage_decode(eng, [401, None, 402, 403], [40, 0, 20, 9])
            return eng.graphs.run(("decode", K, False, 64),
                                  lambda: eng._decode_program(
                                      K, samp_extras=False, samp_kcap=64))
        progs["decode", K] = run
    for run in progs.values():
        run()           # eager first use
        run()           # capture + replay
    assert eng.graphs.n_graphs == len(progs)
    for key, run in progs.items():
        outs = run()
        torch.cuda.synchronize()
        want = [t.clone() for t in outs]
        for other, run2 in progs.items():
            if other == key:
                continue
            run2()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(outs, want)), \
                f"replaying {other} changed the outputs of {key}"


def test_engine_greedy_tokens_with_and_without_graphs(cuda, tiny_model):
    """Four greedy requests (one repeated) through the started engine:
    graphs on and off, K = 1 and 16, give the same tokens; with graphs on,
    the launches of every kernel the path runs count the replays."""
    from llama_box_tpu_torch.sampling import SamplerParams
    from llama_box_tpu_torch.server.cuda_graph import kernel_wrappers
    from llama_box_tpu_torch.server.task import CompletionsTask
    rng = np.random.default_rng(82)
    prompts = [rng.integers(300, 500, n).tolist() for n in (40, 23, 9)]
    prompts.append(prompts[0])
    out = {}
    for graphs in (True, False):
        for K in (1, 16):
            eng = _engine(tiny_model, graphs, chain=K, start=True)
            for w in kernel_wrappers():
                w.launches = 0
            try:
                tasks = [CompletionsTask(p, SamplerParams(
                    temp=0.0, ignore_eos=True), tokenizer=eng.tokenizer,
                    max_tokens=20) for p in prompts]
                for t in tasks:
                    eng.submit(t)
                gen = []
                for t in tasks:
                    while True:
                        kind, payload = t.result_q.get(timeout=300)
                        if kind == "error":
                            raise payload
                        if kind == "final":
                            gen.append(list(payload.generated))
                            break
                n_graphs = eng.graphs.n_graphs
            finally:
                eng.stop()
            out[graphs, K] = gen
            assert (n_graphs > 0) == graphs
            if graphs:
                assert flash_decode.launches > 0
                assert flash_prefill_batched.launches > 0
    assert out[True, 1] == out[True, 16] == out[False, 1] == out[False, 16]
    assert all(len(g) == 20 for g in out[True, 16])
    assert out[True, 16][3] == out[True, 16][0]


def test_sampler_arrays_change_between_replays(cuda, tiny_model):
    """A captured chain reads the engine's persistent SamplerArrays: a
    logit bias filled in between two replays moves the sampled token, as
    the eager chain does with the same arrays (runs: eager first use,
    capture + replay, replay after the refill)."""
    from llama_box_tpu_torch.sampling import SamplerParams
    eng, ref = _engine(tiny_model, True), _engine(tiny_model, False)
    greedy = SamplerParams(temp=0.0)
    got = []
    for run in range(3):
        pair = []
        for e in (eng, ref):
            sp = greedy if run < 2 else SamplerParams(
                temp=0.0, logit_bias={int(got[0][0, 0]): -1e9})
            e.arrs = e._samp_bufs.fill([sp] * 4, e.eog_ids)
            _stage_decode(e, [400, 401, 402, 403], [0, 0, 0, 0])
            out = e.graphs.run(("decode", 1, True, 0),
                               lambda e=e: e._decode_program(
                                   1, samp_extras=True))
            pair.append(out[0].cpu().clone())
        assert torch.equal(pair[0], pair[1]), run
        got.append(pair[0])
    assert eng.graphs.n_graphs == 1
    assert torch.equal(got[0], got[1])
    assert int(got[2][0, 0]) != int(got[0][0, 0])


def test_a_capture_failure_raises(cuda):
    """An operation a capture cannot take (a device synchronise) raises
    out of the runner's second use; nothing runs eagerly instead."""
    from llama_box_tpu_torch.server.cuda_graph import GraphRunner
    runner = GraphRunner(cuda)
    x = torch.ones(4, device=cuda)

    def fn():
        y = x * 2
        torch.cuda.synchronize()
        return y
    assert torch.equal(runner.run("k", fn), x * 2)       # eager first use
    with pytest.raises(RuntimeError):
        runner.run("k", fn)
    assert runner.n_graphs == 0
    torch.cuda.synchronize()


# -- pipelined chains (chain N+1 dispatched before chain N's sync) -------------


def _serve(eng, specs, timeout=300):
    """Submit (prompt ids, SamplerParams, max_tokens) tasks at once; their
    generated tokens, in order."""
    from llama_box_tpu_torch.server.task import CompletionsTask
    tasks = [CompletionsTask(list(p), sp, tokenizer=eng.tokenizer,
                             max_tokens=n) for p, sp, n in specs]
    for t in tasks:
        eng.submit(t)
    out = []
    for t in tasks:
        while True:
            kind, payload = t.result_q.get(timeout=timeout)
            if kind == "error":
                raise payload
            if kind == "final":
                out.append(list(payload.generated))
                break
    return out


def _pipeline_specs(rng, n=20, penalty=1.2):
    """Greedy and seeded requests of mixed lengths and budgets; the last
    with a repeat penalty (without one, every request may take the
    post-prefill chain)."""
    from llama_box_tpu_torch.sampling import SamplerParams
    prompts = [rng.integers(300, 500, k).tolist() for k in (40, 23, 9, 17)]
    return [(prompts[0], SamplerParams(temp=0.0, ignore_eos=True), n),
            (prompts[1], SamplerParams(temp=0.0), n),
            (prompts[2], SamplerParams(temp=0.8, seed=5), n),
            (prompts[3], SamplerParams(temp=0.9, seed=11,
                                       penalty_repeat=penalty), n + 7)]


@pytest.mark.parametrize("chain,depth", [(16, 2), (4, 2)])
def test_pipelined_texts_equal_lockstep(cuda, tiny_model, chain, depth):
    """Graphs on: pipelined chains (depth 2) and pipeline_chain=False give
    identical greedy and seeded tokens on every weight path. At K 4 two
    chains of one key are in flight at once (their outputs are the same
    graph buffers): the copy made right after each replay keeps each
    chain's tokens."""
    specs = _pipeline_specs(np.random.default_rng(83),
                            n=20 if chain == 16 else 40)
    out, spec = {}, {}
    for pipe in (True, False):
        eng = _engine(tiny_model, True, chain=chain, start=True,
                      pipeline_chain=pipe, pipeline_depth=depth)
        try:
            out[pipe] = _serve(eng, specs)
            spec[pipe] = eng.metrics.n_spec_chains
            assert eng.graphs.n_graphs > 0
        finally:
            eng.stop()
    assert out[True] == out[False]
    assert spec[True] > 0 and spec[False] == 0
    assert [len(g) for g in out[True]][:1] == [specs[0][2]]


def _warm_every_key(eng):
    """Run every program key the engine's traffic below can meet twice
    (its eager first use, then its capture), so the engine only replays."""
    S = len(eng.slots)
    for T in eng.buckets:
        for _ in range(2):
            _stage_prefill(eng, {0: (0, [400] * T)}, T)
            eng._refresh_arrs()
            eng.graphs.run(("prefill", T),
                           lambda T=T: eng._prefill_program(T))
    K = 1
    while K <= eng.ecfg.decode_chain:
        for extras, kcap in ((True, 0), (False, 0), (False, 64)):
            for _ in range(2):
                _stage_decode(eng, [400] + [None] * (S - 1), [0] * S)
                eng.graphs.run(("decode", K, extras, kcap),
                               lambda K=K, e=extras, c=kcap:
                               eng._decode_program(K, samp_extras=e,
                                                   samp_kcap=c))
        K *= 2
    torch.cuda.synchronize()


def test_pipelined_serving_syncs_only_at_consume(cuda, tiny_model):
    """Once every graph is captured, a whole wave (admission, prefill, the
    post-prefill chain, pipelined decode) runs under
    torch.cuda.set_sync_debug_mode("error"): an implicit synchronisation
    (a read-back, a copy from pageable memory, a stream or device
    synchronise) raises in the engine and fails the tasks. The one wait
    is the event of a program's output copy (HostCopies.wait), which the
    mode does not count; the detector itself is shown live first."""
    eng = _engine(tiny_model, True, chain=16)
    _warm_every_key(eng)
    n_graphs = eng.graphs.n_graphs
    eng.start()
    specs = _pipeline_specs(np.random.default_rng(84), penalty=1.0)
    try:
        torch.cuda.set_sync_debug_mode("error")
        try:
            with pytest.raises(RuntimeError):
                torch.ones(1, device=cuda).item()
            out = _serve(eng, specs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert eng.graphs.n_graphs == n_graphs     # nothing captured
        assert eng.metrics.n_spec_chains > 0
        assert eng.metrics.n_spec_post_prefill > 0
    finally:
        eng.stop()
    ref = _engine(tiny_model, True, chain=16, start=True,
                  pipeline_chain=False)
    try:
        assert _serve(ref, specs) == out
    finally:
        ref.stop()


# -- in-place KV-cache edits between replays (context shift, prefix copy) -----


def _leaf_ptrs(eng):
    return [x.data_ptr() for x in eng.kv if x is not None]


def _cloned(tensors) -> list:
    """Copies of a program's outputs (a replay writes them anew)."""
    return [t.clone() for t in tensors if t is not None]


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_shift_and_copy_between_replays_give_the_eager_bits(cuda, tiny_model,
                                                            kv_dtype):
    """Two prefill passes fill slot 0 to 56 rows (slot 1: 20), an 8-step
    chain takes slot 0 to its capacity of 64, then a context shift of
    slot 0 and a copy of its first 40 rows into slot 2, then another
    8-step chain over slots 0 and 2 that reads the edited rows; three
    times (eager first use, capture + replay, replay) on an engine with
    graphs and on one without: every output, the cache and the sampler
    state equal bit for bit each time, and no cache leaf moves."""
    from llama_box_tpu_torch.models.llama import copy_kv_prefix
    engines = [_engine(tiny_model, g, n_ctx=4 * 64, kv_dtype=kv_dtype)
               for g in (True, False)]
    ptrs = [_leaf_ptrs(e) for e in engines]
    rng = np.random.default_rng(85)
    ids = rng.integers(300, 500, 56).tolist()
    side = rng.integers(300, 500, 20).tolist()
    key = ("decode", 8, False, 64)
    for it in range(3):
        outs = []
        for eng in engines:
            got = []
            for chunks in ({0: (0, ids[:32]), 1: (0, side)},
                           {0: (32, ids[32:])}):
                _stage_prefill(eng, chunks, 32)
                eng._refresh_arrs()
                pre = _cloned(eng.graphs.run(
                    ("prefill", 32), lambda e=eng: e._prefill_program(32)))
                got += pre
            tok0 = int(pre[0][0])
            _stage_decode(eng, [tok0, None, None, None], [56, 0, 0, 0])
            got += _cloned(eng.graphs.run(key, lambda e=eng: e._decode_program(
                8, samp_extras=False, samp_kcap=64)))
            s = eng.slots[0]
            s.pos, s.cache_tokens = eng.slot_ctx, list(range(eng.slot_ctx))
            eng._context_shift(s)                   # 16 rows dropped
            assert s.pos == eng.slot_ctx - 16
            copy_kv_prefix(eng.kv, 0, 2, 40)
            last = int(got[-4][0, -1])
            _stage_decode(eng, [last, None, last, None], [s.pos, 0, 40, 0])
            got += _cloned(eng.graphs.run(key, lambda e=eng: e._decode_program(
                8, samp_extras=False, samp_kcap=64)))
            torch.cuda.synchronize()
            outs.append(got + _cloned(eng.kv) + _cloned(eng.sstate))
        for a, b in zip(*outs):
            assert torch.equal(a, b), it
        assert [_leaf_ptrs(e) for e in engines] == ptrs
    assert engines[0].graphs.n_graphs == 2
    assert engines[1].graphs.n_graphs == 0


def test_pipelined_wave_that_shifts_syncs_only_at_consume(cuda, tiny_model):
    """Once every graph is captured, a wave whose requests run past their
    64-position slots (each shifting at least twice) runs under
    torch.cuda.set_sync_debug_mode("error"): the shifts add no host
    wait. Its tokens equal lockstep's, and no cache leaf moved."""
    eng = _engine(tiny_model, True, chain=16, n_ctx=4 * 64)
    _warm_every_key(eng)
    n_graphs, ptrs = eng.graphs.n_graphs, _leaf_ptrs(eng)
    shifts = []
    shift = eng._context_shift

    def spy(s):
        shifts.append(s.idx)
        return shift(s)
    eng._context_shift = spy
    eng.start()
    from llama_box_tpu_torch.sampling import SamplerParams
    rng = np.random.default_rng(86)
    specs = [(rng.integers(300, 500, k).tolist(),
              SamplerParams(temp=t, seed=seed, ignore_eos=True), 120)
             for k, t, seed in ((40, 0.0, 0), (23, 0.0, 0), (9, 0.8, 5),
                                (17, 0.9, 11))]
    try:
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = _serve(eng, specs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert eng.graphs.n_graphs == n_graphs     # nothing captured
        assert eng.metrics.n_spec_chains > 0
        assert _leaf_ptrs(eng) == ptrs
    finally:
        eng.stop()
    assert all(shifts.count(i) >= 2 for i in range(4)), shifts
    assert [len(g) for g in out][:1] == [120]
    ref = _engine(tiny_model, True, chain=16, start=True, n_ctx=4 * 64,
                  pipeline_chain=False)
    try:
        assert _serve(ref, specs) == out
    finally:
        ref.stop()


def test_one_token_pass_replays_the_eager_bits(cuda, tiny_model):
    """The one-token pass (three slots decoding, two of them host-sampled,
    one idle), run three times on an engine with graphs (eager first use,
    capture + replay, replay) and on one without: every output, the
    gathered host rows, the KV cache and the sampler state equal bit for
    bit; the host-sampled slots' sampler state never advances; the third
    call captures nothing."""
    engines = [_engine(tiny_model, g) for g in (True, False)]
    key = ("one", False, 64)
    host = [3, 0]
    for it in range(3):
        outs = []
        for eng in engines:
            eng._stage_one([400 + it, 401, None, 403 + it], [it, 5, 0, 9],
                           host)
            eng._refresh_arrs()
            n_before = eng.graphs.n_graphs
            out = eng.graphs.run(key, lambda e=eng: e._one_token_program(
                samp_extras=False, samp_kcap=64))
            torch.cuda.synchronize()
            if it == 2:
                assert eng.graphs.n_graphs == n_before
            outs.append(_cloned(out) + _cloned(eng.kv) + _cloned(eng.sstate))
            steps = eng.sstate.step.cpu().tolist()
            assert steps[0] == steps[2] == steps[3] == 0
            assert steps[1] == it + 1
        for a, b in zip(*outs):
            assert torch.equal(a, b), it
    assert engines[0].graphs.n_graphs == 1
    assert engines[1].graphs.n_graphs == 0


def test_engine_host_sampled_tokens_with_and_without_graphs(cuda,
                                                            tiny_model):
    """A greedy grammar request, a seeded mirostat request and a plain
    greedy one through the started engine, graphs on and off: the same
    tokens; the grammar text is in its language; the plain request's
    tokens equal its tokens served alone (chained, on a fresh engine, so
    both prefill the whole prompt cold); one-token passes launched the
    attention kernel."""
    from llama_box_tpu_torch.grammar import Grammar
    from llama_box_tpu_torch.sampling import SamplerParams
    rng = np.random.default_rng(87)
    prompts = [rng.integers(300, 500, n).tolist() for n in (40, 23, 9)]

    def specs():
        return [(prompts[0], SamplerParams(
                    temp=0.0, grammar=Grammar('root ::= [a-e]+ "."')), 24),
                (prompts[1], SamplerParams(temp=0.8, seed=9, mirostat=2),
                 24),
                (prompts[2], SamplerParams(temp=0.0, ignore_eos=True), 24)]
    out = {}
    for graphs in (True, False):
        eng = _engine(tiny_model, graphs, start=True)
        try:
            flash_decode.launches = 0
            out[graphs] = _serve(eng, specs())
            assert flash_decode.launches > 0
        finally:
            eng.stop()
        eng = _engine(tiny_model, graphs, start=True)
        try:
            alone = _serve(eng, specs()[2:])
        finally:
            eng.stop()
        assert alone == out[graphs][2:]
    assert out[True] == out[False]
    text = tiny_model[3].decode(out[True][0])
    assert Grammar('root ::= [a-e]+ "."', native=False).accept_bytes(
        text.encode()), text


# -- speculative decoding: the verify rows, the spec passes --------------------


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
def test_verify_rows_are_the_one_row_queries(cuda, quant):
    """T = 9 verify rows a slot at the served shape (C 2048, 4 KV heads of
    8 queries, D 64): query j through flash decode with the verify rows as
    its chain (meta (pos0 + j, j + 1)) gives, bit for bit, the one-row
    query at pos0 + j whose earlier rows are in the cache as the verify
    writes them (a decode step at K = 1). Cache positions from pos0 on
    hold NaN in the verify call: it must not read them."""
    from llama_box_tpu_torch.models.llama import (KVCache, _attn_verify,
                                                  _cache_rows)
    rng = np.random.default_rng(95)
    B, C, Hkv, G, D, T = 4, 2048, 4, 8, 64, 9
    bf = torch.bfloat16
    pos0 = [17, 1023, 2030, 500]
    q = _x(rng, B * T * Hkv * G, D, cuda).reshape(B, T, Hkv * G, D)
    k = _x(rng, B * T * Hkv, D, cuda).reshape(B, T, Hkv, D)
    v = _x(rng, B * T * Hkv, D, cuda).reshape(B, T, Hkv, D)
    base = _x(rng, B * C * Hkv, D, cuda, torch.float32).reshape(B, C, Hkv, D)
    if quant:
        sc = (base.abs().amax(-1) / 127).to(bf)
        codes = (base / sc.float()[..., None]).round().clamp(-127, 127).to(
            torch.int8)
        kv = KVCache(codes.clone(), codes.clone(), sc.clone(), sc.clone())
    else:
        kv = KVCache(base.to(bf), base.flip(0).to(bf))
    stored = _cache_rows(kv, k, v)
    poisoned = [t.clone() for t in kv if t is not None]
    for b, p in enumerate(pos0):
        poisoned[-1 if quant else 0][b, p:] = float("nan")
        poisoned[-2 if quant else 1][b, p:] = float("nan")
    win = torch.zeros(2, dtype=torch.int32, device=cuda)
    j = torch.arange(T, device=cuda)
    p0 = torch.tensor(pos0, device=cuda)
    meta = torch.stack([(p0[None] + j[:, None]),
                        (j + 1)[:, None].expand(T, B)], -1).to(torch.int32)
    ks, vs = (poisoned[2], poisoned[3]) if quant else (None, None)
    got = _attn_verify(q, k, v, poisoned[0], poisoned[1], ks, vs, stored,
                       meta, win, bf, None)
    flash_decode.launches = 0
    for jj in range(T):
        caches = [t.clone() for t in kv if t is not None]
        for f, new in enumerate(stored):
            for b, p in enumerate(pos0):
                caches[f][b, p:p + jj] = new[b, :jj]
        qd = q[:, jj].reshape(B, Hkv, G, D).contiguous()
        m1 = torch.tensor([[p + jj, 1] for p in pos0], dtype=torch.int32,
                          device=cuda)
        sc_kw = dict(k_scale=caches[2], v_scale=caches[3]) if quant else {}
        one = flash_decode(qd, caches[0], caches[1], k[:, jj:jj + 1].to(bf),
                           v[:, jj:jj + 1].to(bf), m1, win, **sc_kw)
        torch.cuda.synchronize()
        assert torch.isfinite(got[:, jj].float()).all()
        assert torch.equal(got[:, jj], one.to(bf).reshape(B, -1)), jj
    assert flash_decode.launches == T


def _spec_engine(tiny, graphs, start=False, **kw):
    """An engine over the tiny model drafting for itself (draft_p_min 0:
    every draft is the target's own greedy token)."""
    from llama_box_tpu_torch.server.engine import Engine, EngineConfig
    _, cfg, params, tok = tiny
    kw = dict(dict(n_slots=4, n_ctx=4 * 256, n_ubatch=32,
                   kv_dtype="bfloat16", decode_chain=16, draft_max=4,
                   draft_p_min=0.0), **kw)
    eng = Engine(cfg, params, tok, EngineConfig(cuda_graphs=graphs, **kw),
                 device="cuda", draft=(cfg, params))
    eng.fuse_params()
    if start:
        eng.start()
    return eng


def _stage_spec(eng, tokens, pos, carry=False):
    """Stage a spec pass: slot b verifies from tokens[b] at pos[b] (None:
    inactive) and drafts; carry: round 0's catch-up is valid."""
    S = len(eng.slots)
    T = 1 + eng.ecfg.draft_max
    h = eng._spec_in.host()
    h[:] = 0
    h[S:2 * S] = eng.slot_ctx
    for b, (t, p) in enumerate(zip(tokens, pos)):
        if t is not None:
            h[b], h[S + b], h[2 * S + b], h[3 * S + b] = t, p, 1, 1
            h[S * (4 + T) + b] = 2
            h[S * (5 + T) + b] = max(p - 2, 0)
            h[S * (6 + T) + b] = int(carry)
    eng._spec_in.push()


def _warm_spec_keys(eng):
    """Every program key a self-drafting wave of plain requests meets, run
    twice (its eager first use, then its capture): the prefill and the
    draft's catch-up buckets, the M-round spec pass and the one-round
    pass."""
    S = len(eng.slots)
    K = eng.ecfg.draft_max
    for T in eng.buckets:
        for key, prog in ((("prefill", T), eng._prefill_program),
                          (("draft_prefill", T), eng._draft_prefill_program)):
            for _ in range(2):
                _stage_prefill(eng, {0: (0, [400] * T)}, T)
                eng._refresh_arrs()
                eng.graphs.run(key, lambda T=T, prog=prog: prog(T))
    for M, carry, name in ((eng.ecfg.spec_rounds, True, "spec"),
                           (1, False, "fused")):
        for extras, kcap in ((True, 0), (False, 0), (False, 64)):
            kw = dict(samp_extras=extras, samp_kcap=kcap)
            for _ in range(2):
                _stage_spec(eng, [400] + [None] * (S - 1), [0] * S, carry)
                eng.graphs.run((name, M, K, extras, kcap),
                               lambda M=M, c=carry, kw=kw:
                               eng._spec_program(M, c, **kw))
    torch.cuda.synchronize()


def test_spec_pass_replays_the_eager_bits_and_counts_its_kernels(
        cuda, tiny_model, tmp_path):
    """One M-round spec pass (M 2, K 4, three slots, one idle) on an
    engine with graphs and on one without, three times with its carry:
    every output, both KV caches and the sampler state equal bit for bit;
    its graph holds, a round, one flash prefill launch a draft layer (the
    catch-up), K flash decode launches a draft layer (the draft steps) and
    K + 1 a target layer (the verify rows)."""
    engines = [_spec_engine(tiny_model, g, spec_rounds=2) for g in
               (True, False)]
    key = ("spec", 2, 4, False, 64)
    for it in range(3):
        outs = []
        for eng in engines:
            _stage_spec(eng, [400 + it, 401, None, 403], [20, 33, 0, 7],
                        carry=it > 0)
            eng._refresh_arrs()
            out = eng.graphs.run(key, lambda e=eng: e._spec_program(
                2, True, samp_extras=False, samp_kcap=64))
            torch.cuda.synchronize()
            outs.append(_cloned(out[:6]) + _cloned(out[6])
                        + _cloned(eng.kv) + _cloned(eng.draft_kv)
                        + _cloned(eng.sstate))
        for a, b in zip(*outs):
            assert torch.equal(a, b), it
        packed = outs[0][0]
        assert (packed[:, 2, 5] == 0).all() and (packed[:, 0, 6] == 4).all()
    assert engines[0].graphs.n_graphs == 1
    eng = engines[1]
    L = eng.cfg.n_layers
    names, graph = _graph_kernels(lambda: eng._spec_program(
        2, True, samp_extras=False, samp_kcap=64), tmp_path)
    graph.replay()
    torch.cuda.synchronize()
    fp = [n for n in names if "flash_prefill" in n]
    fd = [n for n in names if "flash_decode" in n]
    assert len(fp) == 2 * L
    assert len(fd) == 2 * (L * 4 + L * 5)


def test_spec_wave_pipelined_syncs_only_at_consume(cuda, tiny_model):
    """Self-drafting, every key captured first: a wave of four plain
    requests (greedy and seeded) runs under set_sync_debug_mode("error")
    with spec passes pipelined (pass N + 1 off pass N's device-resident
    carry), captures nothing, accepts every draft and gives the tokens of
    plain chained decode."""
    rng = np.random.default_rng(96)
    specs = _pipeline_specs(rng, n=40, penalty=1.0)
    eng = _spec_engine(tiny_model, True, spec_rounds=2)
    _warm_spec_keys(eng)
    n_graphs = eng.graphs.n_graphs
    filled = []
    fill = eng._fill_spec_queue

    def spy(dec, pend):
        n0 = len(eng._spec_q)
        fill(dec, pend)
        filled.append(len(eng._spec_q) - n0)
    eng._fill_spec_queue = spy
    eng.start()
    try:
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = _serve(eng, specs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert eng.graphs.n_graphs == n_graphs
        assert sum(filled) > 0
        m = eng.metrics
        assert m.n_drafted_total > 0
    finally:
        eng.stop()
    ref = _engine(tiny_model, True, chain=16, start=True)
    try:
        assert _serve(ref, specs) == out
    finally:
        ref.stop()


# -- embeddings and rerank -----------------------------------------------------

# TinyLlama-1.1B's and BERT-base's (bge-base-en-v1.5) widths, two layers each
_TINYLLAMA_WIDTH = dict(L=2, E=2048, H=32, HKV=4, D=64, FF=5632, V=512)
_BERT_BASE = dict(L=2, E=768, H=12, FF=3072, V=512, P=512)


def _bert_gguf(path, rank=True, dims=_BERT_BASE, seed=6):
    """A BERT GGUF (a WordPiece vocab of letter pieces; with `rank`, a
    classification head and pooling rank, else pooling cls), random F16
    matrices and F32 vectors from `seed`."""
    from llama_box_tpu_torch.gguf import GGMLType, GGUFWriter
    L, E, H, FF, V, P = (dims[k] for k in ("L", "E", "H", "FF", "V", "P"))
    alpha = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    words = alpha + [a + b for a in alpha for b in alpha]
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
             + ["##" + w for w in words])[:V]
    rng = np.random.default_rng(seed)
    w = GGUFWriter(str(path), architecture="bert")
    for k, v in (("bert.block_count", L), ("bert.context_length", P),
                 ("bert.embedding_length", E),
                 ("bert.feed_forward_length", FF),
                 ("bert.attention.head_count", H),
                 ("bert.attention.layer_norm_epsilon", 1e-12),
                 ("bert.pooling_type", 4 if rank else 2),
                 ("tokenizer.ggml.model", "bert"),
                 ("tokenizer.ggml.tokens", vocab),
                 ("tokenizer.ggml.token_type", np.asarray(
                     [3] * 5 + [1] * (V - 5), np.int32)),
                 ("tokenizer.ggml.unknown_token_id", 1),
                 ("tokenizer.ggml.cls_token_id", 2),
                 ("tokenizer.ggml.seperator_token_id", 3)):
        w.add_kv(k, v)

    def rand(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.02

    f16 = GGMLType.F16
    w.add_tensor("token_embd.weight", rand(V, E), f16)
    w.add_tensor("token_types.weight", rand(2, E), f16)
    w.add_tensor("position_embd.weight", rand(P, E), f16)
    w.add_tensor("token_embd_norm.weight", 1.0 + rand(E))
    w.add_tensor("token_embd_norm.bias", rand(E))
    for i in range(L):
        for name, (o, n) in (("attn_q", (E, E)), ("attn_k", (E, E)),
                             ("attn_v", (E, E)), ("attn_output", (E, E)),
                             ("ffn_up", (FF, E)), ("ffn_down", (E, FF))):
            w.add_tensor(f"blk.{i}.{name}.weight", rand(o, n), f16)
            w.add_tensor(f"blk.{i}.{name}.bias", rand(o))
        for name in ("attn_output_norm", "layer_output_norm"):
            w.add_tensor(f"blk.{i}.{name}.weight", 1.0 + rand(E))
            w.add_tensor(f"blk.{i}.{name}.bias", rand(E))
    if rank:
        w.add_tensor("cls.weight", rand(E, E), f16)
        w.add_tensor("cls.bias", rand(E))
        w.add_tensor("cls.output.weight", rand(1, E), f16)
        w.add_tensor("cls.output.bias", rand(1))
    w.write()


@pytest.fixture(scope="module")
def bert_model(tmp_path_factory):
    """("bert", cfg, bf16 params on the card, tokenizer) of a BERT-base
    width cross-encoder."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from llama_box_tpu_torch.gguf import GGUFFile
    from llama_box_tpu_torch.models.bert import load_bert
    from llama_box_tpu_torch.tokenizer import Tokenizer
    path = tmp_path_factory.mktemp("bert") / "bert-base.gguf"
    _bert_gguf(path)
    cfg, params = load_bert(str(path), dtype=torch.bfloat16, device="cuda")
    with GGUFFile(str(path)) as g:
        tok = Tokenizer.from_gguf(g)
    return "bert", cfg, params, tok


@pytest.fixture(scope="module")
def wide_model(tmp_path_factory):
    """A TinyLlama-width two-layer llama file, bf16 weights on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from llama_box_tpu_torch.gguf import GGUFFile
    from llama_box_tpu_torch.models.loader import load_model
    from llama_box_tpu_torch.tokenizer import Tokenizer
    path = tmp_path_factory.mktemp("wide") / "tinyllama-width.gguf"
    _tiny_gguf(path, "f16", _TINYLLAMA_WIDTH)
    cfg, params = load_model(str(path), dtype=torch.bfloat16, device="cuda")
    with GGUFFile(str(path)) as g:
        tok = Tokenizer.from_gguf(g)
    return "bf16", cfg, params, tok


def _embed_lists(rng, lens, lo=10, hi=500):
    return [rng.integers(lo, hi, n).tolist() for n in lens]


def _stage_embed(eng, lists, R, T):
    h = eng._emb_in.host()
    h[:R * (1 + T)] = 0
    toks = h[R:R * (1 + T)].reshape(R, T)
    for b, ids in enumerate(lists):
        toks[b, :len(ids)] = ids
        h[b] = len(ids)
    eng._emb_in.push(R * (1 + T))


def _run_embed(eng, lists, R, T, pooling):
    _stage_embed(eng, lists, R, T)
    return eng.graphs.run(("embed", R, T, pooling),
                          lambda: eng._embed_program(R, T, pooling))


@pytest.mark.parametrize("pooling", ["mean", "rank"])
def test_embed_graph_replays_the_eager_bits(cuda, tiny_model, pooling):
    """An embed pass (4 rows, bucket 32; pooled, or every row under the
    rank pooling) three times on an engine with graphs and on one
    without: the outputs equal bit for bit each time; the replays count
    the pass's kernels (flash prefill once a layer)."""
    from llama_box_tpu_torch.ops.flash_prefill import flash_prefill_batched
    engines = [_engine(tiny_model, g) for g in (True, False)]
    lists = _embed_lists(np.random.default_rng(97), (32, 9, 20))
    for it in range(3):
        outs = []
        for eng in engines:
            n0 = flash_prefill_batched.launches
            out = _run_embed(eng, lists, 4, 32, pooling)
            torch.cuda.synchronize()
            assert flash_prefill_batched.launches - n0 == eng.cfg.n_layers
            outs.append(out.clone())
        assert torch.equal(*outs), it
        assert torch.isfinite(outs[0]).all()
    assert engines[0].graphs.n_graphs == 1
    assert engines[1].graphs.n_graphs == 0


@pytest.mark.parametrize("pooling", ["cls", "rank"])
def test_bert_embed_graph_replays_the_eager_bits(cuda, bert_model, pooling):
    from llama_box_tpu_torch.server.engine import Engine, EngineConfig
    _, cfg, params, tok = bert_model
    engines = [Engine(cfg, params, tok, EngineConfig(
        n_slots=1, n_ctx=512, n_ubatch=64, cuda_graphs=g), device="cuda")
        for g in (True, False)]
    lists = _embed_lists(np.random.default_rng(98), (64, 17, 40, 3, 64),
                         5, 500)
    for it in range(3):
        outs = []
        for eng in engines:
            out = _run_embed(eng, lists, 8, 64, pooling)
            torch.cuda.synchronize()
            outs.append(out.clone())
        assert torch.equal(*outs), it
    assert outs[0].shape == ((8,) if pooling == "rank" else (8, cfg.n_embd))
    assert engines[0].graphs.n_graphs == 1


def _plain_on_card(mp):
    """Route the embedding pass's kernels to their plain versions, on the
    card's tensors."""
    from llama_box_tpu_torch.models import llama as tl
    from llama_box_tpu_torch.ops import fused_decode as fdm
    from llama_box_tpu_torch.ops import qmatmul as qm
    mp.setattr(tl, "flash_prefill_batched", fp_mod.flash_prefill_plain)
    mp.setattr(tl, "norm_any", norm_mod.norm_any_plain)
    mp.setattr(tl, "rms_norm", norm_mod.rms_norm_plain)
    mp.setattr(tl, "fused_norm_qmm", fdm.fused_norm_qmm_plain)
    mp.setattr(tl, "fused_layer_tail", fdm.fused_layer_tail_plain)
    mp.setattr(qm, "w8a8_matmul", lambda x, qs, sc, out_dtype=torch.float32:
               qm.w8a8_matmul_plain(x, qs, sc).to(out_dtype))
    mp.setattr(qm, "q_matmul", lambda x, w, out_dtype=torch.float32:
               qm.q_matmul_ref(x, w).to(out_dtype))


def _card_against_plain(model, lists, T, monkeypatch):
    from llama_box_tpu_torch.models.llama import (forward_embeddings,
                                                  make_rope)
    from llama_box_tpu_torch.ops.flash_prefill import flash_prefill_batched
    _, cfg, params, _ = model
    cos, sin = make_rope(cfg, T, device="cuda")
    toks = torch.zeros((len(lists), T), dtype=torch.int64)
    for b, ids in enumerate(lists):
        toks[b, :len(ids)] = torch.tensor(ids)
    lens = torch.tensor([len(x) for x in lists])
    n0 = flash_prefill_batched.launches
    got = forward_embeddings(params, cfg, toks, lens, cos, sin)
    assert flash_prefill_batched.launches - n0 == cfg.n_layers
    with monkeypatch.context() as mp:
        _plain_on_card(mp)
        want = forward_embeddings(params, cfg, toks, lens, cos, sin)
    assert flash_prefill_batched.launches - n0 == cfg.n_layers
    cos_sim = torch.nn.functional.cosine_similarity(got, want)
    assert torch.isfinite(got).all()
    assert float(cos_sim.min()) >= 0.999, cos_sim


def test_embedding_vectors_against_the_plain_versions(cuda, tiny_model,
                                                      monkeypatch):
    """Every weight path at the tiny widths, 3 rows of bucket 64 (more
    than 64 token rows) and 1 row of 32 (w8a8: the fused kernels): the
    card's vectors against the same pass through the plain versions on
    the card, cosine >= 0.999."""
    rng = np.random.default_rng(99)
    _card_against_plain(tiny_model, _embed_lists(rng, (64, 30, 51)), 64,
                        monkeypatch)
    _card_against_plain(tiny_model, _embed_lists(rng, (32,)), 32,
                        monkeypatch)


def test_tinyllama_width_vectors_against_the_plain_versions(
        cuda, wide_model, monkeypatch):
    rng = np.random.default_rng(100)
    _card_against_plain(wide_model, _embed_lists(rng, (512, 300, 77, 16)),
                        512, monkeypatch)


def test_bert_base_width_vectors_against_the_cpu(cuda, bert_model):
    """The BERT encoder runs no kernel of the port: its bf16 vectors and
    rank scores on the card against the f32 encoder on the CPU."""
    from llama_box_tpu_torch.models.bert import bert_forward
    _, cfg, params, _ = bert_model
    cpu = {k: ({kk: vv.float().cpu() for kk, vv in v.items()}
               if isinstance(v, dict) else v.float().cpu())
           for k, v in params.items()}
    lists = _embed_lists(np.random.default_rng(101), (512, 300, 77, 16),
                         5, 500)
    toks = torch.zeros((4, 512), dtype=torch.int64)
    for b, ids in enumerate(lists):
        toks[b, :len(ids)] = torch.tensor(ids)
    lens = torch.tensor([len(x) for x in lists])
    for pooling in ("cls", "mean"):
        got = bert_forward(params, cfg, toks, lens, pooling).float().cpu()
        want = bert_forward(cpu, cfg, toks, lens, pooling)
        sim = torch.nn.functional.cosine_similarity(got, want)
        assert float(sim.min()) >= 0.999, (pooling, sim)
    got = bert_forward(params, cfg, toks, lens, "rank").float().cpu()
    want = bert_forward(cpu, cfg, toks, lens, "rank")
    assert float((got - want).abs().max()) <= 0.02, (got, want)


def test_embed_pass_between_pipelined_chains_leaves_their_tokens(
        cuda, tiny_model):
    """Three requests decoding in pipelined chains (graphs, chains of 4,
    the prefix cache off) with a 12-input embeddings task beside them (in
    passes of 2 rows, one a reconcile pass, enqueued between the chains'
    replays): their tokens equal those of the same requests alone, the
    chains were speculated, and the vectors are those of a quiet
    engine."""
    from llama_box_tpu_torch.server.task import (CompletionsTask,
                                                 EmbeddingsTask)
    specs = _pipeline_specs(np.random.default_rng(102), n=40)[:3]
    lists = _embed_lists(np.random.default_rng(103),
                         [5, 9, 31, 17, 2, 30, 11, 25, 7, 19, 3, 28])
    res = {}
    for beside in (False, True):
        eng = _engine(tiny_model, True, chain=4, start=True,
                      max_embed_batch=2, prompt_cache=False)
        try:
            task = EmbeddingsTask(lists)
            tasks = [CompletionsTask(list(p), sp, tokenizer=eng.tokenizer,
                                     max_tokens=n) for p, sp, n in specs]
            for t in tasks + ([task] if beside else []):
                eng.submit(t)
            out = [list(_final(t).generated) for t in tasks]
            if beside:
                assert eng.metrics.n_spec_chains > 0
            else:
                eng.submit(task)
            res[beside] = (out, np.asarray(_final(task).embeddings))
        finally:
            eng.stop()
    assert res[True][0] == res[False][0]
    assert np.array_equal(res[True][1], res[False][1])


def _final(task, timeout=300):
    while True:
        kind, payload = task.result_q.get(timeout=timeout)
        if kind == "error":
            raise payload
        if kind == "final":
            return payload


def test_embed_graph_outputs_survive_the_other_graphs_replays(cuda,
                                                              tiny_model):
    """Two embed keys, a prefill bucket and two decode chains captured in
    turn; each replays and keeps its outputs while every other replays
    after it (test_a_graphs_outputs_survive_the_other_graphs_replays with
    the embed graphs among them)."""
    eng = _engine(tiny_model, True)
    rng = np.random.default_rng(104)
    progs = {}
    for R, T, pooling in ((4, 32, "mean"), (2, 64, "rank")):
        lists = _embed_lists(rng, [T, T // 2][:R])

        def run(R=R, T=T, pooling=pooling, lists=lists):
            return (_run_embed(eng, lists, R, T, pooling),)
        progs["embed", R, T, pooling] = run
    ids = rng.integers(300, 500, 32).tolist()

    def prefill():
        _stage_prefill(eng, {0: (0, ids), 2: (0, ids[:16])}, 32)
        eng._refresh_arrs()
        return eng.graphs.run(("prefill", 32),
                              lambda: eng._prefill_program(32))
    progs["prefill", 32] = prefill
    for K in (1, 16):
        def run(K=K):
            _stage_decode(eng, [401, None, 402, 403], [40, 0, 20, 9])
            return eng.graphs.run(("decode", K, False, 64),
                                  lambda: eng._decode_program(
                                      K, samp_extras=False, samp_kcap=64))
        progs["decode", K] = run
    for run in progs.values():
        run()           # eager first use
        run()           # capture + replay
    assert eng.graphs.n_graphs == len(progs)
    for key, run in progs.items():
        outs = run()
        torch.cuda.synchronize()
        want = [t.clone() for t in outs]
        for other, run2 in progs.items():
            if other == key:
                continue
            run2()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(outs, want)), \
                f"replaying {other} changed the outputs of {key}"


# -- the row-norm kernel (csrc/norm.cu) ---------------------------------------
#
# Against its plain versions: f32 rows within 1e-5 (the sums run in another
# order), bf16 rows within one bf16 rounding (rtol 2**-7: the f32 result
# before the cast moves by a few f32 ulps, which can cross a bf16 rounding
# point). A row's bits must not depend on how many rows share the call.

from llama_box_tpu_torch.ops import norm as norm_mod  # noqa: E402

NORM_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _norm_inputs(shape, dtype, wdtype, groups=1, seed=30):
    g = torch.Generator().manual_seed(seed)
    n = shape[-1]
    x = (torch.randn(shape, generator=g) * 2 + 0.3).to(dtype)
    w = (1 + 0.1 * torch.randn(groups * n, generator=g)).to(wdtype)
    b = (0.1 * torch.randn(groups * n, generator=g)).to(wdtype)
    return x, w, b


@pytest.mark.parametrize("shape", [(4, 2048), (2048, 2048), (64, 128),
                                   (9, 100), (3, 6144)])
@pytest.mark.parametrize("style", ["rms", "ln", "ln_nobias"])
@pytest.mark.parametrize("dtype,wdtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32)])
def test_row_norm_kernel_matches_plain(cuda, shape, style, dtype, wdtype):
    x, w, b = _norm_inputs(shape, dtype, wdtype)
    b = b if style == "ln" else None
    st = "ln" if style.startswith("ln") else "rms"
    before = norm_mod.row_norm.launches
    got = norm_mod.norm_any(x.to(cuda), w.to(cuda),
                            None if b is None else b.to(cuda), st, 1e-5)
    torch.cuda.synchronize()
    assert norm_mod.row_norm.launches == before + 1
    want = norm_mod.norm_any_plain(x.to(cuda), w.to(cuda),
                                   None if b is None else b.to(cuda), st,
                                   1e-5)
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=NORM_RTOL[dtype], atol=1e-5)
    if st == "rms":
        assert torch.equal(got, norm_mod.rms_norm(x.to(cuda), w.to(cuda)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_norm_kernel_per_head_weights(cuda, dtype):
    """chameleon's per-head LayerNorm: row r of [B, T, H, D] takes the
    weight and bias of head r mod H."""
    x, w, b = _norm_inputs((4, 9, 16, 128), dtype, dtype, groups=16)
    got = norm_mod.ln_per_head(x.to(cuda), w.to(cuda), b.to(cuda))
    want = norm_mod.ln_per_head_plain(x.to(cuda), w.to(cuda), b.to(cuda))
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=NORM_RTOL[dtype], atol=1e-5)


@pytest.mark.parametrize("n", [2048, 128, 6144, 100])
@pytest.mark.parametrize("style", ["rms", "ln"])
def test_row_norm_rows_do_not_depend_on_the_row_count(cuda, n, style):
    """The bits of a row normed among 36 rows (a verify pass of 4 slots x
    9 rows), among 4 (a decode step) and alone are the same."""
    x, w, b = _norm_inputs((36, n), torch.bfloat16, torch.bfloat16, seed=31)
    x, w, b = x.to(cuda), w.to(cuda), b.to(cuda)
    b = b if style == "ln" else None
    full = norm_mod.norm_any(x, w, b, style, 1e-6)
    four = norm_mod.norm_any(x[8:12], w, b, style, 1e-6)
    assert torch.equal(full[8:12], four)
    for i in (0, 13, 35):
        assert torch.equal(full[i:i + 1],
                           norm_mod.norm_any(x[i:i + 1], w, b, style, 1e-6))


def test_row_norm_cuda_tensors_never_take_the_plain_version(cuda,
                                                            monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    for name in ("rms_norm_plain", "norm_any_plain", "ln_per_head_plain"):
        monkeypatch.setattr(norm_mod, name, boom)
    x, w, b = _norm_inputs((4, 256), torch.bfloat16, torch.bfloat16)
    x, w, b = x.to(cuda), w.to(cuda), b.to(cuda)
    norm_mod.rms_norm(x, w)
    norm_mod.norm_any(x, w, b, "ln", 1e-5)
    norm_mod.ln_per_head(x.reshape(4, 2, 128), w, b)
    with pytest.raises(ValueError):
        norm_mod.rms_norm(x.half(), w)


def test_row_norm_in_a_cuda_graph(cuda):
    x, w, b = _norm_inputs((36, 2048), torch.bfloat16, torch.bfloat16)
    x, w, b = x.to(cuda), w.to(cuda), b.to(cuda)
    eager = norm_mod.norm_any(x, w, b, "ln", 1e-5)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        out = norm_mod.norm_any(x, w, b, "ln", 1e-5)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.fixture(scope="module", params=["bf16", "q4", "w8a8"])
def wide_path_model(request, tmp_path_factory):
    """A TinyLlama-width two-layer llama file on each path: F16 (bf16
    weights, cuBLAS), Q4_K_M's types under LLAMA_BOX_TPU_PACKED4 (the
    grouped kernels) or Q8_0 (w8a8, the fused kernels at decode widths)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from llama_box_tpu_torch.gguf import GGUFFile
    from llama_box_tpu_torch.models.loader import load_model
    from llama_box_tpu_torch.tokenizer import Tokenizer
    fmt, env = _FORMATS[request.param]
    path = tmp_path_factory.mktemp("widep") / f"tinyllama-width-{fmt}.gguf"
    _tiny_gguf(path, fmt, _TINYLLAMA_WIDTH)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        cfg, params = load_model(str(path), dtype=torch.bfloat16,
                                 device="cuda",
                                 quantized=request.param != "bf16")
    with GGUFFile(str(path)) as g:
        tok = Tokenizer.from_gguf(g)
    return request.param, cfg, params, tok


def test_spec_greedy_text_equals_plain_decode_at_tinyllama_width(
        cuda, wide_path_model):
    """The engine invariant at TinyLlama's widths, on every path: a verify
    forward of 4 slots x 9 rows gives the logits of its rows' one-row
    decode steps bit for bit (the row-norm kernel sums each row in one
    order; the grouped and fused matmuls split the in-dim by the weight
    alone up to 64 rows; cuBLAS keeps a row's bits at M 36 and M 4 at
    these widths), so self-drafting greedy chats give the tokens of plain
    chained decode exactly, near ties and all."""
    from llama_box_tpu_torch.models import llama
    from llama_box_tpu_torch.sampling import SamplerParams
    _, cfg, params, _ = wide_path_model
    S, C, T = 4, 512, 9
    rng = np.random.default_rng(97)
    n = np.array([100, 37, 211, 64])
    pre = torch.from_numpy(rng.integers(300, 500, (S, 256)))
    rows = torch.from_numpy(rng.integers(300, 500, (S, T)))
    pos = n[:, None] + np.arange(T)
    cos, sin = llama.make_rope(cfg, C, cuda)
    kv = llama.init_kv_cache(cfg, S, C, torch.bfloat16, cuda)
    llama.prefill_batch_impl(params, cfg, pre, np.zeros(S, np.int64), n, kv,
                             cos, sin)
    kv2 = llama.KVCache(*[x.clone() if x is not None else None for x in kv])
    got = llama.forward_impl(params, cfg, rows, pos, kv, cos, sin)[0]
    want = torch.cat([llama.forward_impl(
        params, cfg, rows[:, j:j + 1], pos[:, j:j + 1].copy(), kv2, cos,
        sin)[0] for j in range(T)], dim=1)
    assert torch.equal(got, want)
    prompts = [rng.integers(300, 500, k).tolist() for k in (40, 23, 9, 17)]
    specs = [(p, SamplerParams(temp=0.0, ignore_eos=True), 48)
             for p in prompts]
    eng = _spec_engine(wide_path_model, True, draft_max=8, start=True)
    try:
        out = _serve(eng, specs)
        assert eng.metrics.n_drafted_total > 0
    finally:
        eng.stop()
    ref = _engine(wide_path_model, True, chain=16, start=True)
    try:
        assert _serve(ref, specs) == out
    finally:
        ref.stop()


# -- the attention variants: head widths 80, 96 and 256, a layer's window
# row, the softcap and ALiBi ---------------------------------------------------

# (Hkv, G) a width: phi-2 / phi-3-mini are MHA, gemma-3-1b has 4 query
# heads on one KV head
_VARIANT_HEADS = {80: (2, 1), 96: (2, 2), 256: (1, 4)}
_VARIANT_CASES = {"local": dict(win=(24, 0)),
                  "global_softcap": dict(softcap=50.0),
                  "alibi": dict(alibi=True),
                  "alibi_int8": dict(alibi=True, quant=True)}


def _variant_kw(case, Hkv, G, cuda):
    kw = dict(_VARIANT_CASES[case])
    win = torch.tensor(kw.pop("win", (0, 0)), dtype=torch.int32)
    alibi = (torch.rand(Hkv, G, generator=torch.Generator().manual_seed(1))
             * 0.5 + 0.01).to(cuda) if kw.pop("alibi", False) else None
    return win, dict(softcap=kw.pop("softcap", 0.0), alibi=alibi), kw


@pytest.mark.parametrize("D", sorted(_VARIANT_HEADS))
@pytest.mark.parametrize("case", sorted(_VARIANT_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernel_variants_match_plain(cuda, D, case, dtype):
    Hkv, G = _VARIANT_HEADS[D]
    win, opts, kw = _variant_kw(case, Hkv, G, cuda)
    if kw.get("quant") and dtype == torch.float32:
        pytest.skip("int8 caches are served to bf16 queries")
    c = prefill_case(np.random.default_rng(D), B=2, Hkv=Hkv, G=G, D=D,
                     C=256, T=80, pos0=(150, 40), n_valid=(80, 33), **kw)
    _poison(c, c["meta"][:, 0])
    args, sc = _on(cuda, c, dtype)
    meta = as_t(c["meta"]).to(cuda)
    before = flash_prefill_batched.launches
    got = flash_prefill_batched(*args, meta, win, **opts, **sc)
    want = flash_prefill_plain(*args, meta, win, **opts, **sc)
    torch.cuda.synchronize()
    assert flash_prefill_batched.launches == before + 1
    atol = F32_ATOL if dtype == torch.float32 and not kw else BF16_ATOL
    for b, nv in enumerate(c["meta"][:, 1]):
        assert torch.isfinite(got[b, :, :, :nv]).all()
        torch.testing.assert_close(got[b, :, :, :nv], want[b, :, :, :nv],
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("D", sorted(_VARIANT_HEADS))
@pytest.mark.parametrize("case", sorted(_VARIANT_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_variants_match_plain(cuda, D, case, dtype):
    Hkv, G = _VARIANT_HEADS[D]
    win, opts, kw = _variant_kw(case, Hkv, G, cuda)
    if kw.get("quant") and dtype == torch.float32:
        pytest.skip("int8 caches are served to bf16 queries")
    c = decode_case(np.random.default_rng(D), B=2, Hkv=Hkv, G=G, D=D, C=256,
                    R=16, cpos=(200, 40), nv=(5, 1), **kw)
    _poison(c, c["meta"][:, 0] - c["meta"][:, 1] + 1)
    args, sc = _on(cuda, c, dtype)
    meta = as_t(c["meta"]).to(cuda)
    before = flash_decode.launches
    got = flash_decode(*args, meta, win, **opts, **sc)
    want = flash_decode_plain(*args, meta, win, **opts, **sc)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    assert torch.isfinite(got).all()
    atol = F32_ATOL if dtype == torch.float32 and not kw else BF16_ATOL
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


def test_prefill_kernel_cold_equals_cached_prefix_at_d256_in_a_window(cuda):
    """Gemma-3-1B's heads (1 x 4 of 256) under its 512 window: a 700-token
    prompt prefilled cold and the same prompt with its first 300 positions
    in a bf16 cache give the same bits (tiles stay aligned to absolute
    key positions; a tile wholly below a row's window is skipped)."""
    rng = np.random.default_rng(41)
    T, P, C, D = 700, 300, 1024, 256
    c = prefill_case(rng, B=2, Hkv=1, G=4, D=D, C=C, T=T, pos0=(0, 0),
                     n_valid=(T, T))
    bf = torch.bfloat16
    q, kr, vr = (as_t(c[k]).to(cuda, bf) for k in ("q", "kr", "vr"))
    kc = torch.full((2, C, 1, D), float("nan"), device=cuda, dtype=bf)
    vc = kc.clone()
    win = torch.tensor([512, 0], dtype=torch.int32, device=cuda)
    meta = torch.tensor([[0, T, 0, 0]] * 2, dtype=torch.int32, device=cuda)
    cold = flash_prefill_batched(q, kc, vc, kr, vr, meta, win)
    want = flash_prefill_plain(q, kc, vc, kr, vr, meta, win)
    kc[:, :P], vc[:, :P] = kr[:, :P], vr[:, :P]
    meta = torch.tensor([[P, T - P, 0, 0]] * 2, dtype=torch.int32,
                        device=cuda)
    warm = flash_prefill_batched(q[:, :, :, P:].contiguous(), kc, vc,
                                 kr[:, P:].contiguous(),
                                 vr[:, P:].contiguous(), meta, win)
    torch.cuda.synchronize()
    assert torch.isfinite(warm).all()
    assert torch.equal(warm, cold[:, :, :, P:])
    torch.testing.assert_close(cold, want, rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("cpos", [1023, 3000])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
def test_decode_kernel_chain_rows_give_the_cache_bits_at_d256_in_a_window(
        cuda, cpos, quant):
    """The nv = 16 / nv = 1 bit check at Gemma-3-1B's heads under its 512
    window, at C 4096 (most splits hold no visible key)."""
    out = {}
    for nv in (1, 16):
        args, sc = _served_decode(np.random.default_rng(cpos), cuda, cpos, nv,
                                  quant, C=4096, Hkv=1, G=4, D=256,
                                  win=(512, 0))
        out[nv] = flash_decode(*args, **sc)
        want = flash_decode_plain(*args, **sc)
        torch.cuda.synchronize()
        assert torch.isfinite(out[nv]).all()
        torch.testing.assert_close(out[nv], want, rtol=0, atol=BF16_ATOL)
    assert torch.equal(out[1], out[16])


# -- the routed-expert kernel (csrc/moe_ffn.cu) ---------------------------------

# name -> (N rows, X experts, K picks, E, F, activation, biases,
# weight_before, an expert no row picks): Qwen3-30B-A3B's layer at a
# decode step, a verify pass and a 4 x 512 prefill; gpt-oss's swiglu_oai
# with biases; and the edges (one pick, every expert, 60 experts, an FF
# that is no multiple of the column tile, several tiles an expert, llama4's
# weight before the FFN, N K not a multiple of the tile rows)
_MOE_CASES = {
    "qwen3_decode": (4, 128, 8, 2048, 768, "silu", False, False, False),
    "qwen3_verify": (36, 128, 8, 2048, 768, "silu", False, False, False),
    "qwen3_prefill": (2048, 128, 8, 2048, 768, "silu", False, False, False),
    "gpt_oss": (36, 32, 4, 2880, 2880, "swiglu_oai", True, False, True),
    "k1_gelu": (37, 8, 1, 256, 200, "gelu", False, False, False),
    "k_all_relu2": (9, 8, 8, 256, 136, "relu2", False, False, False),
    "x60": (129, 60, 4, 512, 1408, "silu", False, False, True),
    "many_tiles": (700, 4, 2, 256, 512, "silu", False, False, False),
    "weight_before": (33, 16, 1, 512, 1024, "silu", False, True, False),
}
# f32 sums of the same exact bf16 products in another order; act enters
# the down product as hi + lo bf16 parts (about 2**-16 of it lost)
MOE_RTOL = 1e-4


def _moe_inputs(case, dev, seed=0):
    N, X, K, E, F, act, bias, wb, idle = _MOE_CASES[case]
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dev, bf)
    h = r(N, E)
    pool = X - 1 if idle else X
    topi = torch.stack([torch.randperm(pool, generator=g)[:K]
                        for _ in range(N)]).to(dev, torch.int32)
    topv = torch.rand(N, K, generator=g).to(dev) + 0.05
    stacks = (r(X, E, F, s=E ** -0.5), r(X, E, F, s=E ** -0.5),
              r(X, F, E, s=F ** -0.5))
    kw = dict(act=act, weight_before=wb, scale=1.5 if case == "x60" else 1.0)
    if bias:
        kw.update(b_gate=r(X, F, s=0.5), b_up=r(X, F, s=0.5),
                  b_down=r(X, E, s=0.1))
    return h, topi, topv, stacks, kw


@pytest.mark.parametrize("case", sorted(_MOE_CASES))
def test_moe_kernel_matches_plain(cuda, case):
    from llama_box_tpu_torch.ops.moe import moe_ffn, moe_ffn_plain
    h, topi, topv, stacks, kw = _moe_inputs(case, cuda)
    N, E = h.shape
    pad = 256
    buf = torch.full((N * E + 2 * pad,), float("nan"), device=cuda)
    out = buf[pad:pad + N * E].view(N, E)
    got = moe_ffn(h, topi, topv, *stacks, out=out, **kw)
    want = moe_ffn_plain(h, topi, topv, *stacks, **kw)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert torch.isnan(buf[:pad]).all() and torch.isnan(buf[-pad:]).all()
    assert torch.isfinite(got).all()
    tol = MOE_RTOL * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("case", ["qwen3_prefill", "gpt_oss",
                                  "weight_before"])
def test_moe_kernel_rows_do_not_depend_on_the_row_count(cuda, case):
    """A row's bits alone = among 36 (a verify pass) = among all N (a
    prefill pass): its tile partners and tile positions change, its
    products' order does not."""
    from llama_box_tpu_torch.ops.moe import moe_ffn
    h, topi, topv, stacks, kw = _moe_inputs(case, cuda, seed=5)
    full = moe_ffn(h, topi, topv, *stacks, **kw)
    some = moe_ffn(h[:36], topi[:36], topv[:36], *stacks, **kw)
    assert torch.equal(full[:36], some)
    for i in (0, 7, 35):
        one = moe_ffn(h[i:i + 1], topi[i:i + 1], topv[i:i + 1], *stacks,
                      **kw)
        assert torch.equal(full[i:i + 1], one)


def test_moe_kernel_in_a_cuda_graph_and_never_plain(cuda, monkeypatch):
    from llama_box_tpu_torch.ops import moe as moe_mod

    def boom(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    h, topi, topv, stacks, kw = _moe_inputs("qwen3_verify", cuda)
    eager = moe_mod.moe_ffn(h, topi, topv, *stacks, **kw)
    monkeypatch.setattr(moe_mod, "moe_ffn_plain", boom)
    n0 = moe_mod.moe_ffn.launches
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        out = moe_mod.moe_ffn(h, topi, topv, *stacks, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert moe_mod.moe_ffn.launches == n0 + 1
    with pytest.raises(ValueError):
        moe_mod.moe_ffn(h.float(), topi, topv, *stacks, **kw)


@pytest.fixture(scope="module")
def tiny_moe_model(tmp_path_factory):
    """A two-layer qwen3moe file at the tiny model's widths: 16 experts,
    4 a token, expert FF 128, F16 (bf16 stacks on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from llama_box_tpu_torch.gguf import GGUFFile
    from llama_box_tpu_torch.models.loader import load_model
    from llama_box_tpu_torch.tokenizer import Tokenizer
    path = tmp_path_factory.mktemp("tinymoe") / "tiny-moe-f16.gguf"
    _tiny_gguf(path, "f16", moe=dict(X=16, K=4, FF=128))
    cfg, params = load_model(str(path), dtype=torch.bfloat16, device="cuda")
    with GGUFFile(str(path)) as g:
        tok = Tokenizer.from_gguf(g)
    return "bf16", cfg, params, tok


def test_moe_spec_greedy_text_equals_plain_decode(cuda, tiny_moe_model):
    """On a small MoE model (bf16 path): a verify forward's rows are its
    one-row decode steps bit for bit, and self-drafting greedy chats give
    the tokens of plain chained decode; the expert kernel ran."""
    from llama_box_tpu_torch.models import llama
    from llama_box_tpu_torch.ops.moe import moe_ffn
    from llama_box_tpu_torch.sampling import SamplerParams
    _, cfg, params, _ = tiny_moe_model
    S, C, T = 4, 512, 9
    rng = np.random.default_rng(98)
    n = np.array([100, 37, 211, 64])
    pre = torch.from_numpy(rng.integers(300, 500, (S, 256)))
    rows = torch.from_numpy(rng.integers(300, 500, (S, T)))
    pos = n[:, None] + np.arange(T)
    cos, sin = llama.make_rope(cfg, C, cuda)
    kv = llama.init_kv_cache(cfg, S, C, torch.bfloat16, cuda)
    n0 = moe_ffn.launches
    llama.prefill_batch_impl(params, cfg, pre, np.zeros(S, np.int64), n, kv,
                             cos, sin)
    assert moe_ffn.launches == n0 + cfg.n_layers
    kv2 = llama.KVCache(*[x.clone() if x is not None else None for x in kv])
    got = llama.forward_impl(params, cfg, rows, pos, kv, cos, sin)[0]
    want = torch.cat([llama.forward_impl(
        params, cfg, rows[:, j:j + 1], pos[:, j:j + 1].copy(), kv2, cos,
        sin)[0] for j in range(T)], dim=1)
    assert torch.equal(got, want)
    prompts = [rng.integers(300, 500, k).tolist() for k in (40, 23, 9, 17)]
    specs = [(p, SamplerParams(temp=0.0, ignore_eos=True), 48)
             for p in prompts]
    eng = _spec_engine(tiny_moe_model, True, draft_max=8, start=True)
    try:
        out = _serve(eng, specs)
        assert eng.metrics.n_drafted_total > 0
    finally:
        eng.stop()
    ref = _engine(tiny_moe_model, True, chain=16, start=True)
    try:
        assert _serve(ref, specs) == out
    finally:
        ref.stop()


# -- multi-head latent attention: K and V of unequal widths --------------------

# the (K, V) pairs both kernels take under MLA: DeepSeek-V2/V3's 192 / 128
# and MiniCPM3's 96 / 64; H heads of each (G = 1)
_MLA_PAIRS = [(192, 128), (96, 64)]


@pytest.mark.parametrize("pair", _MLA_PAIRS, ids=str)
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
def test_prefill_kernel_mla_widths_match_plain(cuda, pair, cache):
    D, Dv = pair
    dtype = torch.float32 if cache == "f32" else torch.bfloat16
    c = prefill_case(np.random.default_rng(D), B=2, Hkv=4, G=1, D=D, Dv=Dv,
                     C=256, T=80, pos0=(150, 40), n_valid=(80, 33),
                     quant=cache == "int8")
    _poison(c, c["meta"][:, 0])
    args, sc = _on(cuda, c, dtype)
    meta = as_t(c["meta"]).to(cuda)
    win = torch.tensor([24, 0], dtype=torch.int32)
    before = flash_prefill_batched.launches
    for w in (torch.zeros(2, dtype=torch.int32), win):
        got = flash_prefill_batched(*args, meta, w, **sc)
        want = flash_prefill_plain(*args, meta, w, **sc)
        torch.cuda.synchronize()
        assert got.shape == (2, 4, 1, 80, Dv)
        atol = F32_ATOL if cache == "f32" else BF16_ATOL
        for b, nv in enumerate(c["meta"][:, 1]):
            assert torch.isfinite(got[b, :, :, :nv]).all()
            torch.testing.assert_close(got[b, :, :, :nv],
                                       want[b, :, :, :nv], rtol=0, atol=atol)
    assert flash_prefill_batched.launches == before + 2


@pytest.mark.parametrize("pair", _MLA_PAIRS, ids=str)
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
def test_decode_kernel_mla_widths_match_plain(cuda, pair, cache):
    D, Dv = pair
    dtype = torch.float32 if cache == "f32" else torch.bfloat16
    c = decode_case(np.random.default_rng(D + 1), B=2, Hkv=4, G=1, D=D,
                    Dv=Dv, C=256, R=16, cpos=(200, 40), nv=(5, 1),
                    quant=cache == "int8")
    _poison(c, c["meta"][:, 0] - c["meta"][:, 1] + 1)
    args, sc = _on(cuda, c, dtype)
    meta = as_t(c["meta"]).to(cuda)
    before = flash_decode.launches
    got = flash_decode(*args, meta, torch.zeros(2, dtype=torch.int32), **sc)
    want = flash_decode_plain(*args, meta, torch.zeros(2, dtype=torch.int32),
                              **sc)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    assert got.shape == (2, 4, 1, Dv) and torch.isfinite(got).all()
    atol = F32_ATOL if cache == "f32" else BF16_ATOL
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


def test_attention_kernels_refuse_width_pairs_they_lack(cuda):
    """A CUDA tensor at a (K, V) pair no instantiation covers raises,
    naming the pairs; it never runs the plain version."""
    c = decode_case(np.random.default_rng(5), B=1, Hkv=2, G=1, D=192,
                    Dv=64, C=128)
    args, sc = _on(cuda, c, torch.bfloat16)
    with pytest.raises(ValueError, match=r"\(192, 128\)"):
        flash_decode(*args, as_t(c["meta"]).to(cuda),
                     torch.zeros(2, dtype=torch.int32))
    c = prefill_case(np.random.default_rng(6), B=1, Hkv=2, G=1, D=192,
                     Dv=64, C=128, pos0=(16,), n_valid=(64,))
    args, sc = _on(cuda, c, torch.bfloat16)
    with pytest.raises(ValueError, match=r"\(96, 64\)"):
        flash_prefill_batched(*args, as_t(c["meta"]).to(cuda),
                              torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("pair", _MLA_PAIRS, ids=str)
def test_prefill_kernel_cold_equals_cached_prefix_at_mla_widths(cuda, pair):
    """A 500-token prompt prefilled cold and the same prompt with its
    first 137 positions in a bf16 cache give the same bits at K and V
    widths that differ."""
    D, Dv = pair
    rng = np.random.default_rng(43)
    T, P, C = 500, 137, 1024
    c = prefill_case(rng, B=2, Hkv=4, G=1, D=D, Dv=Dv, C=C, T=T,
                     pos0=(0, 0), n_valid=(T, T))
    bf = torch.bfloat16
    q, kr, vr = (as_t(c[k]).to(cuda, bf) for k in ("q", "kr", "vr"))
    kc = torch.full((2, C, 4, D), float("nan"), device=cuda, dtype=bf)
    vc = torch.full((2, C, 4, Dv), float("nan"), device=cuda, dtype=bf)
    win = torch.zeros(2, dtype=torch.int32, device=cuda)
    meta = torch.tensor([[0, T, 0, 0]] * 2, dtype=torch.int32, device=cuda)
    cold = flash_prefill_batched(q, kc, vc, kr, vr, meta, win)
    want = flash_prefill_plain(q, kc, vc, kr, vr, meta, win)
    kc[:, :P], vc[:, :P] = kr[:, :P], vr[:, :P]
    meta = torch.tensor([[P, T - P, 0, 0]] * 2, dtype=torch.int32,
                        device=cuda)
    warm = flash_prefill_batched(q[:, :, :, P:].contiguous(), kc, vc,
                                 kr[:, P:].contiguous(),
                                 vr[:, P:].contiguous(), meta, win)
    torch.cuda.synchronize()
    assert torch.isfinite(warm).all()
    assert torch.equal(warm, cold[:, :, :, P:])
    torch.testing.assert_close(cold, want, rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("pair", _MLA_PAIRS, ids=str)
@pytest.mark.parametrize("cpos", [1023, 3000])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
def test_decode_kernel_chain_rows_give_the_cache_bits_at_mla_widths(
        cuda, pair, cpos, quant):
    """The nv = 16 / nv = 1 bit check at K and V widths that differ, C
    4096, H heads of each (G = 1)."""
    D, Dv = pair
    out = {}
    for nv in (1, 16):
        args, sc = _served_decode(np.random.default_rng(cpos), cuda, cpos, nv,
                                  quant, C=4096, Hkv=4, G=1, D=D, Dv=Dv)
        out[nv] = flash_decode(*args, **sc)
        want = flash_decode_plain(*args, **sc)
        torch.cuda.synchronize()
        assert torch.isfinite(out[nv]).all()
        torch.testing.assert_close(out[nv], want, rtol=0, atol=BF16_ATOL)
    assert torch.equal(out[1], out[16])


# DeepSeek-V2's K 192 (rope 64 + nope 128) / V 128 at small widths
_MLA_TINY = dict(L=2, E=512, H=4, HKV=4, D=192, FF=1024, V=512)
_MLA_DIMS = dict(rope=64, nope=128, dv=128, q_lora=128, kv_lora=128)


@pytest.fixture(scope="module")
def mla_model(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from llama_box_tpu_torch.gguf import GGUFFile
    from llama_box_tpu_torch.models.loader import load_model
    from llama_box_tpu_torch.tokenizer import Tokenizer
    path = tmp_path_factory.mktemp("mla") / "tiny-mla.gguf"
    _tiny_gguf(path, "f16", _MLA_TINY, mla=_MLA_DIMS)
    cfg, params = load_model(str(path), dtype=torch.bfloat16, device="cuda")
    with GGUFFile(str(path)) as g:
        tok = Tokenizer.from_gguf(g)
    return "bf16", cfg, params, tok


def test_spec_greedy_text_equals_plain_decode_on_an_mla_model(cuda,
                                                             mla_model):
    """A tiny uniform MLA model at K 192 / V 128: its cache holds H heads
    of each width, both attention kernels run at that pair, a verify
    forward's rows equal their one-row steps bit for bit, and
    self-drafting greedy chats give plain chained decode's tokens."""
    from llama_box_tpu_torch.models import llama
    from llama_box_tpu_torch.sampling import SamplerParams
    _, cfg, params, _ = mla_model
    assert (cfg.head_dim, cfg.v_head_dim, cfg.kv_lora_rank) == (192, 128, 128)
    S, C, T = 4, 512, 9
    rng = np.random.default_rng(98)
    n = np.array([100, 37, 211, 64])
    pre = torch.from_numpy(rng.integers(300, 500, (S, 256)))
    rows = torch.from_numpy(rng.integers(300, 500, (S, T)))
    pos = n[:, None] + np.arange(T)
    cos, sin = llama.make_rope(cfg, C, cuda)
    kv = llama.init_kv_cache(cfg, S, C, torch.bfloat16, cuda)
    assert kv.k.shape[-2:] == (4, 192) and kv.v.shape[-2:] == (4, 128)
    n_pre, n_dec = flash_prefill_batched.launches, flash_decode.launches
    llama.prefill_batch_impl(params, cfg, pre, np.zeros(S, np.int64), n, kv,
                             cos, sin)
    kv2 = llama.KVCache(*[x.clone() if x is not None else None for x in kv])
    got = llama.forward_impl(params, cfg, rows, pos, kv, cos, sin)[0]
    want = torch.cat([llama.forward_impl(
        params, cfg, rows[:, j:j + 1], pos[:, j:j + 1].copy(), kv2, cos,
        sin)[0] for j in range(T)], dim=1)
    assert flash_prefill_batched.launches > n_pre
    assert flash_decode.launches > n_dec
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(kv, kv2) if a is not None)
    prompts = [rng.integers(300, 500, k).tolist() for k in (40, 23, 9, 17)]
    specs = [(p, SamplerParams(temp=0.0, ignore_eos=True), 48)
             for p in prompts]
    eng = _spec_engine(mla_model, True, draft_max=8, start=True)
    try:
        out = _serve(eng, specs)
        assert eng.metrics.n_drafted_total > 0
    finally:
        eng.stop()
    ref = _engine(mla_model, True, chain=16, start=True)
    try:
        assert _serve(ref, specs) == out
    finally:
        ref.stop()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kn", [(10944, 2048), (2048, 2816), (512, 4096)],
                         ids=str)
def test_dense_mm_rows_keep_their_bits_up_to_64_rows(cuda, dtype, kn):
    """A dense projection's rows (DeepSeek-V2-Lite's dense down, shared
    experts' up, MLA's kv_b) are the same bits in a call of 4 rows, of 36
    (a verify pass) and of 64: every call of at most 64 rows runs cuBLAS at
    64 rows. Above 64 rows torch.matmul runs as it is."""
    from llama_box_tpu_torch.ops.qmatmul import dense_matmul, mm
    K, N = kn
    rng = np.random.default_rng(K)
    x = _x(rng, 100, K, cuda, dtype)
    w = _x(rng, K, N, cuda, dtype) * 0.02
    four = mm(x[8:12], w)
    assert torch.equal(dense_matmul(x[:36], w)[8:12], four)
    assert torch.equal(mm(x[:64].reshape(8, 8, K), w).reshape(64, N)[8:12],
                       four)
    assert torch.equal(mm(x[8:9], w), four[:1])
    torch.testing.assert_close(mm(x, w), torch.matmul(x, w), rtol=0,
                               atol=0)


# -- multimodal prompts: the towers and the embedding-chunk prefill ----------

import chip_smoke  # noqa: E402  (its mmproj writer; no JAX there either)

_TOWERS = {
    "clip": dict(kind="clip", proj="mlp", E=64, H=4, FF=128, L=2, img=56,
                 patch=14, out=64),
    "qwen2vl": dict(kind="qwen2vl", proj="qwen2vl_merger", E=64, H=4,
                    FF=128, L=2, img=56, patch=14, out=64),
    "whisper": dict(kind="whisper", proj="qwen2a", E=64, H=4, FF=128, L=2,
                    mels=128, out=64),
}


@pytest.mark.parametrize("kind", sorted(_TOWERS))
def test_tower_on_the_card_matches_its_cpu_run(cuda, tmp_path, kind):
    """A vision or audio tower (plain torch ops in f32) on the card against
    the same tower on the CPU, within 1e-4 x max|CPU|."""
    from llama_box_tpu_torch.cli import load_multimodal
    path = str(tmp_path / "mmproj.gguf")
    chip_smoke.write_mmproj(path, kind, 0, _TOWERS[kind])
    card = load_multimodal(path, 64, cuda)
    host = load_multimodal(path, 64, "cpu")
    if kind == "whisper":
        data = chip_smoke.wav_bytes(1.0, 3)
        got, _ = card.encode_audio(data)
        want, _ = host.encode_audio(data)
    else:
        data = chip_smoke.png_bytes(90, 50, 3)
        got, _ = card.encode(data)
        want, _ = host.encode(data)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _span_logits(cfg, params, emb, span, plain=False):
    """A 24-token text chunk, then the embedding rows at position 24 (with
    the bidirectional span over them, or none), into slot 1 of a 2-slot
    cache (the slot an operand, as the engine passes it): the last row's
    logits, through the flash prefill kernel or its plain version."""
    from llama_box_tpu_torch.models import llama
    kv = llama.init_kv_cache(cfg, 2, 256, torch.bfloat16, device="cuda")
    slot = torch.tensor([1], device="cuda")
    cos, sin = llama.make_rope(cfg, 256, device="cuda")
    n = emb.shape[1]
    saved = llama.flash_prefill_batched
    try:
        if plain:
            llama.flash_prefill_batched = fp_mod.flash_prefill_plain
        llama.prefill_batch_impl(params, cfg,
                                 torch.arange(3, 27, device="cuda")[None],
                                 [0], [24], kv, cos, sin, slots=slot)
        lg, _ = llama.prefill_batch_impl(
            params, cfg, None, [24], [n], kv, cos, sin, embeds=emb,
            bidir=torch.tensor([[24, 24 + n] if span else [0, 0]],
                               device="cuda"), slots=slot)
    finally:
        llama.flash_prefill_batched = saved
    assert not kv.k[:, 0].any()         # slot 0 untouched
    return lg[0].float()


def test_embedding_chunk_with_a_span_matches_the_plain_version(cuda,
                                                              tiny_model):
    """An embedding chunk under gemma3's bidirectional span, on each
    weights path: the kernel's logits against its plain version (cosine
    >= 0.999, 2e-2 x max), and the span changes them."""
    _, cfg, params, _ = tiny_model
    rng = np.random.default_rng(7)
    emb = torch.from_numpy(rng.standard_normal(
        (1, 40, cfg.n_embd)).astype(np.float32)).to(cuda, torch.bfloat16)
    before = flash_prefill_batched.launches
    kern = _span_logits(cfg, params, emb, True)
    assert flash_prefill_batched.launches > before
    plain = _span_logits(cfg, params, emb, True, plain=True)
    causal = _span_logits(cfg, params, emb, False)
    cos = torch.nn.functional.cosine_similarity(kern, plain, dim=0)
    assert cos >= 0.999, float(cos)
    torch.testing.assert_close(kern, plain, rtol=0,
                               atol=BF16_ATOL * float(plain.abs().max()))
    assert not torch.equal(kern, causal)


def test_multimodal_chat_graphs_equal_eager(cuda, tiny_model):
    """A chat of token and embedding chunks (the engine's single-slot
    path, one graph a key) gives the same greedy tokens with graphs and
    eagerly, and again from the prefix cache; four such chats at once, one
    a slot, too, and the graphs' keys name no slot: one graph a (kind,
    bucket) serves every slot."""
    from llama_box_tpu_torch.sampling import SamplerParams
    from llama_box_tpu_torch.server.task import CompletionsTask
    _, cfg, _, tok = tiny_model
    rng = np.random.default_rng(9)
    emb = rng.standard_normal((45, cfg.n_embd)).astype(np.float32)
    chunks = [("tokens", [1, 40, 41, 42, 43]),
              ("embed", emb, [-(10 ** 6) - i for i in range(45)]),
              ("tokens", [44, 45, 46])]
    flat = [t for ch in chunks for t in (ch[2] if ch[0] == "embed"
                                         else ch[1])]

    def lead(i):        # the chat with another first chunk
        ch = [("tokens", [1, 50 + i, 41, 42, 43])] + chunks[1:]
        return [1, 50 + i] + flat[2:], ch

    out = {}
    for graphs in (True, False):
        eng = _engine(tiny_model, graphs, start=True)
        try:
            runs = []
            for _ in range(3):
                t = CompletionsTask(list(flat),
                                    SamplerParams(temp=0.0, ignore_eos=True),
                                    tokenizer=tok, max_tokens=24,
                                    chunks=chunks)
                eng.submit(t)
                runs.append(chip_smoke.wait_final(t))
            assert runs[-1].n_cached >= len(flat) - 1
            par = [CompletionsTask(f, SamplerParams(temp=0.0,
                                                    ignore_eos=True),
                                   tokenizer=tok, max_tokens=24, chunks=c)
                   for f, c in map(lead, range(4))]
            for t in par:
                eng.submit(t)
            runs += [chip_smoke.wait_final(t) for t in par]
            out[graphs] = [r.generated for r in runs]
            if graphs:
                keys = [k for k in eng.graphs._graphs
                        if k[0] == "prefill_mm"]
                assert keys and all(len(k) == 3 for k in keys), keys
        finally:
            eng.stop()
    assert out[True][0] == out[True][1] == out[True][2] == out[False][0]
    assert out[True] == out[False]


def test_grouped_media_chat_cached_repeat_keeps_the_cold_bits(
        cuda, wide_path_model):
    """On grouped weights a media chat whose last text chunk is longer
    than 64 rows, served cold and then again from the prefix cache (all
    but its last token cached: a one-token chunk): the first answer
    token's logits are bit-equal and so are the texts. A single-slot
    chunk's pass holds its bucket's rows, and grouped calls of at most 64
    rows split the in-dim (other bits), so the engine keeps only media
    buckets above 64 rows (Engine.mm_buckets). At TinyLlama's widths."""
    if wide_path_model[0] != "q4":
        pytest.skip("the grouped GEMM's row regimes: grouped weights only")
    from llama_box_tpu_torch.sampling import SamplerParams
    from llama_box_tpu_torch.server.task import CompletionsTask
    _, cfg, _, tok = wide_path_model
    rng = np.random.default_rng(17)
    emb = rng.standard_normal((45, cfg.n_embd)).astype(np.float32)
    tail = rng.integers(300, 500, 100).tolist()
    chunks = [("tokens", [1, 40, 41, 42, 43]),
              ("embed", emb, [-(10 ** 6) - i for i in range(45)]),
              ("tokens", tail)]
    flat = [t for ch in chunks for t in (ch[2] if ch[0] == "embed"
                                         else ch[1])]
    eng = _engine(wide_path_model, True, start=True, n_ubatch=128,
                  n_ctx=4 * 512)
    try:
        assert min(eng.mm_buckets) > 64
        runs = []
        for _ in range(2):
            t = CompletionsTask(list(flat),
                                SamplerParams(temp=0.0, ignore_eos=True),
                                tokenizer=tok, max_tokens=16, chunks=chunks)
            _, task, logits = chip_smoke.served_request(
                eng, lambda t=t: (eng.submit(t), chip_smoke.wait_final(t)))
            runs.append((task.n_cached, task.generated, logits))
    finally:
        eng.stop()
    assert runs[0][0] == 0 and runs[1][0] == len(flat) - 1
    assert torch.equal(runs[0][2], runs[1][2])
    assert runs[0][1] == runs[1][1]


def _lora_stacks(tiny, tmp_path, n_ad=2, rank=16, seed=5):
    """The tiny model's params (a shallow copy) with n_ad random adapters
    on every projection stacked for per-request scales
    (models/lora.stack_dynamic)."""
    from llama_box_tpu_torch.gguf import GGUFWriter
    from llama_box_tpu_torch.models.lora import load_lora, stack_dynamic
    _, cfg, params, _ = tiny
    E, F, hd, kvd = cfg.n_embd, cfg.n_ff, cfg.n_heads * cfg.head_dim, \
        cfg.n_kv_heads * cfg.head_dim
    shapes = {"attn_q": (hd, E), "attn_k": (kvd, E), "attn_v": (kvd, E),
              "attn_output": (E, hd), "ffn_gate": (F, E), "ffn_up": (F, E),
              "ffn_down": (E, F)}
    rng = np.random.default_rng(seed)
    ads = []
    for a in range(n_ad):
        path = str(tmp_path / f"lora{a}.gguf")
        w = GGUFWriter(path, architecture="llama")
        w.add_kv("general.type", "adapter")
        w.add_kv("adapter.type", "lora")
        w.add_kv("adapter.lora.alpha", float(2 * rank))
        for i in range(cfg.n_layers):
            for t, (o, n) in shapes.items():
                w.add_tensor(f"blk.{i}.{t}.weight.lora_a",
                             rng.standard_normal((rank, n), dtype=np.float32)
                             * 0.05)
                w.add_tensor(f"blk.{i}.{t}.weight.lora_b",
                             rng.standard_normal((o, rank), dtype=np.float32)
                             * 0.05)
        w.write()
        ads.append(load_lora(path))
    p = dict(params, layers=dict(params["layers"]))
    assert stack_dynamic(p, cfg, ads) == n_ad
    return cfg, p


def test_lora_delta_rows_keep_their_bits(cuda, tiny_model, tmp_path):
    """A row's LoRA delta (models/llama._lora_delta: f32 products through
    dense_matmul) has the same bits in calls of 1, 4, 36 and 64 rows, as
    the projections' kernels do: verify rows equal one-row steps under
    per-request LoRA."""
    from llama_box_tpu_torch.models import llama
    from llama_box_tpu_torch.models.loader import fuse_projections
    if tiny_model[0] != "bf16":
        pytest.skip("the delta is the same f32 code on every path")
    cfg, p = _lora_stacks(tiny_model, tmp_path)
    lp = llama.layer_params(fuse_projections(p, cfg))[0]
    rng = np.random.default_rng(41)
    h = torch.from_numpy(rng.standard_normal(
        (64, 1, cfg.n_embd), dtype=np.float32)).to(cuda, torch.bfloat16)
    scales = torch.from_numpy(rng.uniform(0, 1, (64, 2)).astype(
        np.float32)).to(cuda)
    for key in ("wq", "wo", "w_gate", "w_down"):
        x = h if key != "w_down" else torch.from_numpy(rng.standard_normal(
            (64, 1, cfg.n_ff), dtype=np.float32)).to(cuda, torch.bfloat16)
        if key == "wo":
            x = x[..., :cfg.n_heads * cfg.head_dim]
        full = llama._lora_delta(x, lp, key, scales)
        for m in (1, 4, 36):
            assert torch.equal(llama._lora_delta(x[:m], lp, key, scales[:m]),
                               full[:m]), (key, m)


def test_lora_scale_rows_change_between_replays(cuda, tiny_model, tmp_path):
    """The [S, n_ad] scale rows are a staged operand: a captured decode
    chain replayed after a slot's row changed (the engine's _set_lora_row)
    gives the eager engine's bits under the new rows, for two different
    rows, and nothing is captured again."""
    from llama_box_tpu_torch.server.engine import Engine, EngineConfig
    cfg, p = _lora_stacks(tiny_model, tmp_path)
    tok = tiny_model[3]
    engines = []
    for graphs in (True, False):
        eng = Engine(cfg, p, tok, EngineConfig(
            n_slots=4, n_ctx=4 * 256, n_ubatch=32, kv_dtype="bfloat16",
            decode_chain=16, cuda_graphs=graphs), device="cuda")
        eng.configure_lora(2, [1.0, 0.5])
        eng.fuse_params()
        engines.append(eng)
    rng = np.random.default_rng(83)
    chunks = {b: (0, rng.integers(300, 500, n).tolist())
              for b, n in ((0, 32), (1, 20), (3, 7))}
    rows = [((0, 0.0),), ((1, 2.0), (0, 0.25))]
    logits = []
    for it in range(4):
        outs = []
        for eng in engines:
            if it >= 2:     # slot 0's and slot 3's rows change
                eng._set_lora_row(0, rows[it - 2])
                eng._set_lora_row(3, rows[3 - it])
            _stage_prefill(eng, chunks, 32)
            eng._refresh_arrs()
            pre = eng.graphs.run(("prefill", 32),
                                 lambda e=eng: e._prefill_program(32))
            tok0 = pre[0].cpu().tolist()
            _stage_decode(eng, [tok0[0], tok0[1], None, tok0[3]],
                          [32, 20, 0, 7])
            dec = eng.graphs.run(("decode", 16, False, 64),
                                 lambda e=eng: e._decode_program(
                                     16, samp_extras=False, samp_kcap=64))
            torch.cuda.synchronize()
            outs.append([t.clone() for t in (*pre, *dec)]
                        + [t.clone() for t in eng.kv if t is not None])
        for a, b in zip(*outs):
            assert torch.equal(a, b), it
        logits.append(outs[0][4])                   # the prefill's
    assert torch.equal(logits[0], logits[1])
    assert not torch.equal(logits[1], logits[2])
    assert not torch.equal(logits[2], logits[3])
    assert engines[0].graphs.n_graphs == 2
    assert engines[0]._lora_rows.tolist()[3] == [0.0, 0.5]


# -- the recurrent kernels: csrc/ssm_scan.cu and csrc/wkv.cu ---------------

# (C, steps a row nh, B/C groups G, states ds, decay per state): the tiny
# fixtures' widths and the published ones chip_smoke.py serves
_SSM_CASES = {
    "tiny mamba1": (128, 128, 1, 8, True),
    "tiny mamba2": (64, 8, 1, 16, False),
    "mamba-1.4b": (4096, 4096, 1, 16, True),
    "jamba2-3b": (5120, 5120, 1, 16, True),
    "granite-4.0-h-micro": (4096, 64, 1, 128, False),
    "mamba2 4 groups": (512, 16, 4, 64, False),
}
# (mode, H, Hk, N): rwkv6 / rwkv7 at the fixtures' and RWKV-1.5B's heads,
# the delta rule at qwen3-next's 32 v-heads over 16 k-heads of 128
_WKV_CASES = {
    "rwkv6 tiny": ("wkv6", 4, 4, 16), "rwkv6 h32x64": ("wkv6", 32, 32, 64),
    "rwkv7 tiny": ("wkv7", 4, 4, 16), "rwkv7 h32x64": ("wkv7", 32, 32, 64),
    "delta tiny": ("delta", 4, 2, 16), "delta 32/16x128": ("delta", 32, 16,
                                                           128),
}
_REC_REL = 1e-5


def _ssm_inputs(g, dev, case, S, T):
    C, nh, G, ds, per_state = _SSM_CASES[case]

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dev)
    x = r(S, T, C)
    dt = torch.nn.functional.softplus(r(S, T, nh) - 2.0)
    A = -torch.exp(r(C, ds) if per_state else r(nh))
    return dict(x=x, dt=dt, A=A, B=r(S, T, G, ds), Cm=r(S, T, G, ds),
                D=r(nh), state=r(S, C, ds, s=0.5))


def _ssm_call(fn, inp, lens, state):
    return fn(inp["x"], inp["dt"], inp["A"], inp["B"], inp["Cm"], inp["D"],
              lens, state)


def _close_rel(got, want, valid_rows):
    for b, n in enumerate(valid_rows):
        if not n:
            continue
        w = want[b, :n]
        err = float((got[b, :n] - w).abs().max())
        assert err <= _REC_REL * float(w.abs().max()), (b, err)


@pytest.mark.parametrize("case", sorted(_SSM_CASES))
def test_ssm_scan_kernel_matches_plain(cuda, case):
    """Within 1e-5 x max|plain| at seq_lens 0, a part of T and T; a
    masked slot's state (NaN here) keeps its bits, the others agree."""
    from llama_box_tpu_torch.ops import ssm_scan as ss
    g = torch.Generator().manual_seed(1)
    S, T = 3, 24
    inp = _ssm_inputs(g, cuda, case, S, T)
    lens = torch.tensor([0, 11, T], device=cuda)
    inp["state"][0] = float("nan")
    st_k, st_p = inp["state"].clone(), inp["state"].clone()
    y = _ssm_call(ss.ssm_scan, inp, lens, st_k)
    want = _ssm_call(ss.ssm_scan_plain, inp, lens, st_p)
    assert torch.isnan(st_k[0]).all()
    _close_rel(y, want, [0, 11, T])
    err = float((st_k[1:] - st_p[1:]).abs().max())
    assert err <= _REC_REL * float(st_p[1:].abs().max())


@pytest.mark.parametrize("case", sorted(_SSM_CASES))
def test_ssm_scan_split_and_one_row_keep_the_bits(cuda, case):
    """A prefill of P + Q rows gives the state and outputs of P then Q,
    and a one-row call those of the row after a P-row prefill, bit for
    bit."""
    from llama_box_tpu_torch.ops.ssm_scan import ssm_scan
    g = torch.Generator().manual_seed(2)
    S, T, P = 2, 20, 13
    inp = _ssm_inputs(g, cuda, case, S, T)
    full = T * torch.ones(S, dtype=torch.int32, device=cuda)
    st = inp["state"].clone()
    y = _ssm_call(ssm_scan, inp, full, st)
    st2 = inp["state"].clone()
    parts = []
    for a, b in ((0, P), (P, P + 1), (P + 1, T)):
        sub = {k: (v[:, a:b].contiguous() if k in ("x", "dt", "B", "Cm")
                   else v) for k, v in inp.items()}
        parts.append(_ssm_call(ssm_scan, sub, (b - a) * torch.ones_like(full),
                               st2))
    assert torch.equal(torch.cat(parts, dim=1), y)
    assert torch.equal(st2, st)


def _wkv_inputs(g, dev, case, S, T):
    mode, H, Hk, N = _WKV_CASES[case]

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dev)
    if mode == "delta":
        q = torch.nn.functional.normalize(r(S, T, Hk, N), dim=-1)
        k = torch.nn.functional.normalize(r(S, T, Hk, N), dim=-1)
        return mode, (q, k, r(S, T, H, N), torch.sigmoid(r(S, T, H) + 2),
                      torch.sigmoid(r(S, T, H))), r(S, H, N, N, s=0.3)
    w = torch.exp(-torch.exp(r(S, T, H, N) - 1.0))
    if mode == "wkv6":
        return mode, (r(S, T, H, N), r(S, T, H, N, s=0.3),
                      r(S, T, H, N, s=0.3), w, r(H, N, s=0.3)), \
            r(S, H, N, N, s=0.3)
    kk = torch.nn.functional.normalize(r(S, T, H, N), dim=-1)
    return mode, (r(S, T, H, N), w, r(S, T, H, N, s=0.3),
                  r(S, T, H, N, s=0.3), kk, torch.sigmoid(r(S, T, H, N))), \
        r(S, H, N, N, s=0.3)


def _wkv_fns(mode):
    from llama_box_tpu_torch.ops import wkv
    name = {"delta": "delta_rule"}.get(mode, mode)
    return getattr(wkv, name), getattr(wkv, name + "_plain")


def _wkv_slice(mode, args, a, b):
    """The per-step operands' rows a..b (u stays whole)."""
    return tuple(t if (mode == "wkv6" and i == 4) else
                 t[:, a:b].contiguous() for i, t in enumerate(args))


@pytest.mark.parametrize("case", sorted(_WKV_CASES))
def test_wkv_kernel_matches_plain(cuda, case):
    g = torch.Generator().manual_seed(3)
    S, T = 3, 24
    mode, args, s0 = _wkv_inputs(g, cuda, case, S, T)
    fn, plain = _wkv_fns(mode)
    lens = torch.tensor([0, 9, T], device=cuda)
    s0[0] = float("nan")
    sk, sp = s0.clone(), s0.clone()
    y = fn(*args, lens, sk)
    want = plain(*args, lens, sp)
    assert torch.isnan(sk[0]).all()
    _close_rel(y, want, [0, 9, T])
    err = float((sk[1:] - sp[1:]).abs().max())
    assert err <= _REC_REL * float(sp[1:].abs().max())


@pytest.mark.parametrize("case", sorted(_WKV_CASES))
def test_wkv_split_and_one_row_keep_the_bits(cuda, case):
    g = torch.Generator().manual_seed(4)
    S, T, P = 2, 20, 13
    mode, args, s0 = _wkv_inputs(g, cuda, case, S, T)
    fn, _ = _wkv_fns(mode)
    full = torch.full((S,), T, dtype=torch.int32, device=cuda)
    st = s0.clone()
    y = fn(*args, full, st)
    st2 = s0.clone()
    parts = [fn(*_wkv_slice(mode, args, a, b), torch.full_like(full, b - a),
                st2) for a, b in ((0, P), (P, P + 1), (P + 1, T))]
    assert torch.equal(torch.cat(parts, dim=1), y)
    assert torch.equal(st2, st)


@pytest.fixture(scope="module", params=["mamba", "rwkv7"])
def tiny_rec(request, tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from llama_box_tpu_torch.gguf import GGUFFile
    from llama_box_tpu_torch.models.loader import load_model
    from llama_box_tpu_torch.tokenizer import Tokenizer

    from .fixtures.make_tiny_mamba import write_tiny_mamba
    from .fixtures.make_tiny_rwkv import write_tiny_rwkv7
    path = str(tmp_path_factory.mktemp("tiny_rec") / f"{request.param}.gguf")
    {"mamba": write_tiny_mamba, "rwkv7": write_tiny_rwkv7}[request.param](
        path)
    cfg, params = load_model(path, dtype=torch.bfloat16, device="cuda")
    with GGUFFile(path) as g:
        tok = Tokenizer.from_gguf(g)
    return request.param, cfg, params, tok


def test_recurrent_engine_greedy_chains_graphs_and_kernels(cuda, tiny_rec):
    """On the tiny mamba and rwkv7 (bf16): greedy texts at K = 1 equal K =
    16, graphs equal eager, and the engine's scan kernel launched."""
    from llama_box_tpu_torch.ops import ssm_scan as ss
    from llama_box_tpu_torch.ops import wkv
    from llama_box_tpu_torch.sampling import SamplerParams
    from llama_box_tpu_torch.server.engine import Engine, EngineConfig
    from llama_box_tpu_torch.server.task import CompletionsTask
    name, cfg, params, tok = tiny_rec
    prompts = [[1] + list(range(40 + 7 * i, 52 + 9 * i)) for i in range(3)]

    def run(chain, graphs):
        eng = Engine(cfg, params, tok, EngineConfig(
            n_slots=4, n_ctx=4 * 128, n_ubatch=32, decode_chain=chain,
            cuda_graphs=graphs, pipeline_chain=graphs), device="cuda")
        eng.start()
        try:
            tasks = [CompletionsTask(p, SamplerParams(temp=0.0,
                                                      ignore_eos=True),
                                     tokenizer=tok, max_tokens=24)
                     for p in prompts]
            for t in tasks:
                eng.submit(t)
            out = []
            for t in tasks:
                while True:
                    kind, payload = t.result_q.get(timeout=300)
                    if kind == "error":
                        raise payload
                    if kind == "final":
                        out.append(payload.generated)
                        break
            return out
        finally:
            eng.stop()
    ss.ssm_scan.launches = 0
    wkv.wkv_kernel.launches = 0
    want = run(16, True)
    n = ss.ssm_scan.launches if name == "mamba" else wkv.wkv_kernel.launches
    assert n > 0
    assert run(1, True) == want
    assert run(16, False) == want
