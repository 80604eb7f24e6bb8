"""Quantized-resident weights: QTensor and its matmuls (counterpart of
llama_box_tpu/ops/qmatmul.py).

Two residencies, chosen at load time by `pack_repacked` from the JAX
package's switches (LLAMA_BOX_TPU_PACKED4, _Q4_INT8, _Q4_F32SCALES):

- w8a8 (the default, no switch set): every block-quant projection as
  per-output-column symmetric int8 codes (`pack_w8a8`). A matmul quantizes
  its activations per row to int8 and runs s8 x s8 -> s32
  (`w8a8_matmul`, csrc/w8a8_matmul.cu).
- grouped (any switch set): the GGUF group quantization kept as it is,
  w = s * q - m per group of rows, dequantized inside the matmul
  (`q4_matmul` for nibble-packed codes, `q8_matmul` for int8 codes; one
  kernel template in csrc/q_matmul.cu, one launch a call): bf16 weights,
  bf16 activations, f32 sums, f32 or bf16 out.

Layout ([in, out] matmul convention; the loader transposes GGUF [out, in]),
each optionally stacked over layers as [L, ...]:
- w8a8: qs int8 [in, out]; scales f32 [out]: w[i, o] = qs[i, o] * scales[o].
- grouped, 4-bit formats (Q4_0, Q4_1, Q4_K, Q2_K) unless _Q4_INT8: qs int8
  [in/2, out] in HALVES packing: byte row r holds row r in its low nibble
  and row r + in/2 in its high nibble (`packed4`).
- grouped, other formats (or _Q4_INT8): qs int8 codes [in, out].
- grouped scales and mins [in/group, out], bf16 (f32 under
  _Q4_F32SCALES); mins None for formats without them (Q8_0, Q6_K):
  w[i, o] = scales[i // group, o] * q[i, o] - mins[i // group, o].

On a CUDA tensor each matmul launches its hand-written kernel; on a CPU
tensor it runs its `*_plain` version, the same function in torch. `mm`,
the model's dispatch, sends a grouped weight with a CPU x to
`q_matmul_ref` instead, as the JAX package does off the TPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import _kernels


class QTensor:
    """Packed quantized 2D weight (or a [L, ...] stack of them), with the
    JAX QTensor's fields. `w8a8` marks per-column int8 weights with f32
    column scales; `group`/`packed4`/`mins` describe the grouped forms."""

    def __init__(self, qs: torch.Tensor, scales: torch.Tensor,
                 mins: torch.Tensor | None, in_dim: int, group: int,
                 packed4: bool, w8a8: bool = False):
        self.qs = qs
        self.scales = scales
        self.mins = mins
        self.in_dim = in_dim
        self.group = group
        self.packed4 = packed4
        self.w8a8 = w8a8

    @property
    def out_dim(self) -> int:
        return self.qs.shape[-1]

    def leaves(self) -> list[torch.Tensor]:
        return [t for t in (self.qs, self.scales, self.mins) if t is not None]

    def _map(self, fn) -> "QTensor":
        return QTensor(fn(self.qs), fn(self.scales),
                       None if self.mins is None else fn(self.mins),
                       self.in_dim, self.group, self.packed4, self.w8a8)

    def to(self, device) -> "QTensor":
        return self._map(lambda t: t.to(device))

    def unbind(self, dim: int = 0) -> list["QTensor"]:
        """Per-layer views of a layer-stacked QTensor (dim 0 only)."""
        if dim != 0:
            raise ValueError("QTensor.unbind: layers stack along dim 0")
        n = self.qs.shape[0]
        return [self._map(lambda t, i=i: t[i]) for i in range(n)]

    def __repr__(self):
        return (f"QTensor(in={self.in_dim}, out={self.out_dim}, "
                f"group={self.group}, packed4={self.packed4}, "
                f"w8a8={self.w8a8})")


def pack_repacked(rt, shape_in_out: tuple[int, int],
                  device=None) -> QTensor:
    """RepackedTensor (flat, GGUF [out, in] row-major order) -> QTensor in
    [in, out] layout. The residency follows the JAX package's switches,
    read here at load time: none set gives w8a8 (`pack_w8a8`, packed on
    `device`); any of LLAMA_BOX_TPU_PACKED4, _Q4_INT8, _Q4_F32SCALES gives
    the grouped layout as host tensors, 4-bit codes nibble-packed unless
    _Q4_INT8, scales and mins bf16 (round to nearest even, as ml_dtypes)
    unless _Q4_F32SCALES."""
    if not (os.environ.get("LLAMA_BOX_TPU_PACKED4")
            or os.environ.get("LLAMA_BOX_TPU_Q4_INT8")
            or os.environ.get("LLAMA_BOX_TPU_Q4_F32SCALES")):
        return pack_w8a8(rt, shape_in_out, device)
    f32_scales = bool(os.environ.get("LLAMA_BOX_TPU_Q4_F32SCALES"))
    out_dim, in_dim = shape_in_out[1], shape_in_out[0]
    q = rt.q.reshape(out_dim, in_dim).T                      # [in, out]
    scales = rt.scales.reshape(out_dim, in_dim // rt.group).T
    mins = (rt.mins.reshape(out_dim, in_dim // rt.group).T
            if rt.mins is not None else None)
    packed4 = rt.qbits == 4 and not os.environ.get("LLAMA_BOX_TPU_Q4_INT8")
    if packed4:
        half = in_dim // 2
        if in_dim % 2 or half % rt.group:
            raise ValueError(f"pack_repacked: in={in_dim} cannot be nibble-"
                             f"packed in groups of {rt.group}")
        qs = (q[:half].astype(np.uint8)
              | (q[half:].astype(np.uint8) << 4)).astype(np.int8)
    else:
        qs = q.astype(np.int8)

    def sc(a):
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        return t if f32_scales else t.to(torch.bfloat16)
    return QTensor(torch.from_numpy(np.ascontiguousarray(qs)), sc(scales),
                   None if mins is None else sc(mins), in_dim, rt.group,
                   packed4)


# output columns requantized at a time by pack_w8a8 (its f32 temporaries)
_PACK_COLS = 4096


def pack_w8a8(rt, shape_in_out: tuple[int, int], device=None) -> QTensor:
    """RepackedTensor -> per-column int8 residency (W8A8), tensors on
    `device` (the host by default). The group quantization is dequantized
    exactly, then requantized symmetric int8 per output column: the JAX
    arithmetic (every step one correctly rounded operation, so the bits
    are the same on any device), in torch on `device`, _PACK_COLS output
    columns at a time."""
    out_dim, in_dim = shape_in_out[1], shape_in_out[0]
    dev = torch.device(device or "cpu")
    n_g = in_dim // rt.group

    def put(a, cols):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev).view(-1,
                                                                      cols)
    q = put(rt.q, in_dim)                             # GGUF [out, in]
    scales = put(rt.scales, n_g)
    mins = None if rt.mins is None else put(rt.mins, n_g)
    q8 = torch.empty(out_dim, in_dim, dtype=torch.int8, device=dev)
    col = torch.empty(out_dim, dtype=scales.dtype, device=dev)
    for o in range(0, out_dim, _PACK_COLS):
        s = slice(o, o + _PACK_COLS)
        wf = q[s].float() * scales[s].repeat_interleave(rt.group, dim=1)
        if mins is not None:
            wf = wf - mins[s].repeat_interleave(rt.group, dim=1)
        amax = wf.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
        c = amax / torch.full_like(amax, 127.0)
        q8[s] = torch.round(wf / c).clamp(-127, 127).to(torch.int8)
        col[s] = c[:, 0]
    return QTensor(q8.T.contiguous(), col.float(), None, in_dim, in_dim,
                   packed4=False, w8a8=True)


# -- the w8a8 matmul -----------------------------------------------------------


def _quant_rows(hf: torch.Tensor):
    """Per-row symmetric int8 of f32 rows: codes round(h / xs) (half to
    even) clipped to +-127, xs = max(amax, 1e-12) / 127 [..., 1] f32.
    Both divisions are true divisions by tensors: on CUDA, torch turns a
    division by a Python scalar into a multiply by its reciprocal, which
    moves xs by an ulp."""
    amax = hf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    xs = amax / torch.full_like(amax, 127.0)
    xq = torch.round(hf / xs).clamp(-127, 127).to(torch.int8)
    return xq, xs


def _int_dot(xq: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """s8 x s8 -> exact integer sums, as f32 (rounded once, as an s32 sum
    converted to f32). The sums are formed in float64, exact below 2**53,
    because CUDA has no general integer matmul."""
    return torch.matmul(xq.double(), qs.double()).float()


def w8a8_matmul_plain(x: torch.Tensor, qs: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """The plain torch version of the kernel (any device): x [M, in] any
    float dtype -> [M, out] f32 = s32(xq @ qs) * xs * scales."""
    xq, xs = _quant_rows(x.float())
    return _int_dot(xq, qs) * xs * scales.float()[None, :]


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"w8a8_matmul: {what}")


# csrc/w8a8_matmul.cu: 64 x 64 output tiles on mma.sync walk the in-dim in
# steps of 64 (up to _W8_SMALL_ROWS rows, and shapes TMA cannot take);
# above, 128 x 128 or 256 x 128 tiles on TMA and wgmma in steps of 128, one
# block an SM of the 132 of an H100; at most 8 splits. _W8_BIG_COST: the
# time of a 256-row tile over a 128-row one's, tuned on the H100 at
# TinyLlama's projections.
_W8_SMALL_ROWS, _W8_MAX_SPLITS, _SMS, _W8_BIG_COST = 64, 8, 132, 1.4


def _w8a8_plan(M: int, N: int, K: int, tma: bool = True) -> tuple[int, int]:
    """(tile rows bm, in-dim splits) of a w8a8_matmul call, from its shape
    alone (`tma`: K a multiple of 8, N of 16 and the weight 16-byte
    aligned). bm 64, the mma.sync kernel, at most _W8_SMALL_ROWS rows or
    without `tma`, with as many splits as keep the blocks within four an SM
    (up to 8 and the in-dim's 64-deep steps; its blocks are 128 threads and
    10 KB). Else, where 128-row tiles fill a wave: bm 256 if its waves x
    _W8_BIG_COST are fewer than the 128-row tiles' waves, else 128, and no
    split; below a wave, bm 128 and the split count (up to 8 and the
    in-dim's 128-deep steps) that minimises waves x (steps a split + 2), the
    2 standing for a block's start and epilogue, ties to the fewer. Integer
    sums are exact, so neither ever changes a bit of the result."""
    if M <= _W8_SMALL_ROWS or not tma:
        tiles = -(-M // 64) * -(-N // 64)
        steps = -(-(-(-K // 16) * 16) // 64)
        return 64, max(1, min(_W8_MAX_SPLITS, steps, 4 * _SMS // tiles))
    cols, steps = -(-N // 128), -(-K // 128)
    tiles = -(-M // 128) * cols
    if tiles >= _SMS:
        big = -(-(-(-M // 256) * cols) // _SMS) * _W8_BIG_COST
        return (256 if big < -(-tiles // _SMS) else 128), 1

    def cost(s: int) -> int:
        return -(-tiles * s // _SMS) * (-(-steps // s) + 2)
    return 128, min(range(1, min(_W8_MAX_SPLITS, steps) + 1),
                    key=lambda s: (cost(s), s))


def w8a8_quant_rows(x: torch.Tensor):
    """The row-quantize pass of w8a8_matmul alone: x [M, in] (bf16 or f32)
    -> (codes int8 [M, roundup(in, 16)], zero past in; scales f32 [M]). A
    CUDA x launches the pass of csrc/w8a8_matmul.cu; a CPU x takes
    _quant_rows."""
    M, K = x.shape
    kp = (K + 15) // 16 * 16                  # codes rows padded to 16 B
    if not x.is_cuda:
        xq, xs = _quant_rows(x.float())
        return torch.nn.functional.pad(xq, (0, kp - K)), xs[:, 0]
    _check(x.dtype in (torch.bfloat16, torch.float32), f"x dtype {x.dtype}")
    x = x.contiguous()
    xq = torch.empty((M, kp), dtype=torch.int8, device=x.device)
    xs = torch.empty((M,), dtype=torch.float32, device=x.device)
    if M:
        _kernels.call("w8a8_matmul", "lbt_w8a8_quant_rows",
                      _kernels.DTYPE_CODES[x.dtype], x, xq, xs, M, K)
    return xq, xs


def w8a8_matmul(x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor, *,
                out: torch.Tensor | None = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x [M, in] (bf16 or f32) -> [M, out]: f32, or with
    out_dtype=torch.bfloat16 the f32 result rounded once to bf16 (as
    `.to(torch.bfloat16)` of it). A CUDA x launches csrc/w8a8_matmul.cu (a
    row-quantize pass, then the int8 GEMM as its programmatic dependent,
    tiles and splits from _w8a8_plan); a CPU x takes the plain version.
    `out` may name a contiguous [M, out] tensor of out_dtype to write
    into."""
    _check(out_dtype in (torch.float32, torch.bfloat16),
           f"out_dtype {out_dtype}: f32 or bf16")
    if not x.is_cuda:
        res = w8a8_matmul_plain(x, qs, scales).to(out_dtype)
        return res if out is None else out.copy_(res)
    M, K = x.shape
    N = qs.shape[-1]
    dev = x.device
    _check(x.dtype in (torch.bfloat16, torch.float32), f"x dtype {x.dtype}")
    _check(qs.dtype == torch.int8 and tuple(qs.shape) == (K, N),
           f"qs {qs.dtype} {tuple(qs.shape)} for x {tuple(x.shape)}")
    _check(K * 127 * 127 < 2 ** 31, f"in={K}: the s32 sum could overflow")
    _check(N % 4 == 0, f"out={N} must be a multiple of 4 (4-byte loads)")
    x = x.contiguous()
    qs = qs.contiguous()
    _check(qs.device == dev and qs.data_ptr() % 4 == 0,
           "qs must be a 4-byte aligned tensor on x's device")
    scales = scales.to(dev, torch.float32).contiguous()
    _check(tuple(scales.shape) == (N,) and scales.data_ptr() % 16 == 0,
           "scales must be a 16-byte aligned [out] tensor")
    if out is None:
        out = torch.empty((M, N), dtype=out_dtype, device=dev)
    _check(out.dtype == out_dtype and tuple(out.shape) == (M, N)
           and out.is_contiguous() and out.device == dev
           and out.data_ptr() % 16 == 0,
           f"out must be a contiguous, 16-byte aligned {out_dtype} "
           f"{(M, N)} tensor on x's device")
    if not M:
        return out
    kp = (K + 15) // 16 * 16                  # codes rows padded to 16 B
    xq = torch.empty((M, kp), dtype=torch.int8, device=dev)
    xs = torch.empty((M,), dtype=torch.float32, device=dev)
    bm, S = _w8a8_plan(M, N, K, tma=K % 8 == 0 and N % 16 == 0
                       and qs.data_ptr() % 16 == 0)
    part = cnt = None
    if S > 1:
        part = torch.empty((S, M, N), dtype=torch.int32, device=dev)
        cnt = _counter_buffer(dev, -(-M // bm) * -(-N // (64 if bm == 64
                                                            else 128)))
    _kernels.call("w8a8_matmul", "lbt_w8a8_matmul",
                  _kernels.DTYPE_CODES[x.dtype], x, qs, scales, xq, xs, part,
                  cnt, out, int(out_dtype == torch.bfloat16), M, K, N, bm, S)
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0   # kernel launches (chip_smoke reads it)


# -- the grouped matmuls -------------------------------------------------------


def _codes(qs: torch.Tensor, packed4: bool) -> torch.Tensor:
    """Integer codes [in, out]: nibble-packed [in/2, out] bytes unpack to
    their low nibbles (rows 0..in/2-1) over their high nibbles."""
    if not packed4:
        return qs
    b = qs.view(torch.uint8)
    return torch.cat([b & 0x0F, b >> 4], dim=0)


def _dequant_f32(qs, scales, mins, group: int, packed4: bool):
    """w = s * q - m in f32, scales and mins converted from their stored
    dtype (the JAX package's f32 dequantization)."""
    w = _codes(qs, packed4).float() * scales.float().repeat_interleave(
        group, dim=0)
    if mins is not None:
        w = w - mins.float().repeat_interleave(group, dim=0)
    return w


def _grouped_plain(x, qs, scales, mins, group: int, packed4: bool):
    """The TPU kernels' arithmetic: the f32 weight rounded to bf16, x
    rounded to bf16, the exact bf16 products summed. The sums are formed
    in float64 and rounded once to f32, so the kernel's order of
    summation does not enter the plain version."""
    w = _dequant_f32(qs, scales, mins, group, packed4).to(torch.bfloat16)
    return torch.matmul(x.to(torch.bfloat16).double(), w.double()).float()


def q4_matmul_plain(x, qs, scales, mins, group: int) -> torch.Tensor:
    """Plain version of q4_matmul (any device): x [M, in] -> [M, out] f32
    against nibble-packed codes qs [in/2, out]."""
    return _grouped_plain(x, qs, scales, mins, group, True)


def q8_matmul_plain(x, qs, scales, mins, group: int) -> torch.Tensor:
    """Plain version of q8_matmul (any device): x [M, in] -> [M, out] f32
    against int8 codes qs [in, out]."""
    return _grouped_plain(x, qs, scales, mins, group, False)


# rows up to which a call splits its in-dim across blocks (decode widths)
_SPLIT_MAX_ROWS = 64
# csrc/q_matmul.cu: 128-column blocks of 64-row tiles, at most one wave of
# two blocks per SM of an H100 at decode widths
_TILE_N, _TILE_K, _MAX_SPLITS, _WAVE = 128, 64, 16, 2 * 132


def _splits(M: int, N: int, K: int) -> int:
    """in-dim splits of a q4_matmul or q8_matmul call: 1 above
    _SPLIT_MAX_ROWS rows; below, as many as keep the blocks within one wave
    (up to 16 and one 64-row tile each). The number depends on the
    weight's shape alone, so a row's bits never depend on how many other
    rows of at most _SPLIT_MAX_ROWS share the call."""
    if M > _SPLIT_MAX_ROWS:
        return 1
    n_blocks = -(-N // _TILE_N)
    return max(1, min(_MAX_SPLITS, K // _TILE_K, _WAVE // n_blocks))


# per device: the split tickets of csrc/q_matmul.cu and csrc/w8a8_matmul.cu,
# zero between calls (the last block of each output tile resets its own),
# grown on demand outside a CUDA graph capture (a grown-out buffer is kept:
# a graph may point into it)
_counters: dict[torch.device, torch.Tensor] = {}


def _counter_buffer(dev: torch.device, n: int) -> torch.Tensor:
    buf = _counters.get(dev)
    if buf is None or buf.numel() < n:
        buf = _kernels.grown(buf, lambda: torch.zeros(
            max(n, 4096), dtype=torch.int32, device=dev), dev,
            "the split tickets")
        _counters[dev] = buf
    return buf


def _grouped_checks(fn: str, packed4: bool, x, qs, scales, mins,
                    group: int):
    """Shapes, dtypes and alignment of a grouped call; returns x
    contiguous."""
    def check(cond: bool, what: str) -> None:
        if not cond:
            raise ValueError(f"{fn}: {what}")
    check(x.dim() == 2 and x.dtype in (torch.bfloat16, torch.float32),
          f"x {x.dtype} {tuple(x.shape)}: 2-D bf16 or f32")
    M, K = x.shape
    N = qs.shape[-1]
    dev = x.device
    check(K % _TILE_K == 0, f"in={K} must be a multiple of {_TILE_K}")
    check(N % 8 == 0, f"out={N} must be a multiple of 8")
    check(group in (2, 4, 8, 16, 32), f"group {group}: a power of two <= 32")
    rows = K // 2 if packed4 else K
    check(qs.dtype == torch.int8 and tuple(qs.shape) == (rows, N),
          f"qs {qs.dtype} {tuple(qs.shape)}, want int8 {(rows, N)}")
    check(scales.dtype in (torch.bfloat16, torch.float32)
          and tuple(scales.shape) == (K // group, N),
          f"scales {scales.dtype} {tuple(scales.shape)}, want "
          f"{(K // group, N)} bf16 or f32")
    check(mins is None or (mins.dtype == scales.dtype
                           and mins.shape == scales.shape),
          "mins must match the scales' dtype and shape")
    x = x.contiguous()
    for name, t in (("x", x), ("qs", qs), ("scales", scales),
                    ("mins", mins)):
        check(t is None or (t.device == dev and t.is_contiguous()
                            and t.data_ptr() % 16 == 0),
              f"{name} must be a contiguous, 16-byte aligned tensor on "
              "x's device")
    return x


def _grouped(fn: str, packed4: bool, x, qs, scales, mins, group: int, out,
             out_dtype: torch.dtype) -> torch.Tensor:
    """One grouped call of the wrapper named `fn`: its plain version on a
    CPU x, else one launch of csrc/q_matmul.cu's lbt_<fn> when x has
    rows."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{fn}: out_dtype {out_dtype}: f32 or bf16")
    if not x.is_cuda:
        plain = q4_matmul_plain if packed4 else q8_matmul_plain
        res = plain(x, qs, scales, mins, group).to(out_dtype)
        return res if out is None else out.copy_(res)
    x = _grouped_checks(fn, packed4, x, qs, scales, mins, group)
    (M, K), N, dev = x.shape, qs.shape[-1], x.device
    if out is None:
        out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if not (out.dtype == out_dtype and tuple(out.shape) == (M, N)
            and out.is_contiguous() and out.device == dev
            and out.data_ptr() % 16 == 0):
        raise ValueError(f"{fn}: out must be a contiguous, 16-byte aligned "
                         f"{out_dtype} {(M, N)} tensor on x's device")
    if not M:
        return out
    S = _splits(M, N, K)
    ws = cnt = None
    if S > 1:
        ws = torch.empty((S, M, N), dtype=torch.float32, device=dev)
        cnt = _counter_buffer(dev, -(-N // _TILE_N) * -(-M // 16))
    _kernels.call("q_matmul", f"lbt_{fn}", _kernels.DTYPE_CODES[x.dtype],
                  _kernels.DTYPE_CODES[scales.dtype], x, qs, scales, mins, ws,
                  cnt, out, int(out_dtype == torch.bfloat16), M, K, N, group,
                  S)
    return out


def q4_matmul(x, qs, scales, mins, group: int, *, out=None,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x [M, in] (bf16 or f32) -> [M, out] against nibble-packed codes
    qs [in/2, out], scales/mins [in/group, out] (bf16 or f32; mins may be
    None). A CUDA x launches csrc/q_matmul.cu's lbt_q4_matmul, one launch a
    call; a CPU x takes the plain version. The result is f32, or with
    out_dtype=torch.bfloat16 the f32 sums rounded once to bf16 (as
    `.to(torch.bfloat16)` of the f32 result). `out` may name a contiguous
    [M, out] tensor of out_dtype."""
    out = _grouped("q4_matmul", True, x, qs, scales, mins, group, out,
                   out_dtype)
    if x.is_cuda and x.shape[0]:
        q4_matmul.launches += 1
    return out


def q8_matmul(x, qs, scales, mins, group: int, *, out=None,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x [M, in] (bf16 or f32) -> [M, out] against int8 codes qs [in, out],
    as q4_matmul; a CUDA x launches csrc/q_matmul.cu's lbt_q8_matmul."""
    out = _grouped("q8_matmul", False, x, qs, scales, mins, group, out,
                   out_dtype)
    if x.is_cuda and x.shape[0]:
        q8_matmul.launches += 1
    return out


q4_matmul.launches = 0   # kernel launches (chip_smoke reads them)
q8_matmul.launches = 0


def q_matmul(x: torch.Tensor, w: QTensor,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x [M, in] -> [M, out] through the kernel that matches a grouped
    QTensor's layout (q4_matmul for packed codes, else q8_matmul), the
    result rounded to out_dtype in the kernel."""
    fn = q4_matmul if w.packed4 else q8_matmul
    return fn(x, w.qs, w.scales, w.mins, w.group, out_dtype=out_dtype)


# -- reference implementation ----------------------------------------------------


def q_matmul_ref(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Dequantize-then-matmul in f32 (the JAX package's correctness
    baseline and CPU path): x [M, in] -> [M, out] f32."""
    if w.w8a8:
        wf = w.qs.float() * w.scales.float()[None, :]
    else:
        wf = _dequant_f32(w.qs, w.scales, w.mins, w.group, w.packed4)
    return x.float() @ wf


# -- dispatch ------------------------------------------------------------------


def dense_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for a dense w in x's dtype (torch.matmul), except that on the
    card a call of at most _SPLIT_MAX_ROWS rows runs at that many rows, the
    rest zeros and dropped: cuBLAS picks its kernel (tiles, in-dim splits)
    by the row count, so without it a verify pass's rows (slots x drafts)
    could round otherwise than their one-row decode steps (DeepSeek-V2-
    Lite's FF 10944 did, at 36 rows against 4), as the grouped and fused
    kernels' calls of at most 64 rows do not."""
    w = w.to(x.dtype)
    M = x.numel() // x.shape[-1]
    if not x.is_cuda or M >= _SPLIT_MAX_ROWS:
        return torch.matmul(x, w)
    xf = torch.nn.functional.pad(x.reshape(M, x.shape[-1]),
                                 (0, 0, 0, _SPLIT_MAX_ROWS - M))
    return torch.matmul(xf, w)[:M].reshape(*x.shape[:-1], w.shape[-1])


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul dispatch returning x's dtype, x: [..., in]: a dense tensor ->
    dense_matmul; a w8a8 QTensor -> w8a8_matmul; a grouped QTensor ->
    q_matmul on a CUDA x, q_matmul_ref on a CPU x. The kernels round a bf16
    x's result to bf16 themselves, so the final cast is a no-op on the
    card."""
    if not isinstance(w, QTensor):
        return dense_matmul(x, w)
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    if w.w8a8:
        out = w8a8_matmul(xf, w.qs, w.scales, out_dtype=(
            torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32))
    elif xf.is_cuda:
        out = q_matmul(xf, w, out_dtype=x.dtype)
    else:
        out = q_matmul_ref(xf, w)
    return out.reshape(*lead, w.out_dim).to(x.dtype)
