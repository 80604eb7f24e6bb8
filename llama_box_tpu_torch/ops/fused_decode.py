"""Fused w8a8 decode-layer kernels (counterpart of
llama_box_tpu/ops/fused_decode.py).

At decode widths (R <= 64 rows) every projection of a layer streams its
int8 weights once and does little arithmetic; what the unfused path adds
is a string of small elementwise ops (norm, activation quantization,
activation, residual adds), each one a launch. Two functions fold them
into the matmuls:

- fused_norm_qmm:   rms_norm -> bf16 -> per-row int8 -> s8 x s8 -> s32 ->
                    rescale -> bf16 (the fused wqkv projection and the
                    output/vocab projection); csrc/fused_norm_qmm.cu
- fused_layer_tail: int8(attn_out) . wo -> +residual -> rms_norm -> int8
                    -> gate|up -> act * up -> int8 -> down -> +residual
                    (the whole post-attention layer); csrc/fused_layer_tail.cu

Both keep every rounding point of the unfused path (mm() returns bf16
between the matmuls; per-row int8 activations as ops/qmatmul), so greedy
output through them matches the unfused path. On a CUDA tensor each
launches its kernel; on a CPU tensor it runs its `*_plain` version, the
same function written out in torch.
"""

from __future__ import annotations

import torch

from . import _kernels
from .qmatmul import _int_dot, _quant_rows

_MAX_ROWS = 64          # fused kernels serve decode/verify widths only
_ACT_CODES = {"silu": 0, "gelu": 1, "relu2": 2}
# csrc/w8a8_common.cuh: blocks of 128 output columns streaming 64-row
# weight tiles; the in-dim split fills one wave of an H100's 132 SMs, up to
# 16 splits, and keeps a split's codes within 128 tiles
_TILE_N, _TILE_K, _WAVE, _MAX_SPLITS, _MAX_SPLIT_TILES = 128, 64, 132, 16, 128


def _pick_tile(dim: int, caps=(512, 256, 128)) -> int:
    """The JAX package's tile rule, kept as a gate: a width none of
    `caps` divides takes the unfused path, as in JAX (the CUDA kernels
    themselves tile by 128 columns and take any multiple of 4)."""
    for c in caps:
        if dim % c == 0:
            return c
    return 0


def _splits(k: int, n: int) -> int:
    """In-dim splits of a fused kernel's call against int8 weights [k, n]
    (gate|up: n = 2 * FF, a block taking 64 gate and 64 up columns): as
    many as put one wave of blocks on the card, at most _MAX_SPLITS, and at
    least as many as keep a split within _MAX_SPLIT_TILES tiles. Each split
    is a whole number of 64-row tiles (the kernel cuts the ceil(k / 64)
    tiles evenly; only the last tile may be ragged). The count depends on
    the weight's shape alone: the splits' int32 sums are exact in any
    order, and a row's bits never depend on the other rows of the call."""
    tiles = -(-n // _TILE_N)
    kt = -(-k // _TILE_K)
    want = max(min(_MAX_SPLITS, -(-_WAVE // tiles)),
               -(-kt // _MAX_SPLIT_TILES))
    return max(1, min(kt, want))


# per device: the split sums (int32) and tickets of the fused kernels, zero
# between calls (the block with a tile's last ticket re-zeroes its own),
# grown on demand outside a CUDA graph capture (a grown-out buffer is kept:
# a graph may point into it); calls that share it run on one stream. The
# views carved for a call's shape are kept (the decode step is bound by
# host time).
_scratch: dict[torch.device, torch.Tensor] = {}
_regions: dict[tuple, list] = {}


def _split_regions(dev: torch.device, R: int, parts):
    """(acc, cnt) views, one pair per (n, splits) of `parts` (None, None
    where splits is 1), carved from the device's zeroed buffer. A region
    holds the sums of R rows rounded up to 8 and the tickets of up to R row
    groups, for ceil(n / 128) column tiles, whatever rows a block takes (1,
    2, 4 or 8)."""
    key = (dev, R, tuple(parts))
    out = _regions.get(key)
    if out is not None:
        return out
    sizes = [(0, 0) if s == 1 else (-(-R // 8) * 8 * tiles * _TILE_N,
                                    R * tiles)
             for tiles, s in ((-(-n // _TILE_N), s) for n, s in parts)]
    total = sum(a + c for a, c in sizes)
    buf = _scratch.get(dev)
    if total and (buf is None or buf.numel() < total):
        buf = _kernels.grown(buf, lambda: torch.zeros(
            max(total, 1 << 16), dtype=torch.int32, device=dev), dev,
            "the fused kernels' split sums")
        _scratch[dev] = buf
        _regions.clear()            # views of the old buffer
    out, off = [], 0
    for a, c in sizes:
        if not a:
            out.append((None, None))
            continue
        out.append((buf[off:off + a], buf[off + a:off + a + c]))
        off += a + c
    _regions[key] = out
    return out


# per device: the tail's row maxima of |act| (phase A zeroes them, phase B
# raises them, phase C reads them), one word for each of up to _MAX_ROWS
_row_max: dict[torch.device, torch.Tensor] = {}


def _row_max_buffer(dev: torch.device) -> torch.Tensor:
    buf = _row_max.get(dev)
    if buf is None:
        _kernels.no_capture(dev, "the tail's row maxima")
        buf = torch.zeros(_MAX_ROWS, dtype=torch.int32, device=dev)
        _row_max[dev] = buf
    return buf


def _rms_bf16(x32: torch.Tensor, nw32: torch.Tensor, eps: float):
    """f32 rows -> normed rows rounded to bf16 (matches ops/norm.rms_norm
    on a bf16 input followed by mm()'s f32 upcast)."""
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * nw32).to(torch.bfloat16)


def _act_f32(gate32: torch.Tensor, act_fn: str) -> torch.Tensor:
    if act_fn == "gelu":
        return torch.nn.functional.gelu(gate32, approximate="tanh")
    if act_fn == "relu2":
        return torch.square(torch.relu(gate32))
    return torch.nn.functional.silu(gate32)


def _qmm_bf16(h: torch.Tensor, qs: torch.Tensor, sc: torch.Tensor):
    """bf16 rows -> per-row int8 -> s32 -> * xs * scales -> bf16."""
    hq, hs = _quant_rows(h.float())
    return (_int_dot(hq, qs) * hs * sc.float()[None, :]).to(torch.bfloat16)


def fused_norm_qmm_plain(x, nw, qs, scales, *, eps: float):
    """The plain torch version of fused_norm_qmm (any device)."""
    h = _rms_bf16(x.float(), nw.float(), eps)
    return _qmm_bf16(h, qs, scales)


def _rs_bf16(rs: float, dev) -> torch.Tensor:
    return torch.tensor(rs, dtype=torch.bfloat16, device=dev)


def tail_xnew_plain(ao, x_res, wo_qs, wo_sc, *, rs: float = 1.0):
    """The tail's first phase, plain: xnew = x_res + bf16(attn_out * rs),
    the bf16 rows fused_layer_tail leaves in its xnew scratch."""
    attn_out = _qmm_bf16(ao, wo_qs, wo_sc)
    return x_res.to(torch.bfloat16) + attn_out * _rs_bf16(rs, ao.device)


def fused_layer_tail_plain(ao, x_res, wo_qs, wo_sc, ffn_nw, gu_qs, gu_sc,
                           dn_qs, dn_sc, *, eps: float, rs: float = 1.0,
                           act_fn: str = "silu"):
    """The plain torch version of fused_layer_tail (any device), with the
    Pallas kernel's bf16 rounding points."""
    FF = gu_qs.shape[1] // 2
    rsb = _rs_bf16(rs, ao.device)
    xnew = tail_xnew_plain(ao, x_res, wo_qs, wo_sc, rs=rs)
    h = _rms_bf16(xnew.float(), ffn_nw.float(), eps)
    gate = _qmm_bf16(h, gu_qs[:, :FF], gu_sc[:FF])
    up = _qmm_bf16(h, gu_qs[:, FF:], gu_sc[FF:])
    act = (_act_f32(gate.float(), act_fn) * up.float()).to(torch.bfloat16)
    return xnew + _qmm_bf16(act, dn_qs, dn_sc) * rsb


def _check(fn: str, cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"{fn}: {what}")


def _weights(fn: str, qs, sc, k: int, n: int, dev):
    _check(fn, qs.dtype == torch.int8 and tuple(qs.shape) == (k, n),
           f"weights {qs.dtype} {tuple(qs.shape)}, want int8 {(k, n)}")
    _check(fn, n % 4 == 0 and k % 4 == 0, f"weights {(k, n)}: dims must "
           "be multiples of 4 (4-byte loads)")
    _check(fn, k * 127 * 127 < 2 ** 31, f"in={k}: the s32 sum could overflow")
    qs = qs.contiguous()
    _check(fn, qs.device == dev and qs.data_ptr() % 4 == 0,
           "weights must be 4-byte aligned on the rows' device")
    sc = sc.to(dev, torch.float32).contiguous()
    _check(fn, tuple(sc.shape) == (n,), f"scales shape {tuple(sc.shape)}")
    return qs, sc


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (the kernels read rows and norm
    weights 8 and 16 bytes at a time); a view off that alignment is
    copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _rows(fn: str, x, width: int, dev):
    _check(fn, x.dtype == torch.bfloat16 and x.dim() == 2
           and x.shape[1] == width and x.device == dev,
           f"rows {x.dtype} {tuple(x.shape)}: want bf16 [R, {width}]")
    return _aligned(x)


def _norm_weight(fn: str, nw, width: int, dev):
    """The norm weight as stored, bf16 or f32: the kernels read either (a
    cast per call would be one more device op per layer and step)."""
    _check(fn, nw.dtype in (torch.bfloat16, torch.float32)
           and tuple(nw.shape) == (width,) and nw.device == dev,
           f"norm weight {nw.dtype} {tuple(nw.shape)} on {nw.device}")
    return _aligned(nw)


def _out(fn: str, out, shape, dev):
    if out is None:
        return torch.empty(shape, dtype=torch.bfloat16, device=dev)
    _check(fn, out.dtype == torch.bfloat16 and tuple(out.shape) == shape
           and out.is_contiguous() and out.device == dev, "out")
    return out


def fused_norm_qmm(x, nw, qs, scales, *, eps: float, out=None):
    """x [R, E] bf16 -> rms_norm(x, nw) @ dequant(qs) as bf16 [R, O].

    qs: [E, O] int8 per-column weights, scales: [O] f32, R <= _MAX_ROWS.
    A CUDA x launches csrc/fused_norm_qmm.cu, a CPU x takes the plain
    version. `out` may name a contiguous bf16 [R, O] tensor to write."""
    if not x.is_cuda:
        res = fused_norm_qmm_plain(x, nw, qs, scales, eps=eps)
        return res if out is None else out.copy_(res)
    fn = "fused_norm_qmm"
    R, E = x.shape
    O = qs.shape[-1]
    dev = x.device
    _check(fn, 1 <= R <= _MAX_ROWS, f"{R} rows (1..{_MAX_ROWS})")
    x = _rows(fn, x, E, dev)
    qs, scales = _weights(fn, qs, scales, E, O, dev)
    nw = _norm_weight(fn, nw, E, dev)
    out = _out(fn, out, (R, O), dev)
    S = _splits(E, O)
    (acc, cnt), = _split_regions(dev, R, [(O, S)])
    _kernels.call("fused_norm_qmm", "lbt_fused_norm_qmm",
                  _kernels.DTYPE_CODES[nw.dtype], x, nw, qs, scales, out, acc,
                  cnt, R, E, O, S, float(eps))
    fused_norm_qmm.launches += 1
    return out


fused_norm_qmm.launches = 0   # kernel launches (chip_smoke reads it)


def fused_layer_tail(ao, x_res, wo_qs, wo_sc, ffn_nw, gu_qs, gu_sc, dn_qs,
                     dn_sc, *, eps: float, rs: float = 1.0,
                     act_fn: str = "silu", out=None, scratch=None):
    """The whole post-attention layer tail.

    ao [R, HD] attention output (bf16), x_res [R, E] residual stream.
    wo_qs [HD, E], gu_qs [E, 2*FF] (gate cols first), dn_qs [FF, E] — all
    per-column int8 with f32 scales. Returns x_out [R, E] bf16. A CUDA ao
    launches csrc/fused_layer_tail.cu (three kernels, the second and third
    as programmatic dependent launches, counted as one launch of this
    function), a CPU ao takes the plain version. `scratch`
    may name the (xnew [R, E], act [R, FF]) bf16 buffers the kernels pass
    between them; `out` the output."""
    if not ao.is_cuda:
        res = fused_layer_tail_plain(ao, x_res, wo_qs, wo_sc, ffn_nw, gu_qs,
                                     gu_sc, dn_qs, dn_sc, eps=eps, rs=rs,
                                     act_fn=act_fn)
        return res if out is None else out.copy_(res)
    fn = "fused_layer_tail"
    R, HD = ao.shape
    E = x_res.shape[-1]
    FF = gu_qs.shape[-1] // 2
    dev = ao.device
    _check(fn, 1 <= R <= _MAX_ROWS, f"{R} rows (1..{_MAX_ROWS})")
    _check(fn, act_fn in _ACT_CODES, f"activation {act_fn!r}")
    ao = _rows(fn, ao, HD, dev)
    x_res = _rows(fn, x_res, E, dev)
    _check(fn, x_res.shape[0] == R, "x_res rows")
    wo_qs, wo_sc = _weights(fn, wo_qs, wo_sc, HD, E, dev)
    gu_qs, gu_sc = _weights(fn, gu_qs, gu_sc, E, 2 * FF, dev)
    dn_qs, dn_sc = _weights(fn, dn_qs, dn_sc, FF, E, dev)
    ffn_nw = _norm_weight(fn, ffn_nw, E, dev)
    if scratch is None:
        scratch = (torch.empty((R, E), dtype=torch.bfloat16, device=dev),
                   torch.empty((R, FF), dtype=torch.bfloat16, device=dev))
    xnew = _out(fn, scratch[0], (R, E), dev)
    act = _out(fn, scratch[1], (R, FF), dev)
    _check(fn, xnew.data_ptr() % 8 == 0 and act.data_ptr() % 8 == 0,
           "scratch rows must be 8-byte aligned (read as rows by the next "
           "phase)")
    out = _out(fn, out, (R, E), dev)
    splits = (_splits(HD, E), _splits(E, 2 * FF), _splits(FF, E))
    regions = _split_regions(dev, R, list(zip((E, 2 * FF, E), splits)))
    amax = _row_max_buffer(dev)
    _kernels.call("fused_layer_tail", "lbt_fused_layer_tail",
                  _kernels.DTYPE_CODES[ffn_nw.dtype], ao, x_res, wo_qs, wo_sc,
                  ffn_nw, gu_qs, gu_sc, dn_qs, dn_sc, xnew, act, out, amax,
                  *(t for pair in regions for t in pair), *splits, R, HD, E,
                  FF, float(eps), float(rs), _ACT_CODES[act_fn])
    fused_layer_tail.launches += 1
    return out


fused_layer_tail.launches = 0   # calls, three kernels each (chip_smoke)
