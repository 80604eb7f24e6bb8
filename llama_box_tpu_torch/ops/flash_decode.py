"""Single-query attention for chained decode (counterpart of
llama_box_tpu/ops/flash_decode.py).

`flash_decode` keeps the JAX signature (without the TPU block size and
`interpret`): on a CUDA tensor it launches the hand-written kernel
csrc/flash_decode.cu, on a CPU tensor it runs `flash_decode_plain`, the
same function written out in torch. On the TPU this kernel was opt-in; on
the card it is the decode attention of every chained step.

Layouts (post-RoPE; B = slot batch):
    q:     [B, Hkv, G, D]          the current query row per slot
    k/v:   [B, C, Hkv, D|Dv]       cache (bf16/f32, or int8 + [B, C, Hkv]
                                   scales); or layer-stacked [L, B, C, ...]
                                   with `layer` the index
    kr/vr: [B, R, Hkv, D|Dv]       chain rows; row i is position
                                   cpos - (nv-1) + i, rows >= nv are dead
                                   (row nv-1 is the current token's)
    meta:  [B, 2] int32            (cpos, nv)
    win:   [2] int32               (swa_window, chunked_window)
    alibi: [Hkv, G] f32            ALiBi slopes, or None
Cache index c is visible iff c < cpos - (nv-1) and c is inside the window
and chunk; chain row i iff i < nv and its position is >= 0 and visible.
Under ALiBi a score gains slope x (key position - cpos) before the
softcap. (D, Dv) in flash_prefill.HEAD_PAIRS. Output [B, Hkv, G, Dv] f32.
"""

from __future__ import annotations

import torch

from . import _kernels
from .attention import pos_visible, softmax_attend
from .flash_prefill import (HEAD_PAIRS, _as_int_list, _int32_on, _slopes_on,
                            kv_dequant)


def flash_decode_plain(q, k_cache, v_cache, k_rows, v_rows, meta, win,
                       k_scale=None, v_scale=None, *, layer=None, sinks=None,
                       scale: float | None = None, softcap: float = 0.0,
                       alibi=None):
    """The plain torch version of the kernel (any device)."""
    if layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    B, Hkv, G, D = q.shape
    C = k_cache.shape[1]
    R = k_rows.shape[1]
    dev, dt = q.device, q.dtype
    if scale is None:
        scale = D ** -0.5
    w, cw = _as_int_list(win)
    meta = torch.as_tensor(meta).to(dev, torch.long)
    cpos, nv = meta.unbind(1)
    cstart = cpos - nv + 1
    ar_c = torch.arange(C, device=dev)
    ar_r = torch.arange(R, device=dev)
    rpos = cstart[:, None] + ar_r
    kpos = torch.cat([ar_c.expand(B, C), rpos], dim=1)
    kvalid = torch.cat([ar_c[None] < cstart[:, None],
                        (ar_r[None] < nv[:, None]) & (rpos >= 0)], dim=1)
    mask = pos_visible(kpos, cpos[:, None], w, cw) & kvalid     # [B, K]
    k = torch.cat([kv_dequant(k_cache, k_scale, dt), k_rows.to(dt)], dim=1)
    v = torch.cat([kv_dequant(v_cache, v_scale, dt), v_rows.to(dt)], dim=1)
    dist = (kpos - cpos[:, None])[:, None, :]
    out = softmax_attend(q[:, :, :, None], k, v, mask[:, None, :], scale,
                         softcap, sinks, alibi, dist)
    return out[:, :, :, 0]


# csrc/flash_decode.cu's bf16 kernel: 64-key tiles, spans of whole tiles,
# at most 64 splits (one block each per slot and KV head)
_TILE, _MAX_SPLITS = 64, 64


def _splits(C: int) -> tuple[int, int]:
    """(L, S) of a bf16 call on a cache of C positions: split z takes key
    positions [z*L, (z+1)*L), the last one everything beyond; L is at
    least two tiles. A function of C alone, never of (cpos, nv), R or B:
    the host cannot read the device-side meta without a sync, and where the
    splits fall must not move with the chain step."""
    L = _TILE * max(2, -(-C // (_TILE * _MAX_SPLITS)))
    return L, max(1, -(-C // L))


# per device: the bf16 kernel's partials and split tickets (zero between
# calls: the last block of each slot and KV head resets its own), grown on
# demand outside a CUDA graph capture (a grown-out buffer is kept: a graph
# may point into it), so a call allocates only its output
_scratch: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch_for(dev: torch.device, n_ws: int, n_cnt: int):
    ws, cnt = _scratch.get(dev, (None, None))
    what = "flash_decode's scratch"
    if ws is None or ws.numel() < n_ws:
        ws = _kernels.grown(ws, lambda: torch.empty(
            n_ws, dtype=torch.float32, device=dev), dev, what)
    if cnt is None or cnt.numel() < n_cnt:
        cnt = _kernels.grown(cnt, lambda: torch.zeros(
            max(n_cnt, 1024), dtype=torch.int32, device=dev), dev, what)
    _scratch[dev] = ws, cnt
    return ws, cnt


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"flash_decode: {what}")


def flash_decode(q, k_cache, v_cache, k_rows, v_rows, meta, win,
                 k_scale=None, v_scale=None, *, layer=None, sinks=None,
                 scale: float | None = None, softcap: float = 0.0,
                 alibi=None):
    """Single-query chained-decode attention (see the module docstring).
    A CUDA q launches csrc/flash_decode.cu, one launch a call (a bf16 q:
    split across the SMs by _splits(C)); a CPU q takes the plain version.
    `layer` indexes a layer-stacked cache (a free view in torch, where XLA
    had to let the kernel slice it)."""
    if not q.is_cuda:
        return flash_decode_plain(q, k_cache, v_cache, k_rows, v_rows, meta,
                                  win, k_scale, v_scale, layer=layer,
                                  sinks=sinks, scale=scale, softcap=softcap,
                                  alibi=alibi)
    if layer is not None:
        layer = int(layer)
        k_cache, v_cache = k_cache[layer], v_cache[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    B, Hkv, G, D = q.shape
    C = k_cache.shape[1]
    Dv = v_cache.shape[-1]
    R = k_rows.shape[1]
    dev, dt = q.device, q.dtype
    quant = k_scale is not None
    _check(dt in (torch.bfloat16, torch.float32), f"q dtype {dt}")
    _check(k_cache.dtype == v_cache.dtype
           and k_cache.dtype == (torch.int8 if quant else dt),
           f"cache dtype {k_cache.dtype} with q {dt} (scales: {quant})")
    _check(tuple(k_cache.shape) == (B, C, Hkv, D)
           and tuple(v_cache.shape) == (B, C, Hkv, Dv), "cache shape")
    _check(tuple(k_rows.shape) == (B, R, Hkv, D)
           and tuple(v_rows.shape) == (B, R, Hkv, Dv), "rows shape")
    _check((D, Dv) in HEAD_PAIRS, f"head dims {(D, Dv)} (the kernel takes "
           f"{HEAD_PAIRS})")
    _check(1 <= G <= 16, f"group size {G}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        _check(t.device == dev and t.is_contiguous(),
               f"{name} must be contiguous on {dev}")
    if quant:
        _check(v_scale is not None
               and k_scale.dtype in (torch.bfloat16, torch.float32)
               and k_scale.dtype == v_scale.dtype
               and tuple(k_scale.shape) == (B, C, Hkv)
               and tuple(v_scale.shape) == (B, C, Hkv), "scales")
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
    k_rows = k_rows.to(dev, dt).contiguous()
    v_rows = v_rows.to(dev, dt).contiguous()
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("k_rows", k_rows), ("v_rows", v_rows)):
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned "
               "(the kernel loads 16 bytes at a time)")
    meta, win = _int32_on(dev, meta), _int32_on(dev, win)
    _check(tuple(meta.shape) == (B, 2) and tuple(win.shape) == (2,),
           "meta/win shape")
    if sinks is not None:
        sinks = sinks.to(dev, torch.float32).contiguous()
        _check(tuple(sinks.shape) == (Hkv, G), "sinks shape")
    alibi = _slopes_on(dev, alibi, Hkv, G, _check)
    out = torch.empty((B, Hkv, G, Dv), dtype=torch.float32, device=dev)
    L, S = _splits(C)
    ws = cnt = None
    if dt == torch.bfloat16:
        ws, cnt = _scratch_for(dev, B * Hkv * S * 16 * (Dv + 2), B * Hkv)
    codes = _kernels.DTYPE_CODES
    _kernels.call(
        "flash_decode", "lbt_flash_decode", codes[dt], codes[k_cache.dtype],
        codes[k_scale.dtype] if quant else 0, D, Dv, q, k_cache, v_cache,
        k_scale, v_scale, k_rows, v_rows, meta, win, sinks, alibi, ws, cnt,
        out, B, Hkv, G, C, R, L, S,
        float(D ** -0.5 if scale is None else scale), float(softcap))
    flash_decode.launches += 1
    return out


flash_decode.launches = 0   # kernel launches (chip_smoke reads it)
