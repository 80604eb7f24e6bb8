"""Batched prefill attention over a read-only cache plus the chunk's rows
(counterpart of llama_box_tpu/ops/flash_prefill.py).

`flash_prefill_batched` keeps the JAX signature (without the TPU block
sizes and `interpret`): on a CUDA tensor it launches the hand-written
kernel csrc/flash_prefill.cu (a bf16 q: the tensor-core kernel; an f32 q:
the f32 FMA kernel, chosen by dtype before the launch), on a CPU tensor it
runs `flash_prefill_plain`, the same function written out in torch.

Layouts (all post-RoPE):
    q:        [B, Hkv, G, T, D]
    k/v:      [Bc, C, Hkv, D|Dv] cache (bf16/f32, or int8 + [Bc, C, Hkv]
                                 scales)
    k/v rows: [B, T, Hkv, D|Dv]  the chunk's own rows
    meta:     [B, 4|5] int32     (pos0, n_valid, bidir_st, bidir_en[, slot])
    win:      [2] int32          (swa_window, chunked_window) of this layer
    alibi:    [Hkv, G] f32       ALiBi slopes, or None
Batch row b reads cache row b (Bc = B), or with a fifth meta column cache
row meta[b, 4] (< Bc, unchecked on the card): one program then prefills
any slot in place. Row r of batch row b (position pos0 + r) sees cache
position c iff c < pos0 and
c is causal/in-window/in-chunk, or c lies in [st, en); it sees row r' iff
r' < n_valid under the same rule. Under ALiBi a score gains slope x (key
position - query position) before the softcap. (D, Dv) in HEAD_PAIRS: the
equal widths of HEAD_DIMS, and multi-head latent attention's K 192 / V 128
(DeepSeek-V2/V3) and K 96 / V 64 (MiniCPM3). Output [B, Hkv, G, T, Dv] f32.
"""

from __future__ import annotations

import torch

from . import _kernels
from .attention import pos_visible, softmax_attend

# the head widths (D = Dv) both attention kernels instantiate, and the
# (K, V) width pairs: those, and MLA's unequal ones
HEAD_DIMS = (64, 80, 96, 128, 256)
HEAD_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128), (96, 64))


def _as_int_list(x) -> list[int]:
    return [int(v) for v in (x.tolist() if hasattr(x, "tolist") else x)]


def _int32_on(dev, t) -> torch.Tensor:
    """An int32 operand (meta, win) on dev: itself when it already is a
    contiguous int32 tensor there (the engine's path: no device op), else
    converted."""
    if isinstance(t, torch.Tensor) and t.device == dev \
            and t.dtype == torch.int32 and t.is_contiguous():
        return t
    return torch.as_tensor(t).to(dev, torch.int32).contiguous()


def kv_dequant(cache: torch.Tensor, scale: torch.Tensor | None,
               dtype: torch.dtype) -> torch.Tensor:
    """Cache entries as the kernels see them: int8 codes times their
    per-(position, head) scale in f32, rounded to the compute dtype."""
    if scale is None:
        return cache.to(dtype)
    return (cache.float() * scale.float()[..., None]).to(dtype)


def _slopes_on(dev, alibi, Hkv: int, G: int, check):
    """The ALiBi slopes operand as the kernels take it: [Hkv, G] f32,
    contiguous, on dev (None stays None)."""
    if alibi is None:
        return None
    alibi = alibi.to(dev, torch.float32).contiguous()
    check(tuple(alibi.shape) == (Hkv, G), "alibi shape")
    return alibi


def flash_prefill_plain(q, k_cache, v_cache, k_rows, v_rows, meta, win,
                        k_scale=None, v_scale=None, *, sinks=None,
                        scale: float | None = None, softcap: float = 0.0,
                        alibi=None):
    """The plain torch version of the kernel (any device)."""
    B, Hkv, G, T, D = q.shape
    C = k_cache.shape[1]
    dev, dt = q.device, q.dtype
    if scale is None:
        scale = D ** -0.5
    w, cw = _as_int_list(win)
    meta = torch.as_tensor(meta).to(dev, torch.long)
    if meta.shape[1] == 5:
        rows = meta[:, 4]
        k_cache, v_cache = k_cache[rows], v_cache[rows]
        if k_scale is not None:
            k_scale, v_scale = k_scale[rows], v_scale[rows]
    pos0, nval, st, en = meta[:, :4].unbind(1)
    ar_c = torch.arange(C, device=dev)
    ar_t = torch.arange(T, device=dev)
    kpos = torch.cat([ar_c.expand(B, C), pos0[:, None] + ar_t], dim=1)
    kvalid = torch.cat([ar_c[None] < pos0[:, None],
                        ar_t[None] < nval[:, None]], dim=1)
    qpos = (pos0[:, None] + ar_t)[:, :, None]              # [B, T, 1]
    kp = kpos[:, None, :]                                  # [B, 1, K]
    mask = pos_visible(kp, qpos, w, cw) \
        | ((kp >= st[:, None, None]) & (kp < en[:, None, None]))
    mask = mask & kvalid[:, None, :]
    k = torch.cat([kv_dequant(k_cache, k_scale, dt), k_rows.to(dt)], dim=1)
    v = torch.cat([kv_dequant(v_cache, v_scale, dt), v_rows.to(dt)], dim=1)
    return softmax_attend(q, k, v, mask, scale, softcap, sinks, alibi,
                          kp - qpos)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"flash_prefill_batched: {what}")


def flash_prefill_batched(q, k_cache, v_cache, k_rows, v_rows, meta, win,
                          k_scale=None, v_scale=None, *, sinks=None,
                          scale: float | None = None, softcap: float = 0.0,
                          alibi=None):
    """Batched prefill attention (see the module docstring). A CUDA q
    launches csrc/flash_prefill.cu; a CPU q takes the plain version."""
    if not q.is_cuda:
        return flash_prefill_plain(q, k_cache, v_cache, k_rows, v_rows, meta,
                                   win, k_scale, v_scale, sinks=sinks,
                                   scale=scale, softcap=softcap, alibi=alibi)
    B, Hkv, G, T, D = q.shape
    C = k_cache.shape[1]
    Dv = v_cache.shape[-1]
    dev, dt = q.device, q.dtype
    quant = k_scale is not None
    _check(dt in (torch.bfloat16, torch.float32), f"q dtype {dt}")
    _check(k_cache.dtype == v_cache.dtype
           and k_cache.dtype == (torch.int8 if quant else dt),
           f"cache dtype {k_cache.dtype} with q {dt} (scales: {quant})")
    meta, win = _int32_on(dev, meta), _int32_on(dev, win)
    _check(meta.dim() == 2 and tuple(meta.shape) in ((B, 4), (B, 5))
           and tuple(win.shape) == (2,), "meta/win shape")
    Bc = k_cache.shape[0] if meta.shape[1] == 5 else B
    _check(tuple(k_cache.shape) == (Bc, C, Hkv, D)
           and tuple(v_cache.shape) == (Bc, C, Hkv, Dv), "cache shape")
    _check(tuple(k_rows.shape) == (B, T, Hkv, D)
           and tuple(v_rows.shape) == (B, T, Hkv, Dv), "rows shape")
    _check((D, Dv) in HEAD_PAIRS, f"head dims {(D, Dv)} (the kernel takes "
           f"{HEAD_PAIRS})")
    _check(1 <= G <= 128, f"group size {G}")
    k_rows = k_rows.to(dev, dt).contiguous()
    v_rows = v_rows.to(dev, dt).contiguous()
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("k_rows", k_rows), ("v_rows", v_rows)):
        _check(t.device == dev and t.is_contiguous()
               and t.data_ptr() % 16 == 0,
               f"{name} must be contiguous and 16-byte aligned on {dev}")
    if quant:
        _check(v_scale is not None
               and k_scale.dtype in (torch.bfloat16, torch.float32)
               and k_scale.dtype == v_scale.dtype
               and tuple(k_scale.shape) == (Bc, C, Hkv)
               and tuple(v_scale.shape) == (Bc, C, Hkv), "scales")
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
    if sinks is not None:
        sinks = sinks.to(dev, torch.float32).contiguous()
        _check(tuple(sinks.shape) == (Hkv, G), "sinks shape")
    alibi = _slopes_on(dev, alibi, Hkv, G, _check)
    out = torch.empty((B, Hkv, G, T, Dv), dtype=torch.float32, device=dev)
    codes = _kernels.DTYPE_CODES
    _kernels.call(
        "flash_prefill", "lbt_flash_prefill", codes[dt],
        codes[k_cache.dtype], codes[k_scale.dtype] if quant else 0, D, Dv,
        q, k_cache, v_cache, k_scale, v_scale, k_rows, v_rows, meta, win,
        sinks, alibi, out, B, Hkv, G, T, C, meta.shape[1],
        float(D ** -0.5 if scale is None else scale), float(softcap))
    flash_prefill_batched.launches += 1
    return out


flash_prefill_batched.launches = 0   # kernel launches (chip_smoke reads it)
