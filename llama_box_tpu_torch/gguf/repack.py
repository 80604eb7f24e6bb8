"""Exact repacking of GGUF block-quant tensors into structure-of-arrays
form (counterpart of llama_box_tpu/gguf/repack.py, numpy only).

Every supported format is rewritten LOSSLESSLY as
    w[i] = scales[i // group] * q[i] - mins[i // group]
with q integer (int8 range), scales/mins float32 computed exactly from the
stored f16/6-bit fields. ops/qmatmul.pack_w8a8 turns this form into the
per-column int8 weights the w8a8 kernels stream. Dequantizing this form
reproduces gguf/quants.py dequantize() bit-for-bit in f32.

The JAX package hands tensors of 64K elements and more to a native C++
repacker when one is built; it falls back to this same numpy code, which
the port always runs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .constants import GGMLType
from .quants import (
    IQ4_NL_VALUES, _blocks, _f16, _k4_unpack_scale_min, _q3k_unpack_scales,
)


class RepackedTensor(NamedTuple):
    q: np.ndarray        # int8 [n] integer codes
    scales: np.ndarray   # f32 [n/group]
    mins: np.ndarray | None  # f32 [n/group] (w = s*q - m); None => 0
    group: int
    qbits: int           # 4 if codes fit 0..15 (packable), else 8


def _nibbles(qs: np.ndarray) -> np.ndarray:
    """GGUF nibble order: 32-byte chunk -> weights [lo*32, hi*32]."""
    lo = (qs & 0x0F).astype(np.int8)
    hi = (qs >> 4).astype(np.int8)
    return np.concatenate([lo, hi], axis=1)


def repack_q4_0(raw, n):
    b = _blocks(raw, 18)
    d = _f16(b[:, 0:2]).astype(np.float32)
    q = _nibbles(b[:, 2:18]).reshape(-1)[:n]
    return RepackedTensor(q, d, 8.0 * d, 32, 4)


def repack_q4_1(raw, n):
    b = _blocks(raw, 20)
    d = _f16(b[:, 0:2]).astype(np.float32)
    m = _f16(b[:, 2:4]).astype(np.float32)
    q = _nibbles(b[:, 4:20]).reshape(-1)[:n]
    return RepackedTensor(q, d, -m, 32, 4)


def repack_q5_0(raw, n):
    b = _blocks(raw, 22)
    d = _f16(b[:, 0:2]).astype(np.float32)
    qh = np.ascontiguousarray(b[:, 2:6]).view("<u4").reshape(-1)
    bits = (qh[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    q = (_nibbles(b[:, 6:22]).astype(np.int16)
         | (bits.astype(np.int16) << 4)).astype(np.int8)
    return RepackedTensor(q.reshape(-1)[:n], d, 16.0 * d, 32, 8)


def repack_q5_1(raw, n):
    b = _blocks(raw, 24)
    d = _f16(b[:, 0:2]).astype(np.float32)
    m = _f16(b[:, 2:4]).astype(np.float32)
    qh = np.ascontiguousarray(b[:, 4:8]).view("<u4").reshape(-1)
    bits = (qh[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    q = (_nibbles(b[:, 8:24]).astype(np.int16)
         | (bits.astype(np.int16) << 4)).astype(np.int8)
    return RepackedTensor(q.reshape(-1)[:n], d, -m, 32, 8)


def repack_q8_0(raw, n):
    b = _blocks(raw, 34)
    d = _f16(b[:, 0:2]).astype(np.float32)
    q = np.ascontiguousarray(b[:, 2:34]).view(np.int8).reshape(-1)[:n]
    return RepackedTensor(q, d, None, 32, 8)


def repack_q4_k(raw, n):
    b = _blocks(raw, 144)
    d = _f16(b[:, 0:2]).astype(np.float32)[:, None]
    dmin = _f16(b[:, 2:4]).astype(np.float32)[:, None]
    sc, mn = _k4_unpack_scale_min(b[:, 4:16])
    scales = (d * sc.astype(np.float32)).reshape(-1)
    mins = (dmin * mn.astype(np.float32)).reshape(-1)
    qs = b[:, 16:144]
    nb = b.shape[0]
    q = np.empty((nb, 256), dtype=np.int8)
    for c in range(4):
        qpart = qs[:, c * 32:(c + 1) * 32]
        q[:, c * 64:c * 64 + 32] = (qpart & 0x0F).astype(np.int8)
        q[:, c * 64 + 32:c * 64 + 64] = (qpart >> 4).astype(np.int8)
    ng = n // 32
    return RepackedTensor(q.reshape(-1)[:n], scales[:ng], mins[:ng], 32, 4)


def repack_q5_k(raw, n):
    b = _blocks(raw, 176)
    d = _f16(b[:, 0:2]).astype(np.float32)[:, None]
    dmin = _f16(b[:, 2:4]).astype(np.float32)[:, None]
    sc, mn = _k4_unpack_scale_min(b[:, 4:16])
    scales = (d * sc.astype(np.float32)).reshape(-1)
    mins = (dmin * mn.astype(np.float32)).reshape(-1)
    qh = b[:, 16:48]
    qs = b[:, 48:176]
    nb = b.shape[0]
    q = np.empty((nb, 256), dtype=np.int8)
    for c in range(4):
        qpart = qs[:, c * 32:(c + 1) * 32]
        lo = (qpart & 0x0F).astype(np.int8) \
            + np.where((qh & (1 << (2 * c))) != 0, 16, 0).astype(np.int8)
        hi = (qpart >> 4).astype(np.int8) \
            + np.where((qh & (1 << (2 * c + 1))) != 0, 16, 0).astype(np.int8)
        q[:, c * 64:c * 64 + 32] = lo
        q[:, c * 64 + 32:c * 64 + 64] = hi
    ng = n // 32
    return RepackedTensor(q.reshape(-1)[:n], scales[:ng], mins[:ng], 32, 8)


def repack_q6_k(raw, n):
    b = _blocks(raw, 210)
    ql = b[:, 0:128]
    qh = b[:, 128:192]
    scales8 = np.ascontiguousarray(b[:, 192:208]).view(np.int8)
    d = _f16(b[:, 208:210]).astype(np.float32)[:, None]
    nb = b.shape[0]
    q = np.empty((nb, 256), dtype=np.int8)
    for half in range(2):
        qlp = ql[:, half * 64:(half + 1) * 64]
        qhp = qh[:, half * 32:(half + 1) * 32]
        q0 = ((qlp[:, :32] & 0x0F).astype(np.int16)
              | (((qhp >> 0) & 3).astype(np.int16) << 4)) - 32
        q1 = ((qlp[:, 32:] & 0x0F).astype(np.int16)
              | (((qhp >> 2) & 3).astype(np.int16) << 4)) - 32
        q2 = ((qlp[:, :32] >> 4).astype(np.int16)
              | (((qhp >> 4) & 3).astype(np.int16) << 4)) - 32
        q3 = ((qlp[:, 32:] >> 4).astype(np.int16)
              | (((qhp >> 6) & 3).astype(np.int16) << 4)) - 32
        for k, qq in enumerate((q0, q1, q2, q3)):
            base = half * 128 + k * 32
            q[:, base:base + 32] = qq.astype(np.int8)
    scales = (d * scales8.astype(np.float32)).reshape(-1)
    ng = n // 16
    return RepackedTensor(q.reshape(-1)[:n], scales[:ng], None, 16, 8)


def repack_q2_k(raw, n):
    b = _blocks(raw, 84)
    scales = b[:, 0:16]
    qs = b[:, 16:80]
    d = _f16(b[:, 80:82]).astype(np.float32)[:, None]
    dmin = _f16(b[:, 82:84]).astype(np.float32)[:, None]
    sc = (scales & 0x0F).astype(np.float32)
    mn = (scales >> 4).astype(np.float32)
    eff_s = (d * sc).reshape(-1)
    eff_m = (dmin * mn).reshape(-1)
    nb = b.shape[0]
    q = np.empty((nb, 256), dtype=np.int8)
    for half in range(2):
        qpart = qs[:, half * 32:(half + 1) * 32]
        for j in range(4):
            base = half * 128 + j * 32
            q[:, base:base + 32] = ((qpart >> (2 * j)) & 3).astype(np.int8)
    ng = n // 16
    return RepackedTensor(q.reshape(-1)[:n], eff_s[:ng], eff_m[:ng], 16, 4)


def repack_q3_k(raw, n):
    b = _blocks(raw, 110)
    hmask = b[:, 0:32]
    qs = b[:, 32:96]
    scales_raw = b[:, 96:108]
    d = _f16(b[:, 108:110]).astype(np.float32)[:, None]
    sc = _q3k_unpack_scales(scales_raw).astype(np.float32)  # already -32..31
    eff_s = (d * sc).reshape(-1)
    nb = b.shape[0]
    # weight w = 128*j + 32*shift + l: low2 = (qs[32j+l] >> 2*shift) & 3,
    # high bit from hmask[l] bit (4j + shift); value = low2 - (hbit?0:4)
    q = np.empty((nb, 256), dtype=np.int8)
    for j in range(2):
        qs_half = qs[:, j * 32:(j + 1) * 32]
        for shift in range(4):
            base = j * 128 + shift * 32
            low = ((qs_half >> (2 * shift)) & 3).astype(np.int8)
            hbit = (hmask >> (j * 4 + shift)) & 1
            q[:, base:base + 32] = low - np.where(hbit == 0, 4, 0).astype(
                np.int8)
    ng = n // 16
    return RepackedTensor(q.reshape(-1)[:n], eff_s[:ng], None, 16, 8)


def repack_iq4_nl(raw, n):
    b = _blocks(raw, 18)
    d = _f16(b[:, 0:2]).astype(np.float32)
    table = np.asarray(IQ4_NL_VALUES, dtype=np.int16)
    idx = _nibbles(b[:, 2:18]).astype(np.uint8)
    q = table[idx.reshape(-1)[:n]].astype(np.int8)
    return RepackedTensor(q, d, None, 32, 8)


REPACKERS = {
    GGMLType.Q4_0: repack_q4_0,
    GGMLType.Q4_1: repack_q4_1,
    GGMLType.Q5_0: repack_q5_0,
    GGMLType.Q5_1: repack_q5_1,
    GGMLType.Q8_0: repack_q8_0,
    GGMLType.Q2_K: repack_q2_k,
    GGMLType.Q3_K: repack_q3_k,
    GGMLType.Q4_K: repack_q4_k,
    GGMLType.Q5_K: repack_q5_k,
    GGMLType.Q6_K: repack_q6_k,
    GGMLType.IQ4_NL: repack_iq4_nl,
}


def repack(ggml_type: GGMLType, raw, n: int) -> RepackedTensor | None:
    fn = REPACKERS.get(ggml_type)
    if fn is None:
        return None
    return fn(raw, n)


def dequantize_repacked(rt: RepackedTensor) -> np.ndarray:
    """f32 reconstruction (must equal quants.dequantize bit-for-bit)."""
    s = np.repeat(rt.scales, rt.group)[:rt.q.shape[0]]
    out = s * rt.q.astype(np.float32)
    if rt.mins is not None:
        out -= np.repeat(rt.mins, rt.group)[:rt.q.shape[0]]
    return out
