"""Rotary position embeddings with linear/YaRN scaling (counterpart of
llama_box_tpu/ops/rope.py).

The cos/sin tables are computed in float64 numpy exactly as the JAX
version does, then placed on the caller's device. Two GGML rotation
layouts:
- 'norm' : adjacent-pair rotation (dims 2i, 2i+1) — llama-family GGUFs
- 'neox' : half-split rotation (dims i, i+D/2)
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RopeParams:
    head_dim: int
    n_rot: int = 0  # rotated dims; 0 => head_dim
    freq_base: float = 10000.0
    freq_scale: float = 1.0  # linear scaling: positions * freq_scale
    scaling_type: str = "none"  # none | linear | yarn | longrope
    yarn_orig_ctx: int = 0
    yarn_ext_factor: float = -1.0
    yarn_attn_factor: float = 1.0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    mode: str = "norm"  # norm | neox
    freq_factors: tuple = ()

    @property
    def rot_dim(self) -> int:
        return self.n_rot or self.head_dim


def _yarn_find_correction_dim(n_rot: int, base: float, n_orig: int,
                              rot: float) -> float:
    return n_rot * math.log(n_orig / (rot * 2 * math.pi)) \
        / (2 * math.log(base))


def _yarn_ramp(lo: float, hi: float, dims: np.ndarray) -> np.ndarray:
    y = (dims - lo) / max(hi - lo, 1e-3)
    return 1.0 - np.clip(y, 0.0, 1.0)


def compute_rope_cache(params: RopeParams, max_pos: int, device="cpu"):
    """Returns (cos, sin), each [max_pos, rot_dim//2] f32 on `device`."""
    half = params.rot_dim // 2
    dims = np.arange(half, dtype=np.float64)
    inv_freq = params.freq_base ** (-2.0 * dims / params.rot_dim)

    mscale = 1.0
    freq_scale = params.freq_scale
    if params.scaling_type == "longrope" and params.freq_factors:
        inv_freq = inv_freq / np.asarray(params.freq_factors,
                                         np.float64)[:half]
        mscale = params.yarn_attn_factor
    elif params.scaling_type == "yarn" and params.yarn_orig_ctx > 0 \
            and freq_scale != 1.0:
        lo = _yarn_find_correction_dim(params.rot_dim, params.freq_base,
                                       params.yarn_orig_ctx,
                                       params.yarn_beta_fast)
        hi = _yarn_find_correction_dim(params.rot_dim, params.freq_base,
                                       params.yarn_orig_ctx,
                                       params.yarn_beta_slow)
        lo, hi = max(0.0, math.floor(lo)), min(half - 1.0, math.ceil(hi))
        ramp = _yarn_ramp(lo, hi, dims)
        ext = params.yarn_ext_factor if params.yarn_ext_factor >= 0 else 1.0
        ramp = ramp * ext
        inv_freq = inv_freq * (ramp + freq_scale * (1.0 - ramp))
        mscale = params.yarn_attn_factor \
            * (1.0 + 0.1 * math.log(1.0 / freq_scale))
    else:
        inv_freq = inv_freq * freq_scale

    t = np.arange(max_pos, dtype=np.float64)
    freqs = np.outer(t, inv_freq)
    cos = np.cos(freqs).astype(np.float32) * mscale
    sin = np.sin(freqs).astype(np.float32) * mscale
    return (torch.from_numpy(cos).to(device),
            torch.from_numpy(sin).to(device))


def apply_rope(x: torch.Tensor, positions, cos: torch.Tensor,
               sin: torch.Tensor, mode: str = "norm") -> torch.Tensor:
    """x: [..., T, H, D]; positions: [..., T] int64 indices into the
    tables (the caller clamps sentinel positions), or None when cos/sin
    are already gathered per position ([..., T, half])."""
    if mode == "none":
        return x
    rot_dim = cos.shape[-1] * 2
    d = x.shape[-1]
    if positions is None:
        c = cos[..., None, :]
        s = sin[..., None, :]
    else:
        c = cos[positions][..., None, :]
        s = sin[positions][..., None, :]
    xr = x[..., :rot_dim].float()
    if mode == "norm":
        x0 = xr[..., 0::2]
        x1 = xr[..., 1::2]
        o0 = x0 * c - x1 * s
        o1 = x0 * s + x1 * c
        rotated = torch.stack([o0, o1], dim=-1).reshape(xr.shape)
    elif mode == "neox":
        half = rot_dim // 2
        x0 = xr[..., :half]
        x1 = xr[..., half:]
        o0 = x0 * c - x1 * s
        o1 = x0 * s + x1 * c
        rotated = torch.cat([o0, o1], dim=-1)
    else:
        raise ValueError(f"unknown rope mode {mode!r}")
    rotated = rotated.to(x.dtype)
    if rot_dim < d:
        rotated = torch.cat([rotated, x[..., rot_dim:]], dim=-1)
    return rotated


def mrope_section_index(sections, half: int) -> list[int]:
    """The position stream of each rotary half-dim under M-RoPE: the
    sections' dims in turn, dims past them on stream 0."""
    idx = [s for s, n in enumerate(sections) for _ in range(n)]
    return idx[:half] + [0] * (half - len(idx))


# (device, streams, sections, half) -> the stream index of each half-dim,
# made at a program's first, eager, use: a CUDA graph capture may not copy
# it from the host
_SECTION_INDEX: dict[tuple, torch.Tensor] = {}


def mrope_at(cos: torch.Tensor, sin: torch.Tensor, positions3: torch.Tensor,
             sections) -> tuple[torch.Tensor, torch.Tensor]:
    """The [P, half] tables gathered per M-RoPE section: half-dim i takes
    its value at the position of its section's stream. positions3 [S,
    ..., T] (the caller clamps sentinels; a stream the sections name past
    S reuses the last one, as JAX clips) -> [..., T, half] each, what
    apply_rope takes pre-gathered."""
    half, S = cos.shape[-1], positions3.shape[0]
    key = (positions3.device, S, tuple(sections), half)
    sel = _SECTION_INDEX.get(key)
    if sel is None:
        sel = _SECTION_INDEX[key] = torch.tensor(
            [min(i, S - 1) for i in mrope_section_index(sections, half)],
            device=positions3.device)
    p = positions3.index_select(0, sel).movedim(0, -1)    # [..., T, half]
    d = torch.arange(half, device=cos.device)
    return cos[p, d], sin[p, d]
