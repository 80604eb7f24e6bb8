"""Attention written out in torch (counterpart of
llama_box_tpu/ops/attention.py): the arithmetic and the position masks
the flash kernels' plain versions share."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def softmax_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor, scale: float, softcap: float = 0.0,
                   sinks: torch.Tensor | None = None,
                   alibi: torch.Tensor | None = None,
                   dist: torch.Tensor | None = None) -> torch.Tensor:
    """The arithmetic the flash kernels compute, written out in full: the
    core of their plain versions (ops/flash_prefill, ops/flash_decode).

    q [B, Hkv, G, T, D]; k/v [B, K, Hkv, D|Dv] already in q's dtype;
    mask [B, T, K] bool; sinks [Hkv, G] per-head sink logits or None;
    alibi [Hkv, G] f32 per-head ALiBi slopes with dist [B, T, K] (key
    position minus query position), or None: each score gets slope x dist
    after the scale and before the softcap and the mask (the order of the
    JAX model's _attn_deferred).
    Scores accumulate in f32 from q's dtype; the unnormalized
    probabilities are rounded to q's dtype before they weight V (the
    kernels' rounding point); keys no row can see are zeroed first, so a
    NaN in a position the kernels never read cannot reach the output.
    Returns [B, Hkv, G, T, Dv] f32."""
    vis = mask.any(dim=1)[:, :, None, None]
    zero = torch.zeros((), dtype=k.dtype, device=k.device)
    k = torch.where(vis, k, zero)
    v = torch.where(vis, v, zero)
    s = torch.einsum("bhgtd,bkhd->bhgtk", q.float(), k.float()) * scale
    if alibi is not None:
        sl = alibi.float().to(q.device)[None, :, :, None, None]
        s = s + sl * dist.float()[:, None, None]
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    m5 = mask[:, None, None]
    s = torch.where(m5, s, torch.full_like(s, NEG_INF))
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - mx) * m5
    den = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgtk,bkhd->bhgtd", p.to(q.dtype).float(), v.float())
    if sinks is not None:
        snk = sinks.float().to(q.device)[None, :, :, None, None]
        m_fin = torch.maximum(mx, snk)
        f = torch.exp(mx - m_fin)
        den = den * f + torch.exp(snk - m_fin)
        acc = acc * f
    return acc / den.clamp_min(1e-30)


def pos_visible(kpos: torch.Tensor, qpos: torch.Tensor, window: int,
                chunk: int) -> torch.Tensor:
    """Causal + sliding-window + aligned-chunk visibility of key positions
    from query positions (broadcasting int tensors)."""
    ok = kpos <= qpos
    if window > 0:
        ok = ok & (kpos > qpos - window)
    if chunk > 0:
        ok = ok & (torch.div(kpos, chunk, rounding_mode="floor")
                   == torch.div(qpos, chunk, rounding_mode="floor"))
    return ok
