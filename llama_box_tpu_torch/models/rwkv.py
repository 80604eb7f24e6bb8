"""RWKV6 / RWKV7 in PyTorch (counterpart of llama_box_tpu/models/rwkv.py),
served by the recurrent branch (models/mamba.py RecCache and its prefill
and decode programs).

A layer's state is two token-shift rows (the post-ln1 and post-ln2 hidden
of the slot's last token, RecCache.conv [L, S, 2, E]) and the WKV matrix
state (RecCache.ssm [L, S, H, hs, hs]), both written in place. The WKV
recurrences run csrc/wkv.cu on the card (ops/wkv.wkv6 / wkv7), one kernel
for every T: JAX's chunked prefix scans and rwkv7's per-token step below
T = 8 become one call. The lerps, LoRAs, norms and gates are torch ops in
f32 around the projections, which run in the model's dtype (ops/qmatmul.mm)
as in JAX.
"""

from __future__ import annotations

import torch

from ..ops.norm import ln_per_head, norm_any
from ..ops.qmatmul import QTensor, dense_matmul, mm
from ..ops.wkv import wkv6, wkv7
from .config import ModelConfig
from .mamba import _softplus


def _ln(x, w, b, eps):
    """JAX `_ln`: LayerNorm in f32 (the row-norm kernel on the card)."""
    return norm_any(x.float(), w, b, "ln", eps)


def _group_norm(y, w, b, H, eps):
    """Per-head GroupNorm over y [S, T, H, hs] f32, then the flat [E]
    weight and bias (JAX `_group_norm`): a per-head LayerNorm whose weight
    rows are the flat weight's."""
    S_, T = y.shape[:2]
    if b is None:
        b = torch.zeros_like(w)
    return ln_per_head(y, w, b, eps).reshape(S_, T, -1)


def _token_shift(x, prev, seq_lens):
    """x [S, T, E] f32, prev [S, E] (a view into the cache): returns x_prev
    [S, T, E] and writes the last valid token's x into prev (a row with
    seq_lens 0 keeps its bits)."""
    xp = torch.cat([prev[:, None], x[:, :-1]], dim=1)
    idx = (seq_lens.long() - 1).clamp_min(0)
    last = x[torch.arange(x.shape[0], device=x.device), idx]
    prev.copy_(torch.where((seq_lens > 0)[:, None], last, prev))
    return xp


def _lerp5(lp, E):
    """rwkv6's per-stream lerp coefficients (w, k, v, r, g): the fused [5,
    1, 1, E] tensor when present, else the five separate ones."""
    if "tm_lerp_fused" in lp:
        f = lp["tm_lerp_fused"].float().reshape(5, E)
        return tuple(f[i] for i in range(5))
    return tuple(lp[k].float().reshape(E)
                 for k in ("tm_lerp_w", "tm_lerp_k", "tm_lerp_v",
                           "tm_lerp_r", "tm_lerp_g"))


def _rwkv6_time_mix(lp, x, shift0, s0, seq_lens, cfg: ModelConfig):
    """x [S, T, E] f32 (post-ln1); shift0 [S, E] and s0 [S, H, hs, hs] are
    updated in place. Returns out [S, T, E]."""
    S_, T, E = x.shape
    hs = cfg.wkv_head_size
    H = E // hs
    sx = _token_shift(x, shift0, seq_lens) - x
    dt = lp["tm_ln"].dtype        # the model dtype
    xxx = x + sx * lp["tm_lerp_x"].float().reshape(E)
    edim = lp["tm_w1"].shape[-1] // 5
    z = torch.tanh(mm(xxx.to(dt), lp["tm_w1"]).float()).reshape(S_, T, 5,
                                                                 edim)
    w2 = lp["tm_w2"].float()                            # [5, edim, E]
    m = torch.stack([dense_matmul(z[:, :, f], w2[f]) for f in range(5)],
                    dim=2)                              # [S, T, 5, E]
    lw, lk, lv, lr, lg = _lerp5(lp, E)
    xw = x + sx * (lw + m[:, :, 0])
    xk = x + sx * (lk + m[:, :, 1])
    xv = x + sx * (lv + m[:, :, 2])
    xr = x + sx * (lr + m[:, :, 3])
    xg = x + sx * (lg + m[:, :, 4])
    r = mm(xr.to(dt), lp["tm_r"]).float()
    k = mm(xk.to(dt), lp["tm_k"]).float()
    v = mm(xv.to(dt), lp["tm_v"]).float()
    g = torch.nn.functional.silu(mm(xg.to(dt), lp["tm_g"]).float())
    ww = lp["tm_decay"].float().reshape(E) + mm(
        torch.tanh(mm(xw.to(dt), lp["tm_decay_w1"]).float()).to(dt),
        lp["tm_decay_w2"]).float()
    w = torch.exp(-torch.exp(ww))
    shp = (S_, T, H, hs)
    y = wkv6(r.reshape(shp), k.reshape(shp), v.reshape(shp), w.reshape(shp),
             lp["tm_first"].float().reshape(H, hs), seq_lens, s0)
    # ln_x eps: RWKV-LM's 1e-5 x head_size_divisor^2 with divisor 8
    gn = _group_norm(y, lp["tm_ln"], lp.get("tm_ln_b"), H, 64e-5)
    return mm((gn * g).to(dt), lp["tm_o"])


def _rwkv6_channel_mix(lp, x, shift0, seq_lens, cfg: ModelConfig):
    """x [S, T, E] f32 (post-ln2); shift0 [S, E] is updated in place.
    Returns out [S, T, E] f32."""
    del cfg
    sx = _token_shift(x, shift0, seq_lens) - x
    E = x.shape[-1]
    wk = lp["cm_k"]
    dt = wk.qs.dtype if isinstance(wk, QTensor) else wk.dtype
    dt = torch.bfloat16 if dt == torch.int8 else dt
    xk = x + sx * lp["cm_lerp_k"].float().reshape(E)
    k = torch.square(torch.relu(mm(xk.to(dt), wk).float()))
    kv = mm(k.to(dt), lp["cm_v"]).float()
    if "cm_r" in lp:                                    # rwkv6's receptance
        xr = x + sx * lp["cm_lerp_r"].float().reshape(E)
        return torch.sigmoid(mm(xr.to(dt), lp["cm_r"]).float()) * kv
    return kv


def _l2norm_head(x, eps=1e-12):
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def _rwkv7_time_mix(lp, x, shift0, s0, v_first, seq_lens, cfg: ModelConfig):
    """RWKV7 time mix (JAX `_rwkv7_time_mix`). x [S, T, E] f32 post-ln1;
    shift0 [S, E] and s0 [S, H, hs(v), hs(k)] are updated in place;
    v_first [S, T, E] (layer 0, without the v LoRA, sets it). Returns
    (out, v_first)."""
    S_, T, E = x.shape
    hs = cfg.wkv_head_size
    H = E // hs
    sx = _token_shift(x, shift0, seq_lens) - x
    if "tm_lerp_fused" in lp:
        f = lp["tm_lerp_fused"].float().reshape(6, E)
        lr_, lw, lk, lv, la, lg = (f[i] for i in range(6))
    else:
        lr_, lw, lk, lv, la, lg = (
            lp[k].float().reshape(E)
            for k in ("tm_lerp_r", "tm_lerp_w", "tm_lerp_k", "tm_lerp_v",
                      "tm_lerp_a", "tm_lerp_g"))
    xr, xw, xk = x + sx * lr_, x + sx * lw, x + sx * lk
    xv, xa, xg = x + sx * lv, x + sx * la, x + sx * lg
    dt = lp["tm_ln"].dtype        # the model dtype
    r = mm(xr.to(dt), lp["tm_r"]).float()
    k = mm(xk.to(dt), lp["tm_k"]).float()
    v = mm(xv.to(dt), lp["tm_v"]).float()
    w0 = lp["tm_w0"].float().reshape(E)
    wl = mm(torch.tanh(mm(xw.to(dt), lp["tm_w1"]).float()).to(dt),
            lp["tm_w2"]).float()
    ww = -_softplus(-(w0 + wl)) - 0.5
    w = torch.exp(-torch.exp(ww))
    if "tm_v0" not in lp:
        v_first = v
    else:
        vg = torch.sigmoid(lp["tm_v0"].float().reshape(E) + mm(
            mm(xv.to(dt), lp["tm_v1"]).to(dt), lp["tm_v2"]).float())
        v = v + (v_first - v) * vg
    a = torch.sigmoid(lp["tm_a0"].float().reshape(E) + mm(
        mm(xa.to(dt), lp["tm_a1"]).to(dt), lp["tm_a2"]).float())
    g = mm(torch.sigmoid(mm(xg.to(dt), lp["tm_g1"]).float()).to(dt),
           lp["tm_g2"]).float()
    shp = (S_, T, H, hs)
    kk = _l2norm_head((k * lp["tm_kk"].float().reshape(E)).reshape(shp))
    k = k * (1.0 + (a - 1.0) * lp["tm_ka"].float().reshape(E))
    rh, kh, vh = r.reshape(shp), k.reshape(shp), v.reshape(shp)
    y = wkv7(rh, w.reshape(shp), kh, vh, kk, a.reshape(shp), seq_lens, s0)
    gn = _group_norm(y, lp["tm_ln"], lp.get("tm_ln_b"), H, 64e-5)
    rk = lp["tm_rk"].float().reshape(H, hs)
    bonus = ((rh * kh * rk).sum(-1, keepdim=True) * vh).reshape(S_, T, E)
    return mm(((gn + bonus) * g).to(dt), lp["tm_o"]), v_first


def is_rwkv(params) -> bool:
    gp = (params.get("layer_groups") or [params["layers"]])[0]
    return "tm_k" in gp


def rwkv_run_stack(params, cfg: ModelConfig, x, cache, seq_lens):
    """The rwkv layer loop (JAX `rwkv_run_stack`), each layer's token-shift
    rows and WKV state written in place; v_first carried across rwkv7's
    layer groups, the activations halved every rescale_every layers.
    Returns the hidden rows [S, T, E]."""
    from .llama import layer_params
    resc = cfg.rescale_every
    v_first = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for li, lp in enumerate(layer_params(params)):
        conv0, s0 = cache.conv[li], cache.ssm[li]
        h1 = _ln(x, lp["attn_norm"], lp.get("attn_norm_b"), cfg.rms_eps)
        if "tm_w0" in lp:
            att, v_first = _rwkv7_time_mix(lp, h1, conv0[:, 0], s0, v_first,
                                           seq_lens, cfg)
        else:
            att = _rwkv6_time_mix(lp, h1, conv0[:, 0], s0, seq_lens, cfg)
        x = x + att.to(x.dtype)
        h2 = _ln(x, lp["attn_norm_2"], lp.get("attn_norm_2_b"), cfg.rms_eps)
        x = x + _rwkv6_channel_mix(lp, h2, conv0[:, 1], seq_lens,
                                   cfg).to(x.dtype)
        if resc > 0 and (li + 1) % resc == 0:
            # llama.cpp: activations halve every rescale_every layers (the
            # converter pre-divides later layers' output projections)
            x = x * 0.5
    return x
