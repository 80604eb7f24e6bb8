"""The recurrent families in PyTorch (counterpart of
llama_box_tpu/models/mamba.py, which models/rwkv.py joins): mamba's
selective state-space mixer (falcon-mamba's dt/B/C norms, jamba's learned
ones), mamba2's SSD mixer (grouped B/C, the gated norm or none), lfm2's
gated short conv, qwen3-next's gated DeltaNet, and the hybrids whose
other layers attend (jamba, bamba / granitehybrid, nemotron_h, lfm2,
qwen3next) or run both beside each other (falcon-h1), or are FFN-only
blocks (nemotron_h).

A slot's history is a constant-size state instead of a KV cache (RecCache:
the conv tail and the SSM or WKV state a layer; a hybrid's attention
layers add a KV cache of their own). The recurrences run the hand-written
kernels on the card, a CPU tensor their plain versions: the selective scan
(ops/ssm_scan, csrc/ssm_scan.cu) for mamba and mamba2, the matrix-state
rules (ops/wkv, csrc/wkv.cu) for the DeltaNet and rwkv6/7. The depthwise
causal conv, the gating and the projections are torch ops around them.

Where the JAX programs donate the cache and return a new one, every state
here is written in place, into the tensors the engine's CUDA graphs
captured: a forward's mixers write each layer's conv tail and state as
they go, a hybrid's attention rows go in with one scatter at the end of a
prefill or of each decode step (models/llama.write_rows). A row at or
after its slot's valid count changes no state bit (the JAX identity
elements), so one program serves slots that prefill, decode or sit out.

Rounding points follow the JAX functions: the projections in the model's
dtype (ops/qmatmul.mm), everything between them in f32, the state f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.norm import rms_norm
from ..ops.qmatmul import QTensor, mm
from ..ops.ssm_scan import ssm_scan
from ..ops.wkv import delta_rule
from . import llama as _llama
from .config import ModelConfig


class RecCache(NamedTuple):
    """Per-slot recurrent state, layer-stacked (JAX `RecCache`): conv [Lr,
    S, dc-1, conv width] (rwkv: [Lr, S, 2, E], the two token-shift rows),
    ssm [Lr, S, ...] f32 (mamba1 [di, ds], mamba2 [nh, hd, ds], DeltaNet
    [nh, Dk, Dv], rwkv [H, hs, hs], lfm2 a [1, 1] placeholder); a hybrid's
    attention layers add k / v [La, S, C, Hkv, D], else None."""
    conv: torch.Tensor
    ssm: torch.Tensor
    k: torch.Tensor | None = None
    v: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        # positions are bookkeeping only for pure-recurrent models
        return self.k.shape[2] if self.k is not None else (1 << 30)

    @property
    def quantized(self) -> bool:
        return False


def _n_layers(gp: dict) -> int:
    lead = next(iter(gp.values()))
    return lead.qs.shape[0] if isinstance(lead, QTensor) else lead.shape[0]


def _is_rec(gp: dict) -> bool:
    return "ssm_in" in gp or "shortconv_in" in gp or "tm_k" in gp


def _count_layers(params) -> tuple[int, int]:
    """(n_recurrent, n_attention) over the layer groups: a parallel-hybrid
    layer (falcon-h1) counts in both, an FFN-only block (nemotron_h) in
    neither."""
    nr = na = 0
    for gp in _llama.layer_groups(params):
        n = _n_layers(gp)
        nr += n if _is_rec(gp) else 0
        na += n if "wq" in gp or "wqkv" in gp else 0
    return nr, na


def _ssm_style(gp: dict, cfg: ModelConfig) -> bool:
    """True for a mamba2 / SSD mixer: a scalar decay a head (stacked ssm_a
    [L, nh]; mamba1's is [L, di, ds])."""
    a = gp.get("ssm_a")
    if a is not None:
        return a.dim() == 2
    return cfg.arch == "mamba2"


def init_rec_cache(cfg: ModelConfig, n_slots: int, capacity: int = 0,
                   params=None, dtype=torch.float32,
                   device="cuda") -> RecCache:
    """Zero state for n_slots slots (JAX `init_rec_cache`); the mixer's
    geometry comes from the loaded tensors where there are any. A hybrid's
    KV cache holds `capacity` positions in `dtype`, which is bf16 for an
    int8 request (no quantized hybrid KV, as in JAX)."""
    dev = torch.device(device)
    dc, di, ds = cfg.ssm_d_conv, cfg.ssm_d_inner, cfg.ssm_d_state
    Lr, La = (cfg.n_layers, 0) if params is None else _count_layers(params)
    f32 = torch.float32
    k = v = None
    if La > 0:
        if capacity <= 0:
            raise ValueError("a hybrid model needs a KV capacity")
        if dtype == torch.int8:
            dtype = torch.bfloat16
        k = torch.zeros((La, n_slots, capacity, cfg.n_kv_heads,
                         cfg.head_dim), dtype=dtype, device=dev)
        v = torch.zeros_like(k)

    def cache(conv_shape, ssm_shape):
        return RecCache(torch.zeros((Lr, n_slots) + conv_shape, dtype=f32,
                                    device=dev),
                        torch.zeros((Lr, n_slots) + ssm_shape, dtype=f32,
                                    device=dev), k, v)

    if cfg.wkv_head_size > 0:
        hs = cfg.wkv_head_size
        return cache((2, cfg.n_embd), (cfg.n_embd // hs, hs, hs))
    conv_dim = di
    mamba2 = cfg.arch == "mamba2"
    nh = cfg.ssm_dt_rank
    if params is not None:
        for gp in _llama.layer_groups(params):
            if "shortconv_in" in gp:    # lfm2: the conv tail only
                w = gp["shortconv_conv"]
                return cache((w.shape[-1] - 1, w.shape[-2]), (1, 1))
            if "ssm_ba" in gp:          # qwen3-next's gated DeltaNet
                w = gp["ssm_conv_w"]
                return cache((w.shape[-1] - 1, w.shape[-2]),
                             (gp["ssm_a"].shape[-1], ds,
                              gp["ssm_norm"].shape[-1]))
            if "ssm_in" in gp:
                conv_dim = gp["ssm_conv_w"].shape[-2]
                mamba2 = gp["ssm_a"].dim() == 2
                if mamba2:
                    nh = gp["ssm_a"].shape[-1]
                break
    elif mamba2:
        conv_dim = di + 2 * max(cfg.ssm_n_group, 1) * ds
    if mamba2:
        return cache((dc - 1, conv_dim), (nh, di // nh, ds))
    return cache((dc - 1, conv_dim), (di, ds))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jnp.logaddexp(x, 0), as JAX's softplus computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _silu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x)


def _causal_conv(conv0, xc, w, b, seq_lens):
    """The depthwise causal conv over time with a carried tail (JAX
    `_causal_conv`): xc [S, T, C] f32, conv0 [S, dc-1, C] (the entering
    tail, a view into the cache), w [C, dc]. Returns out [S, T, C] f32 and
    writes the new tail, the last dc-1 valid inputs a row, into conv0 (a
    row with seq_lens 0 rewrites its own bits)."""
    T = xc.shape[1]
    dc = w.shape[1]
    ext = torch.cat([conv0, xc], dim=1)                # [S, dc-1+T, C]
    wf = w.float()
    out = ext[:, 0:T] * wf[:, 0]
    for k in range(1, dc):
        out = out + ext[:, k:k + T] * wf[:, k]
    if b is not None:
        out = out + b.float()
    idx = seq_lens.long()[:, None] + torch.arange(dc - 1, device=xc.device)
    conv0.copy_(ext.gather(1, idx[:, :, None].expand(-1, -1, ext.shape[2])))
    return out


def _mixer(lp, r, conv0, ssm0, seq_lens, cfg: ModelConfig):
    """One mamba mixer over a [S, T, E] chunk (JAX `_mixer`), falcon-mamba's
    weightless dt/B/C RMS norms and jamba's learned ones; the states conv0
    [S, dc-1, di] and ssm0 [S, di, ds] are updated in place. Returns out
    [S, T, E] in r's dtype."""
    di, ds, dtr = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_dt_rank
    xz = mm(r, lp["ssm_in"])                           # [S, T, 2 di]
    xc = xz[..., :di].float()
    z = xz[..., di:].float()
    x_act = _silu(_causal_conv(conv0, xc, lp["ssm_conv_w"],
                               lp.get("ssm_conv_b"), seq_lens))
    xdb = mm(x_act.to(r.dtype), lp["ssm_x"])           # [S, T, dtr + 2 ds]
    dt_in = xdb[..., :dtr]
    B = xdb[..., dtr:dtr + ds].float()
    C = xdb[..., dtr + ds:].float()
    if cfg.ssm_dt_b_c_rms:
        ones = torch.ones
        dt_in = rms_norm(dt_in, ones(dtr, device=r.device), cfg.rms_eps)
        B = rms_norm(B, ones(ds, device=r.device), cfg.rms_eps)
        C = rms_norm(C, ones(ds, device=r.device), cfg.rms_eps)
    if lp.get("ssm_dt_norm") is not None:
        dt_in = rms_norm(dt_in, lp["ssm_dt_norm"], cfg.rms_eps)
        B = rms_norm(B, lp["ssm_b_norm"], cfg.rms_eps)
        C = rms_norm(C, lp["ssm_c_norm"], cfg.rms_eps)
    dt = mm(dt_in, lp["ssm_dt"]).float()
    if lp.get("ssm_dt_b") is not None:
        dt = dt + lp["ssm_dt_b"].float()
    dt = _softplus(dt)                                 # [S, T, di]
    y = ssm_scan(x_act, dt, lp["ssm_a"].float(), B[:, :, None],
                 C[:, :, None], lp["ssm_d"].float(), seq_lens, ssm0)
    y = y * _silu(z)
    return mm(y.to(r.dtype), lp["ssm_out"])


def _mixer2(lp, r, conv0, ssm0, seq_lens, cfg: ModelConfig):
    """The mamba2 / SSD mixer (JAX `_mixer2`): conv over x|B|C, a scalar
    decay a head, grouped B/C, then the gated RMSNorm over the inner width
    (none on falcon-h1). ssm0 [S, nh, hd, ds] is updated in place."""
    S, T, _ = r.shape
    di, ds = cfg.ssm_d_inner, cfg.ssm_d_state
    nh = lp["ssm_a"].shape[-1]
    conv_dim = lp["ssm_conv_w"].shape[-2]
    ng = max((conv_dim - di) // (2 * ds), 1)
    zxbcdt = mm(r, lp["ssm_in"])          # [S, T, 2 di + 2 ng ds + nh]
    z = zxbcdt[..., :di].float()
    xBC = zxbcdt[..., di:di * 2 + 2 * ng * ds].float()
    dt = zxbcdt[..., -nh:].float()
    xBC = _silu(_causal_conv(conv0, xBC, lp["ssm_conv_w"],
                             lp.get("ssm_conv_b"), seq_lens))
    x = xBC[..., :di]
    B = xBC[..., di:di + ng * ds].reshape(S, T, ng, ds)
    C = xBC[..., di + ng * ds:].reshape(S, T, ng, ds)
    if lp.get("ssm_dt_b") is not None:
        dt = dt + lp["ssm_dt_b"].float()
    dt = _softplus(dt)                                 # [S, T, nh]
    y = ssm_scan(x, dt, lp["ssm_a"].float().reshape(nh), B, C,
                 lp["ssm_d"].float().reshape(nh), seq_lens,
                 ssm0.view(S, di, ds))
    y = y * _silu(z)
    if "ssm_norm" in lp:
        y = rms_norm(y, lp["ssm_norm"], cfg.rms_eps)
    return mm(y.to(r.dtype), lp["ssm_out"])


def _mixer_shortconv(lp, r, conv0, ssm0, seq_lens, cfg: ModelConfig):
    """lfm2's gated short conv (JAX `_mixer_shortconv`): in_proj -> B, C,
    x thirds; y = C * conv(B * x); out_proj. Only the conv tail is state."""
    del ssm0, cfg
    bcx = mm(r, lp["shortconv_in"])
    E3 = bcx.shape[-1] // 3
    B = bcx[..., :E3].float()
    C = bcx[..., E3:2 * E3].float()
    xg = bcx[..., 2 * E3:].float()
    conv = _causal_conv(conv0, B * xg, lp["shortconv_conv"],
                        lp.get("shortconv_conv_b"), seq_lens)
    return mm((C * conv).to(r.dtype), lp["shortconv_out"])


def _l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def _mixer_deltanet(lp, r, conv0, ssm0, seq_lens, cfg: ModelConfig):
    """qwen3-next's gated DeltaNet (JAX `_mixer_deltanet`): conv + silu
    over the flattened q|k|v, L2-normed q / k, alpha = exp(A softplus(a +
    dt_bias)), beta = sigmoid(b), the delta rule on the [nh, Dk, Dv] state
    (updated in place), then the per-head RMSNorm and the silu(z) gate."""
    Sb, T, _ = r.shape
    nh = lp["ssm_a"].shape[-1]
    Dv = lp["ssm_norm"].shape[-1]
    Dk = cfg.ssm_d_state
    conv_dim = lp["ssm_conv_w"].shape[-2]
    value_dim = nh * Dv
    key_dim = (conv_dim - value_dim) // 2
    hk = key_dim // Dk
    R = nh // hk
    qkvz = mm(r, lp["ssm_in"]).float().reshape(Sb, T, hk, 2 * Dk + 2 * R * Dv)
    ba = mm(r, lp["ssm_ba"]).float().reshape(Sb, T, hk, 2 * R)
    q = qkvz[..., :Dk]
    k = qkvz[..., Dk:2 * Dk]
    v = qkvz[..., 2 * Dk:2 * Dk + R * Dv]
    z = qkvz[..., 2 * Dk + R * Dv:].reshape(Sb, T, nh, Dv)
    b = ba[..., :R].reshape(Sb, T, nh)
    a = ba[..., R:].reshape(Sb, T, nh)
    mixed = torch.cat([q.reshape(Sb, T, key_dim), k.reshape(Sb, T, key_dim),
                       v.reshape(Sb, T, value_dim)], dim=-1)
    mixed = _silu(_causal_conv(conv0, mixed, lp["ssm_conv_w"],
                               lp.get("ssm_conv_b"), seq_lens))
    q = mixed[..., :key_dim].reshape(Sb, T, hk, Dk)
    k = mixed[..., key_dim:2 * key_dim].reshape(Sb, T, hk, Dk)
    v = mixed[..., 2 * key_dim:].reshape(Sb, T, nh, Dv)
    q = _l2norm(q) * (Dk ** -0.5)
    k = _l2norm(k)
    beta = torch.sigmoid(b)
    alpha = torch.exp(lp["ssm_a"].float()
                      * _softplus(a + lp["ssm_dt_b"].float()))
    y = delta_rule(q, k, v, alpha, beta, seq_lens, ssm0)   # [S, T, nh, Dv]
    y = rms_norm(y, lp["ssm_norm"], cfg.rms_eps) * _silu(z)
    return mm(y.reshape(Sb, T, value_dim).to(r.dtype), lp["ssm_out"])


def _pick_mixer(gp: dict, cfg: ModelConfig):
    if "ssm_ba" in gp:
        return _mixer_deltanet
    if "shortconv_in" in gp:
        return _mixer_shortconv
    return _mixer2 if _ssm_style(gp, cfg) else _mixer


def _rec_layer(lp, x, conv0, ssm0, seq_lens, cfg: ModelConfig, mixer):
    """One recurrent layer (JAX `_rec_layer`): RMSNorm -> mixer ->
    residual, then the FFN block a hybrid (jamba) attaches."""
    r = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    x = x + mixer(lp, r, conv0, ssm0, seq_lens, cfg).to(x.dtype)
    if "w_up" in lp or "w_gate_inp" in lp:
        h = _llama._pre_norm(x, lp, "ffn_norm", cfg)
        x = x + _llama._ffn_block(h, lp, cfg, x.dtype)
    return x


class AttnOperands(NamedTuple):
    """What a hybrid's attention layers read in one forward: the rows'
    positions [S, T] and the rope tables gathered there, the row writes,
    and either the flash prefill meta [S, 4] (a chunk) or the flash decode
    meta [S, 2] with its one-row chain (a decode step)."""
    positions: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    writes: _llama.RowWrites
    flash_meta: torch.Tensor | None = None
    decode_meta: torch.Tensor | None = None


def _run_rec_stack(params, cfg: ModelConfig, x, cache: RecCache, seq_lens,
                   attn: AttnOperands | None = None):
    """The layer loop (JAX `_run_rec_stack`), each layer's state written in
    place: rwkv stacks through models/rwkv.rwkv_run_stack; else layer by
    layer over the groups, a recurrent layer through its mixer, an
    attention layer through models/llama._attn_layer against the hybrid's
    KV (its own index among the attention layers), falcon-h1's layers
    both on the same normed input (the mixer's output rides the attention
    tail's extra residual), an FFN-only block (nemotron_h) norm and FFN.
    The attention rows go into the cache in one scatter at the end.
    Returns the hidden rows [S, T, E]."""
    from .rwkv import is_rwkv, rwkv_run_stack
    if is_rwkv(params):
        return rwkv_run_stack(params, cfg, x, cache, seq_lens)
    kv = None if cache.k is None else _llama.KVCache(cache.k, cache.v)
    rows: list = []
    chain = None
    if attn is not None and attn.decode_meta is not None and kv is not None:
        chain = _llama.init_chain_rows(cfg, kv, 1)
    win = alibi = None
    if kv is not None:
        win = _llama.layer_windows(cfg, x.device)[0]
        alibi = _llama.alibi_slopes(cfg, x.device)

    def attend(x, lp, o_a, extra=None):
        return _llama._attn_layer(
            x, lp, o_a, kv, cfg, attn.cos, attn.sin, rows, win, alibi,
            flash_meta=attn.flash_meta, chain=chain, step=0,
            decode_meta=attn.decode_meta, positions=attn.positions,
            extra_residual=extra)

    o_r = o_a = 0
    for gp in _llama.layer_groups(params):
        rec = _is_rec(gp)
        mixer = _pick_mixer(gp, cfg) if rec else None
        has_attn = "wq" in gp or "wqkv" in gp
        cols = {k: v.unbind(0) for k, v in gp.items()}
        for j in range(_n_layers(gp)):
            lp = {k: v[j] for k, v in cols.items()}
            if rec and has_attn:
                # falcon-h1: attention and the mixer on the same normed
                # input, x + attn + mixer, then the FFN block
                r = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
                mo = mixer(lp, r, cache.conv[o_r], cache.ssm[o_r], seq_lens,
                           cfg)
                x = attend(x, lp, o_a, mo)
                o_r += 1
                o_a += 1
            elif rec:
                x = _rec_layer(lp, x, cache.conv[o_r], cache.ssm[o_r],
                               seq_lens, cfg, mixer)
                o_r += 1
            elif has_attn:
                x = attend(x, lp, o_a)
                o_a += 1
            else:
                h = _llama._pre_norm(x, lp, "attn_norm", cfg)
                x = x + _llama._ffn_block(h, lp, cfg, x.dtype)
    if rows:
        fields = [torch.stack([r[f] for r in rows])
                  for f in range(len(rows[0]))]
        _llama.write_rows(kv, fields, attn.writes)
    return x


def _rec_logits(params, cfg: ModelConfig, x):
    return _llama._output_logits(params, cfg, x)


def _embed(params, cfg: ModelConfig, tokens):
    return _llama._embed_tokens(params, cfg, tokens)


def _attn_operands(cache: RecCache, raw, live, rope_cos, rope_sin, slots,
                   flash_meta=None, decode=False):
    """A hybrid's AttnOperands for rows at positions `raw` [S, T] (int64)
    of cache slots `slots` [S], live where `live` [S, T] (a masked row
    takes the sentinel position C: attended by nothing, rotated at the
    table's end, never written). Row t of slot b writes position raw mod
    C when live and inside the cache, so a slot's writes never share a
    position. Without rope tables the rows rotate by JAX's stand-in, a
    [1, 1] zero table."""
    C = cache.capacity
    positions = torch.where(live, raw, C)
    if rope_cos is None or rope_cos.dim() < 2:
        rope_cos = rope_sin = torch.zeros(1, 1, device=raw.device)
    cos, sin = _llama._rope_at(rope_cos, rope_sin, positions)
    writes = _llama.RowWrites(slots[:, None].expand_as(raw), raw % C,
                              live & (raw < C))
    meta = None
    if decode:
        cpos = torch.where(positions[:, 0] >= C, 0, positions[:, 0])
        meta = torch.stack([cpos, torch.ones_like(cpos)],
                           dim=1).to(torch.int32)
    return AttnOperands(positions, cos, sin, writes, flash_meta, meta)


# -- prefill ------------------------------------------------------------------


def rec_prefill_batch_impl(params, cfg: ModelConfig, tokens, pos_base,
                           n_valid, cache: RecCache, rope_cos=None,
                           rope_sin=None):
    """Batched prefill (JAX `rec_prefill_batch_impl`): one chunk a slot,
    tokens [S, T], pos_base / n_valid [S] (host arrays or device tensors);
    a row with n_valid 0 keeps its state. The states are written in place.
    Returns (last-token logits [S, V] f32, cache)."""
    dev = cache.conv.device
    tokens = torch.as_tensor(tokens).to(dev)
    pos_base = torch.as_tensor(pos_base).to(dev, torch.int64)
    n_valid = torch.as_tensor(n_valid).to(dev, torch.int64)
    S, T = tokens.shape
    x = _embed(params, cfg, tokens)
    attn = None
    if cache.k is not None:
        t = torch.arange(T, device=dev)[None, :]
        zeros = torch.zeros_like(pos_base)
        meta = torch.stack([pos_base, n_valid, zeros, zeros],
                           dim=1).to(torch.int32)
        attn = _attn_operands(cache, pos_base[:, None] + t,
                              t < n_valid[:, None], rope_cos, rope_sin,
                              torch.arange(S, device=dev), flash_meta=meta)
    x = _run_rec_stack(params, cfg, x, cache, n_valid, attn)
    last = (n_valid - 1).clamp_min(0)
    x_last = x[torch.arange(S, device=dev), last]
    return _rec_logits(params, cfg, x_last), cache


def _slot_view(cache: RecCache, slot: int) -> RecCache:
    def sl(a):
        return None if a is None else a[:, slot:slot + 1]
    return RecCache(sl(cache.conv), sl(cache.ssm), sl(cache.k), sl(cache.v))


def rec_prefill_impl(params, cfg: ModelConfig, tokens, cache: RecCache,
                     slot: int, pos_base: int, n_valid: int, rope_cos=None,
                     rope_sin=None):
    """A single-slot chunk (JAX `rec_prefill_impl`): tokens [T] into slot
    `slot` (a host int: the slot's views of the cache are written in
    place). Returns (last-valid-token logits [V], cache)."""
    view = _slot_view(cache, int(slot))
    tokens = torch.as_tensor(tokens).reshape(1, -1)
    logits, _ = rec_prefill_batch_impl(params, cfg, tokens, [int(pos_base)],
                                       [int(n_valid)], view, rope_cos,
                                       rope_sin)
    return logits[0], cache


# -- decode -------------------------------------------------------------------


def _decode_step(params, cfg: ModelConfig, tok, pos, active,
                 cache: RecCache, rope_cos, rope_sin):
    """One row a slot: tok [S] at pos [S] (int64) where active [S]; an
    inactive slot keeps its state (seq_lens 0) and writes no KV row.
    Returns logits [S, V] f32."""
    seq_lens = active.long()
    x = _embed(params, cfg, tok[:, None])
    attn = None
    if cache.k is not None:
        attn = _attn_operands(cache, pos[:, None], active[:, None], rope_cos,
                              rope_sin, torch.arange(tok.shape[0],
                                                     device=tok.device),
                              decode=True)
    x = _run_rec_stack(params, cfg, x, cache, seq_lens, attn)
    return _rec_logits(params, cfg, x[:, 0])


def rec_decode_verify_sample(params, cfg: ModelConfig, tokens, pos0,
                             cache: RecCache, sstate, arrs, fwd_active,
                             samp_active, rope_cos=None, rope_sin=None,
                             samp_extras: bool = True, samp_kcap: int = 0):
    """The one-token pass (JAX `rec_decode_verify_sample`; no drafts on a
    recurrent model): tokens [S, 1] at pos0 [S], the fwd_active slots
    advanced, the samp_active ones sampled (sampling.verify_impl at
    n_draft 0). Returns (tokens [S, 1], n_emitted [S], ids, probs, tokps,
    logits [S, V] f32, cache, sstate)."""
    from ..sampling import verify_impl
    logits = _decode_step(params, cfg, tokens[:, 0], pos0, fwd_active, cache,
                          rope_cos, rope_sin)
    zero = torch.zeros_like(pos0)
    toks, n_em, ids, probs, tokps, sstate = verify_impl(
        logits[:, None], tokens[:, :1], zero, sstate, arrs, samp_active,
        extras=samp_extras, kcap=samp_kcap)
    return toks, n_em, ids, probs, tokps, logits, cache, sstate


def rec_decode_chain(params, cfg: ModelConfig, token0, pos0, cache: RecCache,
                     sstate, arrs, active, rope_cos=None, rope_sin=None,
                     n_steps: int = 8, samp_extras: bool = True,
                     samp_kcap: int = 0):
    """n_steps decode steps and samples with no host sync between them
    (JAX `rec_decode_chain`; one CUDA graph on the card), the state (and a
    hybrid's KV rows, step by step) written in place; an inactive slot's
    state keeps its bits. Returns (tokens [S, K], ids [S, K, NP], probs,
    tokps [S, K], cache, sstate)."""
    from ..sampling import sample_impl
    tok = token0
    outs = []
    for j in range(n_steps):
        logits = _decode_step(params, cfg, tok, pos0 + j, active, cache,
                              rope_cos, rope_sin)
        tok, ids, probs, tokp, sstate = sample_impl(
            logits, sstate, arrs, active, extras=samp_extras, kcap=samp_kcap)
        outs.append((tok, ids, probs, tokp))
    toks, ids, probs, tokps = (torch.stack(x, dim=1) for x in zip(*outs))
    return toks, ids, probs, tokps, cache, sstate


# -- in-place state edits (outside any graph) ----------------------------------


def reset_rec_slot(cache: RecCache, slot: int) -> RecCache:
    """Zero one slot's recurrent state (a fresh prompt); a hybrid's KV rows
    stay: the new prefill overwrites them and the causal mask hides the
    rest."""
    cache.conv[:, slot].zero_()
    cache.ssm[:, slot].zero_()
    return cache


def copy_rec_state(cache: RecCache, src: int, dst: int) -> RecCache:
    """Slot src's whole state into slot dst, every leaf."""
    for a in cache:
        if a is not None:
            a[:, dst].copy_(a[:, src])
    return cache
