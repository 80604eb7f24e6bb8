"""Batched sampling chain on the device (counterpart of
llama_box_tpu/sampling.py: SamplerParams, the sampler state, and
sample_impl's chain).

The chain is the reference's default: penalties -> top-k -> top-p -> min-p
-> typical -> xtc -> temperature -> dist, plus logit bias, ignore-eos and
greedy (temp <= 0), over a top-N_CAND candidate set. It runs as torch ops
over the decode batch [B, V]; nothing crosses to the host per step.

Randomness is counter-based, as in the JAX sampler (`fold_in(PRNGKey(seed),
step)` per slot): every uniform is an integer hash of (the slot's seed,
its `step`, the stream, the draw's index), computed by the same int64
torch ops on the CPU and on the card, so the draws agree bit for bit
between the two, depend on nothing but (seed, step), and need no host
state (a decode chain replays as one CUDA graph). Every row draws; only
active rows advance `step`. The hash is not the JAX package's threefry:
seeded sampling agrees with it in distribution, not token by token. The
host-side sampler (mirostat, DRY, grammar) is not ported yet; such
requests are refused at admission.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .utils.staging import StagedBuffer

NEG_INF = -1e30
N_CAND = 256     # candidate-set width; exact for any top_k <= N_CAND
N_PROBS = 16     # top-probs returned for logprobs rendering
RING_CAP = 256   # static penalty-window cap (penalty_last_n clamps to this)
BIAS_CAP = 64    # static per-request logit-bias slots


@dataclasses.dataclass
class SamplerParams:
    """Per-request sampling knobs (defaults mirror engine_param.hpp:131-136)."""
    seed: int = 0xFFFFFFFF
    temp: float = 0.8
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    typ_p: float = 1.0
    xtc_probability: float = 0.0
    xtc_threshold: float = 0.10
    penalty_last_n: int = 64
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    logit_bias: dict[int, float] = dataclasses.field(default_factory=dict)
    ignore_eos: bool = False
    n_probs: int = 0
    grammar: object = None
    grammar_lazy: bool = False
    grammar_triggers: tuple = ()
    mirostat: int = 0
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    dry_multiplier: float = 0.0
    dry_base: float = 1.75
    dry_allowed_length: int = 2
    dry_penalty_last_n: int = -1
    dry_sequence_breakers: tuple = ("\n", ":", "\"", "*")
    dynatemp_range: float = 0.0
    dynatemp_exponent: float = 1.0
    top_n_sigma: float = -1.0
    samplers: tuple = ()

    @property
    def is_greedy(self) -> bool:
        return self.temp <= 0.0

    @property
    def needs_host_sampler(self) -> bool:
        """True when the request needs the host sampling path (grammar,
        mirostat, DRY, or a reordered chain)."""
        return (self.grammar is not None or self.mirostat > 0
                or self.dry_multiplier > 0.0
                or (bool(self.samplers)
                    and not samplers_order_canonical(self.samplers)))

    @property
    def plain(self) -> bool:
        """Only the common chain (top-k / top-p / min-p / temperature) is
        needed: sample_impl's extras=False path applies. `ignore_eos`
        rides the logit bias, so it needs the full chain (the JAX chain's
        plain test leaves it out and can sample an end-of-generation
        token for such a request)."""
        return (not self.logit_bias
                and not self.ignore_eos
                and self.penalty_repeat == 1.0
                and self.penalty_freq == 0.0
                and self.penalty_present == 0.0
                and self.typ_p >= 1.0
                and self.xtc_probability <= 0.0
                and self.top_n_sigma <= 0.0
                and self.dynatemp_range <= 0.0)


CHAIN_ORDER = ("penalties", "dry", "top_n_sigma", "top_k", "top_p",
               "min_p", "typ_p", "xtc", "temperature")

_SAMPLER_CHARS = {"e": "penalties", "d": "dry", "s": "top_n_sigma",
                  "k": "top_k", "p": "top_p", "m": "min_p", "y": "typ_p",
                  "x": "xtc", "t": "temperature"}
_SAMPLER_ALIASES = {"temp": "temperature", "typical_p": "typ_p",
                    "typical": "typ_p", "typ-p": "typ_p", "typ": "typ_p",
                    "top-k": "top_k", "top-p": "top_p", "min-p": "min_p",
                    "top-n-sigma": "top_n_sigma", "nsigma": "top_n_sigma"}


def sampler_types_from_names(names) -> tuple[str, ...]:
    out = []
    for raw in names:
        if not isinstance(raw, str):
            continue
        name = raw.strip().lower()
        name = _SAMPLER_ALIASES.get(name, name)
        if name in CHAIN_ORDER and name not in out:
            out.append(name)
    return tuple(out)


def sampler_types_from_chars(chars: str) -> tuple[str, ...]:
    out = []
    for c in chars.strip().lower():
        name = _SAMPLER_CHARS.get(c)
        if name and name not in out:
            out.append(name)
    return tuple(out)


def samplers_order_canonical(samplers) -> bool:
    idx = [CHAIN_ORDER.index(s) for s in samplers if s in CHAIN_ORDER]
    return all(a <= b for a, b in zip(idx, idx[1:]))


def restrict_to_samplers(sp: SamplerParams) -> SamplerParams:
    """Neutralize the knobs of samplers excluded from sp.samplers."""
    if not sp.samplers:
        return sp
    s = set(sp.samplers)
    kw = {}
    if "penalties" not in s:
        kw.update(penalty_repeat=1.0, penalty_freq=0.0, penalty_present=0.0)
    if "dry" not in s:
        kw["dry_multiplier"] = 0.0
    if "top_n_sigma" not in s:
        kw["top_n_sigma"] = -1.0
    if "top_k" not in s:
        kw["top_k"] = 0
    if "top_p" not in s:
        kw["top_p"] = 1.0
    if "min_p" not in s:
        kw["min_p"] = 0.0
    if "typ_p" not in s:
        kw["typ_p"] = 1.0
    if "xtc" not in s:
        kw["xtc_probability"] = 0.0
    if "temperature" not in s and sp.temp > 0.0:
        kw.update(temp=1.0, dynatemp_range=0.0)
    return dataclasses.replace(sp, **kw) if kw else sp


class SamplerState(NamedTuple):
    counts: torch.Tensor    # [B, V] int32 — occurrences in the penalty window
    ring: torch.Tensor      # [B, RING_CAP] int32 — the window itself
    ring_len: torch.Tensor  # [B] int32
    step: torch.Tensor      # [B] int32 — samples drawn
    keys: torch.Tensor      # [B] int64 — each slot's seed (0 .. 2**32-1)


def init_sampler_state(n_slots: int, n_vocab: int,
                       device="cpu") -> SamplerState:
    dev = torch.device(device)
    return SamplerState(
        counts=torch.zeros((n_slots, n_vocab), dtype=torch.int32, device=dev),
        ring=torch.full((n_slots, RING_CAP), -1, dtype=torch.int32,
                        device=dev),
        ring_len=torch.zeros((n_slots,), dtype=torch.int32, device=dev),
        step=torch.zeros((n_slots,), dtype=torch.int32, device=dev),
        keys=torch.zeros((n_slots,), dtype=torch.int64, device=dev),
    )


class SamplerArrays(NamedTuple):
    """Per-slot parameter vectors uploaded once per batch composition."""
    temp: torch.Tensor
    top_k: torch.Tensor
    top_p: torch.Tensor
    min_p: torch.Tensor
    typ_p: torch.Tensor
    xtc_p: torch.Tensor
    xtc_t: torch.Tensor
    pen_last_n: torch.Tensor
    pen_repeat: torch.Tensor
    pen_freq: torch.Tensor
    pen_present: torch.Tensor
    bias_idx: torch.Tensor   # [B, BIAS_CAP] i32, -1 = unused
    bias_val: torch.Tensor   # [B, BIAS_CAP] f32
    dyna_range: torch.Tensor
    dyna_exp: torch.Tensor
    nsigma: torch.Tensor


# the per-slot fields in one flat 4-byte buffer: (name, f32?, getter); the
# two [B, BIAS_CAP] tables follow them
_VEC_FIELDS = (
    ("temp", True, lambda p: p.temp),
    ("top_k", False, lambda p: p.top_k),
    ("top_p", True, lambda p: p.top_p),
    ("min_p", True, lambda p: p.min_p),
    ("typ_p", True, lambda p: p.typ_p),
    ("xtc_p", True, lambda p: p.xtc_probability),
    ("xtc_t", True, lambda p: p.xtc_threshold),
    ("pen_last_n", False, lambda p: min(p.penalty_last_n
                                        if p.penalty_last_n >= 0
                                        else RING_CAP, RING_CAP)),
    ("pen_repeat", True, lambda p: p.penalty_repeat),
    ("pen_freq", True, lambda p: p.penalty_freq),
    ("pen_present", True, lambda p: p.penalty_present),
    ("dyna_range", True, lambda p: p.dynatemp_range),
    ("dyna_exp", True, lambda p: p.dynatemp_exponent),
    ("nsigma", True, lambda p: p.top_n_sigma),
)


def _arrays_size(B: int) -> int:
    return B * (len(_VEC_FIELDS) + 2 * BIAS_CAP)


def _pack_arrays(params: Sequence[SamplerParams], eog_ids,
                 out: np.ndarray) -> None:
    """Write the parameter vectors of `params` into the flat int32 array
    `out` (f32 fields as their bits), in _views' layout."""
    B = len(params)
    nv = len(_VEC_FIELDS) * B
    vecs = out[:nv].reshape(len(_VEC_FIELDS), B)
    for i, (_, f32, fn) in enumerate(_VEC_FIELDS):
        row = np.asarray([fn(p) for p in params],
                         np.float32 if f32 else np.int32)
        vecs[i] = row.view(np.int32)
    bias_idx = out[nv:nv + B * BIAS_CAP].reshape(B, BIAS_CAP)
    bias_val = out[nv + B * BIAS_CAP:].view(np.float32).reshape(B, BIAS_CAP)
    bias_idx[:] = -1
    bias_val[:] = 0.0
    for b, p in enumerate(params):
        entries = list(p.logit_bias.items())
        if p.ignore_eos:
            entries += [(t, NEG_INF) for t in eog_ids]
        for j, (tid, val) in enumerate(entries[:BIAS_CAP]):
            bias_idx[b, j] = tid
            bias_val[b, j] = val


def _views(flat: torch.Tensor, B: int) -> SamplerArrays:
    """SamplerArrays as views of one flat int32 buffer."""
    nv = len(_VEC_FIELDS) * B
    vecs = flat[:nv].view(len(_VEC_FIELDS), B)
    kw = {name: vecs[i].view(torch.float32) if f32 else vecs[i]
          for i, (name, f32, _) in enumerate(_VEC_FIELDS)}
    kw["bias_idx"] = flat[nv:nv + B * BIAS_CAP].view(B, BIAS_CAP)
    kw["bias_val"] = flat[nv + B * BIAS_CAP:].view(torch.float32).view(
        B, BIAS_CAP)
    return SamplerArrays(**kw)


def make_sampler_arrays(params: Sequence[SamplerParams],
                        eog_ids: Sequence[int] = (),
                        device="cpu") -> SamplerArrays:
    host = np.empty(_arrays_size(len(params)), np.int32)
    _pack_arrays(params, eog_ids, host)
    return _views(torch.from_numpy(host).to(device), len(params))


class SamplerBuffers:
    """One engine's SamplerArrays as persistent device buffers: `fill`
    rewrites them in place through one pinned staging copy, so a captured
    CUDA graph that reads them sees every later batch composition."""

    def __init__(self, n_slots: int, device, n_host: int = 1):
        self.n_slots = n_slots
        self._buf = StagedBuffer(_arrays_size(n_slots), torch.int32, device,
                                 n_host)
        self.arrays = _views(self._buf.dev, n_slots)

    def fill(self, params: Sequence[SamplerParams],
             eog_ids: Sequence[int] = ()) -> SamplerArrays:
        if len(params) != self.n_slots:
            raise ValueError(f"{len(params)} parameter sets for "
                             f"{self.n_slots} slots")
        _pack_arrays(params, eog_ids, self._buf.host())
        self._buf.push()
        return self.arrays


# ---------------------------------------------------------------------------
# state maintenance


def reset_slot(state: SamplerState, slot: int, seed: int) -> SamplerState:
    """Clear one slot's penalty window and reseed it (a new task was
    admitted). Updates the state in place and returns it."""
    state.counts[slot] = 0
    state.ring[slot] = -1
    state.ring_len[slot] = 0
    state.step[slot] = 0
    state.keys[slot] = int(seed) & _MASK32
    return state


def _push_window(counts: np.ndarray, ring: np.ndarray, n: int, tokens,
                 n_valid: int, last_n: int) -> int:
    """Push tokens[:n_valid] into one slot's window on the host (`counts`
    and `ring` in place); returns the new ring length."""
    last_n = max(int(last_n), 1)
    for tok in np.asarray(tokens)[:int(n_valid)]:
        pos = n % last_n
        old = ring[pos]
        if n >= last_n and old >= 0:
            counts[old] -= 1
        counts[int(tok)] += 1
        ring[pos] = tok
        n += 1
    return n


def push_tokens(state: SamplerState, slot: int, tokens, n_valid: int,
                last_n: int) -> SamplerState:
    """Bulk-push prompt tokens of one slot into its penalty window (the
    prompt participates in penalties). Host-side window arithmetic, one
    upload; updates the state in place and returns it."""
    counts = state.counts[slot].cpu().numpy().copy()
    ring = state.ring[slot].cpu().numpy().copy()
    n = _push_window(counts, ring, int(state.ring_len[slot]), tokens,
                     n_valid, last_n)
    dev = state.counts.device
    state.counts[slot] = torch.from_numpy(counts).to(dev)
    state.ring[slot] = torch.from_numpy(ring).to(dev)
    state.ring_len[slot] = n
    return state


def window_size(n_vocab: int) -> int:
    """Elements of the int32 staging buffer `seed_slot` takes."""
    return n_vocab + RING_CAP + 1


def seed_slot(state: SamplerState, slot: int, seed: int, tokens,
              n_valid: int, last_n: int,
              staging: StagedBuffer) -> SamplerState:
    """reset_slot, then push_tokens, with the same result and no read-back
    (a read-back would wait for every program in flight): after the reset
    the window is known (no counts, an empty ring), so it is built on the
    host and goes up by one copy from `staging` (window_size(V) int32).
    Updates the state in place and returns it."""
    V = state.counts.shape[1]
    h = staging.host()
    counts, ring = h[:V], h[V:V + RING_CAP]
    counts[:] = 0
    ring[:] = -1
    h[-1] = _push_window(counts, ring, 0, tokens, n_valid, last_n)
    staging.push()
    d = staging.dev
    state.counts[slot].copy_(d[:V])
    state.ring[slot].copy_(d[V:V + RING_CAP])
    state.ring_len[slot].copy_(d[-1])
    # fill_ takes the value as an argument; an indexed assignment would
    # copy it from host memory and synchronise
    state.step[slot].fill_(0)
    state.keys[slot].fill_(int(seed) & _MASK32)
    return state


def _push_active(state: SamplerState, tokens: torch.Tensor,
                 last_n: torch.Tensor, active: torch.Tensor) -> None:
    """Push each active slot's sampled token into its penalty window (the
    batched form of one ring step), in place."""
    B = tokens.shape[0]
    rows = torch.arange(B, device=tokens.device)
    ln = last_n.clamp_min(1)
    pos = (state.ring_len % ln).long()
    old = state.ring[rows, pos]
    evict = active & (state.ring_len >= ln) & (old >= 0)
    state.counts[rows, old.clamp_min(0).long()] -= evict.to(torch.int32)
    state.counts[rows, tokens.long()] += active.to(torch.int32)
    state.ring[rows, pos] = torch.where(active, tokens, old)
    state.ring_len.add_(active.to(torch.int32))


# ---------------------------------------------------------------------------
# the chain


def _apply_bias(logits, arrs: SamplerArrays):
    V = logits.shape[1]
    idx = arrs.bias_idx.clamp(0, V - 1).long()
    val = torch.where(arrs.bias_idx >= 0, arrs.bias_val,
                      torch.zeros_like(arrs.bias_val))
    return logits.scatter_add(1, idx, val)


def _apply_penalties(logits, counts, arrs: SamplerArrays):
    c = counts.float()
    hit = c > 0
    rep = arrs.pen_repeat[:, None]
    scaled = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(hit & (rep != 1.0), scaled, logits)
    return logits - (c * arrs.pen_freq[:, None]
                     + hit.float() * arrs.pen_present[:, None])


def _probs_of(cvals, mask):
    z = torch.where(mask, cvals, torch.full_like(cvals, NEG_INF))
    z = z - z.amax(dim=-1, keepdim=True)
    e = torch.exp(z) * mask
    return e / (e.sum(dim=-1, keepdim=True) + 1e-30)


def _chain_mask(cvals, arrs: SamplerArrays, xtc_draw):
    """Surviving mask over descending candidates [B, K] after
    top-n-sigma / top-k / top-p / min-p / typical / xtc (each filter keeps
    at least one candidate)."""
    B, K = cvals.shape
    col = torch.arange(K, device=cvals.device)[None, :]

    std = cvals.std(dim=-1, unbiased=False, keepdim=True)
    ns_on = (arrs.nsigma > 0.0)[:, None]
    keep_ns = cvals >= (cvals[:, :1] - arrs.nsigma[:, None] * std)
    mask = ~ns_on | keep_ns | (col == 0)

    k = torch.where(arrs.top_k <= 0, K, arrs.top_k.clamp(max=K))[:, None]
    mask = mask & (col < k)
    p = _probs_of(cvals, mask)

    cum = torch.cumsum(p, dim=-1)
    mask = mask & (((cum - p) < arrs.top_p[:, None]) | (col == 0))

    pmax = p.amax(dim=-1, keepdim=True)
    mask = mask & ((p >= arrs.min_p[:, None] * pmax) | (col == 0))

    p2 = _probs_of(cvals, mask)
    neglogp = -torch.log(p2 + 1e-30)
    H = torch.sum(p2 * neglogp, dim=-1, keepdim=True)
    shift = torch.where(mask, (neglogp - H).abs(),
                        torch.full_like(p2, float("inf")))
    order = torch.argsort(shift, dim=-1, stable=True)
    p_sorted = torch.gather(p2, -1, order)
    cum_t = torch.cumsum(p_sorted, dim=-1)
    keep_sorted = ((cum_t - p_sorted) < arrs.typ_p[:, None]) | (col == 0)
    keep_typ = torch.zeros_like(mask).scatter(-1, order, keep_sorted)
    typ_on = (arrs.typ_p < 1.0)[:, None]
    mask = torch.where(typ_on, mask & keep_typ, mask)

    p3 = _probs_of(cvals, mask)
    above = p3 > arrs.xtc_t[:, None]
    n_above = above.sum(dim=-1, keepdim=True)
    last_above = torch.where(above, col, -1).amax(dim=-1, keepdim=True)
    drop = above & (col != last_above) & (n_above >= 2)
    xtc_on = (xtc_draw < arrs.xtc_p)[:, None]
    return torch.where(xtc_on, mask & ~drop, mask)


def _plain_mask(cvals, arrs: SamplerArrays):
    """Survivor mask for `plain` batches: top-k, top-p, min-p only."""
    B, K = cvals.shape
    col = torch.arange(K, device=cvals.device)[None, :]
    k = torch.where(arrs.top_k <= 0, K, arrs.top_k.clamp(max=K))[:, None]
    mask = col < k
    p = _probs_of(cvals, mask)
    cum = torch.cumsum(p, dim=-1)
    mask = mask & (((cum - p) < arrs.top_p[:, None]) | (col == 0))
    pmax = p.amax(dim=-1, keepdim=True)
    return mask & ((p >= arrs.min_p[:, None] * pmax) | (col == 0))


_MASK32 = 0xFFFFFFFF
# odd multipliers below 2**31: a 32-bit value times one stays below 2**63,
# so the int64 products never wrap and every device gives the same bits
_MIX1, _MIX2 = 0x7FEB352D, 0x2C1B3C6D
_GOLDEN = 0x9E3779B9
STREAM_XTC, STREAM_GUMBEL = 0, 1


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit finalizer (the xorshift-multiply shape of lowbias32) on
    int64 tensors holding values in [0, 2**32)."""
    h = h ^ (h >> 16)
    h = (h * _MIX1) & _MASK32
    h = h ^ (h >> 15)
    h = (h * _MIX2) & _MASK32
    return h ^ (h >> 16)


def _draws(state: SamplerState, stream: int, n: int) -> torch.Tensor:
    """[B, n] uniforms in the open interval (0, 1): draw i of slot b is a
    hash of (keys[b], step[b], stream, i), so it depends on the slot's
    seed and step alone (not on K, nor on the other slots). Each value is
    (2m + 1) / 2**24 for a 23-bit m, exact in f32 on every device."""
    ctr = (state.step.long() * (2 * _GOLDEN) + stream * _GOLDEN) & _MASK32
    row = _mix32(state.keys ^ ctr)                                # [B]
    idx = torch.arange(1, n + 1, device=row.device) * _GOLDEN     # < 2**41
    h = _mix32((row[:, None] + idx) & _MASK32)
    return ((h >> 8) | 1).float() * (2.0 ** -24)


def sample_impl(logits: torch.Tensor, state: SamplerState,
                arrs: SamplerArrays, active: torch.Tensor,
                extras: bool = True, kcap: int = 0):
    """Sample one token per slot from [B, V] logits.

    active: [B] bool tensor on the logits' device — the slots actually
    decoding; every row draws, only these advance their state.
    extras=False: every slot is `plain` (skip bias/penalties, the
    typical/xtc/top-n-sigma/dynatemp filters and the penalty-ring
    update). kcap (0 => N_CAND): candidate
    count, valid when every slot has 0 < top_k <= kcap.
    Returns (tokens [B] i32, top_ids [B, N_PROBS] i32, top_probs
    [B, N_PROBS] f32, tok_prob [B] f32, state) — the state is updated in
    place."""
    B, V = logits.shape
    logits = logits.float()
    if extras:
        logits = _apply_bias(logits, arrs)
        logits = _apply_penalties(logits, state.counts, arrs)

    kcap = min(max(kcap, N_PROBS) if kcap else N_CAND, V)
    cvals, cidx = torch.topk(logits, kcap, dim=-1, sorted=True)

    if extras:
        xtc_draw = _draws(state, STREAM_XTC, 1)[:, 0]
        mask = _chain_mask(cvals, arrs, xtc_draw)
    else:
        mask = _plain_mask(cvals, arrs)

    if extras:
        p_surv = torch.exp(torch.where(mask, cvals - cvals[:, :1],
                                       torch.full_like(cvals, NEG_INF)))
        p_surv = p_surv / (p_surv.sum(dim=-1, keepdim=True) + 1e-30)
        ent = -torch.sum(p_surv * torch.log(p_surv + 1e-30), dim=-1)
        n_kept = mask.sum(dim=-1).clamp_min(2).float()
        norm_ent = (ent / torch.log(n_kept)).clamp(0.0, 1.0)
        t_min = (arrs.temp - arrs.dyna_range).clamp_min(0.0)
        t_max = arrs.temp + arrs.dyna_range
        t_dyn = t_min + (t_max - t_min) * norm_ent ** arrs.dyna_exp
        temp = torch.where(arrs.dyna_range > 0.0, t_dyn, arrs.temp)
    else:
        temp = arrs.temp
    temp = temp.clamp_min(1e-4)[:, None]
    z = torch.where(mask, cvals / temp, torch.full_like(cvals, NEG_INF))
    z = z - z.amax(dim=-1, keepdim=True)
    ez = torch.exp(z) * mask
    probs = ez / (ez.sum(dim=-1, keepdim=True) + 1e-30)

    u = _draws(state, STREAM_GUMBEL, kcap)
    gumbel = -torch.log(-torch.log(u))
    noisy = torch.where(mask, z + gumbel, torch.full_like(z, NEG_INF))
    pick_dist = torch.argmax(noisy, dim=-1)
    greedy = arrs.temp <= 0.0
    pick = torch.where(greedy, torch.zeros_like(pick_dist), pick_dist)
    tokens = torch.gather(cidx, 1, pick[:, None])[:, 0].to(torch.int32)

    report = torch.where(greedy[:, None], torch.softmax(cvals, dim=-1), probs)
    top_probs = report[:, :N_PROBS]
    top_ids = cidx[:, :N_PROBS].to(torch.int32)
    tok_prob = torch.gather(report, 1, pick[:, None])[:, 0]

    if extras:
        _push_active(state, tokens, arrs.pen_last_n, active)
    state.step.add_(active.to(torch.int32))
    return tokens, top_ids, top_probs, tok_prob, state
