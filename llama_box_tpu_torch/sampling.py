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
seeded sampling agrees with it in distribution, not token by token.

HostSampler (grammar, mirostat, DRY, reordered chains) is the JAX
package's, line for line: the same chain in numpy over one slot's logits
row, drawn from `np.random.default_rng(seed & 0xFFFFFFFF)`, so a seeded
host-sampled request gives the JAX engine's tokens wherever the logits
agree. The engine gives such a slot one-token passes and keeps its device
sampler state still (server/engine.py).
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


def verify_impl(logits: torch.Tensor, draft: torch.Tensor,
                n_draft: torch.Tensor, state: SamplerState,
                arrs: SamplerArrays, active: torch.Tensor,
                extras: bool = True, kcap: int = 0):
    """Speculative verify+sample over T drafted positions (JAX
    `verify_impl`; the reference's verify loop, httpserver.hpp:4300-4334):
    the sampler runs at each position in turn, a row accepts drafts while
    it reproduces them and emits one replacement or bonus token at the
    first mismatch.

    logits: [B, T, V] from the verify forward (row j's logits from input
    token j); draft: [B, T] the input tokens (column 0 the accepted token,
    1.. the drafts); n_draft: [B] drafts per row (0: plain decode). A
    position samples (and advances the slot's step and penalty ring) only
    while every earlier one matched, so a seeded row draws what a plain
    run draws token by token. Returns (tokens [B, T] i32, n_emitted [B],
    top_ids [B, T, N_PROBS], top_probs, tok_probs [B, T], state); row b
    emits tokens[b, :n_emitted[b]]."""
    B, T, _ = logits.shape
    alive = torch.ones_like(active)
    outs = []
    for j in range(T):
        act_j = active & alive & (j <= n_draft)
        tok, ids, probs, tokp, state = sample_impl(
            logits[:, j], state, arrs, act_j, extras=extras, kcap=kcap)
        match = act_j & (j + 1 <= n_draft) & (tok == draft[:, min(j + 1,
                                                                  T - 1)])
        alive = alive & match
        outs.append((tok, ids, probs, tokp))
    toks, ids, probs, tokps = (torch.stack(x, dim=1) for x in zip(*outs))
    # position j is emitted iff every earlier one matched its draft; the
    # cumulative product is monotone, so a later accidental equality of a
    # dead position's sample cannot resurrect a row
    cols = torch.arange(1, T, device=logits.device)[None, :]
    match = torch.cat([torch.ones_like(active)[:, None],
                       (toks[:, :-1] == draft[:, 1:])
                       & (cols <= n_draft[:, None])], dim=1)
    n_emitted = torch.cumprod(match.long(), dim=1).sum(dim=1)
    n_emitted = torch.where(active, n_emitted, 0)
    n_emitted = torch.minimum(n_emitted, n_draft.long() + 1)
    return toks, n_emitted, ids, probs, tokps, state


class HostSampler:
    """Host-side sampler for grammar-constrained slots.

    Mirrors the device chain (penalties -> top-k -> top-p -> min-p ->
    typical -> xtc -> temp) in numpy, with the reference's lazy-grammar
    strategy (sampling.patch / common_sampler_sample2): sample WITHOUT the
    grammar first; only if the pick violates the grammar, mask the
    candidates and re-sample. Grammar-advancing and the penalty window live
    here, so the device sampler state for this slot stays untouched.
    """

    def __init__(self, sp: SamplerParams, grammar, tokenizer):
        self.sp = sp
        self.grammar = grammar
        self.tok = tokenizer
        # lazy grammars (tool-call constraint, reference common_chat
        # grammar_lazy + trigger words): stay unconstrained until a
        # trigger string appears in the generated text, enforce the
        # grammar until it completes, then re-arm for the next call
        self._gr_template = None
        self._trigger_tail = ""
        if grammar is not None and sp.grammar_lazy and sp.grammar_triggers:
            self._gr_template = grammar.copy()
            self.grammar = None
        self.rng = np.random.default_rng(sp.seed & 0xFFFFFFFF)
        self._window: list[int] = []
        self._counts: dict[int, int] = {}
        self._last_n = min(sp.penalty_last_n if sp.penalty_last_n >= 0
                           else RING_CAP, RING_CAP)
        self._mask_cache: dict = {}
        self._history: list[int] = []   # full generation history (DRY)
        # mirostat v1/v2 state: target surprise window
        self._mu = 2.0 * sp.mirostat_tau

    # -- state ---------------------------------------------------------------

    def accept(self, token: int) -> None:
        self._history.append(token)
        if self._last_n > 0:
            self._window.append(token)
            self._counts[token] = self._counts.get(token, 0) + 1
            if len(self._window) > self._last_n:
                old = self._window.pop(0)
                self._counts[old] -= 1
                if not self._counts[old]:
                    del self._counts[old]
        if self._gr_template is not None and self.grammar is None \
                and not self.tok.is_eog(token):
            piece = self.tok.token_bytes(token, render_special=True)
            self._trigger_tail = (self._trigger_tail
                                  + piece.decode("utf-8", "replace"))[-64:]
            for trig in self.sp.grammar_triggers:
                if self._trigger_tail.endswith(trig):
                    self.grammar = self._gr_template.copy()
                    self._mask_cache.clear()
                    self._trigger_tail = ""
                    return
            return
        if self.grammar is not None and not self.tok.is_eog(token):
            self.grammar.accept_bytes(
                self.tok.token_bytes(token, render_special=True))
            self._mask_cache.clear()
            if self._gr_template is not None and self.grammar.completed:
                # call emitted in full: back to unconstrained text until
                # the next trigger (parallel tool calls)
                self.grammar = None
                self._mask_cache.clear()

    def push_prompt(self, tokens: list[int]) -> None:
        for t in tokens[-self._last_n:] if self._last_n > 0 else []:
            self._window.append(t)
            self._counts[t] = self._counts.get(t, 0) + 1
        while len(self._window) > self._last_n:
            old = self._window.pop(0)
            self._counts[old] -= 1
            if not self._counts[old]:
                del self._counts[old]

    @property
    def must_stop(self) -> bool:
        return self.grammar is not None and self.grammar.must_stop

    def _token_allowed(self, tid: int) -> bool:
        g = self.grammar
        cached = self._mask_cache.get(tid)
        if cached is not None:
            return cached
        if self.tok.is_eog(tid):
            ok = g.completed
        elif self.tok.is_control(tid):
            ok = False
        else:
            piece = self.tok.token_bytes(tid, render_special=True)
            ok = bool(piece) and g.accepts_token(piece)
        self._mask_cache[tid] = ok
        return ok

    # -- the chain -----------------------------------------------------------

    def sample(self, logits: np.ndarray
               ) -> tuple[int, np.ndarray, np.ndarray, float]:
        """Returns (token, top_ids [N_PROBS], top_probs [N_PROBS],
        tok_prob — the sampled token's own candidate-softmax probability)."""
        sp = self.sp
        logits = logits.astype(np.float64).copy()
        for tid, v in sp.logit_bias.items():
            if 0 <= tid < logits.shape[0]:
                logits[tid] += v
        if sp.ignore_eos:
            for tid in self.tok.eog_ids:
                logits[tid] = NEG_INF
        # penalties
        if self._counts and (sp.penalty_repeat != 1.0 or sp.penalty_freq
                             or sp.penalty_present):
            for tid, c in self._counts.items():
                l = logits[tid]
                if sp.penalty_repeat != 1.0:
                    l = l / sp.penalty_repeat if l > 0 else l * sp.penalty_repeat
                logits[tid] = (l - c * sp.penalty_freq
                               - (c > 0) * sp.penalty_present)

        if self.sp.dry_multiplier > 0.0:
            self._apply_dry(logits)

        kcap = min(N_CAND, logits.shape[0])
        cand = np.argpartition(-logits, kcap - 1)[:kcap]
        cand = cand[np.argsort(-logits[cand], kind="stable")]
        cvals = logits[cand]

        token = self._pick(cand, cvals, grammar_mask=None)
        if self.grammar is not None and not self._token_allowed(int(token)):
            mask = np.fromiter((self._token_allowed(int(t)) for t in cand),
                               bool, len(cand))
            if not mask.any():
                # no candidate fits: fall back to scanning the full
                # vocab in logit order, in chunks through the batched
                # native matcher (grammar.filter_pieces — one crossing
                # per 512 candidates instead of one per token; the
                # Python matcher path degrades to per-token trials)
                order = np.argsort(-logits, kind="stable")
                token = None
                for base in range(0, len(order), 512):
                    chunk = [int(t) for t in order[base:base + 512]]
                    cached = [self._mask_cache.get(t) for t in chunk]
                    todo = [t for t, c in zip(chunk, cached) if c is None]
                    if todo:
                        pieces = [b"" if (self.tok.is_eog(t)
                                          or self.tok.is_control(t))
                                  else self.tok.token_bytes(
                                      t, render_special=True)
                                  for t in todo]
                        oks = self.grammar.filter_pieces(pieces)
                        for t, pc, ok in zip(todo, pieces, oks):
                            # eog/control keep _token_allowed semantics
                            self._mask_cache[t] = (
                                self.grammar.completed
                                if self.tok.is_eog(t)
                                else bool(pc) and ok)
                    hit = next((t for t in chunk if self._mask_cache[t]),
                               None)
                    if hit is not None:
                        token = hit
                        break
                if token is None:
                    token = self.tok.eos_id or 0
            else:
                token = self._pick(cand, cvals, grammar_mask=mask)

        # logprobs view
        z = cvals - cvals.max()
        p = np.exp(z)
        p /= p.sum()
        # sampled token's own probability in the same (candidate-softmax)
        # view; grammar fallback may land outside the candidate set
        hit = np.nonzero(cand == token)[0]
        if hit.size:
            tok_prob = float(p[hit[0]])
        else:
            tok_prob = float(np.exp(logits[token] - cvals.max())
                             / np.exp(z).sum())
        return (int(token), cand[:N_PROBS].astype(np.int64), p[:N_PROBS],
                tok_prob)

    _DRY_BRK_CACHE: dict = {}   # (tokenizer id, breakers) -> frozenset

    def _dry_breaker_ids(self) -> frozenset:
        """Token ids whose text contains a DRY sequence breaker (computed
        once per tokenizer+breaker set; llama.cpp preprocesses the breaker
        strings into a token restart set the same way)."""
        brks = tuple(self.sp.dry_sequence_breakers or ())
        if not brks or self.tok is None \
                or not hasattr(self.tok, "n_vocab"):
            return frozenset()
        key = (id(self.tok), brks)
        hit = self._DRY_BRK_CACHE.get(key)
        if hit is None:
            pats = [b.encode() for b in brks]
            hit = frozenset(
                t for t in range(self.tok.n_vocab)
                if any(p in self.tok.token_bytes(t, render_special=True)
                       for p in pats))
            self._DRY_BRK_CACHE[key] = hit
        return hit

    def _apply_dry(self, logits: np.ndarray) -> None:
        """DRY sampler (llama.cpp semantics, simplified): penalize tokens
        that would extend a sequence already seen — for each candidate z, if
        history ends with S and S+z occurred before with |S| >= allowed,
        subtract multiplier * base^(|S| - allowed)."""
        sp = self.sp
        h = self._history
        if sp.dry_penalty_last_n > 0:
            h = h[-sp.dry_penalty_last_n:]
        # sequence breakers cut the match window: only history after the
        # most recent breaker token participates (llama.cpp restart set)
        brk = self._dry_breaker_ids()
        if brk:
            for i in range(len(h) - 1, -1, -1):
                if h[i] in brk:
                    h = h[i + 1:]
                    break
        n = len(h)
        if n < sp.dry_allowed_length:
            return
        max_pen: dict[int, int] = {}
        # find occurrences of the current suffix of length L (L descending
        # capped at 32) and note the token that followed each
        for L in range(min(n, 32), sp.dry_allowed_length - 1, -1):
            suffix = h[n - L:]
            for i in range(0, n - L):
                if h[i:i + L] == suffix:
                    nxt = h[i + L]
                    if nxt not in max_pen:
                        max_pen[nxt] = L
            if max_pen:
                break
        for tok, L in max_pen.items():
            if 0 <= tok < logits.shape[0]:
                logits[tok] -= (sp.dry_multiplier
                                * sp.dry_base ** (L - sp.dry_allowed_length))

    def _mirostat_pick(self, cand, cvals) -> int:
        """Mirostat v2: drop candidates with surprise > mu, sample from the
        rest, then update mu toward the target surprise tau."""
        sp = self.sp
        z = cvals - cvals.max()
        p = np.exp(z)
        p /= p.sum()
        surprise = -np.log2(p + 1e-30)
        keep = surprise <= self._mu
        if not keep.any():
            keep[p.argmax()] = True
        pk = p * keep
        pk /= pk.sum()
        idx = int(self.rng.choice(len(cand), p=pk))
        observed = float(surprise[idx])
        self._mu -= sp.mirostat_eta * (observed - sp.mirostat_tau)
        return int(cand[idx])

    def _pick(self, cand, cvals, grammar_mask) -> int:
        """Filter/scale the candidate view and draw.

        Ops run in sp.samplers order (reference: the chain is built from
        the listed samplers in order); the default is the device chain's
        canonical order. penalties/DRY always run on the full logits
        before candidate selection (their canonical slot) — only the
        candidate-view ops reorder here.
        """
        sp = self.sp
        if sp.mirostat > 0 and grammar_mask is None:
            return self._mirostat_pick(cand, cvals)
        K = len(cand)
        cvals = cvals.copy()
        keep = np.ones(K, bool)
        if grammar_mask is not None:
            keep &= grammar_mask

        def probs_of(keep):
            z = np.where(keep, cvals, NEG_INF)
            z = z - z.max()
            e = np.exp(z) * keep
            return e / max(e.sum(), 1e-30)

        for op in (sp.samplers or CHAIN_ORDER):
            if op == "top_n_sigma" and sp.top_n_sigma > 0.0:
                keep &= cvals >= cvals.max() - sp.top_n_sigma * cvals.std()
                keep[0] = True
            elif op == "top_k" and sp.top_k > 0:
                kk = np.zeros(K, bool)
                kk[np.nonzero(keep)[0][:sp.top_k]] = True
                keep &= kk
            elif op == "top_p" and sp.top_p < 1.0:
                p = probs_of(keep)
                cum = np.cumsum(p)
                keep &= (cum - p) < sp.top_p
                keep[np.nonzero(p)[0][:1]] = True
            elif op == "min_p" and sp.min_p > 0.0:
                p = probs_of(keep)
                keep &= ((p >= sp.min_p * p.max())
                         | (np.arange(K) == p.argmax()))
            elif op == "typ_p" and sp.typ_p < 1.0:
                p = probs_of(keep)
                nlp = -np.log(p + 1e-30)
                H = float((p * nlp).sum())
                shift = np.where(keep, np.abs(nlp - H), np.inf)
                order = np.argsort(shift, kind="stable")
                ps = p[order]
                cs = np.cumsum(ps)
                k2 = (cs - ps) < sp.typ_p
                k2[0] = True
                kt = np.zeros(K, bool)
                kt[order[k2]] = True
                keep &= kt
            elif op == "xtc" and sp.xtc_probability > 0.0 \
                    and self.rng.random() < sp.xtc_probability:
                p = probs_of(keep)
                above = p > sp.xtc_threshold
                if above.sum() >= 2:
                    last = np.nonzero(above)[0][-1]
                    drop = above.copy()
                    drop[last] = False
                    keep &= ~drop
            elif op == "temperature" and sp.temp > 0.0:
                temp = sp.temp
                if sp.dynatemp_range > 0.0:
                    p = probs_of(keep)
                    ent = float(-(p * np.log(p + 1e-30)).sum())
                    n_kept = max(int(keep.sum()), 2)
                    norm = min(max(ent / np.log(n_kept), 0.0), 1.0)
                    t_min = max(temp - sp.dynatemp_range, 0.0)
                    t_max = temp + sp.dynatemp_range
                    temp = t_min + (t_max - t_min) * norm ** sp.dynatemp_exponent
                # scale the surviving logits; later ops see the scaled view
                cvals = cvals / max(temp, 1e-4)

        if sp.temp <= 0.0:
            # greedy replaces the final dist draw (reference swaps in a
            # greedy sampler when temp<=0 regardless of chain position)
            return int(cand[np.nonzero(keep)[0][0]])
        p = probs_of(keep)
        return int(self.rng.choice(cand, p=p))
