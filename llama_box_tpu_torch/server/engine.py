"""Continuous-batching inference engine — the reconcile loop (counterpart
of llama_box_tpu/server/engine.py for completions on a dense llama).

- N slots = N rows of one batched KV cache on the device; one batched
  prefill per pass packs every prefilling slot's next chunk, and one
  K-step decode chain per pass covers every decoding slot.
- Prefix cache: per-slot token history, slot picked by longest common
  prefix, partial KV reuse.
- Chained decode: `_decode_chain` runs K forward+sample steps on the
  device and the host syncs once per chain; the first chains after a
  prefill are short (chain_ramp) so the first tokens stream early, and the
  chain shrinks to the remaining token budget.
- Pipelined chains (EngineConfig.pipeline_chain, on by default, as in the
  JAX engine): up to pipeline_depth further chains go out (one fewer,
  and short, while a slot is idle; none past a budget's end while a task
  waits for a slot), each taking its token0 from the chain before it on the
  device, before the host waits for the oldest; the first chain after a
  prefill goes out from the prefill's device-resident first tokens
  before the host waits for them. A speculated chain is consumed whole
  by the slots it covers (same task, same position) or dropped. Each
  program's outputs are copied to pinned host buffers right after its
  dispatch (utils/staging.HostCopies) and the consume step waits on that
  copy's event; no other step waits for the device.
- One dispatch per program, as the JAX engine's jitted programs: on a
  CUDA device each decode chain (keyed by K, samp_extras, samp_kcap) and
  each prefill pass with its first-token sample (keyed by the bucket)
  replays one captured CUDA graph (server/cuda_graph.py). Their operands
  live in persistent device buffers that the host fills by one pinned
  copy a pass (a speculated chain's token0 by a copy on the device).
  EngineConfig.cuda_graphs=False runs the same programs eagerly (for
  comparison); on the CPU they always run eagerly.
- Context shift: a slot that reaches its capacity drops n_discard rows
  after n_keep and re-rotates the keys it keeps (models/llama.shift_kv),
  then decodes on; chains shrink toward the boundary, so the shift fires
  with no chain in flight over the slot (`_context_shift`).
- Cross-slot prefix copy: a new request that shares at least
  cache_share_min more prefix tokens with another slot than with its own
  takes that slot's rows (models/llama.copy_kv_prefix).
Both edit the cache the graphs captured, in place, on the stream the
programs replay on, with no host wait.
- Host-controlled decode (JAX `_decode_pass`'s per-token path): a request
  with a grammar, mirostat, DRY or a reordered chain samples on the host
  (sampling.HostSampler), and one with a token-rate bucket decodes one
  token per pass. While such a slot decodes, every pass is ONE one-token
  pass (`_decode_verify_sample` at T = 1, one graph a key on the card):
  the device samples the other slots (samp_active), the host-sampled
  slots' device sampler state stays still, and their logits rows come
  back gathered by a staged index vector; no chain is dispatched or
  speculated, and a chain in flight when such a task arrives is consumed
  first. A slot whose bucket is empty sits the pass out.
- Speculative decoding (the JAX engine's, the reference's draft model and
  prompt lookup): the one-token pass widens to T = 1 + draft_max rows a
  slot (`_decode_verify_sample`: the verify forward, each query row
  through the flash decode kernel with the verify rows as its chain, then
  sampling.verify_impl; one graph a key ("verify", T, extras, kcap)).
  n-gram drafts (server/ngram.py, a cache per task built at admission,
  gated by its moving acceptance) are made on the host from the synced
  history; a pass where no slot drafts runs a chain, and no chain is
  speculated while a slot could draft. A draft model (`draft=`) drafts on
  the device: with no slot under host control, one program drafts and
  verifies (`_spec_rounds`), M = spec_rounds rounds a pass, each round's
  acceptance and advance on the device, the host catching the draft
  cache up before the first (the draft's prefill kernel) and syncing once
  a pass; further passes go out off the newest's device-resident token,
  position and catch-up carry (`_fill_spec_queue`), near capacity M
  shrinks, then one round a pass, then the one-token pass (two syncs:
  the drafts, then the verify) and its shift, which shifts the draft
  cache too.
- Embeddings and rerank (JAX `_admit_embed`, `_embed_pass`): a task's
  inputs, sorted by length, go in groups of at most max_embed_batch, ONE
  group a reconcile pass, before prefill and decode, so decoding slots
  keep streaming beside a large batch. A group pads its rows to a power
  of two and its length to the engine's bucket (longer inputs are cut to
  the largest, as in JAX) and runs the BERT encoder (models/bert.py) or
  the llama embedding forward (models/llama.forward_embeddings: the
  flash prefill kernel on a scratch cache); on the card one graph a key
  ("embed", rows, T, pooling), enqueued between the other programs'
  replays on the same stream, its output read back by a sync of its own
  right after the replay. As in JAX, a task is admitted only while a slot
  is idle: an embeddings request waits while every slot decodes.

- Multimodal prompts (JAX `_prefill_chunk`'s embedding chunks): a task
  with `chunks` (server/multimodal.build_chunks: token chunks and the
  towers' projected rows, whose negative dummy ids key the prefix cache)
  prefills one slot at a time, one ubatch of one chunk a pass, through
  the batched prefill on that slot of the cache (the flash prefill
  kernel, the slot a staged operand; an embedding chunk in place of
  token rows, gemma3's image span bidirectional); on the card one graph a
  key ("prefill_mm", kind, bucket) for every slot, its first token
  sampled in it. M-RoPE models (Qwen2-VL)
  take each chunk's (t, y, x) position streams and decode at position +
  the task's mrope_delta, a staged operand of every chain, one-token and
  one-round draft pass; as in JAX, no chain is speculated after their
  prefill and a draft model runs one round a pass.

- Per-request LoRA (JAX `configure_lora`, `_set_lora_row`): with
  adapters stacked unmerged (models/lora.stack_dynamic), each slot holds
  a row of adapter scales, the adapters' defaults until a request's
  `lora` field sets its own at admission; the [S, n_ad] rows are a staged
  operand every program reads (the single-slot media prefill its slot's
  row), so every graph key serves any mix. As in JAX, a slot's cached
  prefix is reused whatever mix computed it, the embeddings pass reads
  the rows against its own batch rows, and the rope layout stays the
  file's (the stacks' q / k columns are in its order).

- Recurrent models (JAX `self.rec`: mamba, mamba2, jamba, bamba /
  granitehybrid, falcon-h1, nemotron_h, lfm2, qwen3next, rwkv6, rwkv7;
  models/mamba.py): a constant-size state a slot (RecCache) in place of
  the KV cache, a hybrid's attention layers with a KV cache of their own
  (bf16 for an int8 --cache-type, as in JAX). As in the JAX engine: no
  speculative decoding (a draft model raises, n-gram lookup is switched
  off with its warning), no context shift (max_tokens is capped at the
  slot boundary, a slot that reaches it finishes with "length"), no
  embeddings or rerank, no cross-slot prefix copy and no chain after a
  prefill; a slot's state is reused only when the new prompt extends its
  whole history exactly, and never once the device has run inputs the
  host did not keep (rec_dirty: a chain's discarded tail, a pipelined
  chain still in flight when its task ends, a dropped chain); else
  admission zeroes the slot's state (reset_rec_slot). Layer-group models
  decode a token a pass, the others chain, pipelined as every chain.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from ..models.bert import BERT_ARCHS, bert_forward, check_bert_supported
from ..models.config import ModelConfig
from ..models.mamba import (init_rec_cache, rec_decode_chain,
                            rec_decode_verify_sample,
                            rec_prefill_batch_impl, reset_rec_slot)
from ..models.llama import (alibi_slopes, check_supported,
                            copy_kv_prefix,
                            decode_operands, decode_step_impl,
                            forward_embeddings, init_chain_rows,
                            init_kv_cache, layer_groups, layer_is_local,
                            layer_windows,
                            make_delta_rope, make_rope,
                            prefill_batch_impl, shift_kv, verify_forward,
                            verify_operands, write_chain_rows)
from ..ops.qmatmul import _SPLIT_MAX_ROWS, QTensor
from ..sampling import (N_PROBS, RING_CAP, HostSampler, SamplerBuffers,
                        SamplerParams, init_sampler_state, sample_impl,
                        seed_slot, verify_impl, window_size)
from ..utils.logging import SRV_DBG, SRV_ERR, SRV_WRN
from ..utils.staging import HostCopies, StagedBuffer
from ..utils.text import longest_common_prefix
from .cuda_graph import GraphRunner
from .metrics import Metrics
from .ngram import NgramCache
from .task import BaseTask, CompletionsTask, EmbeddingsTask, RerankTask

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}


# the longest chain speculated while a slot is idle: a request arriving
# into it waits for the rest of the chain in flight and one such chain
_IDLE_CHAIN = 4


def _pow2_floor(n: int) -> int:
    """Largest power of two <= n (0 for n < 1)."""
    if n < 1:
        return 0
    return 1 << (n.bit_length() - 1)


def resolve_device(device: str) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asked for
    the CPU. No CUDA and no explicit CPU request is an error."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


def _decode_chain(params, cfg: ModelConfig, token0, pos0, kv, sstate, arrs,
                  active, cos, sin, n_steps: int, samp_extras: bool = True,
                  samp_kcap: int = 0, rope_delta=None):
    """Chained multi-step decode: n_steps sequential forward+sample steps
    with no host sync in between (one CUDA graph on the card).

    token0: [S] each slot's next token; pos0: [S] int64 its position;
    active: [S] bool (an inactive slot's rows are neither attended nor
    kept), all on the device. Step j's K/V rows ride the chain operand of
    the attention (the flash decode kernel's rows 0..j); the cache stays
    read-only through the chain and ONE scatter writes all n_steps rows at
    the end, as in the JAX engine. Slots that hit EOG mid-chain keep
    generating; the host discards the tail. Returns (tokens [S,K],
    ids [S,K,NP], probs [S,K,NP], tokps [S,K], kv, sstate), all on the
    device. rope_delta [S]: M-RoPE's mrope_delta (decode_operands)."""
    ops = decode_operands(pos0, active, kv.capacity, n_steps, cos, sin,
                          rope_delta)
    chain = init_chain_rows(cfg, kv, n_steps)
    tok = token0
    outs, steps = [], []
    for j in range(n_steps):
        rows: list = []
        logits = decode_step_impl(params, cfg, tok[:, None], ops, kv, chain,
                                  j, rows)
        steps.append(rows)
        tok, ids, probs, tokp, sstate = sample_impl(
            logits[:, -1], sstate, arrs, active, extras=samp_extras,
            kcap=samp_kcap)
        outs.append((tok, ids, probs, tokp))
    write_chain_rows(kv, steps, ops.writes)
    toks, ids, probs, tokps = (torch.stack(x, dim=1) for x in zip(*outs))
    return toks, ids, probs, tokps, kv, sstate


def _decode_verify_sample(params, cfg: ModelConfig, tokens, pos0, n_draft, kv,
                          sstate, arrs, fwd_active, samp_active, cos, sin,
                          samp_extras: bool = True, samp_kcap: int = 0,
                          rope_delta=None):
    """Decode forward + speculative verify + sampling over the full slot
    batch (JAX `_decode_verify_sample`): tokens [S, T] (column 0 each
    slot's next token, then its n_draft [S] drafts) at pos0 [S] on; every
    fwd_active slot's kept rows are written, and only the samp_active ones
    sample (sampling.verify_impl). The others (the host-sampled slots)
    neither draw a kept token nor advance their sampler state, and are
    sampled on the host from their row 0 logits. T = 1 is a plain decode
    step. Returns (tokens [S, T], n_emitted [S], ids [S, T, NP], probs
    [S, T, NP], tokps [S, T], row 0 logits [S, V] f32, kv, sstate), all on
    the device."""
    ops = verify_operands(pos0, n_draft, fwd_active, kv.capacity,
                          tokens.shape[1], cos, sin, rope_delta)
    logits = verify_forward(params, cfg, tokens, ops, kv)
    toks, n_em, ids, probs, tokps, sstate = verify_impl(
        logits, tokens, n_draft, sstate, arrs, samp_active,
        extras=samp_extras, kcap=samp_kcap)
    return toks, n_em, ids, probs, tokps, logits[:, 0], kv, sstate


def _draft_chain_greedy(params, cfg: ModelConfig, token0, pos0, kv, active,
                        cos, sin, p_min: float, n_steps: int):
    """n_steps greedy draft-model steps with no host sync in between (JAX
    `_draft_chain_greedy`), each feeding its argmax to the next, as a
    decode chain: step j's rows ride the chain operand of the flash decode
    kernel and one scatter writes them at the end. The p >= p_min gate
    runs on the device: n_ok is the length of the leading confident run.
    Returns (tokens [S, n_steps], n_ok [S], 0 for an inactive slot)."""
    ops = decode_operands(pos0, active, kv.capacity, n_steps, cos, sin)
    chain = init_chain_rows(cfg, kv, n_steps)
    tok = token0
    toks, ps, steps = [], [], []
    for j in range(n_steps):
        rows: list = []
        logits = decode_step_impl(params, cfg, tok[:, None], ops, kv, chain,
                                  j, rows)[:, -1]
        steps.append(rows)
        tok = torch.argmax(logits, dim=-1)
        ps.append(torch.softmax(logits, dim=-1).gather(1, tok[:, None])[:, 0])
        toks.append(tok)
    write_chain_rows(kv, steps, ops.writes)
    ok = (torch.stack(ps, dim=1) >= p_min).long()
    n_ok = torch.where(active, torch.cumprod(ok, dim=1).sum(dim=1), 0)
    return torch.stack(toks, dim=1), n_ok


def _spec_rounds(params, cfg: ModelConfig, dparams, dcfg: ModelConfig,
                 token0, pos0, kv, dkv, sstate, arrs, active, dactive, cos,
                 sin, dcos, dsin, p_min: float, pcarry, n_rounds: int,
                 draft_k: int, samp_extras: bool = True, samp_kcap: int = 0,
                 rope_delta=None):
    """n_rounds speculative draft + verify rounds with the accept and
    advance bookkeeping on the device (JAX `_spec_chain`; one CUDA graph on
    the card). Round m:
      1. catch-up: the previous round's accepted tokens a_0..a_{n-2} into
         the draft cache at positions p+1.., a batched prefill chunk of the
         draft (rewrites rows it already holds; fills the one the draft
         chain never fed, after a round that accepted every draft);
      2. draft_k greedy draft steps from (token, position), the slots of
         dactive only (_draft_chain_greedy);
      3. the verify forward of [token | drafts] (T = draft_k + 1 rows),
         sampling.verify_impl and the row write (_decode_verify_sample);
      4. token <- the last emitted token, position += n_emitted.
    pcarry (ptoks [S, T], pnem [S], ppos [S], pvalid [S]): a previous
    pass's last round, whose accepted tail round 0 catches up first (a
    pipelined pass; pvalid false makes it a no-op); None: round 0 has no
    catch-up (the host caught the draft cache up before the dispatch).
    Returns (packed [M, S, T + 2] int32: tokens | n_emitted | n_draft,
    ids [M, S, T, NP], probs, tokps [M, S, T], token_next [S], pos_end
    [S], carry (tokens, n_emitted, start position) of the last round, kv,
    dkv, sstate). rope_delta [S]: the target's M-RoPE mrope_delta (the
    draft rotates at its own positions, as in JAX)."""
    K = draft_k
    outs, ids_l, probs_l, tokps_l = [], [], [], []
    prev = None
    if pcarry is not None:
        ptoks, pnem, ppos, pvalid = pcarry
        prev = (ptoks, torch.where(pvalid, pnem, 0), ppos)
    tok_cur, pos_cur = token0, pos0
    for _ in range(n_rounds):
        if prev is not None:
            ptoks, pnem, ppos = prev
            lens = torch.where(dactive, (pnem - 1).clamp_min(0), 0)
            prefill_batch_impl(dparams, dcfg, ptoks[:, :K],
                               torch.where(lens > 0, ppos + 1, 0), lens, dkv,
                               dcos, dsin, logits=False)
        dtoks, n_draft = _draft_chain_greedy(dparams, dcfg, tok_cur, pos_cur,
                                             dkv, dactive, dcos, dsin, p_min,
                                             K)
        tokens = torch.cat([tok_cur[:, None], dtoks], dim=1)
        toks, n_em, ids, probs, tokps, _, kv, sstate = _decode_verify_sample(
            params, cfg, tokens, pos_cur, n_draft, kv, sstate, arrs, active,
            active, cos, sin, samp_extras, samp_kcap, rope_delta)
        outs.append(torch.cat([toks, n_em[:, None].to(torch.int32),
                               n_draft[:, None].to(torch.int32)], dim=1))
        ids_l.append(ids)
        probs_l.append(probs)
        tokps_l.append(tokps)
        prev = (toks, n_em, pos_cur)
        last = toks.gather(1, (n_em - 1).clamp_min(0)[:, None])[:, 0]
        tok_cur = torch.where(active, last.long(), token0)
        pos_cur = pos_cur + torch.where(active, n_em, 0)
    return (torch.stack(outs), torch.stack(ids_l), torch.stack(probs_l),
            torch.stack(tokps_l), tok_cur, pos_cur, prev, kv, dkv, sstate)


def _host_controlled(task) -> bool:
    """The task needs per-token control on the host: a host sampler or a
    token-rate bucket (the JAX gates on chained and speculated decode)."""
    return task.host_sampler is not None or task.rate_bucket is not None


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 4
    n_ctx: int = 4096             # total; per-slot = n_ctx // n_slots
    n_ubatch: int = 512           # max prefill chunk
    kv_dtype: str = "bfloat16"    # bfloat16 | float32 | int8 (q8_0)
    # --keep: stored and read nowhere, as in the JAX engine (a request's
    # own n_keep sets what a context shift keeps)
    n_keep_default: int = 0
    prompt_cache: bool = True     # prefix cache (--no-prompt-cache disables)
    # cross-slot prefix sharing: copy the rows of any slot that shares at
    # least this many more prefix tokens than the chosen slot's own cache
    # (-1 disables; --prompt-cache-share-min)
    cache_share_min: int = 32
    defrag_headroom: int = 4      # free positions to leave after a squeeze
    max_embed_batch: int = 8      # inputs an embeddings/rerank pass
    # chained decode: tokens sampled per device chain (1 = per token)
    decode_chain: int = 1
    # first chains after a prefill are this long (x4 per chain until
    # decode_chain), so the first tokens stream early; 0 disables
    chain_ramp: int = 4
    # pipelined chains: dispatch chain N+1 (token0 = chain N's last
    # tokens, on the device) before syncing chain N, and the first chain
    # after a prefill before syncing the first tokens (False = strictly
    # alternating; the CLI's --no-decode-pipeline)
    pipeline_chain: bool = True
    # speculative chains kept in flight beyond the one being synced (one
    # fewer, and short, while a slot is idle: _fill_chain_queue)
    pipeline_depth: int = 2
    # on a CUDA device, replay each decode chain and prefill pass as one
    # captured CUDA graph; False runs them eagerly (for comparison)
    cuda_graphs: bool = True
    # speculative decoding (the reference's draft model and prompt lookup)
    draft_max: int = 8            # max drafted tokens a pass (T = this + 1)
    draft_min: int = 1            # drop draft runs shorter than this
    draft_p_min: float = 0.75     # stop drafting below this draft prob
    lookup_ngram_min: int = 0     # n-gram prompt-lookup drafting; 0 = off
    # n-gram gate: a task whose moving acceptance (its last <= 4 drafted
    # passes) dips below this stops drafting and rejoins chained decode,
    # re-probing with one drafted pass every lookup_probe_every tokens
    # (0 disables the gate)
    lookup_min_accept: float = 0.66
    lookup_probe_every: int = 64
    # draft-model rounds a pass (one graph; the host syncs once a pass)
    spec_rounds: int = 4


@dataclasses.dataclass
class _Spec:
    """A dispatched speculative pass (M draft + verify rounds) whose tokens
    the host has not consumed yet."""
    copy: tuple                 # its HostCopies handle
    pos0: np.ndarray | None     # [S] start positions; None until the pass
                                # before it is emitted
    tasks: list                 # [S] the task each slot ran it for
    m: int                      # rounds
    drafted: frozenset          # slots whose draft model ran
    t0: float                   # dispatch time
    tok_next: torch.Tensor      # [S] device: the next pass's token0
    pos_end: torch.Tensor       # [S] device: ... and its pos0
    carry: tuple                # device (tokens, n_emitted, pos) of the
                                # last round: the next pass's catch-up


@dataclasses.dataclass
class _Chain:
    """A dispatched program whose tokens the host has not consumed yet."""
    toks: torch.Tensor          # [S, K] (prefill: [S]) device tokens
    copy: tuple                 # its HostCopies handle
    pos0: np.ndarray | None     # [S] the chain's start positions
    tasks: list                 # [S] the task each slot ran it for
    k: int                      # steps
    t0: float                   # dispatch time


class Slot:
    __slots__ = ("idx", "capacity", "task", "cache_tokens", "pos", "state",
                 "cursor", "next_token", "last_used", "chain_ramp", "drafts",
                 "draft_pos", "rec_dirty")

    def __init__(self, idx: int, capacity: int):
        self.idx = idx
        self.capacity = capacity
        self.task: CompletionsTask | None = None
        self.cache_tokens: list[int] = []   # tokens whose KV is valid
        self.pos = 0                        # next KV write position
        self.state = "idle"                 # idle | prefill | decode
        self.cursor = 0                     # prefill progress into the prompt
        self.next_token = -1                # sampled, not yet in KV
        self.last_used = 0.0
        self.chain_ramp = 0                 # >0 caps the next chain's K
        self.drafts: list[int] = []         # drafted tokens for next verify
        self.draft_pos = 0                  # draft-model KV progress
        # recurrent models: the device ran this slot's state past
        # cache_tokens, so it matches no token prefix (never reused)
        self.rec_dirty = False


class Engine:
    def __init__(self, cfg: ModelConfig, params, tokenizer,
                 ecfg: EngineConfig | None = None, device: str = "cuda",
                 draft: tuple | None = None):
        """draft: (ModelConfig, params) of a draft model for speculative
        decoding (the reference's draft-model path), on `device`."""
        self.device = resolve_device(device)
        # an encoder-only BERT file serves embeddings and rerank only; it
        # passes its own check and holds no KV cache
        self.bert = cfg.arch in BERT_ARCHS
        if self.bert:
            check_bert_supported(cfg, params)
            if draft is not None:
                raise ValueError("speculative decoding needs a decoder; a "
                                 "BERT encoder serves embeddings and rerank")
        else:
            check_supported(cfg, params, self.device)
        if ecfg is not None and ecfg.kv_dtype not in _KV_DTYPES:
            raise ValueError(f"KV cache type {ecfg.kv_dtype!r} is not "
                             f"supported (one of {sorted(_KV_DTYPES)})")
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.ecfg = ecfg or EngineConfig()
        S = self.ecfg.n_slots
        self.slot_ctx = max(16, self.ecfg.n_ctx // S)
        self.rec = bool(not self.bert and cfg.recurrent)
        if self.rec:
            # the JAX engine's gates: a recurrent state has no cheap
            # rollback, so nothing drafts
            if draft is not None:
                raise ValueError("speculative decoding is not supported "
                                 "for recurrent (mamba) models")
            if self.ecfg.lookup_ngram_min > 0:
                SRV_WRN("engine", "n-gram lookup drafting disabled for "
                        "recurrent model")
                self.ecfg = dataclasses.replace(self.ecfg,
                                                lookup_ngram_min=0)
        if self.ecfg.lookup_ngram_min > 0 and self._ngram_dominated():
            SRV_WRN("engine", "n-gram lookup drafting is dominated by "
                    "chained decode (decode_chain=%d > draft_max+1=%d "
                    "tokens per host sync) and will not engage; lower "
                    "--decode-chain or raise --draft-max to use it",
                    self.ecfg.decode_chain, self.ecfg.draft_max + 1)
        kv_dtype = _KV_DTYPES[self.ecfg.kv_dtype]
        if self.rec:
            # the state of every slot, and a hybrid's KV for its
            # attention layers; rope tables where layers attend (JAX)
            self.kv = init_rec_cache(cfg, S, capacity=self.slot_ctx,
                                     params=params, dtype=kv_dtype,
                                     device=self.device)
            if cfg.n_heads > 0:
                self.rope_cos, self.rope_sin = make_rope(
                    cfg, self.slot_ctx, self.device)
            else:
                self.rope_cos = self.rope_sin = torch.zeros(
                    1, device=self.device)
            self.delta_cos = self.delta_sin = self.delta_select = None
        else:
            self.kv = None if self.bert else init_kv_cache(
                cfg, S, self.slot_ctx, kv_dtype, self.device)
            self.rope_cos, self.rope_sin = make_rope(cfg, self.slot_ctx,
                                                     self.device)
            self.delta_cos, self.delta_sin = make_delta_rope(
                cfg, self.slot_ctx, self.device)
            # stacked tables: each layer rotates by its own branch on a
            # shift
            self.delta_select = (layer_is_local(cfg)
                                 if self.delta_cos.dim() == 3 else None)
        if self.kv is not None:
            # the attention kernels' per-layer windows and ALiBi slopes:
            # device constants made before any program is captured
            layer_windows(cfg, self.device)
            alibi_slopes(cfg, self.device)
        self.draft_cfg = self.draft_params = self.draft_kv = None
        if draft is not None:
            self.draft_cfg, self.draft_params = draft
            if self.draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    "draft model vocab differs from main model "
                    f"({self.draft_cfg.vocab_size} vs {cfg.vocab_size})")
            check_supported(self.draft_cfg, self.draft_params, self.device)
            self.draft_kv = init_kv_cache(self.draft_cfg, S, self.slot_ctx,
                                          kv_dtype, self.device)
            self.draft_cos, self.draft_sin = make_rope(
                self.draft_cfg, self.slot_ctx, self.device)
            self.draft_delta_cos, self.draft_delta_sin = make_delta_rope(
                self.draft_cfg, self.slot_ctx, self.device)
            self.draft_delta_select = (
                layer_is_local(self.draft_cfg)
                if self.draft_delta_cos.dim() == 3 else None)
            layer_windows(self.draft_cfg, self.device)
            alibi_slopes(self.draft_cfg, self.device)
        self.sstate = init_sampler_state(S, cfg.vocab_size, self.device)
        self.eog_ids = sorted(tokenizer.eog_ids) if tokenizer else []
        self._default_sp = SamplerParams()
        # staging buffers take a push a program; with chains in flight a
        # buffer is reused only once the chain its last push fed is done
        ring = max(1, self.ecfg.pipeline_depth) + 2
        self._samp_bufs = SamplerBuffers(S, self.device, ring)
        self.arrs = self._samp_bufs.fill([self._default_sp] * S,
                                         self.eog_ids)
        self._arrs_dirty = False
        # a chunk never exceeds the slot's capacity, nor then its bucket
        buckets = sorted({min(b, self.slot_ctx) for b in DEFAULT_BUCKETS
                          if b <= max(self.ecfg.n_ubatch, 16)})
        # grouped weights: a prefill pass holds more rows than the grouped
        # GEMM splits (<= _SPLIT_MAX_ROWS rows take other bits), so a
        # prompt row's bits do not depend on how much of it was cached
        # a multimodal chunk prefills one slot alone, so its pass holds
        # the bucket's rows: on grouped weights only buckets of more than
        # _SPLIT_MAX_ROWS, for the same reason
        self.mm_buckets = tuple(buckets)
        if any(isinstance(w, QTensor) and not w.w8a8
               for gp in layer_groups(params) for w in gp.values()):
            self.mm_buckets = tuple(b for b in buckets
                                    if b > _SPLIT_MAX_ROWS) \
                or tuple(buckets[-1:])
            buckets = [b for b in buckets if S * b > _SPLIT_MAX_ROWS] \
                or buckets[-1:]
        self.buckets = tuple(buckets)
        # the programs' operands: decode token0 | pos0 | active | rope
        # delta, prefill pos_base | n_valid | sample-active | tokens [S,
        # bucket] (the draft's catch-up the same), one-token (verify) pass
        # pos0 | active | sample-active | host-row index | n_draft | rope
        # delta | tokens [S, T], spec pass token0 | pos0 | active |
        # draft-active | carry tokens [S, T] | n_emitted | pos | valid |
        # rope delta (the delta: M-RoPE's mrope_delta a slot, else 0 and
        # unread)
        self.mrope = bool(cfg.mrope_sections)
        T = 1 + self.ecfg.draft_max
        self._dec_in = StagedBuffer(4 * S, torch.int64, self.device, ring)
        self._one_in = StagedBuffer(S * (6 + T), torch.int64, self.device,
                                    ring)
        self._spec_in = StagedBuffer(S * (8 + T), torch.int64, self.device,
                                     ring)
        self._mm_in = self._mm_emb = None   # a multimodal chunk's, lazily
        self._pre_in = StagedBuffer(S * (3 + self.buckets[-1]), torch.int64,
                                    self.device, ring)
        # an embed pass: seq_lens [rows] | tokens [rows, bucket]
        self._emb_in = StagedBuffer(
            self.ecfg.max_embed_batch * (1 + self.buckets[-1]), torch.int64,
            self.device, ring)
        # an admitted slot's penalty window (one pass may admit S)
        self._win_in = StagedBuffer(window_size(cfg.vocab_size), torch.int32,
                                    self.device, S + ring)
        # the outputs of the programs in flight: tokens, top ids, top
        # probs, token probs of up to S x decode_chain samples (a verify
        # or spec pass: its packed tokens, n_emitted and n_draft), and the
        # logits rows of a one-token pass's host-sampled slots
        n = S * max(1, self.ecfg.decode_chain, T + 1,
                    max(1, self.ecfg.spec_rounds) * (T + 2))
        self._copies = HostCopies(ring, [
            (n, torch.int32), (n * N_PROBS, torch.int32),
            (n * N_PROBS, torch.float32), (n, torch.float32),
            (S * cfg.vocab_size, torch.float32)], self.device)
        self.embed_tasks: list = []         # embeddings/rerank, oldest first
        self._chain_q: list[_Chain] = []    # speculated, oldest first
        self._spec_q: list[_Spec] = []      # spec passes, oldest first
        self.graphs = GraphRunner(self.device, self.ecfg.cuda_graphs)
        # dynamic (per-request) adapters: configure_lora
        self.n_lora = 0
        self.lora_default: list[float] = []
        self._lora_rows = self._lora_in = None
        self._lora_stacked = False      # some layer holds a delta's stacks
        self.slots = [Slot(i, self.slot_ctx) for i in range(S)]
        self.queue: queue.Queue[BaseTask] = queue.Queue()
        self.metrics = Metrics()
        self._decode_acct_ts = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self.fuse_params()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="reconcile")
        self._thread.start()

    def fuse_params(self) -> None:
        """Rope layout to half-split and fused q/k/v and gate/up
        projections (both change no outputs beyond f32 summation order;
        see models/loader.py), at start(), after a static LoRA merge and
        the dynamic stacks. The BERT encoder reads the unfused keys. Under
        per-request LoRA the rope layout stays the file's, as in JAX: the
        stacks' q / k columns are in the file's order."""
        if self.bert or self.rec:
            return      # the BERT encoder reads the unfused keys; the
            # recurrent models run unfused, as in JAX
        from ..models.loader import deinterleave_rope, fuse_projections
        if self.n_lora == 0:
            self.params, self.cfg = deinterleave_rope(self.params, self.cfg)
        self.params = fuse_projections(self.params, self.cfg)
        if self.draft_params is not None:
            self.draft_params, self.draft_cfg = deinterleave_rope(
                self.draft_params, self.draft_cfg)
            self.draft_params = fuse_projections(self.draft_params,
                                                 self.draft_cfg)

    def configure_lora(self, n_adapters: int,
                       default_scales: list[float]) -> None:
        """Enable per-request LoRA (JAX `configure_lora`): a [S, n_ad] row
        of adapter scales a slot feeds the forward's low-rank deltas
        (models/lora.stack_dynamic), every slot at the default scales until
        a request sets its own. The rows are a staged operand, one device
        buffer the programs read and the graphs captured, so every graph
        key serves any mix of adapters."""
        S = len(self.slots)
        self.n_lora = n_adapters
        self.lora_default = list(default_scales)
        self._lora_rows = np.tile(np.asarray(default_scales, np.float32),
                                  (S, 1))
        ring = max(1, self.ecfg.pipeline_depth) + 2
        self._lora_in = StagedBuffer(S * n_adapters, torch.float32,
                                     self.device, ring)
        self._push_lora()
        self.params["lora_scales"] = self._lora_in.dev.view(S, n_adapters)
        self._lora_stacked = any(k.startswith("lora_A_")
                                 for gp in layer_groups(self.params)
                                 for k in gp)

    def _push_lora(self) -> None:
        self._lora_in.host()[:] = self._lora_rows.reshape(-1)
        self._lora_in.push()

    def _set_lora_row(self, slot: int, lora: tuple) -> None:
        """A request's adapter scales into its slot's row (JAX
        `_set_lora_row`, at admission): the defaults, then each (id,
        scale) in order; pushed behind the programs already enqueued
        when the row changes."""
        if self.n_lora == 0:
            return
        row = np.asarray(self.lora_default, np.float32).copy()
        for aid, scale in lora or ():
            if 0 <= aid < self.n_lora:
                row[aid] = scale
        if not np.array_equal(self._lora_rows[slot], row):
            self._lora_rows[slot] = row
            self._push_lora()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=30)
        if not (self._thread and self._thread.is_alive()):
            # the chains in flight read and write the graphs' buffers
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._drop_queue()
            self.graphs.close()

    def submit(self, task: BaseTask) -> None:
        self.metrics.n_requests += 1
        self.queue.put(task)

    def kv_cache_usage(self) -> tuple[int, int]:
        return (sum(s.pos for s in self.slots),
                self.slot_ctx * len(self.slots))

    # -- reconcile loop ------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._reconcile()
            except Exception as exc:  # noqa: BLE001 — keep serving
                SRV_ERR("reconcile", "pass failed: %r", exc)
                self._fail_all(exc)
                self._stop.wait(0.2)

    def _fail_all(self, exc: Exception) -> None:
        self._chain_q.clear()
        self._spec_q.clear()
        self._copies.reset()     # the queue's sets and the failed pass's
        for s in self.slots:
            if s.task is not None:
                s.task.fail(exc)
                self._release(s)

    def _reconcile(self) -> None:
        self._admit()
        embed_busy = self._embed_pass()
        pre = [s for s in self.slots if s.state == "prefill"]
        if pre:
            self._prefill_batch(pre)
            return
        dec = [s for s in self.slots if s.state == "decode"]
        if dec:
            self._decode_pass(dec)
            return
        if embed_busy:
            return
        try:
            task = self.queue.get(timeout=0.2)
        except queue.Empty:
            return
        self._dispatch(task)

    # -- admission -----------------------------------------------------------

    def _admit(self) -> None:
        while any(s.state == "idle" for s in self.slots):
            try:
                task = self.queue.get_nowait()
            except queue.Empty:
                return
            self._dispatch(task)

    def _dispatch(self, task: BaseTask) -> None:
        if task.cancelled:
            return
        if getattr(task, "_dispatched", False):
            SRV_ERR("dispatch", "task %s submitted twice; ignoring duplicate",
                    task.rid)
            return
        task._dispatched = True
        try:
            if isinstance(task, CompletionsTask):
                if self.bert:
                    raise ValueError("a BERT encoder serves embeddings and "
                                     "rerank, not completions")
                self._admit_completion(task)
            elif isinstance(task, EmbeddingsTask):
                self._admit_embed(task, task.inputs,
                                  self.cfg.pooling
                                  if self.cfg.pooling not in ("none", "rank")
                                  else "mean")
            elif isinstance(task, RerankTask):
                self._admit_embed(task, task.pairs, "rank")
            else:
                raise NotImplementedError(
                    f"{task.kind} tasks are not ported yet")
        except Exception as exc:  # noqa: BLE001
            SRV_ERR("dispatch", "task %s failed: %r", task.rid, exc)
            task.fail(exc)

    def _admit_completion(self, task: CompletionsTask) -> None:
        if not task.prompt_tokens:
            bos = self.tokenizer.bos_id if self.tokenizer else None
            if bos is None:
                task.fail(ValueError("prompt tokenized to zero tokens"))
                return
            task.prompt_tokens = [bos]
        idle = [s for s in self.slots if s.state == "idle"]
        if not idle:
            task._dispatched = False
            self.queue.put(task)
            return

        # resolve n_keep; squeeze over-long prompts (httpserver.hpp:5714-5738)
        n_keep = task.n_keep if task.n_keep >= 0 else len(task.prompt_tokens)
        n_keep = min(n_keep, self.slot_ctx // 2)
        max_len = self.slot_ctx - self.ecfg.defrag_headroom
        if len(task.prompt_tokens) > max_len:
            if task.chunks is not None:
                raise ValueError(
                    "multimodal prompt exceeds the per-slot context "
                    f"({len(task.prompt_tokens)} > {max_len} tokens)")
            n_block = max(1, (max_len - n_keep) // 2)
            n_erased = (len(task.prompt_tokens) - n_keep - n_block) \
                // n_block
            drop = max(n_erased, 1) * n_block
            drop = max(drop, len(task.prompt_tokens) - max_len)
            task.prompt_tokens = (task.prompt_tokens[:n_keep]
                                  + task.prompt_tokens[n_keep + drop:])
            task.truncated = True
        task.n_keep = n_keep

        # prefix-cache slot selection by longest common prefix
        best = max(idle, key=lambda s: (
            longest_common_prefix(s.cache_tokens, task.prompt_tokens),
            -s.last_used))
        lcp = longest_common_prefix(best.cache_tokens, task.prompt_tokens)
        reuse = min(lcp, len(task.prompt_tokens) - 1)
        if not self.ecfg.prompt_cache:
            reuse = 0
        if self.cfg.swa_window > 0 and reuse < len(task.prompt_tokens) - 1:
            reuse = 0   # a partial reuse would dip below the SWA window
        if self.rec:
            if task.chunks is not None and any(ch[0] != "tokens"
                                               for ch in task.chunks):
                raise ValueError("a recurrent model takes token prompts "
                                 "only (no embedding chunks)")
            if best.rec_dirty or reuse != len(best.cache_tokens):
                # the state stands for ALL cached tokens: exact
                # extensions only (no per-position checkpoints)
                reuse = 0
        else:
            reuse = self._share_prefix(best, task.prompt_tokens, reuse)

        s = best
        s.task = task
        s.state = "prefill"
        if self.rec:
            s.rec_dirty = False
            if reuse == 0:
                reset_rec_slot(self.kv, s.idx)
            # no context shift for a recurrent state: the request ends
            # with "length" at the slot boundary instead
            cap = s.capacity - len(task.prompt_tokens)
            task.max_tokens = (cap if task.max_tokens <= 0
                               else min(task.max_tokens, cap))
        s.cache_tokens = task.prompt_tokens[:reuse]
        s.pos = reuse
        s.cursor = reuse
        s.next_token = -1
        s.last_used = time.monotonic()
        task.n_cached = reuse
        task.t_start_prefill = time.monotonic()

        # reset + seed the sampler slot; the prompt joins the penalties
        sp = task.sparams
        last_n = min(sp.penalty_last_n if sp.penalty_last_n >= 0
                     else RING_CAP, RING_CAP)
        window = []
        if last_n > 0:
            window = [t if t >= 0 else 0
                      for t in task.prompt_tokens[-last_n:]]
        seed_slot(self.sstate, s.idx, sp.seed & 0xFFFFFFFF,
                  np.asarray(window, np.int32), len(window), last_n,
                  self._win_in)
        self._arrs_dirty = True

        # grammar/mirostat/DRY/reordered chains sample on the host (the
        # lazy-grammar semantics of the JAX engine)
        if sp.needs_host_sampler and task.host_sampler is None:
            task.host_sampler = HostSampler(sp, sp.grammar, self.tokenizer)
            task.host_sampler.push_prompt(task.prompt_tokens)
        # the n-gram prompt-lookup cache (httpserver.hpp:4752-4767); not
        # built when chained decode dominates drafting
        if self.ecfg.lookup_ngram_min > 0 and not self._ngram_dominated() \
                and task.ngram is None:
            task.ngram = NgramCache(n_min=self.ecfg.lookup_ngram_min)
            task.ngram.update(task.prompt_tokens)
        s.drafts = []
        s.draft_pos = 0
        # as in JAX, the prefix reused above may have been computed under
        # another adapter mix (ROADMAP: the reference's quirks)
        self._set_lora_row(s.idx, task.lora)
        SRV_DBG("admit", "task %s -> slot %d reuse=%d prompt=%d",
                task.rid, s.idx, reuse, len(task.prompt_tokens))

    def _share_prefix(self, best: Slot, prompt: list, reuse: int) -> int:
        """Cross-slot prefix reuse (JAX `_admit_completion`): copy the
        rows of the slot sharing the longest prefix with `prompt` into
        `best` when it beats `best`'s own `reuse` by cache_share_min or
        more; returns the rows `best` now holds. Never under a sliding
        window (the JAX rule; recurrent models never come here).

        The rows are valid under pipelining: a donor's cache_tokens and
        pos are host state that lags the device, and every row below
        them was written by a program enqueued earlier on this stream, so
        the copy, enqueued now, reads it. A chain in flight that covers
        `best` as an idle slot writes back the values it gathered itself,
        and it runs before the copy."""
        share_min = self.ecfg.cache_share_min
        if not self.ecfg.prompt_cache or share_min < 0 \
                or self.cfg.swa_window > 0:
            return reuse
        donor, donor_l = None, reuse
        for t in self.slots:
            if t is best:
                continue
            n = min(longest_common_prefix(t.cache_tokens, prompt),
                    len(prompt) - 1, t.pos)
            if n > donor_l and n - reuse >= share_min:
                donor, donor_l = t, n
        if donor is None:
            return reuse
        best.cache_tokens, best.pos = [], 0   # no rows claimed mid-copy
        try:
            copy_kv_prefix(self.kv, donor.idx, best.idx, donor_l)
        except Exception as exc:  # noqa: BLE001 — the device is suspect
            self._fail_all(exc)
            raise
        SRV_DBG("admit", "slot %d shares %d prefix rows from slot %d",
                best.idx, donor_l, donor.idx)
        return donor_l

    def _refresh_arrs(self) -> None:
        if not self._arrs_dirty:
            return
        plist = [s.task.sparams if s.task is not None else self._default_sp
                 for s in self.slots]
        self.arrs = self._samp_bufs.fill(plist, self.eog_ids)
        self._arrs_dirty = False

    # -- prefill -------------------------------------------------------------

    def _bucket(self, n: int, buckets: tuple = ()) -> int:
        """The first of `buckets` (the batched passes' by default) that
        holds n rows, else the largest."""
        buckets = buckets or self.buckets
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]

    def _prefill_batch(self, pre: list) -> None:
        """Prefill every pending slot's next chunk in ONE batched pass;
        first tokens of every completed prompt are sampled in the same
        program and reach the host with one wait (after the first decode
        chain has gone out, when it can). A multimodal task's slot
        prefills on its own (_prefill_chunk), as in JAX."""
        slots = []
        for s in pre:
            if s.task.cancelled:
                self._release(s)
            elif s.task.chunks is not None and not self.rec:
                self._prefill_chunk(s)
            else:
                slots.append(s)
        if not slots:
            return
        t0 = time.monotonic()
        done, total, pend, logits = self._prefill_batch_dispatch(slots)
        if done:
            ramp_set = pend is not None and \
                self._speculate_post_prefill(done, pend)
            self._finish_batch_sync(done, pend, ramp_set, logits)
        self.metrics.on_prefill(total, (time.monotonic() - t0) * 1e3)

    def _prefill_batch_dispatch(self, slots: list):
        """Stage and dispatch one batched prefill pass, and start the copy
        of the first tokens of the prompts it completes (the device-sampled
        ones; a host-sampled slot's sampler state stays still); no wait.
        Returns (completed slots, prompt tokens, the device-sampled ones'
        _Chain or None, the pass's last-row logits [S, V] on the device)."""
        S = len(self.slots)
        chunks = {s.idx: min(len(s.task.prompt_tokens) - s.cursor,
                             self.ecfg.n_ubatch) for s in slots}
        T = self._bucket(max(chunks.values()))
        done = [s for s in slots
                if s.cursor + chunks[s.idx] >= len(s.task.prompt_tokens)]
        h = self._pre_in.host()
        h[:S * (3 + T)] = 0
        tokens = h[3 * S:S * (3 + T)].reshape(S, T)
        for s in slots:
            n = chunks[s.idx]
            tokens[s.idx, :n] = s.task.prompt_tokens[s.cursor:s.cursor + n]
            h[s.idx] = s.pos
            h[S + s.idx] = n
        dev_done = [s for s in done if s.task.host_sampler is None]
        for s in dev_done:
            h[2 * S + s.idx] = 1
        self._pre_in.push(S * (3 + T))
        self._refresh_arrs()
        outs = self.graphs.run(("prefill", T),
                               lambda: self._prefill_program(T))
        for s in slots:
            n = chunks[s.idx]
            s.cache_tokens.extend(s.task.prompt_tokens[s.cursor:s.cursor + n])
            s.cursor += n
            s.pos += n
        pend = (self._copy_out(dev_done, 1, outs, None, 0.0)
                if dev_done else None)
        return done, int(sum(chunks.values())), pend, outs[4]

    def _prefill_program(self, T: int):
        """One prefill pass of bucket T over the staged operands, then the
        sample of the device-sampled slots whose prompt it completes (the
        others do not advance their sampler state). Returns (tok, ids,
        probs, tokp, last-row logits [S, V] f32)."""
        S = len(self.slots)
        d = self._pre_in.dev
        prefill = rec_prefill_batch_impl if self.rec else prefill_batch_impl
        logits, self.kv = prefill(
            self.params, self.cfg, d[3 * S:S * (3 + T)].view(S, T), d[:S],
            d[S:2 * S], self.kv, self.rope_cos, self.rope_sin)
        tok, ids, probs, tokp, self.sstate = sample_impl(
            logits, self.sstate, self.arrs, d[2 * S:3 * S] != 0)
        return tok, ids, probs, tokp, logits

    def _chunk_at(self, task, cursor: int):
        """The prompt chunk holding flat position `cursor`: (its start, its
        end, the chunk) (JAX `_chunk_at`)."""
        start = 0
        for ch in task.chunks:
            n = len(ch[1])
            if cursor < start + n:
                return start, start + n, ch
            start += n
        raise RuntimeError("prefill cursor out of range")

    def _mm_buffers(self):
        """The staged operands of a multimodal chunk, made at the first
        one (before its first, eager, program): pos_base | n_valid |
        bidir start | end | sample-active | slot | M-RoPE streams [3,
        bucket] | tokens [bucket], and the embedding rows [bucket, E]
        (f32)."""
        if self._mm_in is None:
            ring = max(1, self.ecfg.pipeline_depth) + 2
            Tm = self.buckets[-1]
            self._mm_in = StagedBuffer(6 + 4 * Tm, torch.int64, self.device,
                                       ring)
            self._mm_emb = StagedBuffer(Tm * self.cfg.n_embd, torch.float32,
                                        self.device, ring)
        return self._mm_in, self._mm_emb

    def _prefill_chunk(self, s: Slot) -> None:
        """Prefill the next ubatch of one slot's current prompt chunk (JAX
        `_prefill_chunk`): token rows or a tower's embedding rows, with
        the chunk's M-RoPE streams on an M-RoPE model and, for gemma3's
        image rows, the bidirectional span (s.pos - off, s.pos + n): the
        image's rows so far and this ubatch's. One program a key
        ("prefill_mm", kind, bucket), the slot among its staged operands,
        whose first token, when it completes the prompt, is sampled in it
        and handled as the batched pass's are."""
        task = s.task
        t0 = time.monotonic()
        cstart, cend, ch = self._chunk_at(task, s.cursor)
        off = s.cursor - cstart
        n = min(cend - s.cursor, self.ecfg.n_ubatch)
        T = self._bucket(n, self.mm_buckets)
        kind = ch[0]
        done = s.cursor + n >= len(task.prompt_tokens)
        dev_done = [s] if done and task.host_sampler is None else []
        mm_in, mm_emb = self._mm_buffers()
        h = mm_in.host()
        h[:6 + 4 * T] = 0
        h[0], h[1], h[4], h[5] = s.pos, n, int(bool(dev_done)), s.idx
        if kind == "embed" and self.cfg.arch == "gemma3":
            h[2], h[3] = s.pos - off, s.pos + n
        if self.mrope:
            h[6:6 + 3 * T].reshape(3, T)[:, :n] = ch[-1][:, off:off + n]
        if kind == "tokens":
            h[6 + 3 * T:6 + 3 * T + n] = ch[1][off:off + n]
        else:
            E = self.cfg.n_embd
            he = mm_emb.host()
            he[:T * E] = 0
            he[:n * E] = np.asarray(ch[1][off:off + n],
                                    np.float32).reshape(-1)
            mm_emb.push(T * E)
        mm_in.push(6 + 4 * T)
        self._refresh_arrs()
        outs = self.graphs.run(("prefill_mm", kind, T),
                               lambda: self._prefill_mm_program(kind, T))
        s.cache_tokens.extend(task.prompt_tokens[s.cursor:s.cursor + n])
        s.cursor += n
        s.pos += n
        if done:
            pend = (self._copy_out(dev_done, 1, outs, None, 0.0)
                    if dev_done else None)
            ramp_set = pend is not None and \
                self._speculate_post_prefill([s], pend)
            self._finish_batch_sync([s], pend, ramp_set, outs[4])
        self.metrics.on_prefill(n, (time.monotonic() - t0) * 1e3)

    def _prefill_mm_program(self, kind: str, T: int):
        """One multimodal chunk of bucket T into the staged slot over the
        staged operands (prefill_batch_impl on that slot of the cache),
        then the sample when it completes the prompt. Returns
        _prefill_program's (tok, ids, probs, tokp, logits [S, V] f32: the
        slot's row set)."""
        S = len(self.slots)
        d = self._mm_in.dev
        tokens = embeds = None
        if kind == "tokens":
            tokens = d[6 + 3 * T:6 + 4 * T].view(1, T)
        else:
            embeds = self._mm_emb.dev[:T * self.cfg.n_embd].view(1, T, -1)
        logits, self.kv = prefill_batch_impl(
            self.params, self.cfg, tokens, d[0:1], d[1:2], self.kv,
            self.rope_cos, self.rope_sin, embeds=embeds,
            mrope_pos=d[6:6 + 3 * T].view(3, 1, T) if self.mrope else None,
            bidir=d[2:4].view(1, 2), slots=d[5:6])
        at = torch.arange(S, device=d.device) == d[5]
        full = torch.where(at[:, None], logits, 0.0)
        active = at & (d[4] != 0)
        tok, ids, probs, tokp, self.sstate = sample_impl(
            full, self.sstate, self.arrs, active)
        return tok, ids, probs, tokp, full

    def _speculate_post_prefill(self, done: list, pend: _Chain) -> bool:
        """Dispatch the first (ramped) decode chain off the prefill's
        device-resident first tokens before the host waits for them, so
        the device runs it while the first tokens stream (JAX
        `_speculate_post_prefill`). Consumed or dropped as every
        speculated chain is (_consume_pending_chain). Returns True when
        it went out (it has set the slots' ramps)."""
        if not self.ecfg.pipeline_chain or self._chain_q or self._spec_q:
            return False
        # no chain over heterogeneous layer groups, after an M-RoPE
        # prefill or on a recurrent model (the JAX gates)
        if "layer_groups" in self.params or self.mrope or self.rec:
            return False
        # no chain while a slot may draft (the JAX gate)
        if self.draft_params is not None or (
                self.ecfg.lookup_ngram_min > 0
                and not self._ngram_dominated()):
            return False
        # every decoding slot must ride a joint chain; slots still
        # prefilling later chunks are inactive rows
        if any(s.state == "decode" for s in self.slots):
            return False
        # the JAX gate: plain slots only, by the JAX chain's `plain`,
        # which leaves ignore_eos out (ROADMAP Queue 3), and none under
        # host control
        if any(_host_controlled(s.task)
               or not dataclasses.replace(s.task.sparams,
                                          ignore_eos=False).plain
               for s in done):
            return False
        K = self.ecfg.decode_chain
        if self.ecfg.chain_ramp > 0:
            K = min(K, self.ecfg.chain_ramp)
        rem = max(self._remaining(s) - 1 for s in done)  # first tok pending
        if rem < K:
            K = min(K, max(4, _pow2_floor(max(rem, 1))))
        K = min(K, _pow2_floor(min(s.capacity - s.pos for s in done)))
        if K < 2 or rem <= 0:
            return False
        self._chain_q.append(self._dispatch_chain(
            done, K, {s.idx: s.pos for s in done}, pend.toks))
        self.metrics.on_speculate(post_prefill=True)
        for s in done:
            nxt = K * 4
            s.chain_ramp = 0 if nxt >= self.ecfg.decode_chain else nxt
        return True

    def _finish_batch_sync(self, done: list, pend: _Chain | None,
                           ramp_set: bool, logits) -> None:
        """Wait for the first tokens and emit them: one host copy for the
        device-sampled slots, one batched gather of the last-row logits
        for the host-sampled ones (JAX `_finish_batch_sync`)."""
        hs = [s for s in done if s.task.host_sampler is not None]
        if pend is not None:
            tok_h, ids_h, probs_h, tokp_h, _ = self._copies.wait(pend.copy)
            for s in done:
                if s in hs:
                    continue
                s.task.t_prefilled = time.monotonic()
                s.state = "decode"
                if not ramp_set:
                    # else the speculated chain already took (and
                    # advanced) this slot's ramp
                    s.chain_ramp = self.ecfg.chain_ramp
                self._accept_token(
                    s, int(tok_h[s.idx]),
                    ids_h[s.idx] if ids_h is not None else None,
                    probs_h[s.idx] if probs_h is not None else None,
                    float(tokp_h[s.idx]) if tokp_h is not None else 0.0)
        if hs:
            # read before any later program can replay the pass's graph:
            # the gather is enqueued behind the pass and waited on here
            rows = torch.stack([logits[s.idx] for s in hs]).cpu().numpy()
            for k, s in enumerate(hs):
                first, ids_row, probs_row, tok_prob = \
                    s.task.host_sampler.sample(rows[k])
                s.task.t_prefilled = time.monotonic()
                s.state = "decode"
                s.chain_ramp = self.ecfg.chain_ramp
                self._accept_token(s, first, ids_row, probs_row, tok_prob)

    # -- decode --------------------------------------------------------------

    def _decode_pass(self, dec: list) -> None:
        # a speculated chain or spec pass holds the tokens these slots
        # consume next (their device sampler state already advanced
        # through it): use it, never re-dispatch
        if self._chain_q and self._consume_pending_chain(dec):
            return
        if self._spec_q and self._consume_spec_chain(dec):
            return
        # n-gram lookup: the drafts first, so that a pass where no slot
        # drafts (no match, or the acceptance gate holds) runs a chain
        ngram_drafts = None
        if self.draft_params is None and self.ecfg.lookup_ngram_min > 0:
            ngram_drafts = {s.idx: self._make_drafts(s) for s in dec}
        host = any(_host_controlled(s.task) for s in dec)
        # heterogeneous layer groups decode a token a pass, never in a
        # chain (the JAX engine's gate)
        groups = "layer_groups" in self.params
        if not host and self.draft_params is None and not groups \
                and not (ngram_drafts and any(ngram_drafts.values())):
            # chains shrink toward the boundary, so a slot reaches its
            # capacity at the end of one; it shifts before the next (the
            # JAX engine's one-token pass), and the chain shrinks to fit
            for s in dec:
                if s.pos >= s.capacity:
                    self._shift_or_finish(s)
            dec = [s for s in dec if s.state == "decode"]
            if not dec:
                return
            K = self._chain_k(dec)
            K = max(1, min(K, _pow2_floor(min(s.capacity - s.pos
                                              for s in dec))))
            self._decode_pass_chain(dec, K)
            return
        # a draft model: draft and verify on the device, one host sync a
        # pass, while no slot needs host control or could shift
        if (self.draft_params is not None and not host
                and self.ecfg.draft_min <= 1
                and all(s.pos + 1 + self.ecfg.draft_max <= s.capacity
                        for s in dec)):
            # M rounds a pass while every slot has room for the pass's
            # most; near capacity M shrinks to what fits (>= 2), then the
            # one-round pass, then the one-token pass's shift at the
            # boundary
            per_round = 1 + self.ecfg.draft_max
            room = min(s.capacity - s.pos for s in dec)
            M = min(self.ecfg.spec_rounds, room // per_round)
            if M > 1 and not self.mrope:    # the JAX gate
                self._decode_pass_spec_chain(dec, M)
            else:
                self._decode_pass_fused_draft(dec)
            return
        # per-token host control (a host sampler or a rate bucket), or
        # drafts verified by the host: ONE one-token (verify) pass for
        # every decoding slot, no chain (the JAX gates)
        self._one_token_pass(dec, ngram_drafts)

    def _one_token_pass(self, dec: list, ngram_drafts=None) -> None:
        """One decode step for every decoding slot, verifying each slot's
        drafts (the JAX engine's per-token pass: `_decode_verify_sample`
        at T = 1 + draft_max when a slot drafts, else T = 1). The drafts
        come from the draft model (two host syncs: the drafts, then the
        verify) or the n-gram cache. The device samples the device-sampled
        slots; the host-sampled ones draft nothing and get their logits
        rows (one gather by a staged index vector, one copy) and sample on
        the host, their device sampler state left as it was. A slot
        without room for its drafts shifts first; a slot whose rate bucket
        lacks 1 + its drafts sits the pass out (a 5 ms sleep when no slot
        is left, so the loop does not spin). The chain queue is empty
        here."""
        if self.draft_params is not None:
            self._draft_model_pass(dec)
        else:
            for s in dec:
                s.drafts = (ngram_drafts[s.idx] if ngram_drafts is not None
                            else self._make_drafts(s))
        for s in dec:
            if s.pos + 1 + len(s.drafts) > s.capacity:
                self._shift_or_finish(s)
        dec = [s for s in dec if s.state == "decode"]
        dec = [s for s in dec if s.task.rate_bucket is None
               or s.task.rate_bucket.try_acquire(1 + len(s.drafts))]
        if not dec:
            time.sleep(0.005)
            return
        self._refresh_arrs()
        t0 = time.monotonic()
        S = len(self.slots)
        T = 1 + (self.ecfg.draft_max if any(s.drafts for s in dec) else 0)
        hs = [s for s in dec if s.task.host_sampler is not None]
        tokens, pos = [None] * S, [0] * S
        for s in dec:
            tokens[s.idx] = [s.next_token] + s.drafts[:T - 1]
            pos[s.idx] = s.pos
        self._stage_one(tokens, pos, [s.idx for s in hs], T)
        kw = self._chain_fast_kw([s for s in dec if s not in hs])
        extras, kcap = kw["samp_extras"], kw.get("samp_kcap", 0)
        key = ("one", extras, kcap) if T == 1 else \
            ("verify", T, extras, kcap)
        outs = self.graphs.run(key,
                               lambda: self._one_token_program(T, **kw))
        want = any(s.task.n_probs > 0 for s in dec)
        copy = self._copies.start(
            (outs[0],) + (outs[1:4] if want else (None,) * 3)
            + (outs[4][:len(hs)] if hs else None,))
        packed_h, ids_h, probs_h, tokps_h, rows_h = self._copies.wait(copy)
        n_em = packed_h[:, T]
        self._acct_decode(int(n_em.sum()) + len(hs), t0)
        self._emit_verify(dec, packed_h[:, :T], n_em, ids_h, probs_h,
                          tokps_h, {s.idx: rows_h[k]
                                    for k, s in enumerate(hs)})

    def _stage_one(self, tokens: list, pos: list, host: list,
                   T: int | None = None) -> None:
        """Stage a one-token pass's operands (pos0 | active | sample-active
        | host-row index | n_draft | rope delta, S each, then tokens [S,
        T]): slot b decodes tokens[b] (its next token, or a list: the next
        token and its drafts) from pos[b] (None: it sits out, at position
        slot_ctx). T is the program's rows a slot (a verify pass's 1 +
        draft_max even when every slot drafts fewer), by default the
        longest list. The device samples the active slots not in `host`,
        and the rows of the slots in `host` come out in that order."""
        S = len(self.slots)
        rows = [[t] if isinstance(t, int) else t for t in tokens]
        if T is None:
            T = max(len(r) for r in rows if r is not None)
        h = self._one_in.host()
        h[:] = 0
        h[:S] = self.slot_ctx
        tok = h[6 * S:S * (6 + T)].reshape(S, T)
        for b, (r, p) in enumerate(zip(rows, pos)):
            if r is not None:
                h[b], h[S + b] = p, 1
                h[2 * S + b] = int(b not in host)
                h[4 * S + b] = len(r) - 1
                h[5 * S + b] = self._rope_delta(b)
                tok[b, :len(r)] = r
        for k, b in enumerate(host):
            h[3 * S + k] = b
        self._one_in.push(S * (6 + T))

    def _one_token_program(self, T: int = 1, **kw):
        """One one-token pass of T rows a slot over the staged operands:
        (tokens | n_emitted [S, T + 1] int32, ids, probs, tokps [S, T, ..],
        the host-sampled slots' row 0 logits first in [S, V], gathered by
        the staged index vector, so the graph's shapes are fixed)."""
        S = len(self.slots)
        d = self._one_in.dev
        if self.rec:
            # T = 1: nothing drafts on a recurrent model
            toks, n_em, ids, probs, tokps, logits0, self.kv, self.sstate = \
                rec_decode_verify_sample(
                    self.params, self.cfg, d[6 * S:S * (6 + T)].view(S, T),
                    d[:S], self.kv, self.sstate, self.arrs, d[S:2 * S] != 0,
                    d[2 * S:3 * S] != 0, self.rope_cos, self.rope_sin, **kw)
            packed = torch.cat([toks, n_em[:, None].to(torch.int32)], dim=1)
            return (packed, ids, probs, tokps,
                    logits0.index_select(0, d[3 * S:4 * S]))
        toks, n_em, ids, probs, tokps, logits0, self.kv, self.sstate = \
            _decode_verify_sample(
                self.params, self.cfg, d[6 * S:S * (6 + T)].view(S, T),
                d[:S], d[4 * S:5 * S], self.kv, self.sstate, self.arrs,
                d[S:2 * S] != 0, d[2 * S:3 * S] != 0, self.rope_cos,
                self.rope_sin, rope_delta=self._delta_operand(d, 5 * S),
                **kw)
        packed = torch.cat([toks, n_em[:, None].to(torch.int32)], dim=1)
        return (packed, ids, probs, tokps,
                logits0.index_select(0, d[3 * S:4 * S]))

    def _emit_verify(self, dec: list, toks_h, n_emitted_h, ids_h, probs_h,
                     tokps_h, hs_rows=None) -> None:
        """Emit a verify pass's accepted tokens (JAX `_emit_verify`; the
        reference's per-token postprocess scan, httpserver.hpp:4284-4334):
        a host-sampled slot samples its row 0 logits; a device-sampled one
        keeps its next token and the accepted drafts in the cache and
        emits n_emitted tokens."""
        for s in dec:
            task = s.task
            hs = task.host_sampler
            if hs is not None:
                s.cache_tokens.append(s.next_token)
                s.pos += 1
                token, top_ids, top_probs, tok_prob = hs.sample(
                    hs_rows[s.idx])
                self._accept_token(s, token, top_ids, top_probs, tok_prob)
                continue
            n_em = int(n_emitted_h[s.idx])
            acc = n_em - 1
            if s.drafts:
                task.n_drafted += len(s.drafts)
                task.n_draft_accepted += acc
                self.metrics.on_draft(len(s.drafts), acc)
                if task.ngram is not None:
                    self._ngram_observe(task, len(s.drafts), acc)
            # the cache now holds next_token and the accepted drafts
            kept = [s.next_token] + s.drafts[:acc]
            s.cache_tokens.extend(kept)
            s.pos += len(kept)
            ngram = task.ngram
            for j in range(n_em):
                self._accept_token(
                    s, int(toks_h[s.idx, j]),
                    ids_h[s.idx, j] if ids_h is not None else None,
                    probs_h[s.idx, j] if probs_h is not None else None,
                    float(tokps_h[s.idx, j]) if tokps_h is not None else 0.0)
                if ngram is not None:
                    ngram.push(task.prompt_tokens + task.generated)
                if s.task is None:  # finished/cancelled mid-emission
                    break

    # -- drafting ------------------------------------------------------------

    def _make_drafts(self, s: Slot) -> list[int]:
        """Draft continuation tokens for one slot by n-gram lookup (JAX
        `_make_drafts`; the draft model drafts in _draft_model_pass)."""
        task = s.task
        if task.host_sampler is not None:
            return []   # host-sampled slots draft nothing
        k = min(self.ecfg.draft_max, max(task.budget_left() - 1, 0))
        if k <= 0 or task.ngram is None or not self._ngram_gate(task):
            return []
        return task.ngram.draft(task.prompt_tokens + task.generated, k)

    def _ngram_dominated(self) -> bool:
        """n-gram drafting needs the synced history, so a drafted pass
        costs one host sync for at most 1 + draft_max tokens and cannot
        pipeline; when a chain moves more tokens a sync, drafting is
        skipped altogether (JAX `_ngram_dominated`)."""
        return self.ecfg.decode_chain > self.ecfg.draft_max + 1

    def _ngram_gate(self, task) -> bool:
        """May this task n-gram-draft this pass? (JAX `_ngram_gate`.) A
        held task rejoins chained decode and re-probes with ONE drafted
        pass every lookup_probe_every tokens (its n-gram cache keeps
        learning from chain-emitted tokens meanwhile)."""
        if self._ngram_dominated():
            return False
        if self.ecfg.lookup_min_accept <= 0:
            return True
        if not hasattr(task, "spec_window"):
            task.spec_window = []       # last <= 4 per-pass accept ratios
            task.spec_resume_at = -1    # generated count to re-probe at
            task.spec_probe = False     # the next drafted pass is a probe
            return True
        if task.spec_resume_at >= 0:
            if len(task.generated) < task.spec_resume_at:
                return False
            task.spec_resume_at = -1
            task.spec_window = []
            task.spec_probe = True      # one pass decides
        return True

    def _ngram_may_draft(self, task, ahead: int = 0) -> bool:
        """Could this task draft within the next `ahead` emitted tokens
        (no change to its gate; JAX `_ngram_may_draft`)?"""
        if self.ecfg.lookup_min_accept <= 0:
            return True
        ra = getattr(task, "spec_resume_at", -1)
        return ra < 0 or len(task.generated) + ahead >= ra

    def _ngram_observe(self, task, drafted: int, accepted: int) -> None:
        """Fold one drafted pass's acceptance into the task's moving
        window; hold drafting when its mean dips below the threshold (JAX
        `_ngram_observe`)."""
        th = self.ecfg.lookup_min_accept
        if th <= 0 or drafted <= 0 or not hasattr(task, "spec_window"):
            return
        win = task.spec_window
        win.append(accepted / drafted)
        if len(win) > 4:
            win.pop(0)
        need = 1 if task.spec_probe else 2
        if len(win) >= need and sum(win) / len(win) < th:
            task.spec_resume_at = (len(task.generated)
                                   + self.ecfg.lookup_probe_every)
        task.spec_probe = False

    def _draft_eligible(self, dec: list) -> list:
        """Clear every slot's drafts; the slots the draft model drafts
        for: device-sampled, with a budget past the next token and room
        for 1 + draft_max positions (JAX `_draft_model_pass`)."""
        K = self.ecfg.draft_max
        for s in dec:
            s.drafts = []
        return [s for s in dec if s.task.host_sampler is None
                and s.task.budget_left() > 1
                and s.pos + 1 + K <= s.capacity]

    def _draft_model_pass(self, dec: list) -> None:
        """The draft model's drafts for every eligible slot, on the host
        (the one-token pass's two-sync path, JAX `_draft_model_pass` with
        sync): catch the draft cache up, then one greedy draft chain of
        draft_max steps whose confident run (p >= draft_p_min, on the
        device) becomes the slot's drafts, or none when shorter than
        draft_min."""
        eligible = self._draft_eligible(dec)
        if not eligible:
            return
        self._draft_catch_up(eligible)
        K = self.ecfg.draft_max
        S = len(self.slots)
        h = self._dec_in.host()
        h[:] = 0
        h[S:2 * S] = self.slot_ctx
        for s in eligible:
            h[s.idx], h[S + s.idx], h[2 * S + s.idx] = \
                s.next_token, s.pos, 1
        self._dec_in.push()
        packed = self.graphs.run(("draft", K),
                                 lambda: self._draft_program(K))
        packed_h = self._copies.wait(self._copies.start(
            (packed,) + (None,) * 4))[0]
        for s in eligible:
            s.draft_pos = s.pos + 1     # next_token is in the draft cache
            d = packed_h[s.idx, :int(packed_h[s.idx, K])].tolist()
            s.drafts = d if len(d) >= self.ecfg.draft_min else []

    def _draft_program(self, K: int):
        """One greedy draft chain of K steps over the staged decode
        operands: (tokens | n_ok [S, K + 1] int32)."""
        S = len(self.slots)
        d = self._dec_in.dev
        toks, n_ok = _draft_chain_greedy(
            self.draft_params, self.draft_cfg, d[:S], d[S:2 * S],
            self.draft_kv, d[2 * S:3 * S] != 0, self.draft_cos,
            self.draft_sin,
            self.ecfg.draft_p_min, K)
        return torch.cat([toks, n_ok[:, None]], dim=1).to(torch.int32)

    def _draft_catch_up(self, eligible: list) -> None:
        """Feed the draft cache the tokens it has not seen, in chunks of
        at most n_ubatch (after a context shift, the whole history), each
        chunk one batched prefill pass of the draft (the flash prefill
        kernel), through next_token's predecessor, so drafting can start
        from next_token (JAX `_draft_catch_up`)."""
        S = len(self.slots)
        missing = {s.idx: s.cache_tokens[s.draft_pos:] for s in eligible}
        while any(missing.values()):
            T = self._bucket(min(max(len(m) for m in missing.values()),
                                 self.ecfg.n_ubatch))
            h = self._pre_in.host()
            h[:S * (3 + T)] = 0
            tokens = h[3 * S:S * (3 + T)].reshape(S, T)
            for s in eligible:
                m = missing[s.idx][:T]
                if not m:
                    continue
                tokens[s.idx, :len(m)] = m
                h[s.idx] = s.pos - len(missing[s.idx])
                h[S + s.idx] = len(m)
                missing[s.idx] = missing[s.idx][len(m):]
            self._pre_in.push(S * (3 + T))
            self.graphs.run(("draft_prefill", T),
                            lambda T=T: self._draft_prefill_program(T))

    def _draft_prefill_program(self, T: int) -> tuple:
        """One batched prefill pass of the draft, bucket T, over the staged
        prefill operands; no logits, no sample."""
        S = len(self.slots)
        d = self._pre_in.dev
        prefill_batch_impl(
            self.draft_params, self.draft_cfg, d[3 * S:S * (3 + T)].view(S, T),
            d[:S], d[S:2 * S], self.draft_kv, self.draft_cos, self.draft_sin,
            logits=False)
        return ()

    # -- speculative passes (a draft model, no slot under host control) ------

    def _decode_pass_fused_draft(self, dec: list) -> None:
        """Draft + verify with ONE host sync a pass (JAX
        `_decode_pass_fused_draft`): the host catches the draft cache up,
        then one program drafts for the eligible slots and verifies every
        slot off the draft chain's device-resident tokens (_spec_rounds at
        M = 1, no carry)."""
        eligible = self._draft_eligible(dec)
        if eligible:
            self._draft_catch_up(eligible)
        self._refresh_arrs()
        rec = self._dispatch_spec(dec, 1, drafted=eligible)
        self._emit_spec(dec, rec)

    def _decode_pass_spec_chain(self, dec: list, M: int) -> None:
        """M draft + verify rounds in ONE program and ONE host sync (see
        _spec_rounds), pipelined as chains are: the next passes go out off
        this one's device-resident token, position and catch-up carry
        before the host waits for it (_consume_spec_chain). Tokens past a
        task's end are discarded on the host."""
        self._draft_catch_up(dec)
        self._refresh_arrs()
        self._spec_q.append(self._dispatch_spec(dec, M, drafted=dec))
        self._consume_spec_chain(dec)

    def _dispatch_spec(self, dec: list, M: int, drafted: list,
                       newest: _Spec | None = None) -> _Spec:
        """Stage a spec pass's operands, run it and start the copy of its
        outputs. Each slot of `dec` verifies from its position, the slots
        of `drafted` draft. M = 1 without `newest` is the one-round pass
        (no carry); an M-round pass takes a carry, valid for its slots
        when it follows `newest` (a pass in flight, whose device-resident
        next token, position and carry it copies on the device; its host
        start positions are then unknown until `newest` is emitted)."""
        t0 = time.monotonic()
        S = len(self.slots)
        T = 1 + self.ecfg.draft_max
        h = self._spec_in.host()
        h[:] = 0
        pos0 = np.full(S, self.slot_ctx, np.int64)
        for s in dec:
            h[s.idx], pos0[s.idx], h[2 * S + s.idx] = s.next_token, s.pos, 1
            h[S * (6 + T) + s.idx] = int(newest is not None)
            h[S * (7 + T) + s.idx] = self._rope_delta(s.idx)
        h[S:2 * S] = pos0
        for s in drafted:
            h[3 * S + s.idx] = 1
        self._spec_in.push()
        if newest is not None:
            d = self._spec_in.dev
            ptoks, pnem, ppos = newest.carry
            d[:S].copy_(newest.tok_next)
            d[S:2 * S].copy_(newest.pos_end)
            d[4 * S:S * (4 + T)].view(S, T).copy_(ptoks)
            d[S * (4 + T):S * (5 + T)].copy_(pnem)
            d[S * (5 + T):S * (6 + T)].copy_(ppos)
        kw = self._chain_fast_kw(dec)
        carry = M > 1
        key = ("spec" if carry else "fused", M, T - 1, kw["samp_extras"],
               kw.get("samp_kcap", 0))
        outs = self.graphs.run(key, lambda: self._spec_program(
            M, carry, **kw))
        want = any(s.task.n_probs > 0 for s in dec)
        copy = self._copies.start(
            (outs[0],) + (tuple(outs[1:4]) if want else (None,) * 3)
            + (None,))
        tasks = [None] * S
        for s in dec:
            tasks[s.idx] = s.task
        return _Spec(copy, None if newest is not None else pos0, tasks, M,
                     frozenset(s.idx for s in drafted), t0, outs[4],
                     outs[5], outs[6])

    def _spec_program(self, M: int, carry: bool, **kw):
        """One spec pass of M rounds over the staged operands (see
        _spec_rounds)."""
        S = len(self.slots)
        T = 1 + self.ecfg.draft_max
        d = self._spec_in.dev
        pcarry = None
        if carry:
            pcarry = (d[4 * S:S * (4 + T)].view(S, T),
                      d[S * (4 + T):S * (5 + T)], d[S * (5 + T):S * (6 + T)],
                      d[S * (6 + T):S * (7 + T)] != 0)
        packed, ids, probs, tokps, tok_next, pos_end, last, self.kv, \
            self.draft_kv, self.sstate = _spec_rounds(
                self.params, self.cfg, self.draft_params, self.draft_cfg,
                d[:S], d[S:2 * S], self.kv, self.draft_kv, self.sstate,
                self.arrs, d[2 * S:3 * S] != 0, d[3 * S:4 * S] != 0,
                self.rope_cos, self.rope_sin, self.draft_cos, self.draft_sin,
                self.ecfg.draft_p_min, pcarry, M, T - 1,
                rope_delta=self._delta_operand(d, S * (7 + T)), **kw)
        return packed, ids, probs, tokps, tok_next, pos_end, last

    def _fill_spec_queue(self, dec: list, pend: _Spec) -> None:
        """Top the spec queue up to pipeline_depth, each new pass going out
        off the newest pass's device-resident token, position and carry
        (JAX `_fill_spec_queue`); `pend` is the pass being consumed, its
        rounds still in flight. Only while even full acceptance of the
        rounds in flight cannot cover every slot's budget, and only while
        every position a pass may reach stays inside the cache (no shift
        can be needed mid-flight)."""
        if not self.ecfg.pipeline_chain:
            return
        per_round = 1 + self.ecfg.draft_max
        while len(self._spec_q) < max(1, self.ecfg.pipeline_depth):
            newest = self._spec_q[-1] if self._spec_q else pend
            inflight = pend.m + sum(p.m for p in self._spec_q)
            if max(self._remaining(s) for s in dec) <= inflight * per_round:
                return
            M = self.ecfg.spec_rounds
            if any(s.pos + (inflight + M) * per_round > s.capacity
                   for s in dec):
                return
            self._spec_q.append(self._dispatch_spec(dec, M, dec, newest))
            self.metrics.on_speculate(post_prefill=False)

    def _consume_spec_chain(self, dec: list) -> bool:
        """Emit the OLDEST spec pass in flight (JAX `_consume_spec_chain`).
        Covered = the same task at the expected position. Returns False,
        the whole queue dropped, when nothing is covered; admission
        rebuilds a dropped slot's device state, as for dropped chains."""
        pend = self._spec_q.pop(0)
        covered = [s for s in dec
                   if s.task is not None and pend.tasks[s.idx] is s.task
                   and (pend.pos0 is None or s.pos == int(pend.pos0[s.idx]))]
        if not covered:
            self._copies.drop(pend.copy)
            self._drop_queue()
            return False
        if len(covered) == len(dec):
            self._fill_spec_queue(covered, pend)
        self._emit_spec(covered, pend)
        # the next pass starts where this one ended
        if self._spec_q and self._spec_q[0].pos0 is None:
            nxt = np.full(len(self.slots), -1, np.int64)
            for s in covered:
                if s.task is not None:
                    nxt[s.idx] = s.pos
            self._spec_q[0].pos0 = nxt
        return True

    def _emit_spec(self, covered: list, rec: _Spec) -> None:
        """Wait for a spec pass's outputs and emit its rounds in turn, as
        verify passes whose drafts are the verify tokens' first n_draft
        (the accepted ones are equal to them, and only those are read)."""
        T = 1 + self.ecfg.draft_max
        packed_h, ids_h, probs_h, tokps_h, _ = self._copies.wait(rec.copy)
        tasks0 = [s.task for s in self.slots]
        gen0 = {s.idx: len(s.task.generated) for s in covered}
        last_nem = {s.idx: 0 for s in covered}
        for m in range(rec.m):
            alive = [s for s in covered
                     if s.task is not None and s.task is tasks0[s.idx]]
            if not alive:
                break
            toks_m = packed_h[m, :, :T]
            nem_m = packed_h[m, :, T]
            for s in alive:
                s.drafts = toks_m[s.idx, :int(packed_h[m, s.idx, T + 1])
                                  ].tolist()
                last_nem[s.idx] = int(nem_m[s.idx])
            self._emit_verify(
                alive, toks_m, nem_m,
                ids_h[m] if ids_h is not None else None,
                probs_h[m] if probs_h is not None else None,
                tokps_h[m] if tokps_h is not None else None)
        for s in covered:
            # the draft cache holds every row before the last round's
            # start and that start's token; the next pass's catch-up
            # feeds the rest
            if s.task is not None and s.task is tasks0[s.idx] \
                    and s.idx in rec.drafted:
                s.draft_pos = s.pos - last_nem[s.idx] + 1
            s.drafts = []
        self._acct_decode(sum(len(tasks0[s.idx].generated) - gen0[s.idx]
                              for s in covered), rec.t0)

    def _shift_or_finish(self, s: Slot) -> None:
        """A slot at its capacity: a context shift, or on a recurrent
        model, whose state cannot shift, the end of its request with
        "length" (JAX `_finish_now`; max_tokens is capped at admission, so
        this is a backstop)."""
        if self.rec:
            self._finish_now(s, "length")
        else:
            self._context_shift(s)

    def _finish_now(self, s: Slot, reason: str = "length") -> None:
        """Finish a decoding slot without accepting another token (JAX
        `_finish_now`)."""
        task = s.task
        text = task.scanner.flush()
        text, r_delta, calls = task.postprocess(text, final=True)
        if text:
            task.text += text
        if task.stream:
            task.emit("delta", {"text": text, "token": -1,
                                "reasoning_content": r_delta,
                                "tool_calls": calls,
                                "finish_reason": reason})
        task.finish_reason = reason
        task.t_decoded = time.monotonic()
        task.emit("final", task)
        self._release(s, keep_cache=self.ecfg.prompt_cache)

    def _context_shift(self, s: Slot) -> None:
        """Drop min(n_left / 4, n_ubatch) rows after n_keep and re-rotate
        the kept keys (JAX `_context_shift`, the reference's reactive
        shift). Enqueued on the stream the programs replay on; a chain in
        flight over the slot would move its rows under it, so none may
        be. The sampler's step is not a position and stays."""
        if any(c.tasks[s.idx] is not None
               for c in self._chain_q + self._spec_q):
            raise RuntimeError(f"context shift of slot {s.idx} with a "
                               "chain in flight over it")
        task = s.task
        n_keep = max(0, min(task.n_keep, s.pos - 2)) if task else 0
        n_discard = max(1, min((s.pos - n_keep) // 4, self.ecfg.n_ubatch))
        shift_kv(self.kv, s.idx, n_keep, n_discard, self.delta_cos,
                 self.delta_sin, self.cfg.rope_mode, self.delta_select)
        del s.cache_tokens[n_keep:n_keep + n_discard]
        s.pos -= n_discard
        s.drafts = []
        if self.draft_kv is not None and s.draft_pos >= n_keep + n_discard:
            # the draft cache shifts alongside the target's (the reference
            # shifts the draft context too, httpserver.hpp:3508-3524); one
            # that has not reached the discarded rows keeps its prefix
            shift_kv(self.draft_kv, s.idx, n_keep, n_discard,
                     self.draft_delta_cos, self.draft_delta_sin,
                     self.draft_cfg.rope_mode, self.draft_delta_select)
            s.draft_pos -= n_discard
        else:
            s.draft_pos = min(s.draft_pos, n_keep)
        if task:
            task.n_shifted += 1
        SRV_DBG("shift", "slot %d keep=%d discard=%d pos=%d", s.idx, n_keep,
                n_discard, s.pos)

    def _remaining(self, s: Slot) -> int:
        """Tokens this slot's task can still emit (max_tokens budget)."""
        task = s.task
        if task is None:
            return 0
        mt = getattr(task, "max_tokens", 0) or 0
        if mt <= 0:
            return 1 << 30
        return max(0, mt - len(task.generated))

    def _chain_k(self, dec: list, off: int = 0) -> int:
        """The configured decode_chain, capped by any ramping slot and by
        the pow2 bucket of the largest remaining budget less `off` steps
        in flight (a 1-3 token leftover runs a 4-chain)."""
        K = self.ecfg.decode_chain
        ramps = [s.chain_ramp for s in dec if s.chain_ramp > 0]
        K = min([K] + ramps)
        rem = max(self._remaining(s) for s in dec) - off
        if rem <= 0:
            return 1
        if rem < K:
            K = min(K, max(4, _pow2_floor(rem)))
        return K

    def _bump_ramps(self, dec: list) -> None:
        """One chain dispatched: quadruple each ramping slot's cap."""
        for s in dec:
            if s.chain_ramp > 0:
                nxt = s.chain_ramp * 4
                s.chain_ramp = 0 if nxt >= self.ecfg.decode_chain else nxt

    def _chain_fast_kw(self, dec: list) -> dict:
        """samp_extras=False when every slot is plain; samp_kcap=64 when
        every slot's chain is covered by 64 candidates (both hold for no
        slot)."""
        plain = all(s.task.sparams.plain for s in dec)
        kw = {"samp_extras": not plain}
        if plain and all(0 < s.task.sparams.top_k <= 64
                         and s.task.n_probs == 0 for s in dec):
            kw["samp_kcap"] = 64
        return kw

    def _decode_pass_chain(self, dec: list, K: int) -> None:
        """K sequential decode steps on the device, the next chains
        speculated behind them, then ONE wait for this chain's tokens."""
        self._refresh_arrs()
        rec = self._dispatch_chain(dec, K, {s.idx: s.pos for s in dec})
        # pipelining: the next chains go out before the wait below, so the
        # device works through the host's token handling
        self._bump_ramps(dec)
        self._fill_chain_queue(dec, K, rec)
        self._emit_chain(dec, rec)

    def _dispatch_chain(self, dec: list, K: int, pos: dict,
                        token0=None) -> _Chain:
        """Stage a K-step chain's operands, run it and start the copy of
        its outputs. Each slot of `dec` is active from pos[idx]; its
        token0 is s.next_token or, given `token0` (a device [S]: the last
        tokens of the chain in flight, or the prefill's first), taken
        from that on the device."""
        t0 = time.monotonic()
        S = len(self.slots)
        pos0 = np.full(S, self.slot_ctx, np.int64)
        h = self._dec_in.host()
        h[:] = 0
        for s in dec:
            pos0[s.idx] = pos[s.idx]
            h[s.idx] = s.next_token
            h[2 * S + s.idx] = 1
            h[3 * S + s.idx] = self._rope_delta(s.idx)
        h[S:2 * S] = pos0
        self._dec_in.push()
        if token0 is not None:
            self._dec_in.dev[:S].copy_(token0)
        kw = self._chain_fast_kw(dec)
        outs = self.graphs.run(
            ("decode", K, kw["samp_extras"], kw.get("samp_kcap", 0)),
            lambda: self._decode_program(K, **kw))
        return self._copy_out(dec, K, outs, pos0, t0)

    def _copy_out(self, dec: list, K: int, outs, pos0, t0: float) -> _Chain:
        """Start the copy of a program's tokens (and probs when a slot of
        `dec` wants them; no logits rows) and record what it was run
        for."""
        want = any(s.task.n_probs > 0 for s in dec)
        copy = self._copies.start(
            (outs[0],) + (tuple(outs[1:4]) if want else (None,) * 3)
            + (None,))
        tasks = [None] * len(self.slots)
        for s in dec:
            tasks[s.idx] = s.task
        return _Chain(outs[0], copy, pos0, tasks, K, t0)

    def _decode_program(self, K: int, **kw):
        """One K-step chain over the staged operands."""
        S = len(self.slots)
        d = self._dec_in.dev
        if self.rec:
            toks, ids, probs, tokps, self.kv, self.sstate = rec_decode_chain(
                self.params, self.cfg, d[:S], d[S:2 * S], self.kv,
                self.sstate, self.arrs, d[2 * S:3 * S] != 0, self.rope_cos,
                self.rope_sin, n_steps=K, **kw)
            return toks, ids, probs, tokps
        toks, ids, probs, tokps, self.kv, self.sstate = _decode_chain(
            self.params, self.cfg, d[:S], d[S:2 * S], self.kv, self.sstate,
            self.arrs, d[2 * S:3 * S] != 0, self.rope_cos, self.rope_sin,
            n_steps=K, rope_delta=self._delta_operand(d, 3 * S), **kw)
        return toks, ids, probs, tokps

    def _rope_delta(self, b: int) -> int:
        """Slot b's M-RoPE decode delta (its task's mrope_delta; 0 for a
        slot without one or a model without M-RoPE)."""
        task = self.slots[b].task
        return int(getattr(task, "mrope_delta", 0) or 0) if self.mrope \
            else 0

    def _delta_operand(self, d: torch.Tensor, off: int):
        """The staged rope-delta operand at d[off:off + S] on an M-RoPE
        model, else None (the program reads no delta)."""
        return d[off:off + len(self.slots)] if self.mrope else None

    def _fill_chain_queue(self, dec: list, k_unemitted: int,
                          newest: _Chain) -> None:
        """Top the speculative queue up to pipeline_depth, each new chain
        taking its token0 from the newest dispatched chain's last tokens
        on the device (JAX `_fill_chain_queue`). Safe because a covered
        slot consumes a speculated chain whole (its position and sampler
        state then match) or its task finishes, and admission rebuilds a
        released slot's sampler state and KV. A chain is speculated only
        while every position it covers stays below capacity, counting the
        k_unemitted steps dispatched but not emitted: a context shift
        there would move a continuing slot's rows under the chain.

        A new request's prefill queues behind every chain in flight, so
        the port adds gates of its own (they move no token, only when
        and how long chains go out): while a slot is idle (a request may
        arrive into it), one chain fewer is speculated, of at most
        _IDLE_CHAIN steps, and none while a task waits for it; and while
        a task waits for a slot, no chain goes out past the point where
        a covered slot's budget ends."""
        if not self.ecfg.pipeline_chain:
            return
        # the JAX gate: no chain while a slot needs per-token host control
        if any(s.state == "decode" and _host_controlled(s.task)
               for s in self.slots):
            return
        if self.ecfg.lookup_ngram_min > 0 and not self._ngram_dominated():
            # the JAX gate: a slot with an n-gram match on the tokens
            # synced so far drafts next pass, so no chain goes out (a
            # speculated chain must be consumed by its slots); slots
            # without a match, or held by the acceptance gate, pipeline
            for s in dec:
                task = s.task
                if task is None or task.ngram is None \
                        or not self._ngram_may_draft(task, k_unemitted):
                    continue
                if task.ngram.draft(task.prompt_tokens + task.generated, 1):
                    return
        waiting = not self.queue.empty()
        idle = any(s.state == "idle" for s in self.slots)
        if waiting and idle:
            return          # admitted next pass, behind fewer chains
        depth = max(1, self.ecfg.pipeline_depth - int(idle))
        while len(self._chain_q) < depth:
            if max(self._remaining(s) for s in dec) <= k_unemitted:
                return      # every slot's budget is already covered
            if waiting and min(self._remaining(s)
                               for s in dec) <= k_unemitted:
                return      # a slot frees for the waiting task
            K2 = self._chain_k(dec, off=k_unemitted)
            if idle:
                K2 = min(K2, _IDLE_CHAIN)
            K2 = min(K2, _pow2_floor(
                min(s.capacity - s.pos for s in dec) - k_unemitted))
            if K2 < 2:
                return
            newest = self._dispatch_chain(
                dec, K2,
                {s.idx: int(newest.pos0[s.idx]) + newest.k for s in dec},
                newest.toks[:, -1])
            self._chain_q.append(newest)
            self.metrics.on_speculate(post_prefill=False)
            self._bump_ramps(dec)
            k_unemitted += K2

    def _consume_pending_chain(self, dec: list) -> bool:
        """Emit the OLDEST speculated chain's tokens (JAX
        `_consume_pending_chain`). Covered = the same task object at the
        expected position (a released or re-admitted slot fails it and
        admission rebuilds its state). Returns False, the whole queue
        dropped (the later chains assumed the continuation), when nothing
        is covered; uncovered slots in `dec` wait one pass."""
        pend = self._chain_q.pop(0)
        covered = [s for s in dec
                   if s.task is not None and pend.tasks[s.idx] is s.task
                   and s.pos == int(pend.pos0[s.idx])]
        if not covered:
            self._copies.drop(pend.copy)
            self._drop_queue()
            return False
        # keep the pipeline full: the next chain goes out before the wait,
        # but only when the pending chain covers every decoding slot (a
        # slot admitted meanwhile is not starved: draining lets the next
        # pass dispatch a joint chain that includes it)
        if len(covered) == len(dec):
            newest = self._chain_q[-1] if self._chain_q else pend
            off = pend.k + sum(c.k for c in self._chain_q)
            self._fill_chain_queue(covered, off, newest)
        self._emit_chain(covered, pend)
        return True

    def _drop_queue(self) -> None:
        """Drop every chain and spec pass in flight, unread (on a
        recurrent model each has advanced its slots' states: dirty)."""
        for c in self._chain_q + self._spec_q:
            self._copies.drop(c.copy)
            if self.rec:
                self._mark_dirty(c)
        self._chain_q.clear()
        self._spec_q.clear()

    def _mark_dirty(self, c) -> None:
        """Every slot chain c ran for: dirty (recurrent models)."""
        for b, t in enumerate(c.tasks):
            if t is not None:
                self.slots[b].rec_dirty = True

    def _emit_chain(self, dec: list, rec: _Chain) -> None:
        """Wait for a chain's tokens and hand them to its slots. On a
        recurrent model a slot whose task ends before the chain's last
        step is dirty: the device ran the chain's tail (JAX
        `_emit_chain`)."""
        toks_h, ids_h, probs_h, tokps_h, _ = self._copies.wait(rec.copy)
        n_tok = 0
        for s in dec:
            inp = s.next_token
            ngram = s.task.ngram if s.task is not None else None
            for j in range(rec.k):
                if s.task is None:   # finished/cancelled mid-chain
                    if self.rec:
                        s.rec_dirty = True
                    break
                s.cache_tokens.append(inp)
                s.pos += 1
                tok = int(toks_h[s.idx, j])
                n_tok += 1
                self._accept_token(
                    s, tok, ids_h[s.idx, j] if ids_h is not None else None,
                    probs_h[s.idx, j] if probs_h is not None else None,
                    float(tokps_h[s.idx, j]) if tokps_h is not None else 0.0)
                if ngram is not None and s.task is not None:
                    ngram.push(s.task.prompt_tokens + s.task.generated)
                inp = tok
        self._acct_decode(n_tok, rec.t0)

    def _acct_decode(self, n_tok: int, t0: float) -> None:
        """Account decode tokens over a non-overlapping wall window
        (pipelined passes dispatch before their predecessors consume), as
        the JAX engine does: from the chain's dispatch, so a chain in
        flight through a prefill pass counts the pass's wall too."""
        now = time.monotonic()
        self.metrics.on_decode(
            n_tok, (now - max(t0, self._decode_acct_ts)) * 1e3)
        self._decode_acct_ts = now

    def _accept_token(self, s: Slot, token: int, ids_row, probs_row,
                      tok_prob: float = 0.0) -> None:
        """Post-process one generated token on the host: budgets, EOG, stop
        words, stream emission."""
        task = s.task
        if task.cancelled:
            self._release(s)
            return
        task.generated.append(token)
        s.next_token = token
        hs = task.host_sampler
        if hs is not None:
            hs.accept(token)
        text = task.scanner.push(token)
        if task.n_probs > 0 and ids_row is not None:
            from .task import TokenProbs
            task.probs.append(TokenProbs(
                token=token,
                text=self.tokenizer.decode([token], skip_leading_space=False)
                if self.tokenizer else "",
                top_ids=ids_row[:max(task.n_probs, 1)].tolist(),
                top_probs=probs_row[:max(task.n_probs, 1)].tolist(),
                prob=float(tok_prob)))

        finish = None
        if self.tokenizer is not None and self.tokenizer.is_eog(token):
            finish = "stop"
        elif hs is not None and hs.must_stop:
            finish = "stop"
        elif task.scanner.stopped:
            finish = "stop"
        elif task.budget_left() <= 0:
            finish = "length"

        if finish == "stop" and not task.scanner.stopped:
            text += task.scanner.flush()
        if finish == "length":
            text += task.scanner.flush()
        text, r_delta, calls = task.postprocess(text, final=bool(finish))
        if finish == "stop" and task.tool_calls:
            finish = "tool_calls"
        if text:
            task.text += text
        if task.stream and (text or r_delta or calls or finish):
            task.emit("delta", {"text": text, "token": token,
                                "reasoning_content": r_delta,
                                "tool_calls": calls,
                                "finish_reason": finish})
        if finish:
            task.finish_reason = finish
            task.t_decoded = time.monotonic()
            task.emit("final", task)
            self._release(s, keep_cache=self.ecfg.prompt_cache)

    # -- embeddings / rerank -------------------------------------------------

    def _admit_embed(self, task, token_lists: list[list[int]],
                     pooling: str) -> None:
        """Queue an embeddings/rerank task as groups of at most
        max_embed_batch inputs, sorted by length; _embed_pass runs ONE
        group a reconcile pass (JAX `_admit_embed`). A recurrent model has
        no embeddings forward: refused, as in JAX."""
        if self.rec:
            raise ValueError("embeddings/rerank are not supported for "
                             "recurrent/encoder-decoder models here")
        order = sorted(range(len(token_lists)),
                       key=lambda i: len(token_lists[i]))
        nb = self.ecfg.max_embed_batch
        task._groups = [order[i:i + nb] for i in range(0, len(order), nb)]
        task._token_lists = token_lists
        task._pooling = pooling
        task._results = [None] * len(token_lists)
        task._t0 = time.monotonic()
        self.embed_tasks.append(task)

    def _embed_rows(self, n: int) -> int:
        """The rows of a pass of n inputs: the next power of two, at most
        max_embed_batch (one graph a row count and bucket)."""
        return min(1 << (n - 1).bit_length(),
                   max(n, self.ecfg.max_embed_batch))

    def _embed_pass(self) -> bool:
        """Run ONE group of the oldest queued embeddings/rerank task (JAX
        `_embed_pass`): rows padded to _embed_rows, length to the group's
        bucket, inputs cut to it; one program ("embed", rows, T, pooling)
        over the staged operands, its output read back right after it.
        Returns whether tasks remain."""
        while self.embed_tasks and (self.embed_tasks[0].cancelled
                                    or not self.embed_tasks[0]._groups):
            t = self.embed_tasks.pop(0)
            if not t.cancelled:
                self._finish_embed(t)
        if not self.embed_tasks:
            return False
        task = self.embed_tasks[0]
        group = task._groups.pop(0)
        try:
            token_lists = task._token_lists
            T = self._bucket(max(len(token_lists[j]) for j in group))
            B = len(group)
            R = self._embed_rows(B)
            S = len(self.slots)
            if self._lora_stacked and B != S and S != 1:
                # JAX's forward broadcasts the [S, n_ad] scale rows
                # against the group's B rows, and fails otherwise
                raise TypeError(f"lora_scales rows {S} do not broadcast "
                                f"against {B} embedding rows")
            h = self._emb_in.host()
            h[:R * (1 + T)] = 0
            toks = h[R:R * (1 + T)].reshape(R, T)
            for b, j in enumerate(group):
                seq = token_lists[j][:T]
                toks[b, :len(seq)] = seq
                h[b] = len(seq)
            self._emb_in.push(R * (1 + T))
            pooling = task._pooling
            out = self.graphs.run(
                ("embed", R, T, pooling),
                lambda: self._embed_program(R, T, pooling))
            # a sync of its own: the replay's output, read before any
            # later program is enqueued
            emb_h = out[:B].cpu().numpy()
            for b, j in enumerate(group):
                task._results[j] = emb_h[b]
            if not task._groups:
                self.embed_tasks.pop(0)
                self._finish_embed(task)
        except Exception as exc:  # noqa: BLE001
            SRV_ERR("embed", "task %s failed: %r", task.rid, exc)
            task.fail(exc)
            if task in self.embed_tasks:
                self.embed_tasks.remove(task)
        return bool(self.embed_tasks)

    def _embed_program(self, R: int, T: int, pooling: str) -> torch.Tensor:
        """One embed pass of R rows of bucket T over the staged operands:
        the pooled rows [R, E] (BERT rank: [R]; llama rank: [R, T, E]) in
        f32."""
        d = self._emb_in.dev
        return self._embed_forward(d[R:R * (1 + T)].view(R, T), d[:R],
                                   pooling).float()

    def _embed_forward(self, toks, lens, pooling: str):
        """Arch dispatch (JAX `_embed_forward`): the BERT encoder, or the
        llama-family embedding forward. Under per-request LoRA, row b of a
        group of S inputs takes slot b's scales, as in JAX; the pass's
        padded rows take zero scales."""
        if self.bert:
            return bert_forward(self.params, self.cfg, toks, lens,
                                pooling=pooling)
        params = self.params
        ls = params.get("lora_scales")
        R = toks.shape[0]
        if ls is not None and ls.shape[0] not in (1, R):
            params = dict(params, lora_scales=torch.nn.functional.pad(
                ls, (0, 0, 0, R - ls.shape[0])))
        return forward_embeddings(params, self.cfg, toks, lens,
                                  self.rope_cos, self.rope_sin,
                                  pooling=pooling)

    def _finish_embed(self, task) -> None:
        if isinstance(task, RerankTask):
            self._finish_rerank(task)
            return
        for e in task._results:
            v = e.astype(np.float64)
            if task.normalize:
                n = np.linalg.norm(v)
                v = v / n if n > 0 else v
            task.embeddings.append(v.tolist())
        self.metrics.on_prefill(task.n_prompt,
                                (time.monotonic() - task._t0) * 1e3)
        task.emit("final", task)

    def _finish_rerank(self, task: RerankTask) -> None:
        """Scores (JAX `_finish_rerank`): each pair's first output value
        (a BERT rank head's score; on a llama model, the first feature of
        its first token, the JAX engine's quirk), min-maxed between the
        query-self and query-unknown anchors when normalize."""
        embs = task._results
        scores = [float(np.asarray(e).reshape(-1)[0]) for e in embs]
        if task.normalize and len(scores) >= task.n_documents + 2:
            doc_scores = scores[:task.n_documents]
            s_self, s_unk = scores[-2], scores[-1]
            lo, hi = min(s_unk, min(doc_scores)), max(s_self, max(doc_scores))
            rng = max(hi - lo, 1e-6)
            task.scores = [(x - lo) / rng for x in doc_scores]
        else:
            task.scores = scores[:task.n_documents]
        self.metrics.on_prefill(task.n_prompt,
                                (time.monotonic() - task._t0) * 1e3)
        task.emit("final", task)

    def probe_decode_tps(self, n_tokens: int = 32) -> float:
        """Timed greedy decode to measure tokens/sec (the reference's
        --tokens-per-second -1 startup probe; JAX `probe_decode_tps`)."""
        bos = self.tokenizer.bos_id if self.tokenizer else 1
        task = CompletionsTask([bos or 1], SamplerParams(temp=0.0, seed=0),
                               tokenizer=self.tokenizer, max_tokens=n_tokens,
                               stream=False)
        self.submit(task)
        while True:
            kind, payload = task.result_q.get(timeout=600)
            if kind == "final":
                tps = payload.timings()["tokens_per_second"]
                # the probe leaves its tokens in the prefix cache; clear it
                for s in self.slots:
                    if s.state == "idle":
                        s.cache_tokens = []
                        s.pos = 0
                return tps
            if kind == "error":
                raise payload

    def _release(self, s: Slot, keep_cache: bool = False) -> None:
        """Free the slot; optionally keep its KV token history for the
        prefix cache."""
        if self.rec and any(c.tasks[s.idx] is not None
                            for c in self._chain_q):
            # a pipelined chain still in flight advances this slot past
            # its tokens
            s.rec_dirty = True
        s.task = None
        s.state = "idle"
        s.cursor = 0
        s.next_token = -1
        s.last_used = time.monotonic()
        if not keep_cache:
            s.cache_tokens = []
            s.pos = 0
        self._arrs_dirty = True
