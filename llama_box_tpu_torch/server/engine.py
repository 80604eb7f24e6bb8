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

Not ported yet (the JAX engine has them): speculative and n-gram
drafting, embeddings, multimodal prompts and the other model families.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.llama import (check_supported, copy_kv_prefix,
                            decode_operands, decode_step_impl,
                            init_chain_rows, init_kv_cache, make_delta_rope,
                            make_rope, prefill_batch_impl, shift_kv,
                            write_chain_rows)
from ..ops.qmatmul import _SPLIT_MAX_ROWS, QTensor
from ..sampling import (N_PROBS, RING_CAP, HostSampler, SamplerBuffers,
                        SamplerParams, init_sampler_state, sample_impl,
                        seed_slot, window_size)
from ..utils.logging import SRV_DBG, SRV_ERR
from ..utils.staging import HostCopies, StagedBuffer
from ..utils.text import longest_common_prefix
from .cuda_graph import GraphRunner
from .metrics import Metrics
from .task import BaseTask, CompletionsTask

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
                  samp_kcap: int = 0):
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
    device."""
    ops = decode_operands(pos0, active, kv.capacity, n_steps, cos, sin)
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


def _decode_verify_sample(params, cfg: ModelConfig, token0, pos0, kv,
                          sstate, arrs, fwd_active, samp_active, cos, sin,
                          samp_extras: bool = True, samp_kcap: int = 0):
    """One decode step over the full slot batch (JAX
    `_decode_verify_sample` at T = 1): forward every fwd_active slot,
    write its row, and sample only the samp_active ones; the others (the
    host-sampled slots) neither draw a kept token nor advance their
    sampler state, and are sampled on the host from the returned logits.
    Returns (tokens [S], ids [S,NP], probs [S,NP], tokps [S], logits
    [S, V] f32, kv, sstate), all on the device."""
    ops = decode_operands(pos0, fwd_active, kv.capacity, 1, cos, sin)
    chain = init_chain_rows(cfg, kv, 1)
    rows: list = []
    logits = decode_step_impl(params, cfg, token0[:, None], ops, kv, chain,
                              0, rows)[:, -1]
    write_chain_rows(kv, [rows], ops.writes)
    tok, ids, probs, tokp, sstate = sample_impl(
        logits, sstate, arrs, samp_active, extras=samp_extras,
        kcap=samp_kcap)
    return tok, ids, probs, tokp, logits, kv, sstate


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
                 "cursor", "next_token", "last_used", "chain_ramp")

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


class Engine:
    def __init__(self, cfg: ModelConfig, params, tokenizer,
                 ecfg: EngineConfig | None = None, device: str = "cuda"):
        self.device = resolve_device(device)
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
        self.kv = init_kv_cache(cfg, S, self.slot_ctx,
                                _KV_DTYPES[self.ecfg.kv_dtype], self.device)
        self.rope_cos, self.rope_sin = make_rope(cfg, self.slot_ctx,
                                                 self.device)
        self.delta_cos, self.delta_sin = make_delta_rope(cfg, self.slot_ctx,
                                                         self.device)
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
        if any(isinstance(w, QTensor) and not w.w8a8
               for w in params.get("layers", {}).values()):
            buckets = [b for b in buckets if S * b > _SPLIT_MAX_ROWS] \
                or buckets[-1:]
        self.buckets = tuple(buckets)
        # the programs' operands: decode token0 | pos0 | active, prefill
        # pos_base | n_valid | sample-active | tokens [S, bucket], one-token
        # pass token0 | pos0 | active | sample-active | host-row index
        self._dec_in = StagedBuffer(3 * S, torch.int64, self.device, ring)
        self._one_in = StagedBuffer(5 * S, torch.int64, self.device, ring)
        self._pre_in = StagedBuffer(S * (3 + self.buckets[-1]), torch.int64,
                                    self.device, ring)
        # an admitted slot's penalty window (one pass may admit S)
        self._win_in = StagedBuffer(window_size(cfg.vocab_size), torch.int32,
                                    self.device, S + ring)
        # the outputs of the programs in flight: tokens, top ids, top
        # probs, token probs of up to S x decode_chain samples, and the
        # logits rows of a one-token pass's host-sampled slots
        n = S * max(1, self.ecfg.decode_chain)
        self._copies = HostCopies(ring, [
            (n, torch.int32), (n * N_PROBS, torch.int32),
            (n * N_PROBS, torch.float32), (n, torch.float32),
            (S * cfg.vocab_size, torch.float32)], self.device)
        self._chain_q: list[_Chain] = []    # speculated, oldest first
        self.graphs = GraphRunner(self.device, self.ecfg.cuda_graphs)
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
        see models/loader.py)."""
        from ..models.loader import deinterleave_rope, fuse_projections
        self.params, self.cfg = deinterleave_rope(self.params, self.cfg)
        self.params = fuse_projections(self.params, self.cfg)

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
        self._copies.reset()     # the queue's sets and the failed pass's
        for s in self.slots:
            if s.task is not None:
                s.task.fail(exc)
                self._release(s)

    def _reconcile(self) -> None:
        self._admit()
        pre = [s for s in self.slots if s.state == "prefill"]
        if pre:
            self._prefill_batch(pre)
            return
        dec = [s for s in self.slots if s.state == "decode"]
        if dec:
            self._decode_pass(dec)
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
            if not isinstance(task, CompletionsTask):
                raise NotImplementedError(
                    f"{task.kind} tasks are not ported yet")
            self._admit_completion(task)
        except Exception as exc:  # noqa: BLE001
            SRV_ERR("dispatch", "task %s failed: %r", task.rid, exc)
            task.fail(exc)

    def _admit_completion(self, task: CompletionsTask) -> None:
        if task.chunks is not None:
            raise NotImplementedError("multimodal prompts are not ported yet")
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
        reuse = self._share_prefix(best, task.prompt_tokens, reuse)

        s = best
        s.task = task
        s.state = "prefill"
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
        SRV_DBG("admit", "task %s -> slot %d reuse=%d prompt=%d",
                task.rid, s.idx, reuse, len(task.prompt_tokens))

    def _share_prefix(self, best: Slot, prompt: list, reuse: int) -> int:
        """Cross-slot prefix reuse (JAX `_admit_completion`): copy the
        rows of the slot sharing the longest prefix with `prompt` into
        `best` when it beats `best`'s own `reuse` by cache_share_min or
        more; returns the rows `best` now holds. (The JAX rule also
        excludes SWA and recurrent models; the port refuses both at load.)

        The rows are valid under pipelining: a donor's cache_tokens and
        pos are host state that lags the device, and every row below
        them was written by a program enqueued earlier on this stream, so
        the copy, enqueued now, reads it. A chain in flight that covers
        `best` as an idle slot writes back the values it gathered itself,
        and it runs before the copy."""
        share_min = self.ecfg.cache_share_min
        if not self.ecfg.prompt_cache or share_min < 0:
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

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _prefill_batch(self, pre: list) -> None:
        """Prefill every pending slot's next chunk in ONE batched pass;
        first tokens of every completed prompt are sampled in the same
        program and reach the host with one wait (after the first decode
        chain has gone out, when it can)."""
        slots = []
        for s in pre:
            if s.task.cancelled:
                self._release(s)
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
        logits, self.kv = prefill_batch_impl(
            self.params, self.cfg, d[3 * S:S * (3 + T)].view(S, T), d[:S],
            d[S:2 * S], self.kv, self.rope_cos, self.rope_sin)
        tok, ids, probs, tokp, self.sstate = sample_impl(
            logits, self.sstate, self.arrs, d[2 * S:3 * S] != 0)
        return tok, ids, probs, tokp, logits

    def _speculate_post_prefill(self, done: list, pend: _Chain) -> bool:
        """Dispatch the first (ramped) decode chain off the prefill's
        device-resident first tokens before the host waits for them, so
        the device runs it while the first tokens stream (JAX
        `_speculate_post_prefill`). Consumed or dropped as every
        speculated chain is (_consume_pending_chain). Returns True when
        it went out (it has set the slots' ramps)."""
        if not self.ecfg.pipeline_chain or self._chain_q:
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
        # a speculated chain holds the tokens these slots consume next
        # (their device sampler state already advanced through it): use
        # it, never re-dispatch
        if self._chain_q and self._consume_pending_chain(dec):
            return
        # per-token host control (a host sampler or a rate bucket): ONE
        # one-token pass for every decoding slot, no chain (the JAX gates)
        if any(_host_controlled(s.task) for s in dec):
            self._one_token_pass(dec)
            return
        # chains shrink toward the boundary, so a slot reaches its
        # capacity at the end of one; it shifts before the next (the JAX
        # engine's one-token pass), and the chain shrinks to fit
        for s in dec:
            if s.pos >= s.capacity:
                self._context_shift(s)
        K = self._chain_k(dec)
        K = max(1, min(K, _pow2_floor(min(s.capacity - s.pos for s in dec))))
        self._decode_pass_chain(dec, K)

    def _one_token_pass(self, dec: list) -> None:
        """One decode step for every decoding slot (the JAX engine's
        per-token pass: `_decode_verify_sample` at T = 1). The device
        samples the device-sampled slots; the host-sampled ones get their
        logits rows (one gather by a staged index vector, one copy) and
        sample on the host, their device sampler state left as it was. A
        slot at its capacity shifts first; a slot whose rate bucket is
        empty sits the pass out (a 5 ms sleep when no slot is left, so
        the loop does not spin). The chain queue is empty here."""
        for s in dec:
            if s.pos >= s.capacity:
                self._context_shift(s)
        dec = [s for s in dec if s.task.rate_bucket is None
               or s.task.rate_bucket.try_acquire(1)]
        if not dec:
            time.sleep(0.005)
            return
        self._refresh_arrs()
        t0 = time.monotonic()
        S = len(self.slots)
        hs = [s for s in dec if s.task.host_sampler is not None]
        tokens, pos = [None] * S, [0] * S
        for s in dec:
            tokens[s.idx], pos[s.idx] = s.next_token, s.pos
        self._stage_one(tokens, pos, [s.idx for s in hs])
        kw = self._chain_fast_kw([s for s in dec if s not in hs])
        outs = self.graphs.run(
            ("one", kw["samp_extras"], kw.get("samp_kcap", 0)),
            lambda: self._one_token_program(**kw))
        want = any(s.task.n_probs > 0 for s in dec)
        copy = self._copies.start(
            (outs[0],) + (outs[1:4] if want else (None,) * 3)
            + (outs[4][:len(hs)] if hs else None,))
        toks_h, ids_h, probs_h, tokps_h, rows_h = self._copies.wait(copy)
        self._acct_decode(len(dec), t0)
        for s in dec:
            s.cache_tokens.append(s.next_token)
            s.pos += 1
            if s in hs:
                tok, ids_row, probs_row, tok_prob = \
                    s.task.host_sampler.sample(rows_h[hs.index(s)])
                self._accept_token(s, tok, ids_row, probs_row, tok_prob)
                continue
            self._accept_token(
                s, int(toks_h[s.idx]),
                ids_h[s.idx] if ids_h is not None else None,
                probs_h[s.idx] if probs_h is not None else None,
                float(tokps_h[s.idx]) if tokps_h is not None else 0.0)

    def _stage_one(self, tokens: list, pos: list, host: list) -> None:
        """Stage a one-token pass's operands (token0 | pos0 | active |
        sample-active | host-row index, S each): slot b decodes tokens[b]
        at pos[b] (None: it sits out, at position slot_ctx); the device
        samples the active slots not in `host`, and the rows of the slots
        in `host` come out in that order."""
        S = len(self.slots)
        h = self._one_in.host()
        h[:] = 0
        h[S:2 * S] = self.slot_ctx
        for b, (t, p) in enumerate(zip(tokens, pos)):
            if t is not None:
                h[b], h[S + b], h[2 * S + b] = t, p, 1
                h[3 * S + b] = int(b not in host)
        for k, b in enumerate(host):
            h[4 * S + k] = b
        self._one_in.push()

    def _one_token_program(self, **kw):
        """One one-token pass over the staged operands; the host-sampled
        slots' logits rows come first in its last output ([S, V], gathered
        by the staged index vector, so the graph's shapes are fixed)."""
        S = len(self.slots)
        d = self._one_in.dev
        tok, ids, probs, tokp, logits, self.kv, self.sstate = \
            _decode_verify_sample(
                self.params, self.cfg, d[:S], d[S:2 * S], self.kv,
                self.sstate, self.arrs, d[2 * S:3 * S] != 0,
                d[3 * S:4 * S] != 0, self.rope_cos, self.rope_sin, **kw)
        return tok, ids, probs, tokp, logits.index_select(0, d[4 * S:])

    def _context_shift(self, s: Slot) -> None:
        """Drop min(n_left / 4, n_ubatch) rows after n_keep and re-rotate
        the kept keys (JAX `_context_shift`, the reference's reactive
        shift). Enqueued on the stream the programs replay on; a chain in
        flight over the slot would move its rows under it, so none may
        be. The sampler's step is not a position and stays."""
        if any(c.tasks[s.idx] is not None for c in self._chain_q):
            raise RuntimeError(f"context shift of slot {s.idx} with a "
                               "chain in flight over it")
        task = s.task
        n_keep = max(0, min(task.n_keep, s.pos - 2)) if task else 0
        n_discard = max(1, min((s.pos - n_keep) // 4, self.ecfg.n_ubatch))
        shift_kv(self.kv, s.idx, n_keep, n_discard, self.delta_cos,
                 self.delta_sin, self.cfg.rope_mode)
        del s.cache_tokens[n_keep:n_keep + n_discard]
        s.pos -= n_discard
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
        toks, ids, probs, tokps, self.kv, self.sstate = _decode_chain(
            self.params, self.cfg, d[:S], d[S:2 * S], self.kv, self.sstate,
            self.arrs, d[2 * S:] != 0, self.rope_cos, self.rope_sin,
            n_steps=K, **kw)
        return toks, ids, probs, tokps

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
        for c in self._chain_q:
            self._copies.drop(c.copy)
        self._chain_q.clear()

    def _emit_chain(self, dec: list, rec: _Chain) -> None:
        """Wait for a chain's tokens and hand them to its slots."""
        toks_h, ids_h, probs_h, tokps_h, _ = self._copies.wait(rec.copy)
        n_tok = 0
        for s in dec:
            inp = s.next_token
            for j in range(rec.k):
                if s.task is None:   # finished/cancelled mid-chain
                    break
                s.cache_tokens.append(inp)
                s.pos += 1
                tok = int(toks_h[s.idx, j])
                n_tok += 1
                self._accept_token(
                    s, tok, ids_h[s.idx, j] if ids_h is not None else None,
                    probs_h[s.idx, j] if probs_h is not None else None,
                    float(tokps_h[s.idx, j]) if tokps_h is not None else 0.0)
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
        s.task = None
        s.state = "idle"
        s.cursor = 0
        s.next_token = -1
        s.last_used = time.monotonic()
        if not keep_cache:
            s.cache_tokens = []
            s.pos = 0
        self._arrs_dirty = True
