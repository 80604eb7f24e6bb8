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
- One dispatch per program, as the JAX engine's jitted programs: on a
  CUDA device each decode chain (keyed by K, samp_extras, samp_kcap) and
  each prefill pass with its first-token sample (keyed by the bucket)
  replays one captured CUDA graph (server/cuda_graph.py). Their operands
  live in persistent device buffers that the host fills by one pinned
  copy a pass. EngineConfig.cuda_graphs=False runs the same programs
  eagerly (for comparison); on the CPU they always run eagerly.

Not ported yet (the JAX engine has them): context shift (a slot that
reaches its capacity finishes with "length"), cross-slot prefix copies,
the host sampler (grammar, mirostat, DRY), speculative and n-gram
drafting, embeddings, multimodal prompts, the other model families, and
the transfer-thread pipelining of chains (the host syncs each chain
before dispatching the next).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.llama import (check_supported, decode_operands,
                            decode_step_impl, init_chain_rows, init_kv_cache,
                            make_rope, prefill_batch_impl, write_chain_rows)
from ..sampling import (RING_CAP, SamplerBuffers, SamplerParams,
                        init_sampler_state, push_tokens, reset_slot,
                        sample_impl)
from ..utils.logging import SRV_DBG, SRV_ERR
from ..utils.staging import StagedBuffer
from ..utils.text import longest_common_prefix
from .cuda_graph import GraphRunner
from .metrics import Metrics
from .task import BaseTask, CompletionsTask

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}


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


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 4
    n_ctx: int = 4096             # total; per-slot = n_ctx // n_slots
    n_ubatch: int = 512           # max prefill chunk
    kv_dtype: str = "bfloat16"    # bfloat16 | float32 | int8 (q8_0)
    prompt_cache: bool = True     # prefix cache (--no-prompt-cache disables)
    defrag_headroom: int = 4      # free positions to leave after a squeeze
    # chained decode: tokens sampled per device chain (1 = per token)
    decode_chain: int = 1
    # first chains after a prefill are this long (x4 per chain until
    # decode_chain), so the first tokens stream early; 0 disables
    chain_ramp: int = 4
    # on a CUDA device, replay each decode chain and prefill pass as one
    # captured CUDA graph; False runs them eagerly (for comparison)
    cuda_graphs: bool = True


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
        self.sstate = init_sampler_state(S, cfg.vocab_size, self.device)
        self.eog_ids = sorted(tokenizer.eog_ids) if tokenizer else []
        self._default_sp = SamplerParams()
        self._samp_bufs = SamplerBuffers(S, self.device)
        self.arrs = self._samp_bufs.fill([self._default_sp] * S,
                                         self.eog_ids)
        self._arrs_dirty = False
        # a chunk never exceeds the slot's capacity, nor then its bucket
        self.buckets = tuple(sorted({
            min(b, self.slot_ctx) for b in DEFAULT_BUCKETS
            if b <= max(self.ecfg.n_ubatch, 16)}))
        # the programs' operands: decode token0 | pos0 | active, prefill
        # pos_base | n_valid | sample-active | tokens [S, bucket]
        self._dec_in = StagedBuffer(3 * S, torch.int64, self.device)
        self._pre_in = StagedBuffer(S * (3 + self.buckets[-1]), torch.int64,
                                    self.device)
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
        if task.sparams.needs_host_sampler:
            raise NotImplementedError("grammar, mirostat, DRY and reordered "
                                      "sampler chains are not ported yet")
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
        reset_slot(self.sstate, s.idx, sp.seed & 0xFFFFFFFF)
        last_n = min(sp.penalty_last_n if sp.penalty_last_n >= 0
                     else RING_CAP, RING_CAP)
        if last_n > 0 and task.prompt_tokens:
            window = [t if t >= 0 else 0
                      for t in task.prompt_tokens[-last_n:]]
            push_tokens(self.sstate, s.idx, np.asarray(window, np.int32),
                        len(window), last_n)
        self._arrs_dirty = True
        SRV_DBG("admit", "task %s -> slot %d reuse=%d prompt=%d",
                task.rid, s.idx, reuse, len(task.prompt_tokens))

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
        program and reach the host with one sync."""
        slots = []
        for s in pre:
            if s.task.cancelled:
                self._release(s)
            else:
                slots.append(s)
        if not slots:
            return
        t0 = time.monotonic()
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
        for s in done:
            h[2 * S + s.idx] = 1
        self._pre_in.push(S * (3 + T))
        self._refresh_arrs()
        tok, ids, probs, tokp = self.graphs.run(
            ("prefill", T), lambda: self._prefill_program(T))
        for s in slots:
            n = chunks[s.idx]
            s.cache_tokens.extend(s.task.prompt_tokens[s.cursor:s.cursor + n])
            s.cursor += n
            s.pos += n
        if done:
            tok_h = tok.cpu().numpy()
            want = any(s.task.n_probs > 0 for s in done)
            ids_h = ids.cpu().numpy() if want else None
            probs_h = probs.cpu().numpy() if want else None
            tokp_h = tokp.cpu().numpy() if want else None
            for s in done:
                s.task.t_prefilled = time.monotonic()
                s.state = "decode"
                s.chain_ramp = self.ecfg.chain_ramp
                self._accept_token(
                    s, int(tok_h[s.idx]),
                    ids_h[s.idx] if want else None,
                    probs_h[s.idx] if want else None,
                    float(tokp_h[s.idx]) if want else 0.0)
        self.metrics.on_prefill(int(sum(chunks.values())),
                                (time.monotonic() - t0) * 1e3)

    def _prefill_program(self, T: int):
        """One prefill pass of bucket T over the staged operands, then the
        sample of the slots whose prompt it completes (the others do not
        advance their sampler state)."""
        S = len(self.slots)
        d = self._pre_in.dev
        logits, self.kv = prefill_batch_impl(
            self.params, self.cfg, d[3 * S:S * (3 + T)].view(S, T), d[:S],
            d[S:2 * S], self.kv, self.rope_cos, self.rope_sin)
        tok, ids, probs, tokp, self.sstate = sample_impl(
            logits, self.sstate, self.arrs, d[2 * S:3 * S] != 0)
        return tok, ids, probs, tokp

    # -- decode --------------------------------------------------------------

    def _decode_pass(self, dec: list) -> None:
        # every decoding slot has room for one more row (_accept_token
        # finishes a slot at its capacity); the chain shrinks to fit
        K = self._chain_k(dec)
        K = max(1, min(K, _pow2_floor(min(s.capacity - s.pos for s in dec))))
        self._decode_pass_chain(dec, K)

    def _remaining(self, s: Slot) -> int:
        """Tokens this slot's task can still emit (max_tokens budget)."""
        task = s.task
        if task is None:
            return 0
        mt = getattr(task, "max_tokens", 0) or 0
        if mt <= 0:
            return 1 << 30
        return max(0, mt - len(task.generated))

    def _chain_k(self, dec: list) -> int:
        """The configured decode_chain, capped by any ramping slot and by
        the pow2 bucket of the largest remaining budget (a 1-3 token
        leftover runs a 4-chain)."""
        K = self.ecfg.decode_chain
        ramps = [s.chain_ramp for s in dec if s.chain_ramp > 0]
        K = min([K] + ramps)
        rem = max(self._remaining(s) for s in dec)
        if rem <= 0:
            return 1
        if rem < K:
            K = min(K, max(4, _pow2_floor(rem)))
        return K

    def _bump_ramps(self, dec: list) -> None:
        for s in dec:
            if s.chain_ramp > 0:
                nxt = s.chain_ramp * 4
                s.chain_ramp = 0 if nxt >= self.ecfg.decode_chain else nxt

    def _chain_fast_kw(self, dec: list) -> dict:
        """samp_extras=False when every slot is plain; samp_kcap=64 when
        every slot's chain is covered by 64 candidates."""
        plain = all(s.task.sparams.plain for s in dec)
        kw = {"samp_extras": not plain}
        if plain and all(0 < s.task.sparams.top_k <= 64
                         and s.task.n_probs == 0 for s in dec):
            kw["samp_kcap"] = 64
        return kw

    def _decode_pass_chain(self, dec: list, K: int) -> None:
        """K sequential decode steps on the device + ONE host sync."""
        self._refresh_arrs()
        t0 = time.monotonic()
        S = len(self.slots)
        h = self._dec_in.host()
        h[:] = 0
        h[S:2 * S] = self.slot_ctx
        for s in dec:
            h[s.idx] = s.next_token
            h[S + s.idx] = s.pos
            h[2 * S + s.idx] = 1
        self._dec_in.push()
        kw = self._chain_fast_kw(dec)
        toks, ids, probs, tokps = self.graphs.run(
            ("decode", K, kw["samp_extras"], kw.get("samp_kcap", 0)),
            lambda: self._decode_program(K, **kw))
        self._bump_ramps(dec)
        toks_h = toks.cpu().numpy()
        want = any(s.task.n_probs > 0 for s in dec)
        ids_h = ids.cpu().numpy() if want else None
        probs_h = probs.cpu().numpy() if want else None
        tokps_h = tokps.cpu().numpy() if want else None
        self._emit_chain(dec, K, toks_h, ids_h, probs_h, tokps_h, t0)

    def _decode_program(self, K: int, **kw):
        """One K-step chain over the staged operands."""
        S = len(self.slots)
        d = self._dec_in.dev
        toks, ids, probs, tokps, self.kv, self.sstate = _decode_chain(
            self.params, self.cfg, d[:S], d[S:2 * S], self.kv, self.sstate,
            self.arrs, d[2 * S:] != 0, self.rope_cos, self.rope_sin,
            n_steps=K, **kw)
        return toks, ids, probs, tokps

    def _emit_chain(self, dec: list, K: int, toks_h, ids_h, probs_h,
                    tokps_h, t0: float) -> None:
        n_tok = 0
        for s in dec:
            inp = s.next_token
            for j in range(K):
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
        elif task.scanner.stopped:
            finish = "stop"
        elif task.budget_left() <= 0:
            finish = "length"
        elif s.pos >= s.capacity:
            # the token just sampled has no cache position left (context
            # shift is not ported yet): the request ends at the boundary
            finish = "length"

        if finish == "stop" and not task.scanner.stopped:
            text += task.scanner.flush()
        if finish == "length":
            text += task.scanner.flush()
        text, r_delta, calls = task.postprocess(text, final=bool(finish))
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
