"""Task model: one object per request carrying all mutable generation state,
mirroring the reference's btask/completions_task/embeddings_task
(httpserver.hpp:2042-2580). Results flow back to the HTTP worker over a
per-task queue (the reference's SPSC result queue, httpserver.hpp:2646-2652).
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import time
from typing import Any, Optional

from ..sampling import SamplerParams
from ..utils.text import utf8_safe_split_point

_task_ids = itertools.count()


class TokenStreamScanner:
    """Incremental detokenizer: UTF-8 boundary hold + stop-word holdback
    (reference per-token postprocess scan, httpserver.hpp:4347-4460)."""

    def __init__(self, tokenizer, stop_words: list[str]):
        self.tok = tokenizer
        self.stop_words = [w for w in stop_words if w]
        self._bytes = b""     # undecoded tail (possibly partial UTF-8)
        self._text = ""       # decoded but unemitted (stop-word holdback)
        self.stopped = False
        self.stop_word: Optional[str] = None

    def _holdback(self) -> int:
        """Length of the longest suffix of pending text that is a proper
        prefix of any stop word (must be withheld from streaming)."""
        hb = 0
        for w in self.stop_words:
            for k in range(min(len(w) - 1, len(self._text)), 0, -1):
                if self._text.endswith(w[:k]):
                    hb = max(hb, k)
                    break
        return hb

    def push(self, token_id: int) -> str:
        """Feed one generated token; returns text safe to emit now."""
        if self.stopped:
            return ""
        self._bytes += self.tok.token_bytes(token_id)
        sp = utf8_safe_split_point(self._bytes)
        if sp:
            self._text += self._bytes[:sp].decode("utf-8", errors="replace")
            self._bytes = self._bytes[sp:]
        for w in self.stop_words:
            i = self._text.find(w)
            if i != -1:
                out, self._text = self._text[:i], ""
                self.stopped = True
                self.stop_word = w
                return out
        emit_len = len(self._text) - self._holdback()
        out, self._text = self._text[:emit_len], self._text[emit_len:]
        return out

    def flush(self) -> str:
        """Emit everything held back (generation finished without stop hit)."""
        out = self._text + self._bytes.decode("utf-8", errors="replace")
        self._text, self._bytes = "", b""
        return out


class BaseTask:
    kind = "base"

    def __init__(self, rid: str = ""):
        self.id = next(_task_ids)
        self.rid = rid or str(self.id)
        self.result_q: queue.Queue = queue.Queue()
        self.cancelled = False
        self.error: Optional[Exception] = None
        self.t_submitted = time.monotonic()
        # optional asyncio bridge: when the HTTP layer attaches (loop, queue),
        # emit() forwards events there instead of blocking an executor thread
        # per in-flight request on result_q.get (scales past the default
        # ThreadPoolExecutor size)
        self._aio_loop = None
        self._aio_q = None

    def attach_aio(self, loop, q) -> None:
        self._aio_loop, self._aio_q = loop, q

    def emit(self, kind: str, payload: Any) -> None:
        if self._aio_loop is not None:
            try:
                self._aio_loop.call_soon_threadsafe(
                    self._aio_q.put_nowait, (kind, payload))
                return
            except RuntimeError:   # loop closed — fall back
                pass
        self.result_q.put((kind, payload))

    def fail(self, exc: Exception) -> None:
        self.error = exc
        self.emit("error", exc)


@dataclasses.dataclass
class TokenProbs:
    token: int
    text: str
    top_ids: list[int]
    top_probs: list[float]
    prob: float = 0.0   # the sampled token's own probability


class CompletionsTask(BaseTask):
    kind = "completions"

    def __init__(
        self,
        prompt_tokens: list[int],
        sparams: SamplerParams,
        tokenizer=None,
        max_tokens: int = -1,
        stop_words: list[str] | None = None,
        stream: bool = True,
        n_keep: int = 0,
        n_probs: int = 0,
        rid: str = "",
        lora: tuple = (),
        reasoning=None,     # ReasoningSplitter | None
        toolscan=None,      # ToolCallScanner | None
        rate_bucket=None,   # RatelimitTokenBucket | None (X-Request-TPS)
        chunks=None,        # multimodal prompt chunks (server/multimodal.py)
    ):
        super().__init__(rid)
        self.prompt_tokens = list(prompt_tokens)
        self.sparams = sparams
        self.max_tokens = max_tokens
        self.stream = stream
        self.n_keep = n_keep
        self.n_probs = n_probs
        self.lora = lora
        self.scanner = TokenStreamScanner(tokenizer, stop_words or [])
        self.reasoning = reasoning
        self.toolscan = toolscan
        self.tool_calls = []        # extracted ToolCall objects
        self.reasoning_text = ""
        self.rate_bucket = rate_bucket
        self.host_sampler = None    # sampling.HostSampler, set at admission
        self.ngram = None           # ngram.NgramCache, set at admission
        self.chunks = chunks        # None => plain text prompt
        self.mrope_delta = 0        # M-RoPE: decode rotates at pos + this

        # mutable generation state
        self.generated: list[int] = []
        self.text = ""
        self.probs: list[TokenProbs] = []
        self.finish_reason: Optional[str] = None
        self.truncated = False
        self.n_cached = 0           # prefix-cache reuse
        self.n_shifted = 0          # context-shift events
        # timings (reference: httpserver.hpp:2149-2162)
        self.t_start_prefill = 0.0
        self.t_prefilled = 0.0
        self.t_decoded = 0.0
        # speculative decoding stats
        self.n_drafted = 0
        self.n_draft_accepted = 0

    def postprocess(self, text: str, final: bool = False
                    ) -> tuple[str, str, list]:
        """Run raw generated text through the reasoning splitter and the
        tool-call scanner (reference stream-time state machines,
        httpserver.hpp:4360-4663). Returns (content_delta,
        reasoning_delta, new_tool_calls)."""
        r_delta = ""
        if self.reasoning is not None:
            text, r_delta = self.reasoning.feed(text)
            if final:
                fc, fr = self.reasoning.flush()
                text += fc
                r_delta += fr
            self.reasoning_text += r_delta
        calls: list = []
        if self.toolscan is not None:
            text, calls = self.toolscan.feed(text)
            if final:
                text += self.toolscan.flush()
            self.tool_calls.extend(calls)
        return text, r_delta, calls

    @property
    def n_prompt(self) -> int:
        return len(self.prompt_tokens)

    def budget_left(self) -> int:
        if self.max_tokens <= 0:
            return 1 << 30
        return self.max_tokens - len(self.generated)

    def timings(self) -> dict:
        n_gen = max(len(self.generated), 1)
        prefill_ms = max((self.t_prefilled - self.t_start_prefill) * 1e3, 1e-6)
        decode_ms = max((self.t_decoded - self.t_prefilled) * 1e3, 1e-6)
        n_uncached = max(self.n_prompt - self.n_cached, 1)
        return {
            "cached_tokens": self.n_cached,
            "prompt_tokens": self.n_prompt,
            "completion_tokens": len(self.generated),
            "time_to_first_token_ms": prefill_ms,
            "time_per_output_token_ms": decode_ms / n_gen,
            "prompt_tokens_per_second": n_uncached / prefill_ms * 1e3,
            "tokens_per_second": n_gen / decode_ms * 1e3,
            "draft_tokens": self.n_drafted,
            "draft_tokens_acceptance": (
                self.n_draft_accepted / self.n_drafted if self.n_drafted else None),
        }


class EmbeddingsTask(BaseTask):
    kind = "embeddings"

    def __init__(self, inputs: list[list[int]], normalize: bool = True,
                 rid: str = ""):
        super().__init__(rid)
        self.inputs = inputs
        self.normalize = normalize
        self.embeddings: list[list[float]] = []
        self.n_prompt = sum(len(i) for i in inputs)


class RerankTask(BaseTask):
    kind = "rerank"

    def __init__(self, pairs: list[list[int]], n_documents: int,
                 normalize: bool = True, rid: str = ""):
        """pairs: tokenized [BOS]query[SEP]doc[SEP][EOS] sequences; when
        normalize, the last two are the query-self / query-unknown anchors
        (httpserver.hpp:6189-6231)."""
        super().__init__(rid)
        self.pairs = pairs
        self.n_documents = n_documents
        self.normalize = normalize
        self.scores: list[float] = []
        self.n_prompt = sum(len(p) for p in pairs)
