"""Aggregate serving metrics (reference httpserver_metrics,
httpserver.hpp:2591-2629, exposed as Prometheus at /metrics)."""

from __future__ import annotations

import threading


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self.t_prefill_total_ms = 0.0
        self.n_prefill_total = 0
        self.t_decode_total_ms = 0.0
        self.n_decode_total = 0
        self.n_drafted_total = 0
        self.n_drafted_accepted_total = 0
        self.n_requests = 0
        self.n_image_steps_forward = 0
        self.n_image_steps_reverse = 0
        # decode chains and speculative passes dispatched before the host
        # synced the one before (all; those off a prefill's first tokens)
        self.n_spec_chains = 0
        self.n_spec_post_prefill = 0

    def on_prefill(self, n_tokens: int, ms: float) -> None:
        with self._lock:
            self.n_prefill_total += n_tokens
            self.t_prefill_total_ms += ms

    def on_decode(self, n_tokens: int, ms: float) -> None:
        with self._lock:
            self.n_decode_total += n_tokens
            self.t_decode_total_ms += ms

    def on_draft(self, drafted: int, accepted: int) -> None:
        with self._lock:
            self.n_drafted_total += drafted
            self.n_drafted_accepted_total += accepted

    def on_speculate(self, post_prefill: bool) -> None:
        with self._lock:
            self.n_spec_chains += 1
            self.n_spec_post_prefill += int(post_prefill)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.__dict__, _lock=None)
