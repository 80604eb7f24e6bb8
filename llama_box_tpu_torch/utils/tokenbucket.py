"""Token buckets for rate limiting.

Behavioral parity with reference llama-box/z_utils.hpp:
- RatelimitTokenBucket (z_utils.hpp:63-101): per-request tokens/second cap,
  consumed once per decoded token (X-Request-Tokens-Per-Second header).
- ParallelControlTokenBucket (z_utils.hpp:103-136): counting semaphore used
  to bound concurrent work.
"""

from __future__ import annotations

import threading
import time


class RatelimitTokenBucket:
    """Refill `rate` tokens per second up to `capacity`; try_acquire per token."""

    def __init__(self, capacity: int, rate: float):
        self.capacity = max(1, int(capacity))
        self.rate = float(rate)
        self.tokens = float(self.capacity)
        self.last = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = time.monotonic()
        self.tokens = min(self.capacity, self.tokens + (now - self.last) * self.rate)
        self.last = now

    def try_acquire(self, n: int = 1) -> bool:
        with self._lock:
            self._refill()
            if self.tokens >= n:
                self.tokens -= n
                return True
            return False

    def acquire(self, n: int = 1) -> None:
        while not self.try_acquire(n):
            with self._lock:
                self._refill()
                deficit = max(0.0, n - self.tokens)
            time.sleep(max(0.001, deficit / self.rate if self.rate > 0 else 0.01))


class ParallelControlTokenBucket:
    """Counting semaphore bounding concurrent holders."""

    def __init__(self, capacity: int):
        self._sem = threading.Semaphore(max(1, int(capacity)))

    def acquire(self) -> None:
        self._sem.acquire()

    def release(self) -> None:
        self._sem.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False
