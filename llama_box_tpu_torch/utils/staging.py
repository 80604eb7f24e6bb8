"""Host-to-device staging of a persistent device buffer (no JAX
counterpart: jax.jit takes its operands by value). Code captured in a
CUDA graph reads the device buffer at a fixed address; between replays
the host writes the staging buffer and one non-blocking copy moves it."""

from __future__ import annotations

import numpy as np
import torch


class StagedBuffer:
    """A flat device buffer `dev` and its host staging buffer, pinned on a
    CUDA device (a copy from pageable memory would synchronise the
    stream)."""

    def __init__(self, n: int, dtype: torch.dtype, device):
        dev = torch.device(device)
        self.dev = torch.zeros(n, dtype=dtype, device=dev)
        self._host = torch.zeros(n, dtype=dtype,
                                 pin_memory=dev.type == "cuda")
        self._copied = torch.cuda.Event() if dev.type == "cuda" else None

    def host(self) -> np.ndarray:
        """The staging buffer as numpy, once the last copy from it has
        left it."""
        if self._copied is not None:
            self._copied.synchronize()
        return self._host.numpy()

    def push(self, n: int | None = None) -> None:
        """Copy the first n elements (all by default) to the device, on the
        current stream, without waiting for it."""
        n = self.dev.numel() if n is None else n
        self.dev[:n].copy_(self._host[:n], non_blocking=True)
        if self._copied is not None:
            self._copied.record()
