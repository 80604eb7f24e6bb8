"""Host-device staging of the engine's programs (no JAX counterpart:
jax.jit takes its operands by value and returns fresh arrays).

- `StagedBuffer`: code captured in a CUDA graph reads a device buffer at
  a fixed address; between replays the host writes a staging buffer and
  one non-blocking copy moves it.
- `HostCopies`: a captured graph's outputs are fixed buffers too, which
  its next replay overwrites; so right after each dispatch they are
  copied, on the same stream, into pinned host buffers, and an event
  marks the copy. The JAX engine instead requests each output's
  device-to-host copy at dispatch and a transfer thread (`_xfer_loop`)
  waits for them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class StagedBuffer:
    """A flat device buffer `dev` and `n_host` host staging buffers,
    pinned on a CUDA device (a copy from pageable memory would synchronise
    the stream), used in turn: a push queued behind programs in flight
    holds up only the `host()` that comes back to its buffer, n_host
    pushes later."""

    def __init__(self, n: int, dtype: torch.dtype, device, n_host: int = 1):
        dev = torch.device(device)
        self.dev = torch.zeros(n, dtype=dtype, device=dev)
        pin = dev.type == "cuda"
        self._hosts = [torch.zeros(n, dtype=dtype, pin_memory=pin)
                       for _ in range(n_host)]
        self._copied = [torch.cuda.Event() if pin else None
                        for _ in range(n_host)]
        self._i = 0

    def host(self) -> np.ndarray:
        """The next staging buffer as numpy, once the last copy from it
        has left it; `push` copies from it."""
        self._i = (self._i + 1) % len(self._hosts)
        if self._copied[self._i] is not None:
            self._copied[self._i].synchronize()
        return self._hosts[self._i].numpy()

    def push(self, n: int | None = None) -> None:
        """Copy the first n elements (all by default) of the buffer
        `host()` gave to the device, on the current stream, without
        waiting for it."""
        n = self.dev.numel() if n is None else n
        self.dev[:n].copy_(self._hosts[self._i][:n], non_blocking=True)
        if self._copied[self._i] is not None:
            self._copied[self._i].record()


class HostCopies:
    """`n_sets` sets of host buffers, one flat buffer per output (its
    element count and dtype in `sizes`), pinned on a CUDA device. `start`
    copies a program's outputs into a free set on the current stream and
    records an event; `wait` takes the event and hands back the values;
    `drop` frees a set unread. A set is not handed out again before it
    is waited on or dropped (copies into one set are ordered on the
    stream, so a dropped set's late copy lands before the next one). On
    the CPU the copy is a plain copy and there is no event."""

    def __init__(self, n_sets: int, sizes: Sequence[tuple[int, torch.dtype]],
                 device):
        self._cuda = torch.device(device).type == "cuda"
        self._sets = [[torch.empty(n, dtype=dt, pin_memory=self._cuda)
                       for n, dt in sizes] for _ in range(n_sets)]
        self._events = [torch.cuda.Event() if self._cuda else None
                        for _ in range(n_sets)]
        self._free = set(range(n_sets))

    def start(self, outs: Sequence[torch.Tensor | None]) -> tuple:
        """Copy each output (None: not wanted) into a free set; returns
        the handle `wait` and `drop` take."""
        if not self._free:
            raise RuntimeError("every host copy set is in use: more "
                               "programs in flight than the ring holds")
        i = self._free.pop()
        shapes = []
        for buf, t in zip(self._sets[i], outs):
            if t is None:
                shapes.append(None)
                continue
            buf[:t.numel()].view(t.shape).copy_(t, non_blocking=True)
            shapes.append(tuple(t.shape))
        if self._events[i] is not None:
            self._events[i].record()
        return i, shapes

    def wait(self, handle: tuple) -> list[np.ndarray | None]:
        """Block until the copy of `handle` has landed (a failed copy or
        program raises here), free its set and return the values."""
        i, shapes = handle
        try:
            if self._events[i] is not None:
                self._events[i].synchronize()
            return [None if shp is None else
                    buf[:int(np.prod(shp))].view(shp).numpy().copy()
                    for buf, shp in zip(self._sets[i], shapes)]
        finally:
            self._free.add(i)

    def drop(self, handle: tuple) -> None:
        self._free.add(handle[0])

    def reset(self) -> None:
        """Free every set (nothing started so far will be read)."""
        self._free = set(range(len(self._sets)))
