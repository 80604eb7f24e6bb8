"""One captured CUDA graph per static configuration (the port's counterpart
of `jax.jit` for the engine's device programs, the K-step decode chain,
the batched prefill pass and the one-token pass of host-controlled
decode; the JAX package keys its programs by their static arguments, and
the port keys its graphs the same way).

`GraphRunner.run(key, fn)` calls `fn()`, a function of the engine's
persistent device buffers that returns its output tensors:
- the first use of a key runs `fn` eagerly, on the runner's stream: it
  does real work, and whatever a call makes at its first use (a kernel
  library, an attribute set once, scratch buffers, cuBLAS's workspace for
  the stream) is made outside any capture;
- the second use captures `fn` into a `torch.cuda.CUDAGraph` on that
  stream, then replays it; every later use replays it (on the caller's
  current stream);
- a capture or replay error raises; nothing falls back to eager.
Each graph has a memory pool of its own. The engine reads a graph's
outputs after other graphs have replayed (the next chain's first token,
a speculative pass's carry), and in a pool shared by graphs that replay
in another order than they were captured, a graph captured earlier
writes its intermediates over memory that a later capture gave to its
outputs. A replay does not call the kernel wrappers, so the runner keeps
their `launches` counts: it takes back what the capture added and adds it
again on every replay. Disabled (the CPU, or EngineConfig.cuda_graphs
off), `run` calls `fn` each time.

A capture (in torch's default global mode) fails when another thread
allocates device memory or copies synchronously meanwhile; the one other
thread that works on the card is a request thread running a multimodal
tower, so a capture and a tower's run take turns on CAPTURE_LOCK.
"""

from __future__ import annotations

import threading

import torch

CAPTURE_LOCK = threading.Lock()


def kernel_wrappers() -> list:
    """The wrappers whose `launches` count their kernels' launches."""
    from ..ops.flash_decode import flash_decode
    from ..ops.flash_prefill import flash_prefill_batched
    from ..ops.fused_decode import fused_layer_tail, fused_norm_qmm
    from ..ops.moe import moe_ffn
    from ..ops.norm import row_norm
    from ..ops.qmatmul import q4_matmul, q8_matmul, w8a8_matmul
    from ..ops.ssm_scan import ssm_scan
    from ..ops.wkv import wkv_kernel
    return [flash_prefill_batched, flash_decode, w8a8_matmul, fused_norm_qmm,
            fused_layer_tail, q4_matmul, q8_matmul, row_norm, moe_ffn,
            ssm_scan, wkv_kernel]


class _Graph:
    __slots__ = ("graph", "outputs", "launches")

    def __init__(self, graph, outputs, launches):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches


class GraphRunner:
    def __init__(self, device, enabled: bool = True):
        dev = torch.device(device)
        self.enabled = enabled and dev.type == "cuda"
        self._graphs: dict = {}
        self._seen: set = set()
        self.pool_bytes = 0       # reserved memory the captures added
        if self.enabled:
            self.stream = torch.cuda.Stream(dev)
            self._wrappers = kernel_wrappers()

    @property
    def n_graphs(self) -> int:
        return len(self._graphs)

    def run(self, key, fn):
        """fn()'s outputs for `key`: eager at its first use, then from its
        captured graph (see the module docstring)."""
        if not self.enabled:
            return fn()
        g = self._graphs.get(key)
        if g is None and key not in self._seen:
            self._seen.add(key)
            return self._on_stream(fn)
        if g is None:
            g = self._graphs[key] = self._capture(fn)
        g.graph.replay()
        for w, n in zip(self._wrappers, g.launches):
            w.launches += n
        return g.outputs

    def _on_stream(self, fn):
        cur = torch.cuda.current_stream()
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        return out

    def _capture(self, fn) -> _Graph:
        with CAPTURE_LOCK:
            return self._capture_locked(fn)

    def _capture_locked(self, fn) -> _Graph:
        before = [w.launches for w in self._wrappers]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()        # as the capture's entry does
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream):
            outputs = fn()
        delta = []
        for w, n in zip(self._wrappers, before):
            delta.append(w.launches - n)
            w.launches = n              # nothing ran yet: the replays count
        self.pool_bytes += torch.cuda.memory_reserved() - reserved
        return _Graph(graph, outputs, delta)

    def close(self) -> None:
        """Drop every graph (and its memory)."""
        self._graphs.clear()
        self._seen.clear()
