"""Control vectors (activation steering), the reference's llama.cpp cvec
(counterpart of llama_box_tpu/models/control_vector.py).

GGUF control-vector files carry one `direction.<N>` tensor of shape
[n_embd] per steered layer (N is 1-based, llama.cpp convention). At
inference the scaled direction is added to the residual stream at each
layer's output: one [L, E] tensor, params["cvec"], that the forward's
layer loop reads (models/llama._run_stack), so steering rides the same
captured programs.

Reference surface: --control-vector / --control-vector-scaled /
--control-vector-layer-range (engine_param.hpp; llama.cpp
llama_apply_adapter_cvec).
"""

from __future__ import annotations

import numpy as np

from ..gguf.reader import GGUFFile
from ..utils.logging import SRV_INF


def load_control_vector(path: str, n_layers: int, n_embd: int,
                        scale: float = 1.0) -> np.ndarray:
    """One GGUF control vector -> dense [n_layers, n_embd] f32 (zero rows
    for layers the file does not steer). Raises ValueError when a
    direction's width is not n_embd."""
    out = np.zeros((n_layers, n_embd), np.float32)
    with GGUFFile(path) as g:
        n_found = 0
        for name in g.tensors:
            if not name.startswith("direction."):
                continue
            layer = int(name.split(".")[1]) - 1   # 1-based in the file
            if not 0 <= layer < n_layers:
                continue
            vec = g.tensor_f32(name).reshape(-1)
            if vec.shape[0] != n_embd:
                raise ValueError(
                    f"{path}: direction dim {vec.shape[0]} != n_embd "
                    f"{n_embd}")
            out[layer] += scale * vec
            n_found += 1
    SRV_INF("cvec", "loaded %s: %d/%d layers steered (scale %.3f)", path,
            n_found, n_layers, scale)
    return out


def combine_control_vectors(entries: list[tuple[str, float]], n_layers: int,
                            n_embd: int,
                            layer_range: tuple[int, int] | None = None
                            ) -> np.ndarray:
    """Sum several (path, scale) vectors; zero outside layer_range
    (1-based inclusive, like --control-vector-layer-range)."""
    cv = np.zeros((n_layers, n_embd), np.float32)
    for path, scale in entries:
        cv += load_control_vector(path, n_layers, n_embd, scale)
    if layer_range is not None:
        lo, hi = layer_range
        keep = np.zeros(n_layers, bool)
        keep[max(lo - 1, 0):hi] = True
        cv[~keep] = 0.0
    return cv
