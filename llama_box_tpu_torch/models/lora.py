"""LoRA adapter loading, merge and per-request stacks (counterpart of
llama_box_tpu/models/lora.py; the reference's LoRA runtime, SURVEY.md
§2.1 #22).

GGUF adapter files (general.type == "adapter", adapter.type == "lora")
carry per-tensor low-rank pairs `<base>.lora_a` (r x in) and
`<base>.lora_b` (out x r); the effective weight is W + scale * (B @ A)
with scale = adapter.lora.alpha / r * user_scale.

Two uses, as in the JAX package:
- `apply_lora` merges static adapters (the CLI's --lora / --lora-scaled)
  into the dense weights at load; a quantized-resident weight is skipped
  with a warning.
- `stack_dynamic` keeps them unmerged for per-request scales
  (--lora-per-request): per-layer stacks the forward reads beside each
  projection (models/llama._lora_delta), one scale row a slot.

numpy in (the adapter's f32 pairs), torch tensors on the weights' device
out.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..gguf.reader import GGUFFile
from ..ops.qmatmul import QTensor
from ..utils.logging import SRV_INF, SRV_WRN


@dataclasses.dataclass
class LoraAdapter:
    name: str
    path: str
    alpha: float
    scale: float                     # user scale (CLI --lora-scaled)
    pairs: dict                      # base tensor name -> (A [r,in], B [out,r])

    @property
    def rank(self) -> int:
        for a, _ in self.pairs.values():
            return a.shape[0]
        return 0


def load_lora(path: str, scale: float = 1.0) -> LoraAdapter:
    """An adapter GGUF's lora_a / lora_b pairs as f32 numpy. Raises
    ValueError for a file that is not a LoRA adapter or holds no pair."""
    g = GGUFFile(path)
    gtype = str(g.metadata.get("general.type", ""))
    atype = str(g.metadata.get("adapter.type", ""))
    if gtype not in ("adapter", "") or (atype and atype != "lora"):
        g.close()
        raise ValueError(f"{path} is not a LoRA adapter GGUF "
                         f"(type={gtype}/{atype})")
    alpha = float(g.metadata.get("adapter.lora.alpha", 16.0))
    name = str(g.metadata.get("general.name", path.rsplit("/", 1)[-1]))
    pairs: dict = {}
    for tname in g.tensors:
        if tname.endswith(".lora_a"):
            base = tname[: -len(".lora_a")]
            b_name = base + ".lora_b"
            if b_name not in g.tensors:
                SRV_WRN("lora", "missing %s; skipping %s", b_name, base)
                continue
            pairs[base] = (g.tensor_f32(tname), g.tensor_f32(b_name))
    g.close()
    if not pairs:
        raise ValueError(f"{path} contains no lora_a/lora_b tensor pairs")
    SRV_INF("lora", "loaded %s: %d tensor pairs, alpha=%.1f scale=%.2f",
            name, len(pairs), alpha, scale)
    return LoraAdapter(name=name, path=path, alpha=alpha, scale=scale,
                       pairs=pairs)


# base tensor name -> the param tree's layer key
_TARGETS = {
    "attn_q.weight": "wq",
    "attn_k.weight": "wk",
    "attn_v.weight": "wv",
    "attn_output.weight": "wo",
    "ffn_gate.weight": "w_gate",
    "ffn_up.weight": "w_up",
    "ffn_down.weight": "w_down",
}


def _device(w) -> torch.device:
    return (w.qs if isinstance(w, QTensor) else w).device


def stack_dynamic(params: dict, cfg, adapters: list[LoraAdapter]) -> int:
    """Register adapters UNMERGED for per-request scaling: per-layer
    low-rank stacks params["layers"]["lora_A_<key>"] [L, n_ad, r_max, in]
    and ["lora_B_<key>"] [L, n_ad, out, r_max] (f32, A times alpha / r,
    ranks zero-padded to r_max), on the weights' device. The forward adds
    sum_a slot_scale[a] * (x @ A_a.T) @ B_a.T beside the projection, so
    every slot runs its own adapter mix in one batch. A quantized base
    gives its dims through the QTensor. Reads params["layers"] as JAX does
    (a layer-group tree has none: KeyError). Returns n_adapters."""
    layers = params["layers"]
    n_layers = cfg.n_layers
    r_max = max((a.rank for a in adapters), default=0)
    if r_max == 0:
        return 0
    by_key: dict = {}
    for ai, ad in enumerate(adapters):
        eff = ad.alpha / max(ad.rank, 1)
        for base, (A, B) in ad.pairs.items():
            if not base.startswith("blk."):
                continue
            _, idx, rest = base.split(".", 2)
            key = _TARGETS.get(rest)
            if key is None or key not in layers:
                continue
            by_key.setdefault(key, {})[(ai, int(idx))] = (A * eff, B)
    n_ad = len(adapters)
    for key, entries in by_key.items():
        W = layers[key]
        if isinstance(W, QTensor):
            in_dim, out_dim = W.in_dim, W.out_dim  # works on quantized base
        else:
            in_dim, out_dim = W.shape[1], W.shape[2]
        A_stack = np.zeros((n_layers, n_ad, r_max, in_dim), np.float32)
        B_stack = np.zeros((n_layers, n_ad, out_dim, r_max), np.float32)
        for (ai, li), (A, B) in entries.items():
            r = A.shape[0]
            A_stack[li, ai, :r, :] = A
            B_stack[li, ai, :, :r] = B
        dev = _device(W)
        layers[f"lora_A_{key}"] = torch.from_numpy(A_stack).to(dev)
        layers[f"lora_B_{key}"] = torch.from_numpy(B_stack).to(dev)
    return n_ad


def apply_lora(params: dict, cfg, adapters: list[LoraAdapter]) -> dict:
    """Merge adapters into the (dense) stacked layer weights and the
    output projection: W[i] + (B @ A).T * scale * alpha / r, the delta in
    f32 numpy, cast to W's dtype and added there, as JAX does.
    Quantized-resident weights cannot be merged; those tensors are skipped
    with a warning (load dense to use LoRA). The merged tensors are new
    (the loaded ones are not written)."""
    layers = params["layers"]
    copied: set = set()
    merged = 0
    for ad in adapters:
        eff = ad.scale * (ad.alpha / max(ad.rank, 1))
        for base, (A, B) in ad.pairs.items():
            if not base.startswith("blk."):
                if base in ("output.weight",) and "output" in params:
                    delta = (B @ A).T * eff       # [in, out]
                    W = params["output"]
                    if isinstance(W, QTensor):
                        SRV_WRN("lora", "cannot merge %s into quantized "
                                "weights; skipped", base)
                        continue
                    params["output"] = W + torch.from_numpy(
                        np.ascontiguousarray(delta)).to(W.device, W.dtype)
                    merged += 1
                continue
            _, idx, rest = base.split(".", 2)
            key = _TARGETS.get(rest)
            if key is None or key not in layers:
                SRV_WRN("lora", "no target for %s; skipped", base)
                continue
            W = layers[key]
            if isinstance(W, QTensor):
                SRV_WRN("lora", "cannot merge %s into quantized weights; "
                        "load with dense weights to use LoRA", base)
                continue
            if key not in copied:
                W = layers[key] = W.clone()
                copied.add(key)
            delta = (B @ A).T * eff               # [in, out]
            W[int(idx)] += torch.from_numpy(
                np.ascontiguousarray(delta)).to(W.device, W.dtype)
            merged += 1
    SRV_INF("lora", "merged %d tensor deltas from %d adapter(s)", merged,
            len(adapters))
    return params
