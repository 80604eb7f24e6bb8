"""GGUF -> torch parameter loading, llama path (counterpart of
llama_box_tpu/models/loader.py: load_model, deinterleave_rope,
fuse_projections).

GGUF 2D tensors arrive as numpy (out_features, in_features); the model
multiplies x @ W, so weights are transposed once here to (in, out). Layer
weights stack along a leading L axis. The param tree has the JAX
package's key names and layouts (`tok_embd`, `output_norm`, `output`,
`layers.wq` ... or the fused `layers.wqkv` / `layers.w_gateup`), so
`params_from_numpy` carries a JAX param tree across unchanged.

Two weight formats:
- dense (default): dequantize to bf16/f32 on the device.
- quantized=True: every block-quant 2D projection (and the output
  projection) is repacked (gguf/repack.py) and held as a QTensor in the
  residency ops/qmatmul.pack_repacked picks from the JAX package's
  switches: w8a8 by default (per-column int8 codes, f32 scales), or the
  grouped layout under LLAMA_BOX_TPU_PACKED4 / _Q4_INT8 / _Q4_F32SCALES
  (group codes, nibble-packed for 4-bit formats, per-group scales and
  mins). Tensors are packed on the host one at a time and moved to the
  device once per layer stack. token_embd, the norms and formats without
  a repacker stay dense, as in JAX.
A layer key whose layers pack to different layouts (a llama.cpp Q4_K_M
gives Q6_K to some layers' attn_v and ffn_down) cannot be stacked: the
JAX loader's np.stack fails on it under the grouped residency, and this
loader refuses it by name. The other families' tensors are later slices
of the port: a GGUF that carries a tensor this path does not know is
refused, never half-loaded.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..gguf.reader import GGUFFile
from ..gguf.repack import REPACKERS, repack
from ..ops.qmatmul import QTensor, pack_repacked
from ..utils.logging import SRV_INF
from .config import ModelConfig

_LAYER_WEIGHTS = {
    "attn_norm": ("blk.{i}.attn_norm.weight", False),
    "wq": ("blk.{i}.attn_q.weight", True),
    "wk": ("blk.{i}.attn_k.weight", True),
    "wv": ("blk.{i}.attn_v.weight", True),
    "wo": ("blk.{i}.attn_output.weight", True),
    "ffn_norm": ("blk.{i}.ffn_norm.weight", False),
    "w_gate": ("blk.{i}.ffn_gate.weight", True),
    "w_up": ("blk.{i}.ffn_up.weight", True),
    "w_down": ("blk.{i}.ffn_down.weight", True),
}
_ROOT = ("token_embd.weight", "output_norm.weight", "output.weight")


def _torch_dtype_of(arr: np.ndarray) -> torch.Tensor:
    """numpy -> torch (copied: arrays handed over from JAX are read-only);
    numpy arrays of dtype bfloat16 (as JAX hands them over) are
    reinterpreted through their 16-bit pattern."""
    arr = np.array(arr, order="C", copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _quantizable(info, shape) -> bool:
    if info.ggml_type not in REPACKERS or len(shape) != 2:
        return False
    out_dim, in_dim = shape
    return in_dim % 64 == 0 and out_dim % 64 == 0


def _layout(q: QTensor) -> tuple:
    return (q.w8a8, q.packed4, q.group, q.in_dim, q.mins is None,
            tuple(q.qs.shape), tuple(q.scales.shape), q.scales.dtype)


def _stack_qtensors(qts: list[QTensor], key: str,
                    formats: list[str]) -> QTensor:
    """Stack per-layer QTensors along a new leading axis. Raises
    ValueError, naming `key` and the GGUF `formats` found, when the layers
    differ in layout; nothing is padded or converted."""
    layouts = sorted({_layout(q) for q in qts}, key=str)
    if len(layouts) > 1:
        desc = "; ".join(f"packed4={p}, group={g}, mins={not nm}, qs{qs}"
                         for _, p, g, _, nm, qs, _, _ in layouts)
        raise ValueError(
            f"{key}: its layers pack to {len(layouts)} different quantized "
            f"layouts ({desc}) from GGUF formats {sorted(set(formats))}; "
            "a layer stack needs one layout per key (the JAX package's "
            "loader cannot stack them either)")
    return QTensor(
        qs=torch.stack([q.qs for q in qts]),
        scales=torch.stack([q.scales for q in qts]),
        mins=(torch.stack([q.mins for q in qts])
              if qts[0].mins is not None else None),
        in_dim=qts[0].in_dim, group=qts[0].group, packed4=qts[0].packed4,
        w8a8=qts[0].w8a8)


def load_model(path: str, dtype=torch.bfloat16, device="cuda",
               quantized: bool = False) -> tuple[ModelConfig, dict]:
    """Load a llama-family GGUF into a stacked-layer param tree of `dtype`
    tensors on `device`; with `quantized`, the block-quant projections as
    QTensors (w8a8 or grouped: see the module docstring)."""
    dev = torch.device(device)
    with GGUFFile(path) as g:
        cfg = ModelConfig.from_gguf(g)
        SRV_INF("load_model", "arch=%s layers=%d embd=%d heads=%d/%d ff=%d "
                "vocab=%d dtype=%s quantized=%s device=%s", cfg.arch,
                cfg.n_layers, cfg.n_embd, cfg.n_heads, cfg.n_kv_heads,
                cfg.n_ff, cfg.vocab_size, dtype, quantized, dev)
        known = set(_ROOT) | {pat.format(i=i)
                              for pat, _ in _LAYER_WEIGHTS.values()
                              for i in range(cfg.n_layers)}
        extra = sorted(set(g.tensors) - known)
        if extra:
            raise NotImplementedError(
                f"{cfg.arch}: tensors outside the dense llama path are not "
                f"ported yet: {extra[:8]}")

        def fetch(name: str, transpose: bool) -> torch.Tensor:
            x = g.tensor_f32(name)
            if transpose and x.ndim == 2:
                x = x.T
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

        def fetch_maybe_q(name: str, transpose: bool):
            """A QTensor (host tensors) or a dense device tensor."""
            info = g.tensors[name]
            if quantized and transpose and _quantizable(info, info.shape):
                rt = repack(info.ggml_type, g.tensor_raw(name),
                            info.n_elements)
                out_dim, in_dim = info.shape
                return pack_repacked(rt, (in_dim, out_dim))
            return fetch(name, transpose)

        def stack(key: str, names: list[str], ws: list):
            if any(isinstance(w, QTensor) for w in ws):
                if not all(isinstance(w, QTensor) for w in ws):
                    raise ValueError(f"{key}: some layers are quantized "
                                     "QTensors and some dense")
                return _stack_qtensors(
                    ws, key, [g.tensors[n].ggml_type.name for n in names]
                ).to(dev)
            return torch.stack(ws)

        params: dict = {"tok_embd": fetch("token_embd.weight", False),
                        "output_norm": fetch("output_norm.weight", False)}
        if "output.weight" in g.tensors:
            out_w = fetch_maybe_q("output.weight", True)
            params["output"] = (out_w.to(dev) if isinstance(out_w, QTensor)
                                else out_w)
        else:
            SRV_INF("load_model", "output.weight absent -> tied embeddings")
        layers = {}
        for key, (pattern, transpose) in _LAYER_WEIGHTS.items():
            names = [pattern.format(i=i) for i in range(cfg.n_layers)]
            layers[key] = stack(key, names, [fetch_maybe_q(n, transpose)
                                             for n in names])
        params["layers"] = layers
    return cfg, params


def params_from_numpy(params_np: dict, cfg: ModelConfig,
                      device="cpu") -> dict:
    """Carry a JAX param tree (after `jax.tree.map(np.asarray, params)`)
    into torch on `device`: same keys, same [in, out] layouts, same
    dtypes. The JAX package's QTensor nodes (numpy leaves) become the
    port's QTensors. The `smalls_all` bundle (a TPU layout of values the
    tree already holds) is dropped."""
    del cfg  # the tree carries its own shapes; kept for the JAX signature

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items() if k != "smalls_all"}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if all(hasattr(x, a) for a in ("qs", "scales", "mins", "in_dim",
                                       "group", "packed4", "w8a8")):
            return QTensor(conv(x.qs), conv(x.scales),
                           None if x.mins is None else conv(x.mins),
                           int(x.in_dim), int(x.group), bool(x.packed4),
                           bool(x.w8a8))
        return _torch_dtype_of(np.asarray(x)).to(device)
    return conv(params_np)


def _out_dim(w) -> int:
    return w.out_dim if isinstance(w, QTensor) else w.shape[-1]


def deinterleave_rope(params: dict, cfg: ModelConfig):
    """Permute wq/wk output columns from ggml's adjacent-pair ('norm')
    rotation order to half-split ('neox') order; attention is invariant
    and the runtime rotation takes the neox path. Returns (params, cfg')
    with cfg'.rope_mode == 'neox', or the inputs unchanged when the
    transform does not apply."""
    lay = params.get("layers")
    if (cfg.rope_mode != "norm" or cfg.mrope_sections or cfg.kv_lora_rank
            or not isinstance(lay, dict)
            or "wq" not in lay or "wk" not in lay):
        return params, cfg
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rot = cfg.rope_dim or D
    if rot % 2 or _out_dim(lay["wq"]) != H * D \
            or _out_dim(lay["wk"]) != Hkv * D:
        return params, cfg
    base = np.concatenate([np.arange(0, rot, 2), np.arange(1, rot, 2),
                           np.arange(rot, D)])

    def perm_cols(w, n_heads):
        idx = torch.from_numpy(np.concatenate(
            [h * D + base for h in range(n_heads)]))

        def take(a):
            return torch.index_select(a, -1, idx.to(a.device))
        if isinstance(w, QTensor):   # permute the codes and the scales
            return w._map(take)
        return take(w)

    lay = dict(lay)
    lay["wq"] = perm_cols(lay["wq"], H)
    lay["wk"] = perm_cols(lay["wk"], Hkv)
    out = dict(params)
    out["layers"] = lay
    return out, dataclasses.replace(cfg, rope_mode="neox")


def _cat_weights(ws):
    """Concatenate projection weights along the output dim: dense tensors
    or QTensors with identical layout params. Returns None when the set is
    heterogeneous (no fusion)."""
    if all(isinstance(w, torch.Tensor) for w in ws):
        if len({w.dtype for w in ws}) != 1 \
                or len({w.shape[:-1] for w in ws}) != 1:
            return None
        return torch.cat(ws, dim=-1)
    if not all(isinstance(w, QTensor) for w in ws):
        return None
    w0 = ws[0]
    if any(w.w8a8 != w0.w8a8 or w.packed4 != w0.packed4
           or w.group != w0.group or w.in_dim != w0.in_dim
           or (w.mins is None) != (w0.mins is None) for w in ws):
        return None
    return QTensor(
        qs=torch.cat([w.qs for w in ws], dim=-1),
        scales=torch.cat([w.scales for w in ws], dim=-1),
        mins=(torch.cat([w.mins for w in ws], dim=-1)
              if w0.mins is not None else None),
        in_dim=w0.in_dim, group=w0.group, packed4=w0.packed4,
        w8a8=w0.w8a8)


def fuse_projections(params: dict, cfg: ModelConfig) -> dict:
    """Fuse per-layer q/k/v and gate/up projections into single matmuls
    (`wqkv` [L, E, (H+2*Hkv)*D], `w_gateup` [L, E, 2*FF]). Each output
    column is an independent contraction (and w8a8 activation scales are
    per row of x, shared by construction), so the split outputs equal the
    separate matmuls'."""
    del cfg
    layers = params.get("layers")
    if not isinstance(layers, dict):
        return params
    layers = dict(layers)
    for fused, keys in (("wqkv", ("wq", "wk", "wv")),
                        ("w_gateup", ("w_gate", "w_up"))):
        if all(k in layers for k in keys):
            f = _cat_weights([layers[k] for k in keys])
            if f is not None:
                layers[fused] = f
                for k in keys:
                    del layers[k]
    out = dict(params)
    out["layers"] = layers
    return out
