"""BERT-family encoder in PyTorch (counterpart of
llama_box_tpu/models/bert.py): embeddings and rerank scoring.

A post-LN transformer with learned absolute positions, token-type
embeddings, an exact (erf) GELU FFN and an optional classification head
that turns the [CLS] hidden state into a relevance score (pooling
"rank"); the archs of the reference's embedding and rerank models,
"new" (jina-reranker) included.

In the JAX package every op of the encoder is XLA (einsum, softmax, layer
norm): none is a Pallas kernel. So the port writes them as plain torch
ops, with the products in torch.matmul, on the card as on the CPU, but
for its LayerNorms, which take the port's row-norm kernel
(ops/norm.norm_any: one launch where the torch ops were five). The
attention is written out, not a library attention kernel, so that its
masked softmax rounds where the JAX one does. Weights are dequantized to
one dtype at load, as in the JAX loader: a BERT file is never held in a
quantized residency.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..gguf.reader import GGUFFile
from ..ops.norm import norm_any
from ..utils.logging import SRV_INF
from .config import ModelConfig
from .loader import _torch_dtype_of

BERT_ARCHS = {"bert", "nomic-bert", "jina-bert-v2", "new"}

_POOLING = {0: "none", 1: "mean", 2: "cls", 3: "last", 4: "rank"}

# param key -> (GGUF tensor name, transposed to [in, out])
_ROOT = {
    "tok_embd": ("token_embd.weight", False),
    "type_embd": ("token_types.weight", False),
    "pos_embd": ("position_embd.weight", False),
    "embd_norm": ("token_embd_norm.weight", False),
    "embd_norm_b": ("token_embd_norm.bias", False),
    "cls": ("cls.weight", True),
    "cls_b": ("cls.bias", False),
    "cls_out": ("cls.output.weight", True),
    "cls_out_b": ("cls.output.bias", False),
}
_LAYER = {
    "wq": ("attn_q.weight", True), "bq": ("attn_q.bias", False),
    "wk": ("attn_k.weight", True), "bk": ("attn_k.bias", False),
    "wv": ("attn_v.weight", True), "bv": ("attn_v.bias", False),
    "wo": ("attn_output.weight", True), "bo": ("attn_output.bias", False),
    "attn_norm": ("attn_output_norm.weight", False),
    "attn_norm_b": ("attn_output_norm.bias", False),
    "w_up": ("ffn_up.weight", True), "b_up": ("ffn_up.bias", False),
    "w_down": ("ffn_down.weight", True), "b_down": ("ffn_down.bias", False),
    "ffn_norm": ("layer_output_norm.weight", False),
    "ffn_norm_b": ("layer_output_norm.bias", False),
}
# what bert_forward reads without a default
_REQUIRED_LAYER = ("wq", "wk", "wv", "wo", "w_up", "w_down")


def load_bert(path: str, dtype=torch.float32,
              device="cuda") -> tuple[ModelConfig, dict]:
    """Load a BERT-family GGUF into (ModelConfig, params): every tensor
    dequantized to `dtype` on `device`, layers stacked on a leading L
    axis; a tensor the file lacks is left out of the tree (the JAX tree
    holds None there)."""
    dev = torch.device(device)
    with GGUFFile(path) as g:
        cfg = ModelConfig.from_gguf(g)
        pooling = _POOLING.get(
            int(g.metadata.get(f"{cfg.arch}.pooling_type", 1)), "mean")
        cfg = dataclasses.replace(cfg, causal=False, pooling=pooling)

        def t(name: str, transpose: bool):
            if name not in g.tensors:
                return None
            x = g.tensor_f32(name)
            if transpose and x.ndim == 2:
                x = x.T
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

        params = {k: t(name, tr) for k, (name, tr) in _ROOT.items()}
        layers = [{k: t(f"blk.{i}.{name}", tr)
                   for k, (name, tr) in _LAYER.items()}
                  for i in range(cfg.n_layers)]
    params = {k: v for k, v in params.items() if v is not None}
    params["layers"] = {k: torch.stack([lay[k] for lay in layers])
                        for k in layers[0] if layers[0][k] is not None}
    SRV_INF("load_bert", "arch=%s layers=%d embd=%d pooling=%s device=%s",
            cfg.arch, cfg.n_layers, cfg.n_embd, cfg.pooling, dev)
    return cfg, params


def bert_params_from_numpy(params_np: dict, cfg: ModelConfig,
                           device="cpu", dtype=None) -> dict:
    """Carry a JAX BERT param tree (after `jax.tree.map(np.asarray,
    params)`) into torch on `device`: same keys and [in, out] layouts,
    the JAX leaves' dtype unless `dtype` is given; None leaves are left
    out."""
    del cfg  # the tree carries its own shapes; kept for the JAX signature

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items() if v is not None}
        t = _torch_dtype_of(np.asarray(x))
        return t.to(device, dtype) if dtype is not None else t.to(device)
    return conv(params_np)


def check_bert_supported(cfg: ModelConfig, params: dict) -> None:
    """Raise NotImplementedError for a BERT-family tree the encoder cannot
    run: a layer key it reads is missing (nomic-bert's fused attn_qkv is
    not loaded, as in the JAX loader), or the heads do not split the
    width. The engine runs this check instead of the llama one."""
    missing = [k for k in _REQUIRED_LAYER
               if k not in params.get("layers", {})]
    if "tok_embd" not in params:
        missing.append("tok_embd")
    if missing or cfg.n_heads <= 0 or cfg.n_embd % cfg.n_heads:
        raise NotImplementedError(
            f"{cfg.arch}: not on the ported BERT encoder (missing "
            f"{missing}, {cfg.n_heads} heads over {cfg.n_embd})")


def _ln(x, w, b, eps):
    """JAX bert `_ln` through the row-norm kernel on the card (f32
    statistics, one rounding to x's dtype; a missing weight is ones)."""
    if w is None:
        w = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
    return norm_any(x, w, b, "ln", eps)


def bert_forward(params, cfg: ModelConfig, tokens, seq_lens,
                 pooling: str = "mean") -> torch.Tensor:
    """tokens [B, T], seq_lens [B] (host arrays or tensors) -> pooled
    [B, E] ("mean", "cls", "last"; any other name pools by mean, as in
    JAX) or [B] scores ("rank": the tanh `cls` head on the [CLS] row, then
    `cls_out`, column 0), in the params' dtype. Padded key positions get
    the -1e30 score; every op stays on the params' device."""
    emb = params["tok_embd"]
    dev = emb.device
    tokens = torch.as_tensor(tokens).to(dev, torch.int64)
    seq_lens = torch.as_tensor(seq_lens).to(dev, torch.int64)
    B, T = tokens.shape
    H, E = cfg.n_heads, cfg.n_embd
    D = E // H
    eps = cfg.rms_eps

    x = emb[tokens.clamp(0, emb.shape[0] - 1)]
    if "type_embd" in params:
        x = x + params["type_embd"][0]
    if "pos_embd" in params:
        x = x + params["pos_embd"][:T][None, :, :]
    x = _ln(x, params.get("embd_norm"), params.get("embd_norm_b"), eps)

    valid = torch.arange(T, device=dev)[None, :] < seq_lens[:, None]
    masked = ~valid[:, None, None, :]                       # [B, 1, 1, T]

    layers = {k: v.unbind(0) for k, v in params["layers"].items()}
    for li in range(cfg.n_layers):
        lp = {k: v[li] for k, v in layers.items()}

        def lin(h, w, b):
            y = torch.matmul(h, lp[w])
            return y + lp[b] if b in lp else y

        q = lin(x, "wq", "bq").reshape(B, T, H, D).transpose(1, 2)
        k = lin(x, "wk", "bk").reshape(B, T, H, D).transpose(1, 2)
        v = lin(x, "wv", "bv").reshape(B, T, H, D).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)) * (D ** -0.5)
        scores = scores.masked_fill(masked, -1e30)
        probs = torch.softmax(scores, dim=-1)
        attn = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, E)
        attn = lin(attn, "wo", "bo")
        x = _ln(x + attn, lp.get("attn_norm"), lp.get("attn_norm_b"), eps)
        h = torch.nn.functional.gelu(lin(x, "w_up", "b_up"),
                                     approximate="none")
        h = lin(h, "w_down", "b_down")
        x = _ln(x + h, lp.get("ffn_norm"), lp.get("ffn_norm_b"), eps)

    if pooling == "rank":
        # classification head on [CLS] (jina-reranker semantics)
        h = x[:, 0]
        if "cls" in params:
            h = torch.tanh(torch.matmul(h, params["cls"])
                           + params.get("cls_b", 0.0))
        if "cls_out" in params:
            h = torch.matmul(h, params["cls_out"]) \
                + params.get("cls_out_b", 0.0)
        return h[:, 0] if h.dim() == 2 and h.shape[-1] >= 1 else h
    if pooling == "cls":
        return x[:, 0]
    if pooling == "last":
        idx = (seq_lens - 1).clamp_min(0)
        return x[torch.arange(B, device=dev), idx]
    w = valid.to(x.dtype)
    return (x * w[:, :, None]).sum(1) / w.sum(1)[:, None].clamp_min(1.0)
