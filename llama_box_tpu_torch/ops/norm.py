"""Normalization ops (counterpart of llama_box_tpu/ops/norm.py and of the
norms of llama_box_tpu/models/llama.py: `_norm_any`, `_ln_per_head`).

Each wrapper launches the hand-written row-norm kernel csrc/norm.cu on a
CUDA tensor and runs its plain version, written out in torch, on a CPU
tensor. The statistics run in f32 and the result is cast back to the input
dtype: the rounding points of the JAX functions. The kernel sums each row
in an order fixed by the row length alone, so a row's bits do not depend
on how many rows share the call (a verify pass's rows are its one-row
decode steps' rows); torch's mean on the card does not promise that."""

from __future__ import annotations

import torch

from . import _kernels


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def norm_any_plain(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor | None, style: str,
                   eps: float) -> torch.Tensor:
    """JAX `_norm_any`: LayerNorm (with an optional bias) for style "ln",
    else RMSNorm."""
    if style != "ln":
        return rms_norm_plain(x, weight, eps)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mu).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def ln_per_head_plain(t: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """JAX `_ln_per_head` (chameleon): LayerNorm over the head dim of t
    [..., H, D] with a weight and bias of their own a head (stored
    flattened [H * D]); eps 1e-5 as in JAX."""
    Hn, D = t.shape[-2:]
    tf = t.float()
    mu = tf.mean(-1, keepdim=True)
    var = torch.square(tf - mu).mean(-1, keepdim=True)
    y = (tf - mu) * torch.rsqrt(var + eps)
    y = y * weight.float().reshape(Hn, D) + bias.float().reshape(Hn, D)
    return y.to(t.dtype)


def row_norm(x: torch.Tensor, weight: torch.Tensor,
             bias: torch.Tensor | None, ln: bool, eps: float,
             groups: int = 1) -> torch.Tensor:
    """One launch of csrc/norm.cu over the rows of x [..., n]; weight and
    bias hold `groups` rows of n (row r of x takes row r mod groups)."""
    n = x.shape[-1]
    ok = (torch.bfloat16, torch.float32)
    if x.dtype not in ok or weight.dtype not in ok:
        raise ValueError(f"norm: dtypes {x.dtype} / {weight.dtype}")
    if weight.numel() != groups * n or weight.device != x.device:
        raise ValueError(f"norm: weight of {weight.numel()} elements on "
                         f"{weight.device} for {groups} x {n} on {x.device}")
    if bias is not None and (bias.numel() != groups * n
                             or bias.dtype != weight.dtype
                             or bias.device != x.device):
        raise ValueError(f"norm: bias of {bias.numel()} {bias.dtype} "
                         f"elements on {bias.device}")
    weight = weight.contiguous()
    bias = None if bias is None else bias.contiguous()
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()   # the kernel loads 16 bytes at a time
    out = torch.empty_like(x)
    rows = x.numel() // n if n else 0
    codes = _kernels.DTYPE_CODES
    _kernels.call("norm", "lbt_norm", codes[x.dtype], codes[weight.dtype],
                  int(ln), x, weight, bias, out, rows, n, groups, float(eps))
    row_norm.launches += 1
    return out


row_norm.launches = 0   # kernel launches (chip_smoke reads it)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    if not x.is_cuda:
        return rms_norm_plain(x, weight, eps)
    return row_norm(x, weight, None, False, eps)


def norm_any(x: torch.Tensor, weight: torch.Tensor,
             bias: torch.Tensor | None, style: str,
             eps: float) -> torch.Tensor:
    if not x.is_cuda:
        return norm_any_plain(x, weight, bias, style, eps)
    if style != "ln":
        return row_norm(x, weight, None, False, eps)
    return row_norm(x, weight, bias, True, eps)


def ln_per_head(t: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    if not t.is_cuda:
        return ln_per_head_plain(t, weight, bias, eps)
    return row_norm(t, weight, bias, True, eps, groups=t.shape[-2])
