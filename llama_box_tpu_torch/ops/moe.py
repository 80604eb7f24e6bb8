"""The routed experts of a mixture-of-experts FFN (the expert part of
llama_box_tpu/models/llama.py `_moe_mix`).

`moe_ffn` launches the hand-written kernel csrc/moe_ffn.cu on a CUDA tensor
and runs `moe_ffn_plain`, the same function written out in torch, on a CPU
tensor. Both take the router's picks, not a dense routing mask:

    h:        [N, E]      the FFN input rows (bf16 on the card)
    topi:     [N, K] int  the experts each row picked (distinct in a row)
    topv:     [N, K]      their routing weights
    w_gate:   [X, E, F]   the expert stacks, the JAX loader's layouts
    w_up:     [X, E, F]
    w_down:   [X, F, E]
    b_gate, b_up [X, F], b_down [X, E]: gpt-oss's per-expert biases, or None

and return y [N, E] f32 = sum over k of topv[n, k] x down(act(gate, up))
(+ b_down inside the weighted term), times `scale`. With `weight_before`
(llama4) the weight scales the expert input instead and the terms add
unweighted. The activations: silu, gelu (tanh), relu2, each gating up,
and gpt-oss's clamped swiglu_oai.

JAX computes every expert densely in f32 under a 0/weight mask and sums
the X terms in expert order; the unrouted terms are exact zeros. So each
row's K terms are summed here in ascending expert index, in f32, and the
expert products run in f32 on the bf16 inputs (the kernel: exact bf16
products, f32 accumulation; its activations enter the down product as a
bf16 pair hi + lo, about 16 bits of mantissa).
"""

from __future__ import annotations

import torch

from . import _kernels

ACTS = ("silu", "gelu", "relu2", "swiglu_oai")
# gpt-oss's clamped swiglu constants (fixed model constants, as in JAX)
SWIGLU_OAI_ALPHA, SWIGLU_OAI_LIMIT = 1.702, 7.0
# what csrc/moe_ffn.cu takes: the tile rows of its sort (BM), the most
# picks a row, the most experts; widths a multiple of 8 (16-byte rows)
TILE_ROWS, MAX_PICKS, MAX_EXPERTS = 64, 64, 4096


def expert_act(gate: torch.Tensor, up: torch.Tensor, act: str) -> torch.Tensor:
    """The f32 expert activation of JAX `_moe_mix`: act(gate) * up, or
    swiglu_oai's (clamped up + 1) * gate * sigmoid(alpha * gate) with the
    gate clamped above."""
    if act == "swiglu_oai":
        gate = gate.clamp_max(SWIGLU_OAI_LIMIT)
        up = up.clamp(-SWIGLU_OAI_LIMIT, SWIGLU_OAI_LIMIT)
        return (up + 1.0) * gate * torch.sigmoid(gate * SWIGLU_OAI_ALPHA)
    if act == "gelu":
        a = torch.nn.functional.gelu(gate, approximate="tanh")
    elif act == "relu2":
        a = torch.square(torch.relu(gate))
    else:
        a = torch.nn.functional.silu(gate)
    return a * up


def moe_ffn_plain(h, topi, topv, w_gate, w_up, w_down, *, act: str = "silu",
                  b_gate=None, b_up=None, b_down=None,
                  weight_before: bool = False,
                  scale: float = 1.0) -> torch.Tensor:
    """The plain torch version (any device): each routed expert's rows by
    index_select, in f32, then each row's picks summed in expert order."""
    N, E = h.shape
    K = topi.shape[1]
    hf = h.float()
    flat_i = topi.reshape(-1).long()
    flat_v = topv.reshape(-1).float()
    out = hf.new_zeros(N * K, E)
    for x in torch.unique(flat_i).tolist():
        idx = (flat_i == x).nonzero().squeeze(1)
        hx = hf.index_select(0, torch.div(idx, K, rounding_mode="floor"))
        if weight_before:
            hx = hx * flat_v[idx, None]
        gate = hx @ w_gate[x].float()
        up = hx @ w_up[x].float()
        if b_gate is not None:
            gate = gate + b_gate[x].float()
        if b_up is not None:
            up = up + b_up[x].float()
        o = expert_act(gate, up, act) @ w_down[x].float()
        if b_down is not None:
            o = o + b_down[x].float()
        out[idx] = o
    out = out.view(N, K, E)
    order = torch.sort(topi.long(), dim=1, stable=True).indices
    rows = torch.arange(N, device=h.device)
    y = None
    for j in range(K):
        k = order[:, j]
        term = out[rows, k]
        if not weight_before:
            term = term * topv.float()[rows, k][:, None]
        y = term if y is None else y + term
    if scale != 1.0:
        y = y * scale
    return y


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"moe_ffn: {what}")


def moe_ffn(h, topi, topv, w_gate, w_up, w_down, *, act: str = "silu",
            b_gate=None, b_up=None, b_down=None, weight_before: bool = False,
            scale: float = 1.0, out=None) -> torch.Tensor:
    """The routed experts (see the module docstring): csrc/moe_ffn.cu on a
    CUDA h, moe_ffn_plain on a CPU h. `out` ([N, E] f32 on the card) takes
    the result in place of a new tensor."""
    if not h.is_cuda:
        return moe_ffn_plain(h, topi, topv, w_gate, w_up, w_down, act=act,
                             b_gate=b_gate, b_up=b_up, b_down=b_down,
                             weight_before=weight_before, scale=scale)
    N, E = h.shape
    K = topi.shape[1]
    X, _, F = w_gate.shape
    dev = h.device
    _check(act in ACTS, f"activation {act!r} (the kernel takes {ACTS})")
    _check(h.dtype == torch.bfloat16, f"h dtype {h.dtype}")
    for name, w, shape in (("w_gate", w_gate, (X, E, F)),
                           ("w_up", w_up, (X, E, F)),
                           ("w_down", w_down, (X, F, E))):
        _check(w.dtype == torch.bfloat16 and w.device == dev
               and tuple(w.shape) == shape and w.is_contiguous()
               and w.data_ptr() % 16 == 0,
               f"{name} must be a contiguous bf16 {shape} stack on {dev} "
               f"(got {w.dtype} {tuple(w.shape)})")
    _check(E % 8 == 0 and F % 8 == 0, f"widths E {E}, F {F} (multiples of 8)")
    _check(1 <= K <= min(X, MAX_PICKS) and X <= MAX_EXPERTS,
           f"{K} picks of {X} experts")
    _check(tuple(topi.shape) == (N, K) and tuple(topv.shape) == (N, K),
           "topi/topv shape")
    h = h.contiguous()
    if h.data_ptr() % 16:
        h = h.clone()
    topi = topi.to(dev, torch.int32).contiguous()
    topv = topv.to(dev, torch.float32).contiguous()
    biases = []
    for name, b, n in (("b_gate", b_gate, F), ("b_up", b_up, F),
                       ("b_down", b_down, E)):
        if b is not None:
            _check(tuple(b.shape) == (X, n), f"{name} shape")
            b = b.to(dev, torch.float32).contiguous()
        biases.append(b)
    _check((biases[0] is None) == (biases[1] is None),
           "b_gate and b_up go together")
    tiles = (N * K + X * (TILE_ROWS - 1)) // TILE_ROWS
    P = tiles * TILE_ROWS
    sorted_pairs = torch.empty(P, dtype=torch.int32, device=dev)
    tile_expert = torch.empty(max(tiles, 1), dtype=torch.int32, device=dev)
    n_tiles = torch.empty(1, dtype=torch.int32, device=dev)
    act_buf = torch.empty((2, P, F), dtype=torch.bfloat16, device=dev)
    pair_out = torch.empty((N * K, E), dtype=torch.float32, device=dev)
    if out is None:
        out = torch.empty((N, E), dtype=torch.float32, device=dev)
    _check(out.dtype == torch.float32 and tuple(out.shape) == (N, E)
           and out.is_contiguous() and out.device == dev, "out")
    _kernels.call(
        "moe_ffn", "lbt_moe_ffn", h, topi, topv, w_gate, w_up, w_down,
        *biases, sorted_pairs, tile_expert, n_tiles, act_buf, pair_out, out,
        N, K, X, E, F, ACTS.index(act), int(weight_before), float(scale))
    moe_ffn.launches += 1
    return out


moe_ffn.launches = 0   # kernel launches (chip_smoke reads it)
