"""The selective scan of the mamba mixers (the recurrence of
llama_box_tpu/models/mamba.py `_mixer` and `_mixer2`, which JAX runs as an
associative scan).

`ssm_scan` launches the hand-written kernel csrc/ssm_scan.cu on a CUDA
tensor and runs `ssm_scan_plain`, the same recurrence written out in torch
a row at a time in the kernel's order of operations, on a CPU tensor:

    x:        [S, T, C]   the conv output after silu
    dt:       [S, T, nh]  after softplus (mamba1: nh = C, a step per
                          channel; mamba2: a step per head of hd = C / nh)
    A:        [C, ds]     mamba1's decay per channel and state, or
              [nh]        mamba2's per head
    B, Cm:    [S, T, G, ds]  head h reads group h // (nh // G)
    D:        [nh]        the skip
    seq_lens: [S] int     valid rows a slot
    state:    [S, C, ds]  (mamba2's [S, nh, hd, ds] viewed so), f32,
                          updated in place

At rows t < seq_lens[s]: h = exp(dt * A) * h + (dt * x) * B; every row's
output is y = sum_n h * Cm + D * x, [S, T, C] f32. Rows from seq_lens[s]
on leave the state's bits as they are (JAX's identity elements), and a
slot with seq_lens 0 is not written. The order of the sums differs from
JAX's scan, so the two agree within f32 rounding; a prefill split in two
gives the bits of the whole, and a one-row decode step those of a one-row
prefill, on the card (tests/test_torch_gpu.py).
"""

from __future__ import annotations

import torch

from . import _kernels

MAX_STATE = 256     # the largest ds csrc/ssm_scan.cu takes


def _heads(x, dt, A):
    C, nh = x.shape[-1], dt.shape[-1]
    if C % nh:
        raise ValueError(f"ssm_scan: {nh} steps a row do not divide {C} "
                         "channels")
    return C // nh, A.dim() == 2


def ssm_scan_plain(x, dt, A, B, Cm, D, seq_lens, state) -> torch.Tensor:
    """The plain torch version (any device); see the module docstring."""
    S, T, C = x.shape
    hd, per_state = _heads(x, dt, A)
    G = B.shape[2]
    rep = (C // hd) // G * hd           # channels a group of B / Cm feeds
    Af = A.float() if per_state else A.float().repeat_interleave(hd)[:, None]
    Dc = D.float().repeat_interleave(hd)
    lens = seq_lens.to(x.device).long()
    h = state.float().clone()
    ys = []
    for t in range(T):
        dtt = dt[:, t].float().repeat_interleave(hd, dim=-1)    # [S, C]
        xt = x[:, t].float()
        Bt = B[:, t].float().repeat_interleave(rep, dim=1)      # [S, C, ds]
        Ct = Cm[:, t].float().repeat_interleave(rep, dim=1)
        dA = torch.exp(dtt[..., None] * Af)
        hn = dA * h + (dtt * xt)[..., None] * Bt
        h = torch.where((t < lens)[:, None, None], hn, h)
        ys.append((h * Ct).sum(-1) + Dc * xt)
    state.copy_(h)
    return torch.stack(ys, dim=1) if ys else x.new_zeros(S, 0, C)


def ssm_scan(x, dt, A, B, Cm, D, seq_lens, state) -> torch.Tensor:
    """One launch of csrc/ssm_scan.cu on CUDA tensors, the plain version
    on CPU ones; see the module docstring."""
    if not x.is_cuda:
        return ssm_scan_plain(x, dt, A, B, Cm, D, seq_lens, state)
    S, T, C = x.shape
    hd, per_state = _heads(x, dt, A)
    G, ds = B.shape[2], B.shape[3]
    f32 = torch.float32
    if state.dtype != f32 or not state.is_contiguous() \
            or state.numel() != S * C * ds:
        raise ValueError(f"ssm_scan: the state must be a contiguous f32 "
                         f"[{S}, {C}, {ds}], not {state.dtype} "
                         f"{tuple(state.shape)}")
    if ds > MAX_STATE or (C // hd) % G:
        raise ValueError(f"ssm_scan: {ds} states a channel (at most "
                         f"{MAX_STATE}) over {G} groups of {C // hd} heads")

    def c(t):
        return t.to(f32).contiguous()

    y = torch.empty(S, T, C, dtype=f32, device=x.device)
    _kernels.call("ssm_scan", "lbt_ssm_scan", c(x), c(dt), c(A), c(B),
                  c(Cm), c(D), seq_lens.to(torch.int32).contiguous(), state,
                  y, S, T, C, hd, G, ds, int(per_state))
    ssm_scan.launches += 1
    return y


ssm_scan.launches = 0   # kernel launches (chip_smoke reads it)
