"""The matrix-state recurrences of the linear-attention mixers: rwkv6's and
rwkv7's WKV (llama_box_tpu/models/rwkv.py `_wkv6_scan`, `_wkv7_scan` and
rwkv7's per-token step) and qwen3-next's gated delta rule (the lax.scan of
llama_box_tpu/models/mamba.py `_mixer_deltanet`).

Each wrapper launches the hand-written kernel csrc/wkv.cu on CUDA tensors
(one block a slot and head, the [N, N] state in registers along T) and
runs its plain version, written out in torch a row at a time in the
kernel's order of operations, on CPU ones. Every input is f32; per-step
vectors are [S, T, H, N]; the state [S, H, N, N] f32 is updated in place;
seq_lens [S] counts the valid rows a slot. Rows from seq_lens[s] on leave
the state's bits as they are and their outputs read it as it stands (the
masking of the JAX scans); a slot with seq_lens 0 is not written. The
outputs are y [S, T, H, N] f32.

- wkv6(r, k, v, w, u): state S[i, j] (key i, value j);
  y[j] = sum_i r[i] (S[i, j] + u[i] k[i] v[j]), then S = diag(w) S + k v^T.
- wkv7(r, w, k, v, kk, a): state S[i, l] (value i, key l);
  S = S diag(w) + (S (-kk)) (kk a)^T + v k^T, then y = S r.
- delta_rule(q, k, v, alpha, beta): q, k [S, T, Hk, N] shared by H / Hk
  v-heads each, alpha, beta [S, T, H]; state S[i, j] (key i, value j);
  S *= alpha, S += k (beta (v - S^T k))^T, then y = S^T q.

JAX's chunked scans sum in another order, so the two agree within f32
rounding; on the card a prefill split in two gives the bits of the whole,
and a one-row decode step those of a one-row prefill
(tests/test_torch_gpu.py).
"""

from __future__ import annotations

import torch

from . import _kernels

WIDTHS = (16, 32, 64, 128)     # the state widths N csrc/wkv.cu takes


def _valid(seq_lens, t):
    return (t < seq_lens.long())[:, None, None, None]


def wkv6_plain(r, k, v, w, u, seq_lens, state) -> torch.Tensor:
    s = state.clone()
    ys = []
    for t in range(r.shape[1]):
        ok = _valid(seq_lens, t)
        kv = torch.where(ok, k[:, t, :, :, None] * v[:, t, :, None, :], 0.0)
        ys.append((r[:, t, :, :, None] * (s + u[None, :, :, None] * kv))
                  .sum(-2))
        s = torch.where(ok, w[:, t, :, :, None] * s + kv, s)
    state.copy_(s)
    return torch.stack(ys, dim=1)


def wkv7_plain(r, w, k, v, kk, a, seq_lens, state) -> torch.Tensor:
    s = state.clone()
    ys = []
    for t in range(r.shape[1]):
        ok = _valid(seq_lens, t)
        sa = (s * (-kk[:, t, :, None, :])).sum(-1)             # [S, H, N]
        s1 = (s * w[:, t, :, None, :]
              + sa[..., :, None] * (kk[:, t] * a[:, t])[:, :, None, :]
              + v[:, t, :, :, None] * k[:, t, :, None, :])
        s = torch.where(ok, s1, s)
        ys.append((s * r[:, t, :, None, :]).sum(-1))
    state.copy_(s)
    return torch.stack(ys, dim=1)


def delta_rule_plain(q, k, v, alpha, beta, seq_lens, state) -> torch.Tensor:
    R = v.shape[2] // q.shape[2]
    qh = q.repeat_interleave(R, dim=2)
    kh = k.repeat_interleave(R, dim=2)
    s = state.clone()
    ys = []
    for t in range(q.shape[1]):
        ok = _valid(seq_lens, t)
        sg = s * alpha[:, t, :, None, None]
        kv = (sg * kh[:, t, :, :, None]).sum(-2)               # [S, H, N]
        d = (v[:, t] - kv) * beta[:, t, :, None]
        s = torch.where(ok, sg + kh[:, t, :, :, None] * d[:, :, None, :], s)
        ys.append((s * qh[:, t, :, :, None]).sum(-2))
    state.copy_(s)
    return torch.stack(ys, dim=1)


def wkv_kernel(mode: int, r, k, v, w, e, f, u, seq_lens, state, H: int,
               Hk: int) -> torch.Tensor:
    """One launch of csrc/wkv.cu (mode 0 rwkv6, 1 rwkv7, 2 the delta rule;
    the operands as lbt_wkv takes them); wkv_kernel.launches counts them
    over the three rules (chip_smoke reads it)."""
    S, T = r.shape[:2]
    N = v.shape[-1]
    f32 = torch.float32
    if N not in WIDTHS or r.shape[-1] != N:
        raise ValueError(f"wkv: state widths {WIDTHS} with equal key and "
                         f"value widths, not {r.shape[-1]} x {N}")
    if state.dtype != f32 or not state.is_contiguous() \
            or tuple(state.shape) != (S, H, N, N):
        raise ValueError(f"wkv: the state must be a contiguous f32 "
                         f"[{S}, {H}, {N}, {N}], not {state.dtype} "
                         f"{tuple(state.shape)}")

    def c(t):
        return None if t is None else t.to(f32).contiguous()

    y = torch.empty(S, T, H, N, dtype=f32, device=v.device)
    _kernels.call("wkv", "lbt_wkv", mode, c(r), c(k), c(v), c(w), c(e), c(f),
                  c(u), seq_lens.to(torch.int32).contiguous(), state, y, S, T,
                  H, Hk, N)
    wkv_kernel.launches += 1
    return y


wkv_kernel.launches = 0


def wkv6(r, k, v, w, u, seq_lens, state) -> torch.Tensor:
    if not r.is_cuda:
        return wkv6_plain(r, k, v, w, u, seq_lens, state)
    return wkv_kernel(0, r, k, v, w, None, None, u, seq_lens, state,
                      r.shape[2], r.shape[2])


def wkv7(r, w, k, v, kk, a, seq_lens, state) -> torch.Tensor:
    if not r.is_cuda:
        return wkv7_plain(r, w, k, v, kk, a, seq_lens, state)
    return wkv_kernel(1, r, k, v, w, kk, a, None, seq_lens, state,
                      r.shape[2], r.shape[2])


def delta_rule(q, k, v, alpha, beta, seq_lens, state) -> torch.Tensor:
    if not q.is_cuda:
        return delta_rule_plain(q, k, v, alpha, beta, seq_lens, state)
    return wkv_kernel(2, q, k, v, None, alpha, beta, None, seq_lens, state,
                      v.shape[2], q.shape[2])
