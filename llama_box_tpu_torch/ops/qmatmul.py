"""Quantized-resident weights: QTensor + the w8a8 matmul (counterpart of
llama_box_tpu/ops/qmatmul.py, its default w8a8 residency).

The loader keeps every block-quant projection weight as per-output-column
symmetric int8 codes (`pack_w8a8`): one byte per weight, half the bytes of
bf16, which is what a decode step streams. A matmul quantizes its
activations per row to int8 and runs s8 x s8 -> s32 (`w8a8_matmul`): on a
CUDA tensor it launches the hand-written kernel csrc/w8a8_matmul.cu, on a
CPU tensor it runs `w8a8_matmul_plain`, the same function in torch.

Layout ([in, out] matmul convention; the loader transposes GGUF [out, in]):
- qs int8 [in, out] (or a layer stack [L, in, out]);
- scales f32 [out] (or [L, out]): w[i, o] = qs[i, o] * scales[o].

The grouped and nibble-packed residencies of the JAX package (its
LLAMA_BOX_TPU_PACKED4 / _Q4_INT8 / _Q4_F32SCALES switches and their
Pallas kernels) are the next slice of the port; `mm` refuses such a
QTensor.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels


class QTensor:
    """Packed quantized 2D weight (or a [L, ...] stack of them), with the
    JAX QTensor's fields. `w8a8` marks per-column int8 weights with f32
    column scales; `group`/`packed4`/`mins` describe the grouped forms."""

    def __init__(self, qs: torch.Tensor, scales: torch.Tensor,
                 mins: torch.Tensor | None, in_dim: int, group: int,
                 packed4: bool, w8a8: bool = False):
        self.qs = qs
        self.scales = scales
        self.mins = mins
        self.in_dim = in_dim
        self.group = group
        self.packed4 = packed4
        self.w8a8 = w8a8

    @property
    def out_dim(self) -> int:
        return self.qs.shape[-1]

    def leaves(self) -> list[torch.Tensor]:
        return [t for t in (self.qs, self.scales, self.mins) if t is not None]

    def _map(self, fn) -> "QTensor":
        return QTensor(fn(self.qs), fn(self.scales),
                       None if self.mins is None else fn(self.mins),
                       self.in_dim, self.group, self.packed4, self.w8a8)

    def to(self, device) -> "QTensor":
        return self._map(lambda t: t.to(device))

    def unbind(self, dim: int = 0) -> list["QTensor"]:
        """Per-layer views of a layer-stacked QTensor (dim 0 only)."""
        if dim != 0:
            raise ValueError("QTensor.unbind: layers stack along dim 0")
        n = self.qs.shape[0]
        return [self._map(lambda t, i=i: t[i]) for i in range(n)]

    def __repr__(self):
        return (f"QTensor(in={self.in_dim}, out={self.out_dim}, "
                f"group={self.group}, packed4={self.packed4}, "
                f"w8a8={self.w8a8})")


def pack_repacked(rt, shape_in_out: tuple[int, int]) -> QTensor:
    """RepackedTensor (flat, GGUF [out, in] row-major order) -> QTensor in
    [in, out] layout, host tensors. The port's only residency so far is
    the JAX package's default, w8a8."""
    return pack_w8a8(rt, shape_in_out)


def pack_w8a8(rt, shape_in_out: tuple[int, int]) -> QTensor:
    """RepackedTensor -> per-column int8 residency (W8A8), host tensors.
    The group quantization is dequantized exactly, then requantized
    symmetric int8 per output column (the JAX arithmetic, in numpy, one
    tensor at a time)."""
    out_dim, in_dim = shape_in_out[1], shape_in_out[0]
    q = rt.q.reshape(out_dim, in_dim).astype(np.float32)
    scales = np.repeat(rt.scales.reshape(out_dim, in_dim // rt.group),
                       rt.group, axis=1)
    wf = q * scales
    if rt.mins is not None:
        wf = wf - np.repeat(rt.mins.reshape(out_dim, in_dim // rt.group),
                            rt.group, axis=1)
    wf = wf.T                                         # [in, out]
    col = np.maximum(np.abs(wf).max(axis=0), 1e-12) / 127.0   # [out]
    q8 = np.clip(np.round(wf / col), -127, 127).astype(np.int8)
    return QTensor(torch.from_numpy(np.ascontiguousarray(q8)),
                   torch.from_numpy(col.astype(np.float32)), None,
                   in_dim, in_dim, packed4=False, w8a8=True)


# -- the w8a8 matmul -----------------------------------------------------------


def _quant_rows(hf: torch.Tensor):
    """Per-row symmetric int8 of f32 rows: codes round(h / xs) (half to
    even) clipped to +-127, xs = max(amax, 1e-12) / 127 [..., 1] f32.
    Both divisions are true divisions by tensors: on CUDA, torch turns a
    division by a Python scalar into a multiply by its reciprocal, which
    moves xs by an ulp."""
    amax = hf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    xs = amax / torch.full_like(amax, 127.0)
    xq = torch.round(hf / xs).clamp(-127, 127).to(torch.int8)
    return xq, xs


def _int_dot(xq: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """s8 x s8 -> exact integer sums, as f32 (rounded once, as an s32 sum
    converted to f32). The sums are formed in float64, exact below 2**53,
    because CUDA has no general integer matmul."""
    return torch.matmul(xq.double(), qs.double()).float()


def w8a8_matmul_plain(x: torch.Tensor, qs: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """The plain torch version of the kernel (any device): x [M, in] any
    float dtype -> [M, out] f32 = s32(xq @ qs) * xs * scales."""
    xq, xs = _quant_rows(x.float())
    return _int_dot(xq, qs) * xs * scales.float()[None, :]


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"w8a8_matmul: {what}")


def w8a8_matmul(x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor, *,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """x [M, in] (bf16 or f32) -> [M, out] f32. A CUDA x launches
    csrc/w8a8_matmul.cu (a row-quantize pass, then the int8 GEMM); a CPU x
    takes the plain version. `out` may name a contiguous f32 [M, out]
    tensor to write into."""
    if not x.is_cuda:
        res = w8a8_matmul_plain(x, qs, scales)
        return res if out is None else out.copy_(res)
    M, K = x.shape
    N = qs.shape[-1]
    dev = x.device
    _check(x.dtype in (torch.bfloat16, torch.float32), f"x dtype {x.dtype}")
    _check(qs.dtype == torch.int8 and tuple(qs.shape) == (K, N),
           f"qs {qs.dtype} {tuple(qs.shape)} for x {tuple(x.shape)}")
    _check(K * 127 * 127 < 2 ** 31, f"in={K}: the s32 sum could overflow")
    _check(N % 4 == 0, f"out={N} must be a multiple of 4 (4-byte loads)")
    x = x.contiguous()
    qs = qs.contiguous()
    _check(qs.device == dev and qs.data_ptr() % 4 == 0,
           "qs must be a 4-byte aligned tensor on x's device")
    scales = scales.to(dev, torch.float32).contiguous()
    _check(tuple(scales.shape) == (N,), "scales shape")
    if out is None:
        out = torch.empty((M, N), dtype=torch.float32, device=dev)
    _check(out.dtype == torch.float32 and tuple(out.shape) == (M, N)
           and out.is_contiguous() and out.device == dev, "out")
    kp = (K + 15) // 16 * 16                  # codes rows padded to 16 B
    xq = torch.empty((M, kp), dtype=torch.int8, device=dev)
    xs = torch.empty((M,), dtype=torch.float32, device=dev)
    if M:
        _kernels.call("w8a8_matmul", "lbt_w8a8_matmul",
                      _kernels.DTYPE_CODES[x.dtype], x, qs, scales, xq, xs,
                      out, M, K, N)
        w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0   # kernel launches (chip_smoke reads it)


# -- reference implementation ----------------------------------------------------


def q_matmul_ref(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Dequantize-then-matmul in f32 (correctness baseline; the w8a8
    branch only, the grouped forms are the Q4 slice)."""
    if not w.w8a8:
        raise NotImplementedError(
            "grouped / packed QTensor: the Q4 slice of the port")
    wf = w.qs.float() * w.scales.float()[None, :]
    return x.float() @ wf


# -- dispatch ------------------------------------------------------------------


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul dispatch returning x's dtype: a dense tensor -> torch.matmul;
    a w8a8 QTensor -> w8a8_matmul. x: [..., in]."""
    if not isinstance(w, QTensor):
        return torch.matmul(x, w.to(x.dtype))
    if not w.w8a8:
        raise NotImplementedError(
            "grouped / packed (Q4/Q8 group-dequant) QTensor weights are the "
            "Q4 slice of the port, not ported yet")
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    return w8a8_matmul(xf, w.qs, w.scales).reshape(*lead, w.out_dim).to(
        x.dtype)
