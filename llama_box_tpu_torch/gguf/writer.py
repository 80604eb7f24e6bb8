"""GGUF v3 writer — used for test fixtures and model conversion tooling."""

from __future__ import annotations

import struct
from typing import Any, BinaryIO

import numpy as np

from .constants import (
    GGMLType,
    GGUFValueType,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
)
from .quants import quantize


def _pack_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


_SCALAR_PACK = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<B",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


def _infer_type(v: Any) -> GGUFValueType:
    if isinstance(v, bool):
        return GGUFValueType.BOOL
    if isinstance(v, int):
        return GGUFValueType.INT64 if (v < 0 or v > 0xFFFFFFFF) else GGUFValueType.UINT32
    if isinstance(v, float):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF type of {type(v)}")


def _pack_value(v: Any, vtype: GGUFValueType) -> bytes:
    if vtype == GGUFValueType.STRING:
        return _pack_string(v)
    if vtype == GGUFValueType.ARRAY:
        if isinstance(v, np.ndarray):
            npmap = {
                np.dtype(np.float32): GGUFValueType.FLOAT32,
                np.dtype(np.int32): GGUFValueType.INT32,
                np.dtype(np.uint32): GGUFValueType.UINT32,
                np.dtype(np.int64): GGUFValueType.INT64,
                np.dtype(np.uint64): GGUFValueType.UINT64,
                np.dtype(np.float64): GGUFValueType.FLOAT64,
                np.dtype(np.int16): GGUFValueType.INT16,
                np.dtype(np.uint16): GGUFValueType.UINT16,
                np.dtype(np.int8): GGUFValueType.INT8,
                np.dtype(np.uint8): GGUFValueType.UINT8,
            }
            etype = npmap[v.dtype]
            body = v.astype(v.dtype.newbyteorder("<")).tobytes()
            return struct.pack("<IQ", int(etype), v.size) + body
        if len(v) == 0:
            return struct.pack("<IQ", int(GGUFValueType.UINT32), 0)
        first = v[0]
        etype = _infer_type(first)
        if etype == GGUFValueType.STRING:
            return struct.pack("<IQ", int(etype), len(v)) + b"".join(_pack_string(s) for s in v)
        if isinstance(first, float):
            etype = GGUFValueType.FLOAT32
        elif isinstance(first, bool):
            etype = GGUFValueType.BOOL
        elif isinstance(first, int):
            lo, hi = min(v), max(v)
            etype = GGUFValueType.INT32 if lo < 0 else GGUFValueType.UINT32
            if hi > 0x7FFFFFFF and lo >= 0:
                etype = GGUFValueType.UINT64
            elif lo < -0x80000000 or hi > 0x7FFFFFFF:
                etype = GGUFValueType.INT64
        fmt = _SCALAR_PACK[etype]
        return struct.pack("<IQ", int(etype), len(v)) + b"".join(
            struct.pack(fmt, int(x) if etype != GGUFValueType.FLOAT32 else float(x)) for x in v
        )
    return struct.pack(_SCALAR_PACK[vtype], v)


class GGUFWriter:
    def __init__(self, path: str, architecture: str | None = None,
                 alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = path
        self.alignment = alignment
        self.kv: list[tuple[str, GGUFValueType, Any]] = []
        self.tensor_meta: list[tuple[str, tuple[int, ...], GGMLType, int]] = []
        self.tensor_data: list[bytes] = []
        self._data_size = 0
        if architecture:
            self.add_kv("general.architecture", architecture)

    def add_kv(self, key: str, value: Any, vtype: GGUFValueType | None = None) -> None:
        self.kv.append((key, vtype or _infer_type(value), value))

    def add_tensor(self, name: str, array: np.ndarray,
                   ggml_type: GGMLType = GGMLType.F32) -> None:
        """array is in numpy row-major logical shape; quantized along last axis.

        Falls back to a finer format when the row length is not a multiple of
        the block size (mirroring llama.cpp's quantization fallback)."""
        from .constants import GGML_BLOCK_SIZES
        row = array.shape[-1] if array.ndim else 1
        blk = GGML_BLOCK_SIZES[ggml_type][0]
        if row % blk != 0:
            ggml_type = GGMLType.Q8_0 if row % 32 == 0 else GGMLType.F16
        data = quantize(ggml_type, np.ascontiguousarray(array, dtype=np.float32))
        offset = self._data_size
        self.tensor_meta.append((name, tuple(array.shape), ggml_type, offset))
        pad = (-len(data)) % self.alignment
        self.tensor_data.append(data + b"\x00" * pad)
        self._data_size += len(data) + pad

    def add_raw_tensor(self, name: str, shape: tuple, ggml_type: GGMLType,
                       data: bytes) -> None:
        """A tensor whose bytes are already in ggml_type's block layout
        (shape in numpy row-major logical order, as add_tensor)."""
        offset = self._data_size
        self.tensor_meta.append((name, tuple(shape), ggml_type, offset))
        pad = (-len(data)) % self.alignment
        self.tensor_data.append(data)
        if pad:
            self.tensor_data.append(b"\x00" * pad)
        self._data_size += len(data) + pad

    def write(self) -> None:
        with open(self.path, "wb") as f:
            f.write(GGUF_MAGIC)
            f.write(struct.pack("<IQQ", GGUF_VERSION, len(self.tensor_meta), len(self.kv)))
            for key, vtype, value in self.kv:
                f.write(_pack_string(key))
                f.write(struct.pack("<I", int(vtype)))
                f.write(_pack_value(value, vtype))
            for name, shape, ggml_type, offset in self.tensor_meta:
                f.write(_pack_string(name))
                dims = list(reversed(shape))  # ggml order
                f.write(struct.pack("<I", len(dims)))
                for d in dims:
                    f.write(struct.pack("<Q", d))
                f.write(struct.pack("<IQ", int(ggml_type), offset))
            pos = f.tell()
            f.write(b"\x00" * ((-pos) % self.alignment))
            for blob in self.tensor_data:
                f.write(blob)
