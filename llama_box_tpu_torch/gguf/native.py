"""Build and load the port's host grammar core (counterpart of
llama_box_tpu/gguf/native.py, restricted to the grammar entry points that
grammar.py binds).

`native/grammar_core.cpp` beside the package is compiled by the host C++
compiler, at first use, into one shared library under
`build/torch_native/` beside the package (the repository root in a
checkout), keyed by a hash of the source and the flags, and loaded with
ctypes. Nothing here runs at import, and nothing falls back: no compiler,
a failed build or a failed dlopen raises (the JAX package's switch
that turns its native library off, and its quiet numpy fallback, are not
ported; grammar.py's pure-Python matcher is the core's plain version,
used by the tests).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "native" / "grammar_core.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _cxx() -> str:
    for cand in (os.environ.get("CXX", ""), "g++", "c++", "clang++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError("no C++ compiler found (g++, c++ or clang++; or set "
                       "CXX); the grammar core is built from "
                       f"{SRC.name} at first use")


def lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"grammar_core-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the grammar core unless its library exists; returns it."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([_cxx(), *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"building {SRC.name} failed:\n{r.stdout}"
                           f"{r.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.lbox_gram_new.restype = ctypes.c_void_p
    lib.lbox_gram_new.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32]
    lib.lbox_gram_free.argtypes = [ctypes.c_void_p]
    lib.lbox_gram_state_new.restype = ctypes.c_void_p
    lib.lbox_gram_state_new.argtypes = [ctypes.c_void_p]
    lib.lbox_gram_state_copy.restype = ctypes.c_void_p
    lib.lbox_gram_state_copy.argtypes = [ctypes.c_void_p]
    lib.lbox_gram_state_free.argtypes = [ctypes.c_void_p]
    for fn in (lib.lbox_gram_accept_bytes, lib.lbox_gram_try_bytes):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, u8p,
                       ctypes.c_int64]
    lib.lbox_gram_completed.restype = ctypes.c_int
    lib.lbox_gram_completed.argtypes = [ctypes.c_void_p]
    lib.lbox_gram_must_stop.restype = ctypes.c_int
    lib.lbox_gram_must_stop.argtypes = [ctypes.c_void_p]
    lib.lbox_gram_filter.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, u8p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, u8p]


def grammar_lib() -> ctypes.CDLL:
    """The grammar core, built and bound at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _lib = lib
        return _lib
