"""Build and load the port's CUDA kernels (no JAX counterpart: the Pallas
kernels were compiled by JAX itself).

Each `csrc/<name>.cu` is compiled by nvcc, at first use, into its own shared
library with a plain C interface, under `build/torch_kernels/` beside the
package (the repository root in a checkout), keyed by a hash of the sources
and the flags. `build()` starts one nvcc per source, all at once. Libraries
are loaded with ctypes; `call()` passes device pointers and the current
stream as `c_void_p` and raises if the C entry returns non-zero (it returns
`cudaGetLastError()` after the launch, or -1 for an unsupported
configuration). Nothing here runs at import, and nothing falls back: a
missing nvcc, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("flash_prefill", "flash_decode", "w8a8_matmul", "fused_norm_qmm",
           "fused_layer_tail", "q_matmul", "norm", "moe_ffn", "ssm_scan",
           "wkv")
# --split-compile=0: each nvcc runs its optimizer over the file's kernels on
# every core, so the sources with dozens of instantiations (the attention
# kernels) no longer hold the whole build behind one core
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
              "--split-compile=0")

# dtype codes of csrc/common.cuh (LbtDtype)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's `-Xptxas -v` report (registers, shared memory, spills) per kernel
ptxas_report: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from llama_box_tpu_torch/csrc at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, Path]:
    """Compile every kernel in `names` whose library is missing, one nvcc
    process per source, all started together. Returns name -> library."""
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    for n in set(names) - set(todo):
        ptxas_report[n] = paths[n].with_suffix(".log").read_text()
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        ptxas_report[n] = out
        paths[n].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{n}:\n{out}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            no_capture("cuda", f"the {name} library")
            lib = ctypes.CDLL(str(build((name,))[name]))
            _libs[name] = lib
        return lib


# scratch buffers a larger one replaced: a captured CUDA graph may still
# point into them, so they are kept for the life of the process (a buffer
# grows only outside a capture, a few times at most)
_retired: list[torch.Tensor] = []


def grown(old: torch.Tensor | None, new_buffer, dev, what: str):
    """The larger buffer `new_buffer()` in place of `old`, which is kept
    alive; raises during a capture (see no_capture)."""
    no_capture(dev, what)
    if old is not None:
        _retired.append(old)
    return new_buffer()


def no_capture(dev, what: str) -> None:
    """Raise if the current stream is capturing a CUDA graph: `what` (a
    library, a persistent buffer) is made at a call's first, eager, use,
    never inside a capture, where it would live in the graph's pool."""
    if torch.device(dev).type == "cuda" \
            and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} would be made during a CUDA graph "
                           "capture; run the call once eagerly first")


def ptr(t: torch.Tensor | None):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def call(lib_name: str, fn_name: str, *args) -> None:
    """Call a C entry with ints, floats, tensors (as device pointers) or
    None (a null pointer); the current CUDA stream is appended. Raises on a
    non-zero return."""
    fn = getattr(load(lib_name), fn_name)
    cargs = []
    for a in args:
        if a is None or isinstance(a, torch.Tensor):
            cargs.append(ptr(a))
        elif isinstance(a, bool) or not isinstance(a, (int, float)):
            raise TypeError(f"{fn_name}: unsupported argument {a!r}")
        elif isinstance(a, int):
            cargs.append(ctypes.c_int(a))
        else:
            cargs.append(ctypes.c_float(a))
    cargs.append(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    fn.argtypes = [type(a) for a in cargs]
    fn.restype = ctypes.c_int
    rc = fn(*cargs)
    if rc != 0:
        what = ("unsupported configuration" if rc == -1
                else f"CUDA error {rc}")
        raise RuntimeError(f"{fn_name}: {what}")
