"""Build and load the hand-written CUDA kernels of ``csrc/``.

All ``csrc/*.cu`` files compile with ``nvcc`` into ONE shared library
with a plain C interface at first use (no PyTorch headers, so the build
takes seconds), which ``ctypes`` loads. The library lands in
``build/kernels/`` at the repo root (listed in ``.gitignore``), named by
a hash of the sources so an edited kernel never loads a stale build.

Every C entry point takes raw device pointers plus the CUDA stream and
returns ``cudaGetLastError()``; :func:`check` turns a nonzero code into
an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream as c_void_p, ints as c_int
SIGNATURES = {
    "x264t_sad_surface16": (_P, _P, _P, _I, _I, _I, _I, _P),
    "x264t_luma_windows": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "x264t_chroma_windows": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "x264t_deblock": (_P,) * 9 + (_I,) * 5 + (_P,),
}

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _build() -> Path:
    global build_seconds
    h = hashlib.sha256()
    sources = sorted(SRC_DIR.glob("*.cu"))
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libx264dsp_kernels_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        build_seconds = 0.0
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sources]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)
    os.replace(tmp, lib_path)          # atomic against a concurrent build
    build_seconds = time.perf_counter() - t0
    return lib_path


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(_build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(t, dtype, shape, name: str) -> None:
    """Validate one kernel argument: CUDA device, dtype, shape and
    contiguity (the C side reads raw row-major memory)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
