"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` into a shared
library with a plain C interface at first use (no PyTorch headers, so a
build takes seconds); the compilers of all sources start together and
run in parallel, and ``ctypes`` loads the libraries. They land in
``build/kernels/`` at the repo root (listed in ``.gitignore``), each
named by a hash of its source so an edited kernel never loads a stale
build.

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
# C signatures by source file: every pointer and the stream as c_void_p,
# ints as c_int
SIGNATURES = {
    "me_sad.cu": {
        "x264t_sad_surface16": (_P, _P, _P, _I, _I, _I, _I, _P),
        "x264t_sad_surfaces_8x8": (_P, _P, _P, _I, _I, _I, _I, _P),
    },
    "windows.cu": {
        "x264t_luma_windows": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
        "x264t_chroma_windows": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    },
    "deblock.cu": {
        "x264t_deblock": (_P,) * 10 + (_I,) * 5 + (_P,),
        "x264t_deblock_wave_luma": (_P,) * 7 + (_I,) * 4 + (_P,),
        "x264t_deblock_wave_chroma": (_P,) * 8 + (_I,) * 4 + (_P,),
        "x264t_filter_regions": (_P,) * 14 + (_I,) + (_P,),
    },
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


def lib_path(src: Path) -> Path:
    """The library built from `src`, named by a hash of its text."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libx264t_{src.stem}_{digest}.so"


def _start(src: Path):
    """Start nvcc on `src` unless its library exists: (temporary output,
    library, process), or None."""
    path = lib_path(src)
    if path.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    return tmp, path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)


def _finish(src: Path, job) -> str:
    """Wait for one nvcc and move its library into place; returns the
    error text, or "" on success."""
    tmp, path, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        return f"nvcc failed on {src.name}:\n{log}"
    os.replace(tmp, path)   # atomic against a concurrent build
    return ""


def compile_source(src: Path) -> Path:
    """Compile one CUDA source (once per source hash); returns its
    library."""
    job = _start(src)
    if job is not None:
        err = _finish(src, job)
        if err:
            raise RuntimeError(err)
    return lib_path(src)


def _build() -> dict:
    """Compile every source that has no library yet, all at once.
    Returns {source name: library path}."""
    global build_seconds
    t0 = time.perf_counter()
    srcs = {name: SRC_DIR / name for name in SIGNATURES}
    jobs = {name: job for name, src in srcs.items()
            if (job := _start(src)) is not None}
    errors = [err for name, job in jobs.items()
              if (err := _finish(srcs[name], job))]
    if errors:
        raise RuntimeError("\n".join(errors))
    build_seconds = time.perf_counter() - t0 if jobs else 0.0
    return {name: lib_path(src) for name, src in srcs.items()}


class _Kernels:
    """The C entry points of all kernel libraries, as attributes."""

    def __init__(self, paths: dict):
        self.handles = []
        for name, fns in SIGNATURES.items():
            handle = ctypes.CDLL(str(paths[name]))
            self.handles.append(handle)
            for fn_name, argtypes in fns.items():
                fn = getattr(handle, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                setattr(self, fn_name, fn)


def lib() -> _Kernels:
    """The loaded kernels (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _Kernels(_build())
    return _lib


_count_lock = threading.Lock()


def count_launch(counts: dict, name: str) -> None:
    """Add one launch of kernel `name` to a wrapper module's counts (under
    a lock: the stream mesh launches from one thread per device)."""
    with _count_lock:
        counts[name] += 1


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
