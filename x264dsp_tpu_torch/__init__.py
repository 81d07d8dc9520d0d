"""x264dsp_tpu_torch — the PyTorch / CUDA port of x264dsp_tpu.

The batched CQP / CAVLC / IPPP encoder (``BatchEncoder``) runs its frame
step in PyTorch, with the three TPU Pallas kernels of that path written
by hand in CUDA C++ for Hopper (``csrc/``, built with nvcc at first
use): the full-pel SAD surface (ops/me_sad.py), the MC reference
windows (ops/mcgather.py) and the in-loop deblock (ops/deblock.py). On a
CPU tensor every kernel wrapper runs its plain PyTorch version instead.

The device is explicit: ``BatchEncoder(param, n_streams, device="cuda")``
raises when torch finds no GPU; the CPU runs only when asked for.
Parameters, pictures, SPS/PPS, the bitstream writer and the C++ CAVLC
writers come from the JAX-free modules of x264dsp_tpu. This package
never imports JAX.
"""

import os
from pathlib import Path

# The C++ CAVLC writers build at first use into $X264TPU_NATIVE_DIR, read
# when x264dsp_tpu/entropy/native.py is imported. Unless the caller chose
# a directory, keep that build inside this checkout (beside the CUDA
# kernels' build/kernels/), so two checkouts never share or race on one
# library.
os.environ.setdefault(
    "X264TPU_NATIVE_DIR",
    str(Path(__file__).resolve().parent.parent / "build" / "native"))

from x264dsp_tpu.api import NAL, Picture  # noqa: E402,F401
from x264dsp_tpu.params import (  # noqa: E402,F401
    Param, ValidationError, param_default, validate_parameters,
    RC_CQP, SLICE_TYPE_I, SLICE_TYPE_P,
)

from .encoder.batch import BatchEncoder  # noqa: E402,F401


def kernel_launches() -> dict:
    """Launch counts of the hand-written CUDA kernels, by name."""
    from .ops import deblock, mcgather, me_sad
    return {"sad_surface16": me_sad.launches,
            "luma_windows": mcgather.launches["luma_windows"],
            "chroma_windows": mcgather.launches["chroma_windows"],
            "deblock": deblock.launches}


def reset_kernel_launches() -> None:
    from .ops import deblock, mcgather, me_sad
    me_sad.launches = 0
    deblock.launches = 0
    for k in mcgather.launches:
        mcgather.launches[k] = 0
