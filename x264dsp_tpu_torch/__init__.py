"""x264dsp_tpu_torch — the PyTorch / CUDA port of x264dsp_tpu.

The batched CQP / CAVLC / IPPP encoder (``BatchEncoder``) runs its frame
step in PyTorch, with the TPU Pallas kernels of that path written by
hand in CUDA C++ for Hopper (``csrc/``, built with nvcc at first use):
the full-pel SAD surfaces (ops/me_sad.py: whole-MB and 8x8-quadrant),
the MC reference windows (ops/mcgather.py) and the in-loop deblock
(ops/deblock.py). On a CPU tensor every kernel wrapper runs its plain
PyTorch version instead.

Entry points run on the card: ``BatchEncoder(param, n_streams)`` uses
``device="cuda"`` and raises when torch finds no GPU; the CPU runs only
when the caller passes ``device="cpu"``. Parameters, pictures, SPS/PPS,
rate control, the bitstream writer and the host C++ CAVLC writers
(``csrc/host/entropy.cpp``, built with g++ into ``build/native/``) are
the port's own copies of the JAX package's JAX-free modules. This
package imports neither JAX nor anything of x264dsp_tpu.
"""

from .api import NAL, Picture  # noqa: F401
from .encoder.batch import BatchEncoder  # noqa: F401
from .params import (  # noqa: F401
    Param, ValidationError, param_default, validate_parameters,
    RC_CQP, SLICE_TYPE_I, SLICE_TYPE_P,
)


def kernel_launches() -> dict:
    """Launch counts of the hand-written CUDA kernels, by name."""
    from .ops import deblock, mcgather, me_sad
    return {"sad_surface16": me_sad.launches["sad_surface16"],
            "sad_surfaces_8x8": me_sad.launches["sad_surfaces_8x8"],
            "luma_windows": mcgather.launches["luma_windows"],
            "chroma_windows": mcgather.launches["chroma_windows"],
            "deblock": deblock.launches}


def reset_kernel_launches() -> None:
    from .ops import deblock, mcgather, me_sad
    deblock.launches = 0
    for counts in (me_sad.launches, mcgather.launches):
        for k in counts:
            counts[k] = 0
