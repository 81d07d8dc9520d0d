"""x264dsp_tpu_torch — the PyTorch / CUDA port of x264dsp_tpu.

The x264.h API's single-stream ``Encoder`` (param_default: CRF 28, CABAC
through the host C++ writer, scenecut) and the batched encoder
(``BatchEncoder``, CAVLC) run their frame step in PyTorch, with the TPU
Pallas kernels written by hand in CUDA C++ for Hopper (``csrc/``, built with nvcc at first use):
the full-pel SAD surfaces (ops/me_sad.py: whole-MB and 8x8-quadrant),
the MC reference windows (ops/mcgather.py) and the in-loop deblock with
its three routes (ops/deblock.py). On a CPU tensor every kernel wrapper
runs its plain PyTorch version instead. A CAVLC slice payload is packed
on the device (entropy/cavlc_device.py), so only payload bytes cross to
the host; a CABAC frame's syntax crosses once, to the C++ writer.

Entry points run on the card: ``Encoder(param)`` and
``BatchEncoder(param, n_streams)`` use ``device="cuda"`` and raise when
torch finds no GPU; the CPU runs only when the caller passes
``device="cpu"``. Parameters, pictures, SPS/PPS, rate control, the
bitstream writer and the host C++ CAVLC and CABAC writers
(``csrc/host/entropy.cpp``, built with g++ into ``build/native/``) are
the port's own copies of the JAX package's JAX-free modules. This
package imports neither JAX nor anything of x264dsp_tpu.
"""

from .api import (  # noqa: F401
    BIT_DEPTH, CHROMA_FORMAT, Encoder, NAL, Picture, nal_encode,
    picture_alloc, picture_clean, picture_init,
)
from .encoder.batch import BatchEncoder  # noqa: F401
from .params import (  # noqa: F401
    Param, ValidationError, param_default, validate_parameters,
    RC_CQP, RC_CRF, RC_ABR,
    ME_DIA, ME_HEX, ME_UMH, ME_ESA,
    SLICE_TYPE_I, SLICE_TYPE_P, SLICE_TYPE_B,
    TYPE_AUTO, TYPE_IDR, TYPE_I, TYPE_P,
)


def kernel_launches() -> dict:
    """Launch counts of the hand-written CUDA kernels, by name."""
    from .ops import deblock, mcgather, me_sad
    return {**me_sad.launches, **mcgather.launches, **deblock.launches}


def reset_kernel_launches() -> None:
    from .ops import deblock, mcgather, me_sad
    for counts in (me_sad.launches, mcgather.launches, deblock.launches):
        for k in counts:
            counts[k] = 0
