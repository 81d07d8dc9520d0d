"""Public encoder API — port of x264dsp_tpu/api.py: the x264.h entry
points (x264_encoder_open / headers / encode / close through
``Encoder``), x264_picture_t / x264_nal_t and the picture helpers.

Copied from x264dsp_tpu/api.py so that the port imports nothing of the
JAX package, with three differences: ``Encoder`` takes ``device=`` (the
GPU unless the caller asks for "cpu") and ``profile=``; a torch tensor
passes ``Picture.from_planes`` unconverted, on its device; and
``mark_reference_corrupt`` (recovery path (c)) raises, as it is not
ported.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np

from . import params as P

# x264_bit_depth / x264_chroma_format twins (common/common.c:10-12;
# BIT_DEPTH 8, X264_CHROMA_FORMAT 0 = all supported — osdep.h:24-26)
BIT_DEPTH = 8
CHROMA_FORMAT = 0


@dataclass
class Picture:
    """x264_picture_t twin (common/x264.h:847): planar I420 input frame."""
    y: np.ndarray = None
    u: np.ndarray = None
    v: np.ndarray = None
    i_type: int = P.TYPE_AUTO
    i_qpplus1: int = 0
    i_pts: int = 0
    i_dts: int = 0
    b_keyframe: int = 0
    # output stats
    i_frame_qp: int = 0
    i_frame_type: int = 0

    @staticmethod
    def from_planes(y, u, v, pts: int = 0) -> "Picture":
        """A torch tensor passes through unconverted, on its device (the
        Encoder pads and encodes it there, with no host round trip);
        anything else is normalized to uint8 numpy."""
        def norm(a):
            if type(a).__module__.startswith("torch"):
                return a
            return np.asarray(a, dtype=np.uint8)
        return Picture(y=norm(y), u=norm(u), v=norm(v), i_pts=pts)


def picture_init(pic: Picture) -> None:
    """x264_picture_init twin (common/common.c:194): reset a Picture to
    defaults in place."""
    fresh = Picture()
    for f in Picture.__dataclass_fields__:
        setattr(pic, f, getattr(fresh, f))


def picture_alloc(width: int, height: int, i_csp: int = P.CSP_I420
                  ) -> Picture:
    """x264_picture_alloc twin (common/common.c:205): a zeroed I420
    Picture with allocated planes. Only I420 is accepted (encoder.c:30)."""
    if i_csp != P.CSP_I420:
        raise ValueError("only X264_CSP_I420 input is supported "
                         "(encoder.c:30)")
    return Picture(y=np.zeros((height, width), np.uint8),
                   u=np.zeros((height // 2, width // 2), np.uint8),
                   v=np.zeros((height // 2, width // 2), np.uint8))


def picture_clean(pic: Picture) -> None:
    """x264_picture_clean twin (common/common.c:259): drop the plane
    references."""
    pic.y = pic.u = pic.v = None


@dataclass
class NAL:
    """x264_nal_t twin (common/x264.h:52)."""
    i_type: int
    i_ref_idc: int
    payload: bytes  # escaped, start-code prefixed (Annex-B)
    b_long_startcode: bool = True

    @property
    def i_payload(self) -> int:
        return len(self.payload)


class Encoder:
    """x264_t twin: one encoding session, on the GPU unless the caller
    passes device="cpu" ("cuda" without a GPU raises).

    Usage::

        enc = Encoder(param)            # x264_encoder_open
        headers = enc.headers()         # x264_encoder_headers
        nals, pic_out = enc.encode(pic) # x264_encoder_encode
        enc.close()                     # x264_encoder_close
    """

    def __init__(self, param: P.Param, device="cuda", profile: bool = False):
        from .encoder.core import EncoderCore
        self._core = EncoderCore(param, device=device, profile=profile)
        self.param = self._core.param

    def headers(self) -> list[NAL]:
        return self._core.headers()

    def encode(self, pic_in: Picture | None):
        """Returns (nals, pic_out) of the oldest queued frame: ([], None)
        while the lookahead queue fills (VBV with i_lookahead > 0 delays
        that many frames); encode(None) drains the queue one frame per
        call, then returns ([], None)."""
        return self._core.encode(pic_in)

    def close(self) -> dict:
        """Finalize; returns the accumulated stats block (h->stat twin)."""
        return self._core.close()

    def mark_reference_corrupt(self, frame_idx: int | None = None):
        """Flag reference frame(s) as corrupt (x264_frame_t.b_corrupt,
        common/frame.h:188; api.py:117-127): corrupt frames are skipped
        when the reference list is built (encoder.c:825-826) with an
        explicit ref_pic_list_modification (encoder.c:777-788), and the
        next frame is forced to an IDR only when no valid reference
        remains (encoder.c:1808-1820). frame_idx selects one DPB entry by
        its encode-order frame index; None marks every held reference."""
        for e in self._core.dpb:
            if frame_idx is None or e["frame_idx"] == frame_idx:
                e["corrupt"] = True

    def parameters(self) -> P.Param:
        """x264_encoder_parameters twin (encoder/encoder.c:638): a copy
        of the validated in-use parameter set."""
        return copy.deepcopy(self._core.param)

    @property
    def stats(self) -> dict:
        """The accumulated stats block so far."""
        return self._core.stats.summary()


def nal_encode(nal: NAL) -> bytes:
    """x264_nal_encode twin (common/bitstream.c): the Annex-B bytes of a
    NAL (start code + escaped payload), already encapsulated at encode()
    time."""
    return nal.payload
