"""Public encoder API types — x264_picture_t / x264_nal_t twins.

Copied from x264dsp_tpu/api.py (``Picture`` and ``NAL`` only) so that
the port imports nothing of the JAX package; only the import lines
differ. The single-stream ``Encoder`` factory there is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import params as P


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
        """Device arrays (jax) pass through unconverted — zero-copy
        device-side ingest for pipelines whose frames already live in
        HBM; anything else is normalized to uint8 numpy."""
        def norm(a):
            if type(a).__module__.startswith("jax"):
                return a
            return np.asarray(a, dtype=np.uint8)
        return Picture(y=norm(y), u=norm(u), v=norm(v), i_pts=pts)


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
