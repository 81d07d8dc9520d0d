"""Half-pel reference planes — port of x264dsp_tpu/ops/mc.py.

common/mc.c: hpel_filter (:144-167), the 6-tap (1,-5,20,20,-5,1) H and V
planes with (v+16)>>5 clip and the HV plane filtered from the UNCLIPPED
vertical intermediate with (+512)>>10; x264_frame_filter (:506) pads the
deblocked plane by PAD_MC with edge replication first. All functions take
a leading stream axis.
"""

from __future__ import annotations

import numpy as np
import torch

PAD_MC = 32  # reference PADH/PADV (common/frame.h:9-10)

# qpel position -> hpel plane selection (common/mc.c:192-193)
HPEL_REF0 = np.array([0, 1, 1, 1, 0, 1, 1, 1, 2, 3, 3, 3, 0, 1, 1, 1],
                     np.int32)
HPEL_REF1 = np.array([0, 0, 0, 0, 2, 2, 3, 2, 2, 2, 3, 2, 2, 2, 3, 2],
                     np.int32)


def _tap6(a, b, c, d, e, f):
    return a + f - 5 * (b + e) + 20 * (c + d)


def hpel_filter(p):
    """(..., H, W) int32 -> (h, v, c) half-pel planes of the same shape.
    Shifts wrap around (torch.roll, like the JAX twin's jnp.roll), so the
    outer 3 pixels of each edge are only meaningful inside a PAD_MC pad."""
    p = p.to(torch.int32)

    def sh(a, dy, dx):
        return torch.roll(a, (-dy, -dx), dims=(-2, -1))

    v_full = _tap6(sh(p, -2, 0), sh(p, -1, 0), p, sh(p, 1, 0), sh(p, 2, 0),
                   sh(p, 3, 0))
    v = ((v_full + 16) >> 5).clamp(0, 255)
    h_full = _tap6(sh(p, 0, -2), sh(p, 0, -1), p, sh(p, 0, 1), sh(p, 0, 2),
                   sh(p, 0, 3))
    h = ((h_full + 16) >> 5).clamp(0, 255)
    c_full = _tap6(sh(v_full, 0, -2), sh(v_full, 0, -1), v_full,
                   sh(v_full, 0, 1), sh(v_full, 0, 2), sh(v_full, 0, 3))
    c = ((c_full + 512) >> 10).clamp(0, 255)
    return h, v, c


def edge_pad(x, pad: int):
    """Edge-replicating pad of the last two axes (any dtype)."""
    H, W = x.shape[-2:]
    ri = torch.arange(-pad, H + pad, device=x.device).clamp(0, H - 1)
    ci = torch.arange(-pad, W + pad, device=x.device).clamp(0, W - 1)
    return x[..., ri[:, None], ci[None, :]]


def make_ref_planes(recon):
    """(S, H, W) deblocked luma -> (S, 4, H+2P, W+2P) int32 planes
    [full, h, v, hv] (x264_frame_filter, common/mc.c:506)."""
    p = edge_pad(recon.to(torch.int32), PAD_MC)
    h, v, c = hpel_filter(p)
    return torch.stack([p, h, v, c], dim=1)


def pad_chroma(recon):
    """(S, H/2, W/2) -> (S, H/2+P, W/2+P) int32, edge-replicated."""
    return edge_pad(recon.to(torch.int32), PAD_MC // 2)


def lowres_planes(plane):
    """Half-res pyramid (mc.py:126 lowres_planes, frame_init_lowres_core,
    common/mc.c:433-460): (S, H, W) with H, W even -> (S, 4, H/2, W/2)
    int32, the four phase-shifted planes [full, h, v, c] of the
    (avg, avg) -> avg filter, the last row and column replicated."""
    H, W = plane.shape[-2:]
    ri = torch.arange(H + 2, device=plane.device).clamp(max=H - 1)
    ci = torch.arange(W + 2, device=plane.device).clamp(max=W - 1)
    p = plane.to(torch.int32)[..., ri[:, None], ci[None, :]]

    def F(a, b, c, d):
        return (((a + b + 1) >> 1) + ((c + d + 1) >> 1) + 1) >> 1

    s0, s1, s2 = p[..., 0:H:2, :], p[..., 1:H + 1:2, :], p[..., 2:H + 2:2, :]
    x0, x1, x2 = slice(0, W, 2), slice(1, W + 1, 2), slice(2, W + 2, 2)
    return torch.stack([F(s0[..., x0], s1[..., x0], s0[..., x1], s1[..., x1]),
                        F(s0[..., x1], s1[..., x1], s0[..., x2], s1[..., x2]),
                        F(s1[..., x0], s2[..., x0], s1[..., x1], s2[..., x1]),
                        F(s1[..., x1], s2[..., x1], s1[..., x2], s2[..., x2])],
                       dim=-3)
