"""Intra predictors — port of x264dsp_tpu/ops/intra.py (common/predict.c).

Each function computes ALL modes for a batch of blocks from explicit
neighbour tensors and returns (..., n_modes, H, W) int32, with the mode
numbering of common/predict.h:
  16x16: V=0 H=1 DC=2 P=3 DC_LEFT=4 DC_TOP=5 DC_128=6
  8x8c:  DC=0 H=1 V=2 P=3 DC_LEFT=4 DC_TOP=5 DC_128=6
  4x4:   V=0 H=1 DC=2 DDL=3 DDR=4 VR=5 HD=6 VL=7 HU=8
         DC_LEFT=9 DC_TOP=10 DC_128=11
"""

from __future__ import annotations

import torch

_I32 = torch.int32


def _full(val, shape):
    """Broadcast a (...,) value to (..., h, w)."""
    return val[..., None, None].expand(val.shape + shape)


def _plane(a, b, c, n: int, scale_off: int, dev):
    xs = torch.arange(n, dtype=_I32, device=dev)
    i00 = a - scale_off * b - scale_off * c + 16
    out = (i00[..., None, None] + b[..., None, None] * xs[None, :]
           + c[..., None, None] * xs[:, None]) >> 5
    return out.clamp(0, 255)


def predict_16x16_all(left, top, topleft):
    """left/top (..., 16), topleft (...,) -> (..., 7, 16, 16)."""
    left, top, topleft = left.to(_I32), top.to(_I32), topleft.to(_I32)
    shp = (16, 16)
    v = top[..., None, :].expand(top.shape[:-1] + shp)
    h = left[..., :, None].expand(left.shape[:-1] + shp)
    sl = left.sum(-1, dtype=_I32)
    st = top.sum(-1, dtype=_I32)
    dc = _full((sl + st + 16) >> 5, shp)
    dcl = _full((sl + 8) >> 4, shp)
    dct_ = _full((st + 8) >> 4, shp)
    dc128 = torch.full_like(dc, 128)
    w = torch.arange(1, 9, dtype=_I32, device=left.device)
    top_ext = torch.cat([topleft[..., None], top], -1)
    left_ext = torch.cat([topleft[..., None], left], -1)
    H = (w * (top_ext[..., 9:17] - top_ext[..., 0:8].flip(-1))).sum(
        -1, dtype=_I32)
    V = (w * (left_ext[..., 9:17] - left_ext[..., 0:8].flip(-1))).sum(
        -1, dtype=_I32)
    a = 16 * (left[..., 15] + top[..., 15])
    plane = _plane(a, (5 * H + 32) >> 6, (5 * V + 32) >> 6, 16, 7,
                   left.device)
    return torch.stack([v, h, dc, plane, dcl, dct_, dc128], dim=-3)


def predict_8x8c_all(left, top, topleft):
    """left/top (..., 8), topleft (...,) -> (..., 7, 8, 8)."""
    left, top, topleft = left.to(_I32), top.to(_I32), topleft.to(_I32)
    shp = (8, 8)
    h = left[..., :, None].expand(left.shape[:-1] + shp)
    v = top[..., None, :].expand(top.shape[:-1] + shp)
    s0 = top[..., 0:4].sum(-1, dtype=_I32)
    s1 = top[..., 4:8].sum(-1, dtype=_I32)
    s2 = left[..., 0:4].sum(-1, dtype=_I32)
    s3 = left[..., 4:8].sum(-1, dtype=_I32)
    # quadrant DC rule (x264_predict_8x8c_dc_c, predict.c:231-270)
    dcq = torch.stack([torch.stack([(s0 + s2 + 4) >> 3, (s1 + 2) >> 2], -1),
                       torch.stack([(s3 + 2) >> 2, (s1 + s3 + 4) >> 3], -1)],
                      -2)                                   # (..., 2, 2)
    dc = dcq.repeat_interleave(4, -1).repeat_interleave(4, -2)
    lo = (torch.arange(8, device=left.device) < 4)
    dcl = torch.where(lo[:, None], _full((s2 + 2) >> 2, shp),
                      _full((s3 + 2) >> 2, shp))
    dct_ = torch.where(lo[None, :], _full((s0 + 2) >> 2, shp),
                       _full((s1 + 2) >> 2, shp))
    dc128 = torch.full_like(dcl, 128)
    w = torch.arange(1, 5, dtype=_I32, device=left.device)
    top_ext = torch.cat([topleft[..., None], top], -1)
    left_ext = torch.cat([topleft[..., None], left], -1)
    H = (w * (top_ext[..., 5:9] - top_ext[..., 0:4].flip(-1))).sum(
        -1, dtype=_I32)
    V = (w * (left_ext[..., 5:9] - left_ext[..., 0:4].flip(-1))).sum(
        -1, dtype=_I32)
    a = 16 * (left[..., 7] + top[..., 7])
    plane = _plane(a, (17 * H + 16) >> 5, (17 * V + 16) >> 5, 8, 3,
                   left.device)
    return torch.stack([dc, h, v, plane, dcl, dct_, dc128], dim=-3)


def predict_4x4_all(left, top, topleft, topright):
    """left/top/topright (..., 4), topleft (...,) -> (..., 12, 4, 4).
    topright must already be patched for unavailability."""
    l, t = left.to(_I32), top.to(_I32)
    lt, tr = topleft.to(_I32), topright.to(_I32)
    l0, l1, l2, l3 = (l[..., i] for i in range(4))
    t0, t1, t2, t3 = (t[..., i] for i in range(4))
    t4, t5, t6, t7 = (tr[..., i] for i in range(4))

    def F1(a, b):
        return (a + b + 1) >> 1

    def F2(a, b, c):
        return (a + 2 * b + c + 2) >> 2

    def grid(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    shp = (4, 4)
    v = t[..., None, :].expand(t.shape[:-1] + shp)
    h = l[..., :, None].expand(l.shape[:-1] + shp)
    dc = _full((l0 + l1 + l2 + l3 + t0 + t1 + t2 + t3 + 4) >> 3, shp)
    dcl = _full((l0 + l1 + l2 + l3 + 2) >> 2, shp)
    dct_ = _full((t0 + t1 + t2 + t3 + 2) >> 2, shp)
    dc128 = torch.full_like(dc, 128)

    f01, f12, f23 = F2(t0, t1, t2), F2(t1, t2, t3), F2(t2, t3, t4)
    f34, f45, f56 = F2(t3, t4, t5), F2(t4, t5, t6), F2(t5, t6, t7)
    f67 = F2(t6, t7, t7)
    ddl = grid([[f01, f12, f23, f34], [f12, f23, f34, f45],
                [f23, f34, f45, f56], [f34, f45, f56, f67]])

    a3, a2, a1 = F2(t3, t2, t1), F2(t2, t1, t0), F2(t1, t0, lt)
    a0, b1 = F2(t0, lt, l0), F2(lt, l0, l1)
    b2, b3 = F2(l0, l1, l2), F2(l1, l2, l3)
    ddr = grid([[a0, a1, a2, a3], [b1, a0, a1, a2],
                [b2, b1, a0, a1], [b3, b2, b1, a0]])

    vr_l2, vr_l1, vr_l0 = F2(l2, l1, l0), F2(l1, l0, lt), F2(l0, lt, t0)
    g0, g1, g2, g3 = F1(lt, t0), F1(t0, t1), F1(t1, t2), F1(t2, t3)
    e1, e2, e3 = F2(lt, t0, t1), F2(t0, t1, t2), F2(t1, t2, t3)
    vr = grid([[g0, g1, g2, g3], [vr_l0, e1, e2, e3],
               [vr_l1, g0, g1, g2], [vr_l2, vr_l0, e1, e2]])

    hd_0, hd_1 = F1(lt, l0), F2(t0, lt, l0)
    hd_2, hd_3 = F2(t1, t0, lt), F2(t2, t1, t0)
    p0, p1 = F1(l0, l1), F2(lt, l0, l1)
    q0, q1 = F1(l1, l2), F2(l0, l1, l2)
    r0, r1 = F1(l2, l3), F2(l1, l2, l3)
    hd = grid([[hd_0, hd_1, hd_2, hd_3], [p0, p1, hd_0, hd_1],
               [q0, q1, p0, p1], [r0, r1, q0, q1]])

    u0, u1, u2, u3, u4 = F1(t0, t1), F1(t1, t2), F1(t2, t3), F1(t3, t4), \
        F1(t4, t5)
    w0, w1, w2 = F2(t0, t1, t2), F2(t1, t2, t3), F2(t2, t3, t4)
    w3, w4 = F2(t3, t4, t5), F2(t4, t5, t6)
    vl = grid([[u0, u1, u2, u3], [w0, w1, w2, w3],
               [u1, u2, u3, u4], [w1, w2, w3, w4]])

    s0, s1, s2 = F1(l0, l1), F2(l0, l1, l2), F1(l1, l2)
    s3, s4, s5 = F2(l1, l2, l3), F1(l2, l3), F2(l2, l3, l3)
    hu = grid([[s0, s1, s2, s3], [s2, s3, s4, s5],
               [s4, s5, l3, l3], [l3, l3, l3, l3]])

    return torch.stack([v, h, dc, ddl, ddr, vr, hd, vl, hu, dcl, dct_, dc128],
                       dim=-3)
