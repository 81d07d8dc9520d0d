"""P-frame encode over a stream batch — port of the main-path subset of
x264dsp_tpu/encoder/inter_frame.py: ``encode_p_frame`` with one
reference, the DIA pattern walk (me_method 0), subme-1 subpel refine,
the fast P-skip probe, no sub-16x16 partitions.

Every tensor carries a leading stream axis S in place of the JAX vmap.
The walk reads the SAD surface in kernel K1's lane layout [row, dy, dx,
mbx]; the JAX CPU path walks the classic layout, and
tests/test_me_methods.py::test_lane_walk_twins_match_classic holds the
two walks equal. Candidate minima update only on a strictly smaller
cost, in candidate order, as in the JAX code (me.c's COPY*_IF_LT).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import deblock as DB
from ..ops import mc as MC
from ..ops import mcgather as MG
from ..ops import me_sad
from ..ops import residual_plane as RP
from ..ops import transforms as T
from ..ops.devtab import device_table
from .intra_frame import optimize_chroma_dc

_I32 = torch.int32
BIG = 1 << 28

# mv_bits = floor(log2(d+1)*2 + 2.218), cost_mv[0] = 1 bit (analyse.c:243)
_MVBITS_RANGE = 4096
_MVBITS = np.ones(_MVBITS_RANGE, np.int32)
_d = np.arange(1, _MVBITS_RANGE)
_MVBITS[1:] = (np.log2(_d + 1.0) * 2 + 1.718 + 0.5).astype(np.int32)

# lambda2 table (encoder/analyse.c:113-130), QP 0..51
LAMBDA2_TAB = np.array([
    14, 18, 22, 28, 36, 45, 57, 72,
    91, 115, 145, 182, 230, 290, 365, 460,
    580, 731, 921, 1161, 1462, 1843, 2322, 2925,
    3686, 4644, 5851, 7372, 9289, 11703, 14745, 18578,
    23407, 29491, 37156, 46814, 58982, 74313, 93628, 117964,
    148626, 187257, 235929, 297252, 374514, 471859, 594505, 749029,
    943718, 1189010, 1498059, 1887436], np.int64)

_DIA_PTS = ((0, -1), (0, 1), (-1, 0), (1, 0))

def mv_cost(lam, mvx, mvy, mvpx, mvpy):
    bits = device_table(_MVBITS, lam.device)
    dx = (mvx - mvpx).abs().clamp(0, _MVBITS_RANGE - 1).long()
    dy = (mvy - mvpy).abs().clamp(0, _MVBITS_RANGE - 1).long()
    return lam * (bits[dx] + bits[dy])


def make_mv_ranges(mb_w: int, mb_h: int, mv_range: int, device):
    """Per-MB legal qpel MV ranges (x264_mb_analyse_init,
    analyse.c:370-393): (mvmin_x, mvmax_x) (mb_w,), (mvmin_y, mvmax_y)
    (mb_h,) int32."""
    fmv = mv_range * 4
    xs = np.arange(mb_w)
    ys = np.arange(mb_h)
    vals = (np.clip((-(xs << 4) - 24) << 2, -fmv, fmv - 1),
            np.clip((((mb_w - xs - 1) << 4) + 24) << 2, -fmv, fmv - 1),
            np.clip((-(ys << 4) - 24) << 2, -fmv, fmv),
            np.clip((((mb_h - ys - 1) << 4) + 24) << 2, -fmv, fmv - 1))
    return tuple(torch.as_tensor(v.astype(np.int32), device=device)
                 for v in vals)


def _clip(x, lo, hi):
    """jnp.clip order: max with lo first, then min with hi."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _median3(a, b, c):
    return a + b + c - torch.minimum(a, torch.minimum(b, c)) \
        - torch.maximum(a, torch.maximum(b, c))


def _shift(field, dy: int, dx: int):
    """field (S, mb_h, mb_w, ...) -> value of the neighbour at (y-dy,
    x-dx) and its in-frame flag (mb_h, mb_w); zero outside."""
    mb_h, mb_w = field.shape[1:3]
    m = torch.roll(field, (dy, dx), dims=(1, 2))
    ys = torch.arange(mb_h, device=field.device)[:, None]
    xs = torch.arange(mb_w, device=field.device)[None, :]
    ok = ((ys - dy >= 0) & (ys - dy < mb_h) & (xs - dx >= 0)
          & (xs - dx < mb_w))
    okb = ok.reshape((1, mb_h, mb_w) + (1,) * (field.dim() - 3))
    return torch.where(okb, m, 0), ok


def _mvp_parts(mv_field):
    """Neighbour MVs A (left), B (top), C (top-right, else top-left)
    with availability (common/mvpred.c:103-137)."""
    mv_a, ok_a = _shift(mv_field, 0, 1)
    mv_b, ok_b = _shift(mv_field, 1, 0)
    mv_c, ok_c = _shift(mv_field, 1, -1)
    mv_d, ok_d = _shift(mv_field, 1, 1)
    mv_c = torch.where(ok_c[None, ..., None], mv_c, mv_d)
    ok_c = ok_c | ok_d
    return mv_a, ok_a, mv_b, ok_b, mv_c, ok_c


def mvp_field_parallel(mv_field):
    """Median MVP of every MB from a given MV field (S, mb_h, mb_w, 2)."""
    mv_a, ok_a, mv_b, ok_b, mv_c, ok_c = _mvp_parts(mv_field)
    count = ok_a.to(_I32) + ok_b.to(_I32) + ok_c.to(_I32)
    med = _median3(mv_a, mv_b, mv_c)
    single = torch.where(ok_a[None, ..., None], mv_a,
                         torch.where(ok_b[None, ..., None], mv_b, mv_c))
    return torch.where((count == 1)[None, ..., None], single, med)


def pskip_mv_field(mv_field):
    """Exact P-SKIP MV (mvpred.c:143-160) of every MB."""
    mv_a, ok_a, mv_b, ok_b, _, _ = _mvp_parts(mv_field)
    mvp = mvp_field_parallel(mv_field)
    a_zero = ok_a[None] & (mv_a == 0).all(-1)
    b_zero = ok_b[None] & (mv_b == 0).all(-1)
    zero = (~ok_a)[None] | (~ok_b)[None] | a_zero | b_zero
    return torch.where(zero[..., None], 0, mvp)


class _LaneSurface:
    """Reads of the (S, mb_h, n, n, mb_w) SAD surface at per-MB full-pel
    offsets: the raw cost (legal-range masked) or the cost biased by
    lambda * mvbits(mv - mvp). Equal to the JAX path's where(ok, surf
    [+ bias], 1<<28) surfaces read at the same points; out-of-surface
    points cost 1<<28."""

    def __init__(self, surf, lam, R, lo_x, hi_x, lo_y, hi_y):
        S, mb_h, n, _, mb_w = surf.shape
        self.flat = surf.reshape(S, mb_h, n * n, mb_w)
        self.lam, self.R, self.n = lam, R, n
        self.lo_x, self.hi_x = lo_x[None, None, :], hi_x[None, None, :]
        self.lo_y, self.hi_y = lo_y[None, :, None], hi_y[None, :, None]

    def at(self, bx, by, mvp=None):
        R, n = self.R, self.n
        idx = (by.clamp(-R, R) + R) * n + bx.clamp(-R, R) + R
        v = torch.gather(self.flat, 2, idx.long()[:, :, None]).squeeze(2)
        if mvp is not None:
            v = v + mv_cost(self.lam, bx * 4, by * 4, mvp[..., 0],
                            mvp[..., 1])
        ok = ((bx >= self.lo_x) & (bx <= self.hi_x) & (by >= self.lo_y)
              & (by <= self.hi_y))
        inb = (bx.abs() <= R) & (by.abs() <= R)
        return torch.where(ok & inb, v, BIG)


def _pattern_walk_lanes(surf: _LaneSurface, mvp, mvp_fp, mvc, me_range):
    """DIA walk (me.c:237-274) of every MB in lockstep: the MVP costed
    without bias, the mvc candidates and (0,0) with bias, then up to
    me_range diamond steps with per-MB stop masks."""
    R = me_range
    bx = mvp_fp[..., 0].clamp(-R, R)
    by = mvp_fp[..., 1].clamp(-R, R)
    bcost = surf.at(bx, by)
    for cand in (mvc or []):
        cx = cand[..., 0].clamp(-R, R)
        cy = cand[..., 1].clamp(-R, R)
        c = surf.at(cx, cy, mvp)
        better = c < bcost
        bcost = torch.where(better, c, bcost)
        bx = torch.where(better, cx, bx)
        by = torch.where(better, cy, by)
    zero = torch.zeros_like(bx)
    zc = surf.at(zero, zero, mvp)
    better = ((bx != 0) | (by != 0)) & (zc < bcost)
    bcost = torch.where(better, zc, bcost)
    bx = torch.where(better, 0, bx)
    by = torch.where(better, 0, by)
    active = torch.ones_like(bx, dtype=torch.bool)
    for _ in range(me_range):
        ox, oy = bx, by
        for dx, dy in _DIA_PTS:
            cx, cy = ox + dx, oy + dy
            c = surf.at(cx, cy, mvp)
            better = (c < bcost) & active
            bcost = torch.where(better, c, bcost)
            bx = torch.where(better, cx, bx)
            by = torch.where(better, cy, by)
        active = active & ((bx != ox) | (by != oy))
        if not bool(active.any()):
            break           # every walk has stopped: later steps no-op
    return bx, by, bcost


def _neighbour_cands(fp):
    return [fp, _shift(fp, 0, 1)[0], _shift(fp, 1, 0)[0],
            _shift(fp, 1, -1)[0]]


def decide_mvs_pattern(surf_lanes, fenc_y, wins4, lam, mb_w: int, mb_h: int,
                       me_range: int, mv_range: int):
    """DIA MV decision (decide_mvs_pattern, inter_frame.py:479) on the
    lane surface (S, mb_h, n, n, mb_w): a zero-MVP walk, then two walks
    with the median MVP propagated from the previous field, then the
    subpel refine. Returns (S, mb_h, mb_w, 2) qpel MVs."""
    R = me_range
    dev = surf_lanes.device
    ranges = make_mv_ranges(mb_w, mb_h, mv_range, dev)
    mvmin_x, mvmax_x, mvmin_y, mvmax_y = ranges
    surf = _LaneSurface(surf_lanes, lam, R, (mvmin_x >> 2) + 6,
                        (mvmax_x >> 2) - 6, (mvmin_y >> 2) + 6,
                        (mvmax_y >> 2) - 6)
    S = surf_lanes.shape[0]
    zero_mvp = torch.zeros((S, mb_h, mb_w, 2), dtype=_I32, device=dev)
    bx, by, _ = _pattern_walk_lanes(surf, zero_mvp, zero_mvp, None, R)
    for _ in range(2):
        mv_prev = torch.stack([bx * 4, by * 4], -1)
        mvp = mvp_field_parallel(mv_prev)
        mvp_fp = (mvp + 2) >> 2                          # me.c:141-142
        mvc = _neighbour_cands(torch.stack([bx, by], -1))
        bx, by, bcost = _pattern_walk_lanes(surf, mvp, mvp_fp, mvc, R)
    mv_field = torch.stack([bx * 4, by * 4], -1)
    return subpel_refine_batch(mv_field, bcost, mvp, fenc_y, wins4, lam,
                               mb_w, mb_h, ranges)


def tile_mb(plane, mb_w: int, mb_h: int, mbsize: int):
    """(S, mb_h*m, mb_w*m) -> (S*mb_h*mb_w, m, m)."""
    S = plane.shape[0]
    return plane.reshape(S, mb_h, mbsize, mb_w, mbsize).permute(
        0, 1, 3, 2, 4).reshape(S * mb_h * mb_w, mbsize, mbsize)


def untile_mb(tiles, S: int, mb_w: int, mb_h: int, mbsize: int):
    return tiles.reshape(S, mb_h, mb_w, mbsize, mbsize).permute(
        0, 1, 3, 2, 4).reshape(S, mb_h * mbsize, mb_w * mbsize)


def subpel_refine_batch(mv_field, cost_field, mvp_field, fenc_y, wins4,
                        lam, mb_w, mb_h, ranges):
    """Subpel refine at subme 1 (refine_subpel, me.c:466-581): try the
    MVP's subpel candidate on the full windows, recentre the windows, one
    half-pel SAD diamond, one quarter-pel SAD diamond. All MBs of all
    streams at once (B = S*mb_h*mb_w)."""
    S = fenc_y.shape[0]
    B = S * mb_h * mb_w
    f = tile_mb(fenc_y.to(_I32), mb_w, mb_h, 16)
    bmx = mv_field[..., 0].reshape(B)
    bmy = mv_field[..., 1].reshape(B)
    bcost = cost_field.reshape(B)
    mvpx = mvp_field[..., 0].reshape(B)
    mvpy = mvp_field[..., 1].reshape(B)
    lamf = lam.reshape(B)
    mvmin_x, mvmax_x, mvmin_y, mvmax_y = ranges
    lo_x = mvmin_x[None, None, :].expand(S, mb_h, mb_w).reshape(B)
    hi_x = mvmax_x[None, None, :].expand(S, mb_h, mb_w).reshape(B)
    lo_y = mvmin_y[None, :, None].expand(S, mb_h, mb_w).reshape(B)
    hi_y = mvmax_y[None, :, None].expand(S, mb_h, mb_w).reshape(B)

    def diamond(wins, margin, bcost, bmx, bmy, scale, gate):
        mxs = torch.stack([bmx, bmx, bmx - scale, bmx + scale], 1)
        mys = torch.stack([bmy - scale, bmy + scale, bmy, bmy], 1)
        blks = MG.mc_luma_multi(wins, mxs, mys, 16, 16, margin=margin)
        d = (f[:, None] - blks).abs().sum(dim=(2, 3), dtype=_I32)
        for k in range(4):
            c = d[:, k] + mv_cost(lamf, mxs[:, k], mys[:, k], mvpx, mvpy)
            better = gate & (c < bcost)
            bcost = torch.where(better, c, bcost)
            bmx = torch.where(better, mxs[:, k], bmx)
            bmy = torch.where(better, mys[:, k], bmy)
        return bcost, bmx, bmy

    # MVP subpel candidate on the full windows (me.c:484-491)
    mx = MG.clamp_qpel(_clip(mvpx, lo_x + 2, hi_x - 2))
    my = MG.clamp_qpel(_clip(mvpy, lo_y + 2, hi_y - 2))
    blk = MG.mc_luma_batched(wins4, mx, my, 16, 16)
    c = (f - blk).abs().sum(dim=(1, 2), dtype=_I32) \
        + mv_cost(lamf, mx, my, mvpx, mvpy)
    better = c < bcost
    bcost = torch.where(better, c, bcost)
    bmx = torch.where(better, mx, bmx)
    bmy = torch.where(better, my, bmy)

    # recentre on the best full-pel position (extract_windows4)
    m = 3                       # min(4, (2*1 + 1 + 3)//4 + 2) at subme 1
    base_x = (bmx >> 2).clamp(-(MG.M_LUMA - m), MG.M_LUMA - m)
    base_y = (bmy >> 2).clamp(-(MG.M_LUMA - m), MG.M_LUMA - m)
    wins_s = MG.extract_windows4(wins4, base_x, base_y, 16, 16, m)
    bx4, by4 = base_x * 4, base_y * 4
    bmx, bmy = bmx - bx4, bmy - by4
    mvpx, mvpy = mvpx - bx4, mvpy - by4
    cov_lo, cov_hi = -4 * (m - 1), 4 * (m - 1) - 1
    lo_x = torch.clamp(lo_x - bx4, min=cov_lo)
    hi_x = torch.clamp(hi_x - bx4, max=cov_hi)
    lo_y = torch.clamp(lo_y - by4, min=cov_lo)
    hi_y = torch.clamp(hi_y - by4, max=cov_hi)
    # one half-pel diamond (me.c:494-517)
    inside = ((bmy - 2 >= cov_lo) & (bmy + 2 <= cov_hi)
              & (bmx - 2 >= cov_lo) & (bmx + 2 <= cov_hi))
    bcost, bmx, bmy = diamond(wins_s, m, bcost, bmx, bmy, 2, inside)
    # one quarter-pel diamond, SAD (subme 1, me.c:565-581)
    inside = (bmy > lo_y) & (bmy < hi_y) & (bmx > lo_x) & (bmx < hi_x)
    bcost, bmx, bmy = diamond(wins_s, m, bcost, bmx, bmy, 1, inside)
    return torch.stack([(bmx + bx4).reshape(S, mb_h, mb_w),
                        (bmy + by4).reshape(S, mb_h, mb_w)], -1)


def probe_pskip(fenc_y, fenc_u, fenc_v, wins4, winsu, winsv, pskip_mv,
                qp_mb, qpc_mb, mb_w: int, mb_h: int, mv_range: int):
    """x264_macroblock_probe_pskip (macroblock.c:492-604) for every MB:
    returns (ok (S, mb_h, mb_w) bool, clamped skip MVs (S, mb_h, mb_w, 2))."""
    S = fenc_y.shape[0]
    B = S * mb_h * mb_w
    mvmin_x, mvmax_x, mvmin_y, mvmax_y = make_mv_ranges(mb_w, mb_h, mv_range,
                                                        fenc_y.device)
    mvx = MG.clamp_qpel(_clip(pskip_mv[..., 0], mvmin_x[None, None, :],
                              mvmax_x[None, None, :]))
    mvy = MG.clamp_qpel(_clip(pskip_mv[..., 1], mvmin_y[None, :, None],
                              mvmax_y[None, :, None]))
    fx, fy_ = mvx.reshape(B), mvy.reshape(B)
    pred_y = untile_mb(MG.mc_luma_batched(wins4, fx, fy_, 16, 16), S, mb_w,
                       mb_h, 16)
    z_cm = RP.zigzag_order(RP.quant_cm(RP.sub_dct_cm(fenc_y, pred_y), qp_mb,
                                       False, 4))
    sc_bg = torch.where(RP.nnz_cm(z_cm) > 0, RP.decimate_score_cm(z_cm), 0)
    luma_ok = sc_bg.reshape(S, mb_h, 4, mb_w, 4).sum(
        dim=(2, 4), dtype=_I32) < 6
    lam2 = device_table(LAMBDA2_TAB, fenc_y.device, torch.int64)
    thresh = ((lam2[qpc_mb.clamp(0, 51).long()] + 32) >> 6)

    def chroma_ok(fenc_c, winsc):
        predc = untile_mb(MG.mc_chroma_batched(winsc, fx, fy_, 8, 8), S,
                          mb_w, mb_h, 8)
        d = fenc_c.to(_I32) - predc
        ssd = (d * d).reshape(S, mb_h, 8, mb_w, 8).sum(dim=(2, 4),
                                                       dtype=torch.int64)
        cm = RP.sub_dct_cm(fenc_c, predc)
        dc_mb = RP.blockgrid_to_mb(cm[:, 0], mb_h, mb_w, 2).reshape(
            S, mb_h, mb_w, 4)
        q_dc = T.quant_dc(T.hadamard2x2(dc_mb), qpc_mb, False)
        dc_nz = (q_dc != 0).any(-1)
        cm_ac = torch.cat([torch.zeros_like(cm[:, :1]), cm[:, 1:]], 1)
        zc = RP.zigzag_order(RP.quant_cm(cm_ac, qpc_mb, False, 2))
        acs = torch.where(RP.nnz_cm(zc) > 0, RP.decimate_score_cm(zc[:, 1:]),
                          0)
        ac_score = acs.reshape(S, mb_h, 2, mb_w, 2).sum(dim=(2, 4),
                                                        dtype=_I32)
        return (ssd < thresh) | (~dc_nz & ((ssd < (thresh << 2))
                                           | (ac_score < 7)))

    ok = luma_ok & chroma_ok(fenc_u, winsu) & chroma_ok(fenc_v, winsv)
    return ok, torch.stack([mvx, mvy], -1)


def _decimate_group(scores):
    """Saturating 8x8 decimate sum (macroblock.c:409-417): scores added
    in block order only while the running sum < 6."""
    s = torch.zeros_like(scores[..., 0])
    for k in range(scores.shape[-1]):
        s = s + torch.where(s < 6, scores[..., k], 0)
    return s


def _mc_chroma_mv8(winsc, mv8f):
    """Per-quadrant chroma MC (4x4 tiles): (N, 2, 2, 2) -> (N, 8, 8)."""
    q = [[MG.mc_chroma_batched(winsc, mv8f[:, qy, qx, 0], mv8f[:, qy, qx, 1],
                               4, 4, qy * 4, qx * 4) for qx in range(2)]
         for qy in range(2)]
    return torch.cat([torch.cat(q[0], -1), torch.cat(q[1], -1)], -2)


def _mc_luma_mv8(wins4, mv8f):
    """Per-quadrant luma MC: (N, 2, 2, 2) -> (N, 16, 16)."""
    q = [[MG.mc_luma_batched(wins4, mv8f[:, qy, qx, 0], mv8f[:, qy, qx, 1],
                             8, 8, qy * 8, qx * 8) for qx in range(2)]
         for qy in range(2)]
    return torch.cat([torch.cat(q[0], -1), torch.cat(q[1], -1)], -2)


def _encode_chroma_plane(fenc8p, pred8p, qpc_mb, b_decimate, fs, mb_h, mb_w):
    """One chroma channel of x264_mb_encode_chroma (b_inter=1,
    macroblock.c:175-300), whole plane (S, 8mb_h, 8mb_w)."""
    S = fenc8p.shape[0]
    cm = RP.sub_dct_cm(fenc8p, pred8p)
    dc_bg = cm[:, 0]
    cm_ac = torch.cat([torch.zeros_like(cm[:, :1]), cm[:, 1:]], 1)
    q_cm = RP.quant_cm(cm_ac, qpc_mb, False, 2)
    z_cm = RP.zigzag_order(q_cm)
    nnz_ac_bg = RP.nnz_cm(z_cm)
    ac_levels = RP.chroma_levels_coding(z_cm, mb_h, mb_w)
    nnz_ac = RP.blockgrid_to_mb(nnz_ac_bg, mb_h, mb_w, 2).reshape(
        S, mb_h, mb_w, 4)
    dc_mb = RP.blockgrid_to_mb(dc_bg, mb_h, mb_w, 2).reshape(S, mb_h, mb_w, 4)
    q_dc = T.quant_dc(T.hadamard2x2(dc_mb), qpc_mb, False)
    nz_dc = (q_dc != 0).any(-1)
    if b_decimate:
        sc_bg = torch.where(nnz_ac_bg > 0, RP.decimate_score_cm(z_cm[:, 1:]),
                            0)
        sc = RP.blockgrid_to_mb(sc_bg, mb_h, mb_w, 2).reshape(
            S, mb_h, mb_w, 4).sum(-1, dtype=_I32)
        nz_ac = (sc >= 7) & (nnz_ac > 0).any(-1)
    else:
        nz_ac = (nnz_ac > 0).any(-1)
    nz_ac = nz_ac & ~fs
    nz_dc = nz_dc & ~fs

    opt_dc, opt_nz = optimize_chroma_dc(q_dc, qpc_mb)
    use_opt = (~nz_ac) & nz_dc & (qpc_mb <= 22)
    dc_final = torch.where(use_opt[..., None], opt_dc, q_dc)
    nz_dc_final = torch.where(use_opt, opt_nz, nz_dc)
    dc_levels = torch.where(nz_dc_final[..., None], dc_final[..., [0, 2, 1, 3]],
                            0)
    dq_dc = T.idct_dequant_2x2_dc(dc_final, qpc_mb)
    dq_cm = RP.dequant_cm(q_cm, qpc_mb, 2)
    dq_dc_bg = RP.mb_to_blockgrid(dq_dc.reshape(S, mb_h, mb_w, 2, 2), mb_h,
                                  mb_w, 2)
    nz_dc_bg = RP.up(nz_dc_final, 2)
    dq_cm = torch.cat([torch.where(nz_dc_bg, dq_dc_bg, 0)[:, None],
                       dq_cm[:, 1:]], 1)
    rec_ac = RP.idct_add_plane(pred8p, dq_cm)
    dc_shift = RP.up((dq_dc_bg + 32) >> 6, 4)
    rec_dc = (pred8p.to(_I32) + dc_shift).clamp(0, 255)
    sel_ac = RP.up(nz_ac, 8)
    sel_dc = RP.up(nz_dc_final, 8)
    recon = torch.where(sel_ac, rec_ac,
                        torch.where(sel_dc, rec_dc, pred8p.to(_I32)))
    nnz_ac = torch.where(nz_ac[..., None], nnz_ac, 0)
    ac_levels = torch.where(nz_ac[..., None, None], ac_levels, 0)
    return dict(recon=recon, dc_levels=dc_levels, ac_levels=ac_levels,
                nnz_ac=nnz_ac, nz_dc=nz_dc_final.to(_I32), has_ac=nz_ac)


def encode_p_residual(fenc_y, fenc_u, fenc_v, wins4, winsu, winsv, mv8,
                      qp_mb, qpc_mb, mb_w: int, mb_h: int,
                      dct_decimate: bool, force_skip):
    """Inter residual encode of all MBs (encode_p_residual,
    inter_frame.py:912): MC, DCT, inter quant with DCT decimation
    (macroblock.c:409-446), chroma, reconstruction. force_skip MBs encode
    as MC-only skips."""
    S = fenc_y.shape[0]
    B = S * mb_h * mb_w
    fs = force_skip
    mv8f = mv8.reshape(B, 2, 2, 2)
    pred_y = untile_mb(_mc_luma_mv8(wins4, mv8f), S, mb_w, mb_h, 16)
    cm = RP.sub_dct_cm(fenc_y, pred_y)
    live_bg = ~RP.up(fs, 4)
    q_cm = RP.quant_cm(cm, qp_mb, False, 4)
    z_cm = RP.zigzag_order(q_cm)
    nnz_bg = RP.nnz_cm(z_cm) * live_bg
    z_cm = RP.mask_cm(z_cm, live_bg)
    bits = (1 << torch.arange(4, dtype=_I32, device=fenc_y.device))
    if dct_decimate:
        sc_bg = torch.where(nnz_bg > 0, RP.decimate_score_cm(z_cm), 0)
        sc_mb = RP.luma_nnz_coding(sc_bg, mb_h, mb_w)
        gsum = _decimate_group(sc_mb.reshape(S, mb_h, mb_w, 4, 4))
        msum = gsum.sum(-1, dtype=_I32)
        keep = (gsum >= 4) & (msum >= 6)[..., None]
        keep_bg = RP.up(RP.mb_to_blockgrid(
            keep.reshape(S, mb_h, mb_w, 2, 2), mb_h, mb_w, 2), 2)
        nnz_bg = nnz_bg * keep_bg
        z_cm = RP.mask_cm(z_cm, keep_bg)
        cbp_luma = torch.where(keep, bits, 0).sum(-1, dtype=_I32)
    else:
        nnz_mb = RP.luma_nnz_coding(nnz_bg, mb_h, mb_w)
        has = (nnz_mb.reshape(S, mb_h, mb_w, 4, 4) > 0).any(-1)
        cbp_luma = torch.where(has, bits, 0).sum(-1, dtype=_I32)
    dq_cm = RP.mask_cm(RP.dequant_cm(q_cm, qp_mb, 4), nnz_bg)
    recon_y = RP.idct_add_plane(pred_y, dq_cm)
    levels = RP.luma_levels_coding(z_cm, mb_h, mb_w)
    nnz = RP.luma_nnz_coding(nnz_bg, mb_h, mb_w)

    pred_u = untile_mb(_mc_chroma_mv8(winsu, mv8f), S, mb_w, mb_h, 8)
    pred_v = untile_mb(_mc_chroma_mv8(winsv, mv8f), S, mb_w, mb_h, 8)
    eu = _encode_chroma_plane(fenc_u, pred_u, qpc_mb, dct_decimate, fs,
                              mb_h, mb_w)
    ev = _encode_chroma_plane(fenc_v, pred_v, qpc_mb, dct_decimate, fs,
                              mb_h, mb_w)
    any_ac = eu["has_ac"] | ev["has_ac"]
    any_dc = (eu["nz_dc"] | ev["nz_dc"]) != 0
    cbp_chroma = torch.where(any_ac, 2, torch.where(any_dc, 1, 0)).to(_I32)
    return dict(
        cbp_luma=cbp_luma, cbp_chroma=cbp_chroma,
        luma_levels=levels, luma_nnz=nnz, luma_nnz_bg=nnz_bg,
        recon_y=recon_y, recon_u=eu["recon"], recon_v=ev["recon"],
        chroma_dc_levels=torch.stack([eu["dc_levels"], ev["dc_levels"]], 3),
        chroma_ac_levels=torch.stack([eu["ac_levels"], ev["ac_levels"]], 3),
        chroma_nnz_ac=torch.stack([eu["nnz_ac"], ev["nnz_ac"]], 3),
        chroma_nz_dc=torch.stack([eu["nz_dc"], ev["nz_dc"]], 3))


def mv8_to_mv4(mv8, mb_w: int, mb_h: int):
    """(S, mb_h, mb_w, 2, 2, 2) quadrant MVs -> (S, 4mb_h, 4mb_w, 2)."""
    S = mv8.shape[0]
    g = mv8.permute(0, 1, 3, 2, 4, 5).reshape(S, mb_h * 2, mb_w * 2, 2)
    return g.repeat_interleave(2, 1).repeat_interleave(2, 2)


def compute_strengths_p(nnz_bg, cbp_luma, cbp_chroma, mv8, mb_w, mb_h):
    """Deblock strengths of a P frame (x264_macroblock_deblock_strength,
    macroblock.c:677): returns (bs, first_edge_only)."""
    S = nnz_bg.shape[0]
    dev = nnz_bg.device
    ref4 = torch.zeros((S, mb_h * 4, mb_w * 4), dtype=_I32, device=dev)
    intra = torch.zeros((S, mb_h, mb_w), dtype=torch.bool, device=dev)
    bs = DB.compute_strengths(nnz_bg, mv8_to_mv4(mv8, mb_w, mb_h), ref4,
                              intra)
    feo = ((cbp_luma | (cbp_chroma << 4)) == 0).to(_I32)
    return bs, feo


def encode_p_frame(fenc_y, fenc_u, fenc_v, ref4, refu, refv, qp_mb, qpc_mb,
                   lam_mb, mb_w: int, mb_h: int, me_range: int,
                   mv_range: int, dct_decimate: bool,
                   fast_pskip: bool = True):
    """P-frame pipeline for S streams: fenc_* (S, H, W) planes; ref4
    (S, 4, Hp, Wp), refu/refv (S, Hc+P, Wc+P) int32 reference planes
    (mc.make_ref_planes / pad_chroma); qp/qpc/lam (S, mb_h, mb_w) int32.
    Returns the syntax + recon dict of the JAX encode_p_frame (n_ref 1,
    no partitions, DIA, subme 1), each tensor with a leading S axis."""
    S = fenc_y.shape[0]
    dev = fenc_y.device
    fy = fenc_y.to(_I32)
    strips = me_sad.make_ref_strips(ref4[:, 0], MC.PAD_MC, mb_w, mb_h,
                                    me_range)
    surf = me_sad.sad_cost_surface16_lanes(fy.contiguous(), strips, mb_w,
                                           mb_h, me_range)
    wins4 = MG.luma_windows(ref4, mb_w, mb_h).reshape(
        S * mb_h * mb_w, 4, MG.WIN_L, MG.WIN_L)
    winsu = MG.chroma_windows(refu, mb_w, mb_h).reshape(
        S * mb_h * mb_w, MG.WIN_C, MG.WIN_C)
    winsv = MG.chroma_windows(refv, mb_w, mb_h).reshape(
        S * mb_h * mb_w, MG.WIN_C, MG.WIN_C)
    mv_field = decide_mvs_pattern(surf, fy, wins4, lam_mb, mb_w, mb_h,
                                  me_range, mv_range)
    del surf, strips
    skip_ok = torch.zeros((S, mb_h, mb_w), dtype=torch.bool, device=dev)
    if fast_pskip:
        psk = pskip_mv_field(mv_field)
        skip_ok, skip_mv = probe_pskip(fy, fenc_u, fenc_v, wins4, winsu,
                                       winsv, psk, qp_mb, qpc_mb, mb_w,
                                       mb_h, mv_range)
        mv_field = torch.where(skip_ok[..., None], skip_mv, mv_field)
    mv8 = mv_field[:, :, :, None, None, :].expand(S, mb_h, mb_w, 2, 2, 2) \
        .contiguous()
    out = encode_p_residual(fy, fenc_u, fenc_v, wins4, winsu, winsv, mv8,
                            qp_mb, qpc_mb, mb_w, mb_h, dct_decimate, skip_ok)
    out["mv"] = mv8[:, :, :, 0, 0].contiguous()
    out["mv8"] = mv8
    out["partition"] = torch.zeros((S, mb_h, mb_w), dtype=_I32, device=dev)
    out["ref"] = torch.zeros((S, mb_h, mb_w), dtype=_I32, device=dev)
    out["bs"], out["feo"] = compute_strengths_p(
        out.pop("luma_nnz_bg"), out["cbp_luma"], out["cbp_chroma"], mv8,
        mb_w, mb_h)
    return out
