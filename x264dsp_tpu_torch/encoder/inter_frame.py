"""P-frame encode over a stream batch — port of
x264dsp_tpu/encoder/inter_frame.py: ``encode_p_frame`` with up to
REF_MAX references, the DIA or HEX pattern walk (me_method 0 or 1; one
launch of csrc/me_walk.cu per walk on the card, ops/me_walk.py), the
UMH surface argmin (2) and the ESA exact-MVP wavefront (3), the subpel
refine of subme 0-11, the fast P-skip probe, the 16x8/8x16/8x8
partition analysis, the scaling lists and noise reduction.

Every tensor carries a leading stream axis S in place of the JAX vmap.
With DIA or HEX and no partitions the walk reads the 16x16 SAD surface
in kernel K1's lane layout [row, dy, dx, mbx]; otherwise the search reads
the classic layout [mbx, dy, dx] of the K4 quadrant sums. The JAX CPU
path walks the classic layout, and
tests/test_me_methods.py::test_lane_walk_twins_match_classic holds the
two walks equal. Candidate minima update only on a strictly smaller
cost, in candidate order, as in the JAX code (me.c's COPY*_IF_LT).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import params as P
from ..ops import deblock as DB
from ..ops import mc as MC
from ..ops import mcgather as MG
from ..ops import me_sad
from ..ops import me_walk as ME
from ..ops import pixel as PX
from ..ops import residual_plane as RP
from ..ops import transforms as T
from ..ops.devtab import device_table
from ..ops.me_walk import (BIG, _MVBITS, _MVBITS_RANGE, _mvp_parts, mv_cost,
                           mvp_field_parallel)
from .intra_frame import optimize_chroma_dc

_I32 = torch.int32

# lambda2 table (encoder/analyse.c:113-130), QP 0..51
LAMBDA2_TAB = np.array([
    14, 18, 22, 28, 36, 45, 57, 72,
    91, 115, 145, 182, 230, 290, 365, 460,
    580, 731, 921, 1161, 1462, 1843, 2322, 2925,
    3686, 4644, 5851, 7372, 9289, 11703, 14745, 18578,
    23407, 29491, 37156, 46814, 58982, 74313, 93628, 117964,
    148626, 187257, 235929, 297252, 374514, 471859, 594505, 749029,
    943718, 1189010, 1498059, 1887436], np.int64)

# subpel recipe per subme (inter_frame.py:654, subpel_iterations of
# me.c:18-33 with the winner refine folded in): subme -> (hpel_iters,
# qpel_iters, use_satd, try_mvp). The fork has no trellis/psy-RD, so the
# RD levels 6-11 reduce to the larger iteration budgets.
SUBME_RECIPE = {
    0: (0, 0, False, False),
    1: (1, 1, False, True),
    2: (1, 1, True, True),
    3: (1, 2, True, False),
    4: (1, 3, True, False),
    5: (1, 4, True, False),
    6: (2, 2, True, False),
    7: (2, 2, True, False),
    8: (4, 10, True, False),
    9: (4, 10, True, False),
    10: (4, 10, True, False),
    11: (4, 10, True, False),
}


@functools.lru_cache(maxsize=None)
def make_mv_ranges(mb_w: int, mb_h: int, mv_range: int, device):
    """Per-MB legal qpel MV ranges (x264_mb_analyse_init,
    analyse.c:370-393): (mvmin_x, mvmax_x) (mb_w,), (mvmin_y, mvmax_y)
    (mb_h,) int32. Made once per shape and device (an upload is a host
    sync); no caller writes them."""
    fmv = mv_range * 4
    xs = np.arange(mb_w)
    ys = np.arange(mb_h)
    vals = (np.clip((-(xs << 4) - 24) << 2, -fmv, fmv - 1),
            np.clip((((mb_w - xs - 1) << 4) + 24) << 2, -fmv, fmv - 1),
            np.clip((-(ys << 4) - 24) << 2, -fmv, fmv),
            np.clip((((mb_h - ys - 1) << 4) + 24) << 2, -fmv, fmv - 1))
    return tuple(torch.as_tensor(v.astype(np.int32), device=device)
                 for v in vals)


@functools.lru_cache(maxsize=None)
def fullpel_bounds(mb_w: int, mb_h: int, mv_range: int, device):
    """The full-pel offsets each MB's search may take: its legal range
    less the reference's 6-pixel border (inter_frame.py:604-614): lo_x,
    hi_x (mb_w,), lo_y, hi_y (mb_h,) int32."""
    mvmin_x, mvmax_x, mvmin_y, mvmax_y = make_mv_ranges(mb_w, mb_h,
                                                        mv_range, device)
    return ((mvmin_x >> 2) + 6, (mvmax_x >> 2) - 6, (mvmin_y >> 2) + 6,
            (mvmax_y >> 2) - 6)


def _clip(x, lo, hi):
    """jnp.clip order: max with lo first, then min with hi."""
    return torch.minimum(torch.maximum(x, lo), hi)


def pskip_mv_field(mv_field):
    """Exact P-SKIP MV (mvpred.c:143-160) of every MB."""
    mv_a, ok_a, mv_b, ok_b, _, _ = _mvp_parts(mv_field)
    mvp = mvp_field_parallel(mv_field)
    a_zero = ok_a[None] & (mv_a == 0).all(-1)
    b_zero = ok_b[None] & (mv_b == 0).all(-1)
    zero = (~ok_a)[None] | (~ok_b)[None] | a_zero | b_zero
    return torch.where(zero[..., None], 0, mvp)


def decide_mvs_pattern(surf16, lanes: bool, fenc_y, wins4, lam, mb_w: int,
                       mb_h: int, me_range: int, mv_range: int, method: int,
                       subme: int):
    """DIA/HEX MV decision (decide_mvs_pattern, inter_frame.py:479) on the
    16x16 surface, in K1's lane layout (lanes=True) or the classic layout:
    a zero-MVP walk, then two walks with the median MVP propagated from
    the previous field, then the subpel refine. Returns (S, mb_h, mb_w, 2)
    qpel MVs."""
    R = me_range
    dev = surf16.device
    bounds = fullpel_bounds(mb_w, mb_h, mv_range, dev)
    lam32 = lam.to(_I32).contiguous()
    best, bcost, mvp = ME.pattern_walk(surf16, lanes, lam32, bounds, None, R,
                                       method)
    for _ in range(2):
        best, bcost, mvp = ME.pattern_walk(surf16, lanes, lam32, bounds, best,
                                           R, method)
    return subpel_refine_batch(best * 4, bcost, mvp, fenc_y, wins4, lam,
                               mb_w, mb_h,
                               make_mv_ranges(mb_w, mb_h, mv_range, dev),
                               subme)


def _legal_offsets(mb_w: int, mb_h: int, me_range: int, mv_range: int, dev):
    """The MV ranges, the full-pel offsets [-R, R] and the (mb_h, mb_w,
    dy, dx) mask of the offsets inside each MB's legal range less the
    reference's 6-pixel border (inter_frame.py:604-614)."""
    R = me_range
    lo_x, hi_x, lo_y, hi_y = fullpel_bounds(mb_w, mb_h, mv_range, dev)
    offs = torch.arange(-R, R + 1, device=dev, dtype=_I32)
    ok_x = ((offs[None, :] >= lo_x[:, None])
            & (offs[None, :] <= hi_x[:, None]))                 # (mb_w, n)
    ok_y = ((offs[None, :] >= lo_y[:, None])
            & (offs[None, :] <= hi_y[:, None]))                 # (mb_h, n)
    return (make_mv_ranges(mb_w, mb_h, mv_range, dev), offs,
            ok_y[:, None, :, None] & ok_x[None, :, None, :])


def _offset_mvs(k, n: int, R: int):
    """Flat offset indices k (dy * n + dx) -> qpel MVs (..., 2) int32."""
    k = k.to(_I32)
    return torch.stack([(k % n - R) * 4, (k // n - R) * 4], -1)


def decide_mvs_parallel(surf16, fenc_y, wins4, lam, mb_w: int, mb_h: int,
                        me_range: int, mv_range: int, subme: int):
    """UMH MV decision (decide_mvs_parallel, inter_frame.py:592) on the
    classic 16x16 surface (S, mb_h, mb_w, n, n): the SAD argmin over the
    legal offsets, a median-MVP field from those MVs, the argmin of SAD
    plus lambda * mvbits against it (first minimum on ties), then the
    subpel refine. Returns (S, mb_h, mb_w, 2) qpel MVs."""
    R = me_range
    n = 2 * R + 1
    S = surf16.shape[0]
    ranges, offs, ok = _legal_offsets(mb_w, mb_h, R, mv_range, surf16.device)
    k0 = torch.argmin(torch.where(ok, surf16, BIG).reshape(
        S, mb_h, mb_w, n * n), -1)
    mvp = mvp_field_parallel(_offset_mvs(k0, n, R))
    bias = mv_cost(lam[..., None, None], offs[None, :] * 4,
                   offs[:, None] * 4, mvp[..., 0][..., None, None],
                   mvp[..., 1][..., None, None])
    cost = torch.where(ok, surf16 + bias, BIG).reshape(S, mb_h, mb_w, n * n)
    k = torch.argmin(cost, -1, keepdim=True)
    return subpel_refine_batch(_offset_mvs(k[..., 0], n, R),
                               torch.gather(cost, -1, k)[..., 0], mvp,
                               fenc_y, wins4, lam, mb_w, mb_h, ranges, subme)


@functools.lru_cache(maxsize=None)
def _esa_schedule(mb_w: int, mb_h: int):
    """The 2:1 diagonals (ops/deblock.diag_schedule: the order of
    intra_frame.py:515 _diag_schedule) as flat MB indices y * mb_w + x,
    with each MB's MVP neighbours A (left), B (top) and C (top-right, else
    top-left) as flat indices, B = mb_w * mb_h where the neighbour lies
    outside the frame, and whether exactly one of them lies inside
    (common/mvpred.c:103-137). Returns numpy arrays idx (N,), nb (N, 3),
    single (N,) over all diagonals in order, and each diagonal's
    [start, end) in them."""
    B = mb_w * mb_h
    idx, nb, single, spans = [], [], [], []
    for ys, xs in DB.diag_schedule(mb_w, mb_h):
        start = len(idx)
        for y, x in zip(ys, xs):
            a = y * mb_w + x - 1 if x >= 1 else B
            b = (y - 1) * mb_w + x if y >= 1 else B
            if y >= 1 and x + 1 < mb_w:
                c = (y - 1) * mb_w + x + 1
            elif y >= 1 and x >= 1:
                c = (y - 1) * mb_w + x - 1
            else:
                c = B
            idx.append(y * mb_w + x)
            nb.append((a, b, c))
            single.append(sum(v < B for v in (a, b, c)) == 1)
        spans.append((start, len(idx)))
    return (np.array(idx, np.int64), np.array(nb, np.int64),
            np.array(single), spans)


def decide_mvs(surf16, fenc_y, wins4, lam, mb_w: int, mb_h: int,
               me_range: int, mv_range: int, subme: int):
    """ESA MV decision (decide_mvs, inter_frame.py:200): the exact
    sequential-MVP wavefront over the 2:1 diagonals, one step per
    diagonal. Each MB of a diagonal takes the median MVP (_mvp_16x16,
    :148) of its neighbours, all decided on earlier diagonals, and the
    argmin of its surface plus lambda * mvbits over the legal offsets
    (first minimum on ties); then the subpel refine against the exact MVP
    field. surf16 (S, mb_h, mb_w, n, n) classic layout. Fixed step count,
    no host sync. Returns (S, mb_h, mb_w, 2) qpel MVs."""
    R = me_range
    n = 2 * R + 1
    S = surf16.shape[0]
    B = mb_w * mb_h
    dev = surf16.device
    ranges, offs, ok = _legal_offsets(mb_w, mb_h, R, mv_range, dev)
    idx_np, nb_np, single_np, spans = _esa_schedule(mb_w, mb_h)
    idx_all = device_table(idx_np, dev, torch.long)
    nb_all = device_table(nb_np, dev, torch.long)
    single_all = device_table(single_np, dev, torch.bool)
    ok_flat = ok.reshape(B, n, n)
    surf = surf16.reshape(S, B, n, n)
    lam_flat = lam.reshape(S, B)
    bits = device_table(_MVBITS, dev)
    offs4 = offs * 4
    # slot B of the MV field stays 0: the MV of a neighbour outside the frame
    mv = torch.zeros((S, B + 1, 2), dtype=_I32, device=dev)
    cost_f = torch.zeros((S, B), dtype=_I32, device=dev)
    for start, end in spans:
        idx = idx_all[start:end]
        k = end - start
        cand = mv[:, nb_all[start:end]]                     # (S, k, 3, 2)
        total = cand.sum(2, dtype=_I32)
        med = total - cand.amin(2) - cand.amax(2)
        mvp = torch.where(single_all[start:end, None], total, med)
        bx = bits[(offs4 - mvp[..., 0:1]).abs().clamp(
            max=_MVBITS_RANGE - 1).long()]                  # (S, k, n)
        by = bits[(offs4 - mvp[..., 1:2]).abs().clamp(
            max=_MVBITS_RANGE - 1).long()]
        bias = lam_flat[:, idx][..., None, None] * (by[..., :, None]
                                                    + bx[..., None, :])
        cost = torch.where(ok_flat[idx], surf[:, idx] + bias, BIG).reshape(
            S, k, n * n)
        kk = torch.argmin(cost, -1, keepdim=True)
        cost_f.index_copy_(1, idx, torch.gather(cost, -1, kk)[..., 0])
        mv.index_copy_(1, idx, _offset_mvs(kk[..., 0], n, R))
    mv_field = mv[:, :B].reshape(S, mb_h, mb_w, 2)
    # every neighbour inside the frame is decided now, so the exact MVP of
    # every MB is the one-pass median field
    return subpel_refine_batch(mv_field, cost_f.reshape(S, mb_h, mb_w),
                               mvp_field_parallel(mv_field), fenc_y, wins4,
                               lam, mb_w, mb_h, ranges, subme)


def tile_mb(plane, mb_w: int, mb_h: int, mbsize: int):
    """(S, mb_h*m, mb_w*m) -> (S*mb_h*mb_w, m, m)."""
    S = plane.shape[0]
    return plane.reshape(S, mb_h, mbsize, mb_w, mbsize).permute(
        0, 1, 3, 2, 4).reshape(S * mb_h * mb_w, mbsize, mbsize)


def untile_mb(tiles, S: int, mb_w: int, mb_h: int, mbsize: int):
    return tiles.reshape(S, mb_h, mb_w, mbsize, mbsize).permute(
        0, 1, 3, 2, 4).reshape(S, mb_h * mbsize, mb_w * mbsize)


class _BlockCost:
    """Subpel costs of one block shape for all MBs (B = S*mb_h*mb_w): the
    (bh, bw) block at (sub_y, sub_x) of the MB, motion-compensated from
    the per-MB windows `wins` (full-pel margin `margin`) at qpel MVs, its
    SAD or SATD against the source block f_blk (B, bh, bw), plus lambda *
    mvbits(mv - mvp)."""

    def __init__(self, f_blk, wins, margin, sub_y, sub_x, lam, mvpx, mvpy):
        self.f, self.wins, self.margin = f_blk, wins, margin
        self.bh, self.bw = f_blk.shape[1:]
        self.sub_y, self.sub_x = sub_y, sub_x
        self.lam, self.mvpx, self.mvpy = lam, mvpx, mvpy

    def at(self, mx, my, satd: bool):
        blk = MG.mc_luma_batched(self.wins, mx, my, self.bh, self.bw,
                                 self.sub_y, self.sub_x, self.margin)
        d = PX.satd(self.f, blk) if satd else PX.sad(self.f, blk)
        return d + mv_cost(self.lam, mx, my, self.mvpx, self.mvpy)

    def try_mv(self, bcost, bmx, bmy, mx, my, gate):
        """One SAD candidate, taken where gate and strictly better."""
        c = self.at(mx, my, False)
        better = gate & (c < bcost)
        return (torch.where(better, c, bcost), torch.where(better, mx, bmx),
                torch.where(better, my, bmy))

    def diamond(self, bcost, bmx, bmy, scale: int, gate, satd: bool):
        """One 4-candidate diamond around (bmx, bmy), all four on one MC
        call, accepted in me.c's order where gate and strictly better."""
        mxs = torch.stack([bmx, bmx, bmx - scale, bmx + scale], 1)
        mys = torch.stack([bmy - scale, bmy + scale, bmy, bmy], 1)
        blks = MG.mc_luma_multi(self.wins, mxs, mys, self.bh, self.bw,
                                self.sub_y, self.sub_x, self.margin)
        f = self.f[:, None]
        d = PX.satd(f, blks) if satd else PX.sad(f, blks)
        for k in range(4):
            c = d[:, k] + mv_cost(self.lam, mxs[:, k], mys[:, k], self.mvpx,
                                  self.mvpy)
            better = gate & (c < bcost)
            bcost = torch.where(better, c, bcost)
            bmx = torch.where(better, mxs[:, k], bmx)
            bmy = torch.where(better, mys[:, k], bmy)
        return bcost, bmx, bmy

    def diamonds(self, bcost, bmx, bmy, n_iter: int, scale: int, active,
                 satd: bool, allowed=None):
        """Up to n_iter diamonds with the per-MB early stop: an MB steps
        while active (and allowed(bmx, bmy), a bounds test) and stops once
        a step leaves its centre unchanged."""
        for _ in range(n_iter):
            gate = active if allowed is None else active & allowed(bmx, bmy)
            ox, oy = bmx, bmy
            bcost, bmx, bmy = self.diamond(bcost, bmx, bmy, scale, gate,
                                           satd)
            active = active & ((bmx != ox) | (bmy != oy))
            if not bool(active.any()):
                break       # every MB has stopped: later steps no-op
        return bcost, bmx, bmy


def _in_range(lo_x, hi_x, lo_y, hi_y):
    """Bounds test of the qpel diamonds (me.c:541-581): strictly inside
    the legal MV range."""
    return lambda mx, my: ((my > lo_y) & (my < hi_y) & (mx > lo_x)
                           & (mx < hi_x))


def _flat_ranges(ranges, S: int, mb_w: int, mb_h: int):
    """Per-MB qpel MV ranges flattened to (B,): lo_x, hi_x, lo_y, hi_y."""
    mvmin_x, mvmax_x, mvmin_y, mvmax_y = ranges
    B = S * mb_h * mb_w
    return (mvmin_x[None, None, :].expand(S, mb_h, mb_w).reshape(B),
            mvmax_x[None, None, :].expand(S, mb_h, mb_w).reshape(B),
            mvmin_y[None, :, None].expand(S, mb_h, mb_w).reshape(B),
            mvmax_y[None, :, None].expand(S, mb_h, mb_w).reshape(B))


def subpel_refine_batch(mv_field, cost_field, mvp_field, fenc_y, wins4,
                        lam, mb_w, mb_h, ranges, subme: int):
    """Subpel refine of the 16x16 MVs (_subpel_refine_batch,
    inter_frame.py:674; refine_subpel, me.c:466-581) with the subme
    recipe, all MBs of all streams at once (B = S*mb_h*mb_w): the MVP's
    subpel candidate on the full windows where the recipe tries it, the
    windows recentred on the best full-pel position, the half-pel SAD
    diamonds, the SATD re-cost where the recipe switches metric, then
    the quarter-pel diamonds (one SAD diamond at subme 1)."""
    hpel_iters, qpel_iters, use_satd, try_mvp = \
        SUBME_RECIPE[min(max(subme, 0), 11)]
    S = fenc_y.shape[0]
    B = S * mb_h * mb_w
    f = tile_mb(fenc_y.to(_I32), mb_w, mb_h, 16)
    bmx = mv_field[..., 0].reshape(B)
    bmy = mv_field[..., 1].reshape(B)
    bcost = cost_field.reshape(B)
    mvpx = mvp_field[..., 0].reshape(B)
    mvpy = mvp_field[..., 1].reshape(B)
    lamf = lam.reshape(B)
    lo_x, hi_x, lo_y, hi_y = _flat_ranges(ranges, S, mb_w, mb_h)
    every = torch.ones((B,), dtype=torch.bool, device=f.device)

    if try_mvp and hpel_iters:
        # the MVP's subpel candidate on the full windows (me.c:484-491)
        full = _BlockCost(f, wins4, MG.M_LUMA, 0, 0, lamf, mvpx, mvpy)
        mx = MG.clamp_qpel(_clip(mvpx, lo_x + 2, hi_x - 2))
        my = MG.clamp_qpel(_clip(mvpy, lo_y + 2, hi_y - 2))
        bcost, bmx, bmy = full.try_mv(bcost, bmx, bmy, mx, my, every)

    # recentre on the best full-pel position (extract_windows4); m covers
    # the recipe's drift, capped at 4 (inter_frame.py:753)
    m = min(4, (2 * hpel_iters + qpel_iters + 3) // 4 + 2)
    base_x = (bmx >> 2).clamp(-(MG.M_LUMA - m), MG.M_LUMA - m)
    base_y = (bmy >> 2).clamp(-(MG.M_LUMA - m), MG.M_LUMA - m)
    wins_s = MG.extract_windows4(wins4, base_x, base_y, 16, 16, m)
    bx4, by4 = base_x * 4, base_y * 4
    bmx, bmy = bmx - bx4, bmy - by4
    cost = _BlockCost(f, wins_s, m, 0, 0, lamf, mvpx - bx4, mvpy - by4)
    # frame bounds made window-relative, cut to the window's coverage
    cov_lo, cov_hi = -4 * (m - 1), 4 * (m - 1) - 1
    lo_x = torch.clamp(lo_x - bx4, min=cov_lo)
    hi_x = torch.clamp(hi_x - bx4, max=cov_hi)
    lo_y = torch.clamp(lo_y - by4, min=cov_lo)
    hi_y = torch.clamp(hi_y - by4, max=cov_hi)

    def covered(mx, my):
        return ((my - 2 >= cov_lo) & (my + 2 <= cov_hi)
                & (mx - 2 >= cov_lo) & (mx + 2 <= cov_hi))

    # half-pel diamonds, SAD (me.c:494-517)
    bcost, bmx, bmy = cost.diamonds(bcost, bmx, bmy, hpel_iters, 2, every,
                                    False, covered)
    if use_satd:
        # switch metric: re-cost the half-pel best with SATD (me.c:520-524)
        bcost = cost.at(bmx, bmy, True)
    inside = _in_range(lo_x, hi_x, lo_y, hi_y)
    if subme == 1:
        # one quarter-pel SAD diamond (subme 1, me.c:565-581)
        bcost, bmx, bmy = cost.diamonds(bcost, bmx, bmy, 1, 1, every, False,
                                        inside)
    else:
        # quarter-pel diamonds, SATD (me.c:541-564)
        bcost, bmx, bmy = cost.diamonds(bcost, bmx, bmy, qpel_iters, 1,
                                        every, use_satd, inside)
    return torch.stack([(bmx + bx4).reshape(S, mb_h, mb_w),
                        (bmy + by4).reshape(S, mb_h, mb_w)], -1)


def _refine_block_batch(wins4, f_blk, bmx, bmy, bcost, mvpx, mvpy, lam,
                        ranges_f, sub_y: int, sub_x: int, gate, subme: int):
    """Subpel refine of one partition block for all MBs
    (_refine_block_batch, inter_frame.py:1125): on the full windows at the
    block's offset in the MB, the half-pel diamonds start from `gate` (the
    MBs whose chosen shape holds this block) with no coverage test, and
    subme 1 takes one quarter-pel diamond. All arguments (B,)-shaped;
    returns (bmx, bmy, bcost)."""
    hpel_iters, qpel_iters, use_satd, try_mvp = \
        SUBME_RECIPE[min(max(subme, 0), 11)]
    lo_x, hi_x, lo_y, hi_y = ranges_f
    cost = _BlockCost(f_blk, wins4, MG.M_LUMA, sub_y, sub_x, lam, mvpx,
                      mvpy)
    if try_mvp and hpel_iters:
        mx = MG.clamp_qpel(_clip(mvpx, lo_x + 2, hi_x - 2))
        my = MG.clamp_qpel(_clip(mvpy, lo_y + 2, hi_y - 2))
        bcost, bmx, bmy = cost.try_mv(bcost, bmx, bmy, mx, my, gate)
    bcost, bmx, bmy = cost.diamonds(bcost, bmx, bmy, hpel_iters, 2, gate,
                                    False)
    if use_satd:
        bcost = cost.at(bmx, bmy, True)
    n_qpel = 1 if subme == 1 else qpel_iters
    bcost, bmx, bmy = cost.diamonds(bcost, bmx, bmy, n_qpel, 1, gate,
                                    use_satd, _in_range(*ranges_f))
    return bmx, bmy, bcost


def decide_partitions(cost8, mv16_field, fenc_y, wins4, lam, mb_w: int,
                      mb_h: int, me_range: int, mv_range: int, skip_mask,
                      subme: int):
    """P partition analysis (decide_partitions, inter_frame.py:1202;
    x264_mb_analyse_inter_p8x8/p16x8/p8x16, analyse.c:864-1057, and the
    partition compare :1145-1182). cost8: (S, mb_h, mb_w, 2, 2, n, n)
    quadrant SADs (K4); mv16_field: the refined 16x16 MVs. Full-pel
    argmin per block shape around the 16x16 result (first minimum on
    ties), the min-cost shape in the COPY3_IF_LT order 8x8, 16x8, 8x16,
    skipped MBs forced to 16x16, then the subpel refine of each shape's
    blocks. Returns (partition (S, mb_h, mb_w) in {0:16x16, 1:16x8,
    2:8x16, 3:8x8}, mv8 (S, mb_h, mb_w, 2, 2, 2) per-quadrant qpel MVs)."""
    R = me_range
    n = 2 * R + 1
    S = cost8.shape[0]
    B = S * mb_h * mb_w
    dev = cost8.device
    ranges, offs, ok = _legal_offsets(mb_w, mb_h, R, mv_range, dev)

    # search bias around the 16x16 result (the partition MEs seed from
    # me16x16.mv, analyse.c:880): lam * (bits(dx) + bits(dy))
    bits = device_table(_MVBITS, dev)

    def axis_bits(mvp):
        d = (offs * 4 - mvp[..., None]).abs().clamp(0, _MVBITS_RANGE - 1)
        return bits[d.long()]                            # (S, mb_h, mb_w, n)
    bias = lam[..., None, None] * (axis_bits(mv16_field[..., 1])[..., :, None]
                                   + axis_bits(mv16_field[..., 0])[..., None, :])

    def pick(surf):
        cost = torch.where(ok, surf + bias, BIG).reshape(S, mb_h, mb_w, n * n)
        k = torch.argmin(cost, dim=-1, keepdim=True)     # first minimum
        c = torch.gather(cost, -1, k)[..., 0]
        return _offset_mvs(k[..., 0], n, R), c

    q = [[pick(cost8[:, :, :, qy, qx]) for qx in range(2)] for qy in range(2)]
    top = pick(cost8[:, :, :, 0, 0] + cost8[:, :, :, 0, 1])     # 16x8
    bot = pick(cost8[:, :, :, 1, 0] + cost8[:, :, :, 1, 1])
    left = pick(cost8[:, :, :, 0, 0] + cost8[:, :, :, 1, 0])    # 8x16
    right = pick(cost8[:, :, :, 0, 1] + cost8[:, :, :, 1, 1])
    _, c16 = pick(cost8.sum(dim=(3, 4), dtype=_I32))

    c8x8 = q[0][0][1] + q[0][1][1] + q[1][0][1] + q[1][1][1]
    part = torch.zeros((S, mb_h, mb_w), dtype=_I32, device=dev)
    best = c16
    for cand, pid in ((c8x8, 3), (top[1] + bot[1], 1),
                      (left[1] + right[1], 2)):
        t = cand < best
        best = torch.where(t, cand, best)
        part = torch.where(t, pid, part)
    part = torch.where(skip_mask, 0, part)

    f16 = tile_mb(fenc_y.to(_I32), mb_w, mb_h, 16)
    lamf = lam.reshape(B)
    ranges_f = _flat_ranges(ranges, S, mb_w, mb_h)
    partf = part.reshape(B)
    mvpx, mvpy = mv16_field[..., 0].reshape(B), mv16_field[..., 1].reshape(B)

    def refine(res, bh, bw, sy, sx, pid):
        mv0, c0 = res
        bmx, bmy, _ = _refine_block_batch(
            wins4, f16[:, sy:sy + bh, sx:sx + bw], mv0[..., 0].reshape(B),
            mv0[..., 1].reshape(B), c0.reshape(B), mvpx, mvpy, lamf,
            ranges_f, sy, sx, partf == pid, subme)
        return torch.stack([bmx, bmy], -1).reshape(S, mb_h, mb_w, 2)

    r_tb = (refine(top, 8, 16, 0, 0, 1), refine(bot, 8, 16, 8, 0, 1))
    r_lr = (refine(left, 16, 8, 0, 0, 2), refine(right, 16, 8, 0, 8, 2))
    r_q = [[refine(q[qy][qx], 8, 8, qy * 8, qx * 8, 3) for qx in range(2)]
           for qy in range(2)]

    # per-quadrant MVs by the chosen shape (inter_frame.py:1297-1310)
    def sel(pid):
        return (part == pid)[..., None]
    mv8 = torch.stack([torch.stack([
        torch.where(sel(1), r_tb[qy], torch.where(
            sel(2), r_lr[qx], torch.where(sel(3), r_q[qy][qx], mv16_field)))
        for qx in range(2)], 3) for qy in range(2)], 3)
    return part, mv8


def probe_pskip(fenc_y, fenc_u, fenc_v, wins4, winsu, winsv, pskip_mv,
                qp_mb, qpc_mb, mb_w: int, mb_h: int, mv_range: int,
                cqm=None):
    """x264_macroblock_probe_pskip (macroblock.c:492-604) for every MB,
    on the inter scaling lists (4PY, 4PC) of cqm: returns (ok (S, mb_h,
    mb_w) bool, clamped skip MVs (S, mb_h, mb_w, 2))."""
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
                                       False, 4, cqm, 1))
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
        q_dc = T.quant_dc(T.hadamard2x2(dc_mb), qpc_mb, False, cqm, 3)
        dc_nz = (q_dc != 0).any(-1)
        cm_ac = torch.cat([torch.zeros_like(cm[:, :1]), cm[:, 1:]], 1)
        zc = RP.zigzag_order(RP.quant_cm(cm_ac, qpc_mb, False, 2, cqm, 3))
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


def _denoise_cm(cm, off, live_bg):
    """x264_denoise_dct (common/quant.c:194; inter_frame.py:896) over the
    coefficient planes (S, 16, Hb, Wb): per-stream per-position |level|
    sums over the live blocks (P_SKIP MBs never reach denoise), then each
    coefficient moved toward zero by its position's offset off (16,),
    sign kept. Returns (denoised planes, (S, 16) int64 sums)."""
    a = cm.abs()
    sums = torch.where(live_bg[:, None], a, 0).sum(dim=(2, 3),
                                                   dtype=torch.int64)
    lvl = (a - off.to(cm.dtype)[None, :, None, None]).clamp(min=0)
    return torch.sign(cm) * lvl, sums


def _encode_chroma_plane(fenc8p, pred8p, qpc_mb, b_decimate, fs, mb_h, mb_w,
                         cqm=None, nr_off=None):
    """One chroma channel of x264_mb_encode_chroma (b_inter=1,
    macroblock.c:175-300), whole plane (S, 8mb_h, 8mb_w), on the scaling
    list 4PC (set 3) of cqm. nr_off: (16,) noise-reduction offsets,
    applied before the 2x2 DC extraction (inter_frame.py:1008-1010); their
    (S, 16) sums come back as nr_sum."""
    S = fenc8p.shape[0]
    cm = RP.sub_dct_cm(fenc8p, pred8p)
    nr = {}
    if nr_off is not None:
        cm, nr["nr_sum"] = _denoise_cm(cm, nr_off, ~RP.up(fs, 2))
    dc_bg = cm[:, 0]
    cm_ac = torch.cat([torch.zeros_like(cm[:, :1]), cm[:, 1:]], 1)
    q_cm = RP.quant_cm(cm_ac, qpc_mb, False, 2, cqm, 3)
    z_cm = RP.zigzag_order(q_cm)
    nnz_ac_bg = RP.nnz_cm(z_cm)
    ac_levels = RP.chroma_levels_coding(z_cm, mb_h, mb_w)
    nnz_ac = RP.blockgrid_to_mb(nnz_ac_bg, mb_h, mb_w, 2).reshape(
        S, mb_h, mb_w, 4)
    dc_mb = RP.blockgrid_to_mb(dc_bg, mb_h, mb_w, 2).reshape(S, mb_h, mb_w, 4)
    q_dc = T.quant_dc(T.hadamard2x2(dc_mb), qpc_mb, False, cqm, 3)
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

    opt_dc, opt_nz = optimize_chroma_dc(q_dc, qpc_mb, cqm, 3)
    use_opt = (~nz_ac) & nz_dc & (qpc_mb <= 22)
    dc_final = torch.where(use_opt[..., None], opt_dc, q_dc)
    nz_dc_final = torch.where(use_opt, opt_nz, nz_dc)
    dc_levels = torch.where(nz_dc_final[..., None], dc_final[..., [0, 2, 1, 3]],
                            0)
    dq_dc = T.idct_dequant_2x2_dc(dc_final, qpc_mb, cqm, 3)
    dq_cm = RP.dequant_cm(q_cm, qpc_mb, 2, cqm, 3)
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
                nnz_ac=nnz_ac, nz_dc=nz_dc_final.to(_I32), has_ac=nz_ac,
                **nr)


def encode_p_residual(fenc_y, fenc_u, fenc_v, wins4, winsu, winsv, mv8,
                      qp_mb, qpc_mb, mb_w: int, mb_h: int,
                      dct_decimate: bool, force_skip, cqm=None,
                      nr_offset=None):
    """Inter residual encode of all MBs (encode_p_residual,
    inter_frame.py:912): MC, DCT, inter quant with DCT decimation
    (macroblock.c:409-446), chroma, reconstruction, on the inter scaling
    lists of cqm. force_skip MBs encode as MC-only skips. nr_offset: the
    (luma, chroma) (16,) noise-reduction offsets or None; with them the
    dict also holds the coefficient sums nr_sum_y, nr_sum_c (S, 16) and
    the counts nr_count (S, 2) that the host update reads."""
    S = fenc_y.shape[0]
    B = S * mb_h * mb_w
    fs = force_skip
    mv8f = mv8.reshape(B, 2, 2, 2)
    pred_y = untile_mb(_mc_luma_mv8(wins4, mv8f), S, mb_w, mb_h, 16)
    cm = RP.sub_dct_cm(fenc_y, pred_y)
    live_bg = ~RP.up(fs, 4)
    nr = {}
    if nr_offset is not None:
        # noise reduction on every inter-coded path (macroblock.c:520-521)
        cm, nr["nr_sum_y"] = _denoise_cm(cm, nr_offset[0], live_bg)
        n_live = (~fs).reshape(S, -1).sum(1, dtype=torch.int64)
        nr["nr_count"] = torch.stack([n_live * 16, n_live * 4], 1)
    q_cm = RP.quant_cm(cm, qp_mb, False, 4, cqm, 1)
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
    dq_cm = RP.mask_cm(RP.dequant_cm(q_cm, qp_mb, 4, cqm, 1), nnz_bg)
    recon_y = RP.idct_add_plane(pred_y, dq_cm)
    levels = RP.luma_levels_coding(z_cm, mb_h, mb_w)
    nnz = RP.luma_nnz_coding(nnz_bg, mb_h, mb_w)

    pred_u = untile_mb(_mc_chroma_mv8(winsu, mv8f), S, mb_w, mb_h, 8)
    pred_v = untile_mb(_mc_chroma_mv8(winsv, mv8f), S, mb_w, mb_h, 8)
    nr_c = None if nr_offset is None else nr_offset[1]
    eu = _encode_chroma_plane(fenc_u, pred_u, qpc_mb, dct_decimate, fs,
                              mb_h, mb_w, cqm, nr_c)
    ev = _encode_chroma_plane(fenc_v, pred_v, qpc_mb, dct_decimate, fs,
                              mb_h, mb_w, cqm, nr_c)
    if nr_offset is not None:
        nr["nr_sum_c"] = eu["nr_sum"] + ev["nr_sum"]
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
        chroma_nz_dc=torch.stack([eu["nz_dc"], ev["nz_dc"]], 3), **nr)


def mv8_to_mv4(mv8, mb_w: int, mb_h: int):
    """(S, mb_h, mb_w, 2, 2, 2) quadrant MVs -> (S, 4mb_h, 4mb_w, 2)."""
    S = mv8.shape[0]
    g = mv8.permute(0, 1, 3, 2, 4, 5).reshape(S, mb_h * 2, mb_w * 2, 2)
    return g.repeat_interleave(2, 1).repeat_interleave(2, 2)


def blocks4_grid(vals, mb_h: int, mb_w: int):
    """(S, mb_h, mb_w, 16) per-4x4-block values in coding order -> the
    (S, 4mb_h, 4mb_w) block grid (ops/mcgather.py:307 blocks4_grid; the
    inverse of residual_plane.luma_nnz_coding)."""
    S = vals.shape[0]
    t = vals.reshape(S, mb_h, mb_w, 2, 2, 2, 2).permute(0, 1, 3, 5, 2, 4, 6)
    return t.reshape(S, mb_h * 4, mb_w * 4)


def compute_strengths_p(nnz_bg, cbp_luma, cbp_chroma, mv8, mb_w, mb_h,
                        ref_mb):
    """Deblock strengths of a P frame (x264_macroblock_deblock_strength,
    macroblock.c:677; inter_frame.py:1739-1756) from each MB's reference
    index ref_mb (S, mb_h, mb_w): returns (bs, first_edge_only)."""
    S = nnz_bg.shape[0]
    dev = nnz_bg.device
    ref4 = ref_mb.repeat_interleave(4, 1).repeat_interleave(4, 2)
    intra = torch.zeros((S, mb_h, mb_w), dtype=torch.bool, device=dev)
    bs = DB.compute_strengths(nnz_bg, mv8_to_mv4(mv8, mb_w, mb_h), ref4,
                              intra)
    feo = ((cbp_luma | (cbp_chroma << 4)) == 0).to(_I32)
    return bs, feo


def fullpel_cost_surfaces_8x8(fenc_y, ref_full, mb_w: int, mb_h: int,
                              me_range: int):
    """Quadrant SADs of every MB at every full-pel offset in [-R, R]^2
    (fullpel_cost_surfaces_8x8, inter_frame.py:101): ref_full (S, Hp, Wp)
    padded full-pel planes (PAD_MC border). Kernel K4 on a CUDA tensor.
    Returns (S, mb_h, mb_w, 2, 2, 2R+1, 2R+1) int32."""
    strips = me_sad.make_ref_strips(ref_full, MC.PAD_MC, mb_w, mb_h,
                                    me_range)
    return me_sad.sad_cost_surfaces_8x8(fenc_y.to(_I32).contiguous(), strips,
                                        mb_w, mb_h, me_range)


def fullpel_cost_surfaces(fenc_y, ref_full, mb_w: int, mb_h: int,
                          me_range: int):
    """16x16 SAD surfaces, the quadrant sums (inter_frame.py:137):
    (S, mb_h, mb_w, 2R+1, 2R+1) int32."""
    return fullpel_cost_surfaces_8x8(fenc_y, ref_full, mb_w, mb_h,
                                     me_range).sum(dim=(3, 4), dtype=_I32)


def _ref_bits(r: int, n_ref: int) -> int:
    """te(n_ref - 1) bit size of reference index r (x264_cost_ref,
    analyse.c:300-308; inter_frame.py:1760)."""
    if n_ref <= 1:
        return 0
    if n_ref == 2:
        return 1
    return 2 * int(np.floor(np.log2(r + 1))) + 1


def select_ref(cost8_r, lam_mb, me_range: int):
    """The per-MB reference of the multi-ref analysis (inter_frame.py
    :1845-1853; analyse.c:787-862): for each reference, the MB's least
    full-pel 16x16 SAD + lambda * (mv bits at a zero MVP) over the search
    window, plus lambda * its te() bits; the nearest reference wins ties
    (jnp.argmin's first minimum, written as a strict-less sweep so that it
    does not rest on how torch.argmin breaks ties). cost8_r (S, n_ref,
    mb_h, mb_w, 2, 2, n, n) quadrant SADs, lam_mb (S, mb_h, mb_w). Returns
    ref_mb (S, mb_h, mb_w) int32."""
    n_ref = cost8_r.shape[1]
    bits = device_table(_MVBITS, lam_mb.device)
    off_bits = bits[4 * torch.arange(-me_range, me_range + 1,
                                     device=lam_mb.device).abs()]
    mv_grid = off_bits[:, None] + off_bits[None, :]
    lam = lam_mb[..., None, None]
    ref_mb = torch.zeros_like(lam_mb)
    best = None
    for r in range(n_ref):
        surf = cost8_r[:, r].sum(dim=(3, 4), dtype=_I32)
        c = (surf + lam * mv_grid).flatten(3).amin(-1) \
            + lam_mb * _ref_bits(r, n_ref)
        if best is None:
            best = c
            continue
        better = c < best
        best = torch.where(better, c, best)
        ref_mb = torch.where(better, r, ref_mb)
    return ref_mb


def _pick_ref(per_ref, ref_mb):
    """Per-MB rows of the chosen reference: per_ref (S, n_ref, B, ...)
    with B = mb_h * mb_w, ref_mb (S, mb_h, mb_w) -> (S * B, ...). An index
    gather stands in for the JAX code's bf16 one-hot sums."""
    S, _, B = per_ref.shape[:3]
    s_idx = torch.arange(S, device=per_ref.device)[:, None]
    b_idx = torch.arange(B, device=per_ref.device)[None, :]
    return per_ref[s_idx, ref_mb.reshape(S, B).long(), b_idx].reshape(
        (S * B,) + per_ref.shape[3:])


def encode_p_frame(fenc_y, fenc_u, fenc_v, ref4, refu, refv, qp_mb, qpc_mb,
                   lam_mb, mb_w: int, mb_h: int, me_range: int,
                   mv_range: int, dct_decimate: bool,
                   fast_pskip: bool = True, me_method: int = P.ME_DIA,
                   subme: int = 1, partitions: bool = False, n_ref: int = 1,
                   cqm=None, nr_offset=None):
    """P-frame pipeline for S streams: fenc_* (S, H, W) planes; ref4
    (S, 4, Hp, Wp), refu/refv (S, Hc+P, Wc+P) int32 reference planes
    (mc.make_ref_planes / pad_chroma), or with n_ref > 1 (S, n_ref, ...)
    the active references nearest first; qp/qpc/lam (S, mb_h, mb_w)
    int32. Returns the syntax + recon dict of the JAX encode_p_frame
    (me_method DIA, HEX, UMH or ESA, subme 0-11, partitions on or off, up
    to REF_MAX references, the scaling lists cqm, noise reduction at
    nr_offset), each tensor with a leading S axis.

    With one reference, DIA or HEX and no partitions the walk is the only
    reader of the SAD surface, so kernel K1 sums the whole MB in-kernel
    (the surface16 path, inter_frame.py:1807); otherwise kernel K4 writes
    the quadrant surfaces and the search reads their sum (:1823, :1873)
    in the classic layout. With n_ref > 1 the references ride the stream
    axis of K4, K2a and K2b (S * n_ref rows: one launch each per frame)
    and each MB takes the reference of select_ref, its quadrant surfaces
    and windows gathered from that reference's (:1830-1872); the P-skip
    probe reads reference 0 and skipped MBs go back to it (:1891-1906);
    partitions inherit the MB's reference."""
    S = fenc_y.shape[0]
    dev = fenc_y.device
    fy = fenc_y.to(_I32).contiguous()
    B = S * mb_h * mb_w
    classic = (partitions or n_ref > 1
               or me_method not in (P.ME_DIA, P.ME_HEX))
    if n_ref > 1:
        # the references on the stream axis, stream-major
        ref4, refu, refv = (r.reshape((S * n_ref,) + r.shape[2:])
                            for r in (ref4, refu, refv))
        cost8_r = fullpel_cost_surfaces_8x8(
            fy.repeat_interleave(n_ref, 0), ref4[:, 0], mb_w, mb_h,
            me_range)
        cost8_r = cost8_r.reshape((S, n_ref) + cost8_r.shape[1:])
        ref_mb = select_ref(cost8_r, lam_mb, me_range)
        cost8 = _pick_ref(cost8_r.flatten(2, 3), ref_mb).reshape(
            (S, mb_h, mb_w) + cost8_r.shape[4:])
        del cost8_r
        surf16 = cost8.sum(dim=(3, 4), dtype=_I32)
        if not partitions:
            del cost8
    elif classic:
        cost8 = fullpel_cost_surfaces_8x8(fy, ref4[:, 0], mb_w, mb_h,
                                          me_range)
        surf16 = cost8.sum(dim=(3, 4), dtype=_I32)
        if not partitions:
            del cost8
    else:
        strips = me_sad.make_ref_strips(ref4[:, 0], MC.PAD_MC, mb_w, mb_h,
                                        me_range)
        surf16 = me_sad.sad_cost_surface16_lanes(fy, strips, mb_w, mb_h,
                                                 me_range)
        del strips
    wins4 = MG.luma_windows(ref4, mb_w, mb_h)
    winsu = MG.chroma_windows(refu, mb_w, mb_h)
    winsv = MG.chroma_windows(refv, mb_w, mb_h)
    if n_ref > 1:
        per_ref = [w.reshape((S, n_ref) + w.shape[1:])
                   for w in (wins4, winsu, winsv)]
        r0 = [w[:, 0].reshape((B,) + w.shape[3:]) for w in per_ref]
        wins4, winsu, winsv = (_pick_ref(w, ref_mb) for w in per_ref)
    else:
        wins4, winsu, winsv = (w.reshape((B,) + w.shape[2:])
                               for w in (wins4, winsu, winsv))
        r0 = (wins4, winsu, winsv)
        ref_mb = torch.zeros((S, mb_h, mb_w), dtype=_I32, device=dev)
    if me_method in (P.ME_DIA, P.ME_HEX):
        mv_field = decide_mvs_pattern(surf16, not classic, fy, wins4, lam_mb,
                                      mb_w, mb_h, me_range, mv_range,
                                      me_method, subme)
    else:
        decide = decide_mvs_parallel if me_method == P.ME_UMH else decide_mvs
        mv_field = decide(surf16, fy, wins4, lam_mb, mb_w, mb_h, me_range,
                          mv_range, subme)
    del surf16
    skip_ok = torch.zeros((S, mb_h, mb_w), dtype=torch.bool, device=dev)
    if fast_pskip:
        psk = pskip_mv_field(mv_field)
        # the probe always tests reference 0 (macroblock.c:503-506)
        skip_ok, skip_mv = probe_pskip(fy, fenc_u, fenc_v, *r0, psk, qp_mb,
                                       qpc_mb, mb_w, mb_h, mv_range, cqm)
        mv_field = torch.where(skip_ok[..., None], skip_mv, mv_field)
        if n_ref > 1:
            # skipped MBs compensate from reference 0
            ref_mb = torch.where(skip_ok, 0, ref_mb)
            wins4, winsu, winsv = (_pick_ref(w, ref_mb) for w in per_ref)
    if n_ref > 1:
        del per_ref, r0
    if partitions:
        part, mv8 = decide_partitions(cost8, mv_field, fy, wins4, lam_mb,
                                      mb_w, mb_h, me_range, mv_range,
                                      skip_ok, subme)
        del cost8
    else:
        part = torch.zeros((S, mb_h, mb_w), dtype=_I32, device=dev)
        mv8 = mv_field[:, :, :, None, None, :].expand(
            S, mb_h, mb_w, 2, 2, 2).contiguous()
    out = encode_p_residual(fy, fenc_u, fenc_v, wins4, winsu, winsv, mv8,
                            qp_mb, qpc_mb, mb_w, mb_h, dct_decimate, skip_ok,
                            cqm, nr_offset)
    out["mv"] = mv8[:, :, :, 0, 0].contiguous()
    out["mv8"] = mv8
    out["partition"] = part
    out["ref"] = ref_mb.to(_I32)
    out["bs"], out["feo"] = compute_strengths_p(
        out.pop("luma_nnz_bg"), out["cbp_luma"], out["cbp_chroma"], mv8,
        mb_w, mb_h, out["ref"])
    return out
