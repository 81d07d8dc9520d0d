"""Full-pel DIA / HEX pattern walk of the P analysis (me.c:237-274 DIA,
:276-387 HEX), with the MV cost and the median MV prediction it reads.

``pattern_walk`` runs one walk of every MB of every stream: on a CUDA
tensor the hand-written kernel ``csrc/me_walk.cu`` (one launch, no host
sync), on a CPU tensor ``pattern_walk_plain``, the lockstep walk of the
JAX package (``_pattern_walk``, x264dsp_tpu/encoder/inter_frame.py:349):
every MB steps in masked tensor ops, and the loop ends when no MB is left
walking. The kernel replaces no TPU kernel: the JAX walk is plain JAX. It
gives each MB a thread that walks until it stops or reaches the step cap,
which is the lockstep walk's result without its per-step ``any()``.

A walk reads a full-pel 16x16 SAD surface in K1's lane layout (S, mb_h,
n, n, mb_w) (``lanes``) or in the classic layout (S, mb_h, mb_w, n, n) of
the quadrant sums, n = 2R+1; candidates update on a strictly smaller
cost, in candidate order (me.c's COPY*_IF_LT). Walk 1 starts at the zero
MVP with no candidates; a later walk takes the median MVP of the previous
walk's field ``prev`` and its four neighbour candidates.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .. import params as P
from .devtab import device_table

_I32 = torch.int32
BIG = 1 << 28

launches = {"pattern_walk": 0}

# mv_bits = floor(log2(d+1)*2 + 2.218), cost_mv[0] = 1 bit (analyse.c:243)
_MVBITS_RANGE = 4096
_MVBITS = np.ones(_MVBITS_RANGE, np.int32)
_d = np.arange(1, _MVBITS_RANGE)
_MVBITS[1:] = (np.log2(_d + 1.0) * 2 + 1.718 + 0.5).astype(np.int32)

# me.c hex2[] (the radius-2 hexagon), the diamond and the 8-point square
# (inter_frame.py:305-307)
_HEX_PTS = ((-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2))
_DIA_PTS = ((0, -1), (0, 1), (-1, 0), (1, 0))
_SQUARE_PTS = _DIA_PTS + ((-1, -1), (-1, 1), (1, -1), (1, 1))


def mv_cost(lam, mvx, mvy, mvpx, mvpy):
    bits = device_table(_MVBITS, lam.device)
    dx = (mvx - mvpx).abs().clamp(0, _MVBITS_RANGE - 1).long()
    dy = (mvy - mvpy).abs().clamp(0, _MVBITS_RANGE - 1).long()
    return lam * (bits[dx] + bits[dy])


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


class _Surface:
    """Reads of a full-pel 16x16 SAD surface at per-MB offsets: in K1's
    lane layout (S, mb_h, n, n, mb_w) or in the classic layout (S, mb_h,
    mb_w, n, n) of the quadrant sums. Returns the raw cost (legal-range
    masked) or the cost biased by lambda * mvbits(mv - mvp). Equal to the
    JAX path's where(ok, surf [+ bias], 1<<28) surfaces read at the same
    points; out-of-surface points cost 1<<28. `reads`, when a tensor,
    counts each MB's reads that the gate lets through."""

    def __init__(self, surf, lanes: bool, lam, R, lo_x, hi_x, lo_y, hi_y):
        S, mb_h = surf.shape[:2]
        n = 2 * R + 1
        self.dim = 2 if lanes else 3            # the axis of the offsets
        shape = (S, mb_h, n * n, -1) if lanes else (S, mb_h, -1, n * n)
        self.flat = surf.reshape(shape)
        self.lam, self.R, self.n = lam, R, n
        self.lo_x, self.hi_x = lo_x[None, None, :], hi_x[None, None, :]
        self.lo_y, self.hi_y = lo_y[None, :, None], hi_y[None, :, None]
        self.reads = None

    def at(self, bx, by, mvp=None, gate=None):
        R, n = self.R, self.n
        idx = (by.clamp(-R, R) + R) * n + bx.clamp(-R, R) + R
        v = torch.gather(self.flat, self.dim,
                         idx.long().unsqueeze(self.dim)).squeeze(self.dim)
        if mvp is not None:
            v = v + mv_cost(self.lam, bx * 4, by * 4, mvp[..., 0],
                            mvp[..., 1])
        ok = ((bx >= self.lo_x) & (bx <= self.hi_x) & (by >= self.lo_y)
              & (by <= self.hi_y))
        inb = (bx.abs() <= R) & (by.abs() <= R)
        if self.reads is not None:
            self.reads += ok & inb if gate is None else ok & inb & gate
        return torch.where(ok & inb, v, BIG)


def _try_candidates(surf: _Surface, mvp, bcost, bx, by, pts, gate):
    """Strict-less acceptance of the offsets `pts` around the centre at
    entry, in order (me.c's COPY*_IF_LT chains), on the biased surface;
    gate (or None) masks the MBs that may move. Returns (bcost, bx, by,
    moved)."""
    ox, oy = bx, by
    for dx, dy in pts:
        cx, cy = ox + dx, oy + dy
        c = surf.at(cx, cy, mvp, gate)
        better = c < bcost if gate is None else (c < bcost) & gate
        bcost = torch.where(better, c, bcost)
        bx = torch.where(better, cx, bx)
        by = torch.where(better, cy, by)
    return bcost, bx, by, (bx != ox) | (by != oy)


def _pattern_walk(surf: _Surface, mvp, mvp_fp, mvc, me_range: int,
                  method: int):
    """DIA (me.c:237-274) or HEX (me.c:276-387) walk of every MB in
    lockstep (_pattern_walk, inter_frame.py:349): the MVP costed without
    bias, the mvc candidates and (0,0) with bias, then up to me_range
    diamonds (DIA) or max(me_range >> 1, 1) hexagons (HEX) with per-MB
    stop masks; HEX ends with one ungated 8-point square refine."""
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
    try_zero = (bx != 0) | (by != 0)
    zc = surf.at(zero, zero, mvp, try_zero)
    better = try_zero & (zc < bcost)
    bcost = torch.where(better, zc, bcost)
    bx = torch.where(better, 0, bx)
    by = torch.where(better, 0, by)
    pts, n_iter = ((_DIA_PTS, me_range) if method == P.ME_DIA
                   else (_HEX_PTS, max(me_range >> 1, 1)))
    active = torch.ones_like(bx, dtype=torch.bool)
    for _ in range(n_iter):
        bcost, bx, by, moved = _try_candidates(surf, mvp, bcost, bx, by, pts,
                                               active)
        active = active & moved
        if not bool(active.any()):
            break           # every walk has stopped: later steps no-op
    if method == P.ME_HEX:
        bcost, bx, by, _ = _try_candidates(surf, mvp, bcost, bx, by,
                                           _SQUARE_PTS, None)
    return bx, by, bcost


def _neighbour_cands(fp):
    return [fp, _shift(fp, 0, 1)[0], _shift(fp, 1, 0)[0],
            _shift(fp, 1, -1)[0]]


def _shapes(surf16, lanes: bool):
    """(S, mb_h, mb_w) of a surface in its layout."""
    S, mb_h = surf16.shape[:2]
    mb_w = surf16.shape[4] if lanes else surf16.shape[2]
    return S, mb_h, mb_w


def pattern_walk_plain(surf16, lanes: bool, lam, bounds, prev, R: int,
                       method: int, count_reads: bool = False):
    """One DIA or HEX walk of every MB in lockstep. surf16 in K1's lane
    layout (lanes) or the classic one; lam (S, mb_h, mb_w) int32; bounds
    the full-pel legal range (lo_x, hi_x (mb_w,), lo_y, hi_y (mb_h,))
    int32; prev None (walk 1: zero MVP, no candidates) or the previous
    walk's full-pel field (S, mb_h, mb_w, 2) int32. Returns (best
    (S, mb_h, mb_w, 2) full-pel int32, cost (S, mb_h, mb_w) int32, mvp
    (S, mb_h, mb_w, 2) qpel int32), and with count_reads the number of
    legal surface points the per-MB walks read."""
    S, mb_h, mb_w = _shapes(surf16, lanes)
    surf = _Surface(surf16, lanes, lam, R, *bounds)
    if count_reads:
        surf.reads = torch.zeros((S, mb_h, mb_w), dtype=torch.int64,
                                 device=surf16.device)
    if prev is None:
        mvp = torch.zeros((S, mb_h, mb_w, 2), dtype=_I32,
                          device=surf16.device)
        mvp_fp, mvc = mvp, None
    else:
        mvp = mvp_field_parallel(prev * 4)
        mvp_fp = (mvp + 2) >> 2                          # me.c:141-142
        mvc = _neighbour_cands(prev)
    bx, by, bcost = _pattern_walk(surf, mvp, mvp_fp, mvc, R, method)
    out = torch.stack([bx, by], -1), bcost, mvp
    return out + (int(surf.reads.sum()),) if count_reads else out


def pattern_walk_cuda(surf16, lanes: bool, lam, bounds, prev, R: int,
                      method: int):
    """The walk in csrc/me_walk.cu: one launch on the current stream,
    arguments and results as the plain version (CUDA tensors, contiguous,
    on one device)."""
    S, mb_h, mb_w = _shapes(surf16, lanes)
    n = 2 * R + 1
    dev = surf16.device
    _build.require_cuda(surf16, _I32, (S, mb_h, n, n, mb_w) if lanes
                        else (S, mb_h, mb_w, n, n), "surf16")
    _build.require_cuda(lam, _I32, (S, mb_h, mb_w), "lam")
    for t, size, name in zip(bounds, (mb_w, mb_w, mb_h, mb_h),
                             ("lo_x", "hi_x", "lo_y", "hi_y")):
        _build.require_cuda(t, _I32, (size,), name)
    if prev is not None:
        _build.require_cuda(prev, _I32, (S, mb_h, mb_w, 2), "prev")
    if method not in (P.ME_DIA, P.ME_HEX):
        raise ValueError(f"pattern_walk: me_method {method} is no pattern")
    if any(t.device != dev for t in (lam, *bounds)
           + (() if prev is None else (prev,))):
        raise ValueError("pattern_walk: the tensors lie on other devices")
    best = torch.empty((S, mb_h, mb_w, 2), dtype=_I32, device=dev)
    cost = torch.empty((S, mb_h, mb_w), dtype=_I32, device=dev)
    mvp = torch.empty((S, mb_h, mb_w, 2), dtype=_I32, device=dev)
    code = _build.lib().x264t_pattern_walk(
        surf16.data_ptr(), lam.data_ptr(),
        device_table(_MVBITS, dev).data_ptr(),
        *(t.data_ptr() for t in bounds),
        None if prev is None else prev.data_ptr(), best.data_ptr(),
        cost.data_ptr(), mvp.data_ptr(), S, mb_h, mb_w, R, int(lanes),
        int(method == P.ME_HEX), _build.stream_ptr(dev))
    _build.check(code, "x264t_pattern_walk")
    _build.count_launch(launches, "pattern_walk")
    return best, cost, mvp


def pattern_walk(surf16, lanes: bool, lam, bounds, prev, R: int,
                 method: int):
    fn = pattern_walk_cuda if surf16.is_cuda else pattern_walk_plain
    return fn(surf16, lanes, lam, bounds, prev, R, method)
