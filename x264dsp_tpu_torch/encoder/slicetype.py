"""Lowres frame cost over a stream batch — port of the cost part of
x264dsp_tpu/encoder/slicetype.py (x264_slicetype_mb_cost,
encoder/slicetype.c:48-222), which the BatchEncoder's per-stream CRF/ABR
reads as each stream's frame SATD.

Per 8x8 block of the half-res pyramid (ops/mc.lowres_planes), four
Jacobi rounds of the lookahead search: full-pel DIA (16 steps, +-8) from
the rounded median of the right / below / below-left chain MVs of the
previous round, one half-pel diamond and the exact-qpel MVP try; then
the SATD of the best MV plus its cost at lambda 1, with the -1 / +5
adjustments and the mv0 fast skip, against the 8x8c V/H/DC intra SATD
with its penalties. The JAX version cuts each block's window out of an
edge-padded pyramid and selects with one-hot matmuls; here every block
is a direct indexed gather from the pyramid with clamped coordinates,
which reads the same pixels (the MVs are clipped so that no read leaves
the JAX pad). The loops have a fixed count and no host sync.

``SlicetypeDecider`` (slicetype.py:248, the scenecut and keyint logic)
serves the single-stream Encoder on top of the same cost pass, with one
pull of the frame summary per frame; the BatchEncoder's GOP is lockstep
and reads only the cost.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import params as P
from ..ops import mc as MC
from ..ops import pixel as PX
from ..ops.devtab import device_table
from .inter_frame import _median3

_I32 = torch.int32
_I64 = torch.int64

LOWRES_PENALTY = 4     # slicetype.c:69
INTRA_PENALTY = 5      # slicetype.c:153
R_LOW = 8              # full-pel search range of the lowres DIA
M_LOW = 10             # the JAX window margin: MVs stay within +-4 (M_LOW-1)
DIA_STEPS = 16
ROUNDS = 4

# copy of slicetype.py:242-245 MVBITS_LOW4: lambda-1 bits of one MV
# component at LOOKAHEAD_QP, indexed by |qpel|
MVBITS_LOW4 = np.ones(128, np.int32)
_d4 = np.arange(1, 128)
MVBITS_LOW4[1:] = (np.log2(_d4 + 1.0) * 2 + 1.718 + 0.5).astype(np.int32)

_DIA = ((0, -1), (0, 1), (-1, 0), (1, 0))
_HPEL_DIA = ((0, -2), (0, 2), (-2, 0), (2, 0))


class _Pyramid:
    """8x8 blocks of a (S, 4, H, W) lowres pyramid at per-block qpel MVs
    (get_ref, common/mc.c:241-264): block b of every stream starts at
    (8 by, 8 bx); rows and columns outside the plane read its edge."""

    def __init__(self, ref4, bw: int, bh: int):
        S, _, self.H, self.W = ref4.shape
        dev = ref4.device
        self.flat = ref4.to(_I32).reshape(S, -1)
        self.row0 = torch.arange(bh, device=dev).repeat_interleave(bw) * 8
        self.col0 = torch.arange(bw, device=dev).repeat(bh) * 8
        self.ar = torch.arange(8, device=dev)
        self.ref0 = device_table(MC.HPEL_REF0, dev, _I64)
        self.ref1 = device_table(MC.HPEL_REF1, dev, _I64)

    def fetch(self, plane, dy, dx):
        """(S, B, 8, 8): plane `plane` ((S, B) or an int) at full-pel
        offsets (dy, dx) (S, B) from each block's origin."""
        H, W = self.H, self.W
        r = ((self.row0 + dy)[..., None] + self.ar).clamp(0, H - 1)
        c = ((self.col0 + dx)[..., None] + self.ar).clamp(0, W - 1)
        if not isinstance(plane, int):
            plane = plane[..., None, None]
        idx = plane * (H * W) + r[..., :, None] * W + c[..., None, :]
        S = idx.shape[0]
        return torch.gather(self.flat, 1, idx.reshape(S, -1)).reshape(
            idx.shape)

    def fullpel(self, fx, fy):
        return self.fetch(0, fy, fx)

    def interp(self, mx, my):
        qidx = (((my & 3) << 2) + (mx & 3)).long()
        fy, fx = my >> 2, mx >> 2
        src1 = self.fetch(self.ref0[qidx], fy + ((my & 3) == 3).to(my.dtype),
                          fx)
        src2 = self.fetch(self.ref1[qidx], fy,
                          fx + ((mx & 3) == 3).to(mx.dtype))
        avg = (src1 + src2 + 1) >> 1
        return torch.where(((qidx & 5) != 0)[..., None, None], avg, src1)


def lowres_costs(fenc_low, fref_low4, bw: int, bh: int):
    """Per-8x8-block costs (slicetype.py:61 lowres_costs) of S streams:
    fenc_low (S, 8 bh, 8 bw), fref_low4 (S, 4, 8 bh, 8 bw) the reference's
    pyramid. Returns (icost, min(pcost, icost), (mvx, mvy)), each
    (S, bh, bw) int32, MVs in lowres qpel."""
    S = fenc_low.shape[0]
    dev = fenc_low.device
    f = fenc_low.to(_I32)
    fblk = f.reshape(S, bh, 8, bw, 8).permute(0, 1, 3, 2, 4).reshape(
        S, bh * bw, 8, 8)
    pyr = _Pyramid(fref_low4, bw, bh)
    bits = device_table(MVBITS_LOW4, dev)
    lim = 4 * (M_LOW - 1)

    def mvb(v):
        return bits[v.abs().clamp(0, 127).long()]

    def try_mv(state, cmx, cmy, mvpx, mvpy):
        bc, bx, by = state
        mx, my = cmx.clamp(-lim, lim - 1), cmy.clamp(-lim, lim - 1)
        c = (PX.sad(fblk, pyr.interp(mx, my)) + mvb(mx - mvpx)
             + mvb(my - mvpy))
        better = c < bc
        return (torch.where(better, c, bc), torch.where(better, mx, bx),
                torch.where(better, my, by))

    # the reverse-raster chain candidates right / below / below-left
    # (slicetype.c:107-113), edge-clamped
    xr = (torch.arange(bw, device=dev) + 1).clamp(max=bw - 1)
    xl = (torch.arange(bw, device=dev) - 1).clamp(min=0)
    yb = (torch.arange(bh, device=dev) + 1).clamp(max=bh - 1)

    def chain_mvp(v):
        g = v.reshape(S, bh, bw)
        below = g[:, yb]
        return _median3(g[:, :, xr], below, below[:, :, xl]).reshape(S, -1)

    def search_round(bx, by):
        """One reference-depth search per block (x264_me_search DIA from
        the rounded MVP, me.c:237-274, + refine_subpel at subme 2: one
        half-pel diamond and the exact-qpel MVP try, me.c:484-517)."""
        mvpx, mvpy = chain_mvp(bx), chain_mvp(by)
        cx = ((mvpx + 2) >> 2).clamp(-R_LOW, R_LOW)
        cy = ((mvpy + 2) >> 2).clamp(-R_LOW, R_LOW)
        c0 = PX.sad(fblk, pyr.fullpel(cx, cy))     # no bias at the start
        for _ in range(DIA_STEPS):
            for ddx, ddy in _DIA:
                nx = (cx + ddx).clamp(-R_LOW, R_LOW)
                ny = (cy + ddy).clamp(-R_LOW, R_LOW)
                cc = (PX.sad(fblk, pyr.fullpel(nx, ny)) + mvb(nx * 4 - mvpx)
                      + mvb(ny * 4 - mvpy))
                take = cc < c0
                c0 = torch.where(take, cc, c0)
                cx = torch.where(take, nx, cx)
                cy = torch.where(take, ny, cy)
        s = (c0, cx * 4, cy * 4)
        for dmx, dmy in _HPEL_DIA:
            s = try_mv(s, s[1] + dmx, s[2] + dmy, mvpx, mvpy)
        s = try_mv(s, mvpx, mvpy, mvpx, mvpy)
        return s[1], s[2], mvpx, mvpy

    zero = torch.zeros((S, bh * bw), dtype=_I32, device=dev)
    bx = by = zero
    for _ in range(ROUNDS):
        bx, by, mvpx, mvpy = search_round(bx, by)

    # final cost: SATD + cost_mv at lambda 1 against the chain MVP, -1, +5
    # for a nonzero MV (slicetype.c:131-134); the mv0 fast skip (:117-124)
    mcost = (PX.satd(fblk, pyr.interp(bx, by)) + mvb(bx - mvpx)
             + mvb(by - mvpy) - 1 + ((bx != 0) | (by != 0)).to(_I32) * 5)
    satd0 = PX.satd(fblk, pyr.fullpel(zero, zero))
    skip0 = (satd0 < 64) & (mvpx == 0) & (mvpy == 0)
    mcost = torch.where(skip0, satd0, mcost)
    bx = torch.where(skip0, 0, bx)
    by = torch.where(skip0, 0, by)
    pcost = mcost.reshape(S, bh, bw) + LOWRES_PENALTY

    # intra: 8x8c V/H/DC SATD from the row above / the column left of each
    # block, edge-replicated at the frame border (slicetype.c:150-180)
    ty = (torch.arange(bh, device=dev) * 8 - 1).clamp(min=0)
    lx = (torch.arange(bw, device=dev) * 8 - 1).clamp(min=0)
    top = f[:, ty, :].reshape(S, bh, bw, 8)
    left = f[:, :, lx].reshape(S, bh, 8, bw).permute(0, 1, 3, 2)
    blocks = fblk.reshape(S, bh, bw, 8, 8)
    shape = blocks.shape
    dc = (top.sum(-1) + left.sum(-1) + 8) >> 4
    costs = [PX.satd(blocks, pred.expand(shape)) for pred in
             (top[..., None, :], left[..., :, None], dc[..., None, None])]
    icost = (torch.minimum(torch.minimum(costs[0], costs[1]), costs[2])
             + INTRA_PENALTY + LOWRES_PENALTY)
    return (icost, torch.minimum(pcost, icost),
            (bx.reshape(S, bh, bw), by.reshape(S, bh, bw)))


def frame_summary(fenc_low, fref_low4, bw: int, bh: int, do_edges: bool):
    """slicetype.py:43 _summary_fn over S streams: (S, 2 + 2 bh) int64
    rows [icost sum, pcost sum, icost row sums, pcost row sums]; the two
    frame sums leave out the edge-block ring unless do_edges."""
    icost, pcost, _ = lowres_costs(fenc_low, fref_low4, bw, bh)

    def total(m):
        mm = m if do_edges else m[:, 1:-1, 1:-1]
        return mm.sum((1, 2), dtype=_I64)[:, None]
    return torch.cat([total(icost), total(pcost), icost.sum(2, dtype=_I64),
                      pcost.sum(2, dtype=_I64)], 1)


class SlicetypeDecider:
    """GOP/IDR decision state of one stream (slicetype.py:248,
    x264_slicetype_decide, slicetype.c:438)."""

    def __init__(self, param: P.Param):
        self.param = param
        self.last_keyframe = -(1 << 30)
        self.prev_lowres = None
        self.frame_idx = 0
        self.row_costs = None

    def decide(self, fenc_y):
        """Returns (slice_type, is_idr, frame_cost) for the next frame and
        advances the state. fenc_y: the padded (H, W) luma plane, a tensor
        on the encoder's device."""
        p = self.param
        h, w = fenc_y.shape[-2:]
        bw, bh = w // 16, h // 16
        low4 = MC.lowres_planes(fenc_y.reshape(1, h, w))
        gop = self.frame_idx - self.last_keyframe
        # with periodic intra refresh only frame 0 takes the keyint_max
        # IDR (slicetype.c:516)
        keyint_applies = (not p.b_intra_refresh) or self.frame_idx == 0
        first = self.prev_lowres is None
        force_i = (keyint_applies and gop >= p.i_keyint_max) or first
        # the edge ring leaves the frame cost unless mb-tree or VBV needs
        # the spatial distribution (do_edges, slicetype.c:286-294)
        do_edges = bool(p.rc.b_mb_tree or p.rc.i_vbv_buffer_size
                        or bw <= 2 or bh <= 2)
        # one device-to-host pull: frame sums and per-row sums of both maps
        vec = frame_summary(low4[:, 0], low4 if first else self.prev_lowres,
                            bw, bh, do_edges)[0].cpu().numpy()
        isum, psum = int(vec[0]), int(vec[1])
        sc = True if first else self._scenecut(isum, psum, gop)
        cost = isum if (force_i or sc) else psum
        is_key = force_i or (sc and p.i_scenecut_threshold > 0
                             and gop >= max(p.i_keyint_min, 1))
        slice_type = P.SLICE_TYPE_I if is_key else P.SLICE_TYPE_P
        if is_key:
            self.last_keyframe = self.frame_idx
        self.prev_lowres = low4   # the full pyramid: the next frame's ME
        self.frame_idx += 1
        # per-MB-row lowres cost (fdec->i_row_satd, slicetype.c:605-642)
        rows = vec[2:2 + bh] if (force_i or sc) else vec[2 + bh:]
        self.row_costs = rows.astype(np.int64)
        return slice_type, is_key, cost

    def _scenecut(self, icost: int, pcost: int, gop: int) -> bool:
        """Copy of slicetype.py:326 _scenecut (slicetype.c:324-367)."""
        p = self.param
        tmax = p.i_scenecut_threshold
        if tmax <= 0:
            return False
        tmin = tmax >> 2
        if p.i_keyint_min == p.i_keyint_max:
            tmin = tmax
        if gop <= (p.i_keyint_min >> 2):
            bias = tmin >> 2
        elif gop <= p.i_keyint_min:
            bias = tmin * gop // p.i_keyint_min
        else:
            bias = tmin + (tmax - tmin) * (gop - p.i_keyint_min) \
                // max(p.i_keyint_max - p.i_keyint_min, 1)
        return 100 * pcost >= (100 - bias) * icost
