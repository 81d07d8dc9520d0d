"""I-frame encode over a stream batch — port of the CPU path of
x264dsp_tpu/encoder/intra_frame.py (``encode_i_frame``, the branch of
``encode_i_frame_best`` that runs off the TPU).

The causal intra dependencies admit a 2:1 wavefront: MBs with equal
x + 2y are independent. One Python step per diagonal (mb_w + 2 mb_h - 2
of them, 254 at 1080p) runs the whole analysis + encode for every MB of
the diagonal in every stream at once; inside, I4x4 takes 16 sequential
block steps. Decisions follow encoder/analyse.c (mode tables :424-484,
i16x16 :564-638, the i4x4 shortcut tree :640-746, chroma :509-560); a
candidate replaces the best only on a strictly smaller cost, in the
reference's candidate order, written out explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import intra as I
from ..ops import pixel as PX
from ..ops import transforms as T
from ..ops.devtab import device_table
from ..ops.transforms import BLOCK_IDX_X, BLOCK_IDX_Y

_I32 = torch.int32
COST_MAX = 1 << 28

# x264_mb_pred_mode4x4_fix (common/predict.h:60-68), indexed by mode+1
_FIX4 = np.array([-1, 0, 1, 2, 3, 4, 5, 6, 7, 8, 2, 2, 2], np.int32)
_UE_BITS = np.array([1, 3, 3, 5], np.int32)
_BITS16 = _UE_BITS[[0, 1, 2, 3, 2, 2, 2]]      # 16x16 V,H,DC,P,DC*
_BITSC = _UE_BITS[[0, 1, 2, 3, 0, 0, 0]]       # chroma DC,H,V,P,DC*
# evaluation orders per availability case (analyse.c:436-442)
_ORDER16 = np.array([[6, -1, -1, -1], [4, 1, -1, -1], [5, 0, -1, -1],
                     [0, 1, 2, -1], [0, 1, 2, 3]], np.int32)
_ORDERC = np.array([[6, -1, -1, -1], [4, 1, -1, -1], [5, 2, -1, -1],
                    [2, 1, 0, -1], [2, 1, 0, 3]], np.int32)
# i4x4 serial mode lists for availability cases 0-2 (analyse.c:471-478)
_I4_LIST = np.array([[11, -1, -1, -1], [9, 1, 8, -1], [10, 0, 3, 7]],
                    np.int32)
_IDX_OF = {(int(x), int(y)): i for i, (x, y) in
           enumerate(zip(BLOCK_IDX_X, BLOCK_IDX_Y))}
# static topright availability of blocks with by > 0 (coded-order rule)
_TR_STATIC = [bool(bx < 3 and by > 0 and _IDX_OF[(int(bx) + 1, int(by) - 1)]
                   < i) for i, (bx, by) in
              enumerate(zip(BLOCK_IDX_X, BLOCK_IDX_Y))]
_LEFT_COL_IDX = [_IDX_OF[(3, by)] for by in range(4)]
_TOP_ROW_IDX = [_IDX_OF[(bx, 3)] for bx in range(4)]
# 2x2 hadamard signs (optimize_chroma_idct_dequant_2x2, quant.c:127-143)
_HAD2x2 = ((1, 1, 1, 1), (1, 1, -1, -1), (1, -1, 1, -1), (1, -1, -1, 1))
PAD = 8

# the i4x4 shortcut list after x3: favor_v ? {DDL, VL} : {HU}
# (analyse.c:485-491)
_SHORT_V = np.array([3, 7])
_SHORT_H = np.array([8, -1])


def _c(table, device):
    return device_table(table, device, torch.long)


def _avail_case(left, top, tl):
    """Availability case 0..4 (analyse.c:486-508)."""
    return torch.where(left & top & tl, 4,
                       left.to(_I32) + 2 * top.to(_I32)).long()


def _ordered_pick(costs, order):
    """COPY2_IF_LT chain over `order` (N, k), -1 padded: the first
    candidate reaching the minimum. costs (N, n_modes)."""
    best = torch.full_like(costs[:, 0], COST_MAX)
    mode = order[:, 0].clone()
    for j in range(order.shape[1]):
        m = order[:, j]
        c = torch.where(m >= 0, costs.gather(1, m.clamp(min=0)[:, None])[:, 0],
                        COST_MAX)
        better = c < best
        best = torch.where(better, c, best)
        mode = torch.where(better, m, mode)
    return best, mode


def optimize_chroma_dc(dc, qp, cqm=None, cqm_set: int = 2):
    """optimize_chroma_2x2_dc (common/quant.c:157-192) in the closed form
    of intra_frame.py:_optimize_chroma_dc: each DC coefficient, in 3,2,1,0
    order, moves toward zero by the largest step that keeps every >>6
    reconstruction in its original rounding band. dc (..., 4), qp (...,);
    cqm / cqm_set the scaling-list set (transforms.tables). Returns
    (new_dc, nz)."""
    dmf = T.dc_dmf(qp, cqm, cqm_set)
    d = [dc[..., c] for c in range(4)]
    a = [sum(h * d[c] for c, h in enumerate(row)) for row in _HAD2x2]
    w = [(aj * dmf) >> 5 for aj in a]
    already_zero = torch.ones_like(d[0], dtype=torch.bool)
    for wj in w:
        already_zero &= ((wj + 32) >> 6) == 0
    amin, amax = [], []
    for wj in w:
        R = (wj + 32) >> 6
        amin.append(-torch.div(-32 * (64 * R - 32), dmf,
                               rounding_mode="floor"))
        amax.append(torch.div(32 * (64 * R + 32) - 1, dmf,
                              rounding_mode="floor"))
    for c in (3, 2, 1, 0):
        s = torch.where(d[c] < 0, -1, 1).to(_I32)
        k = d[c].abs()
        for j in range(4):
            eps_pos = (-s * _HAD2x2[j][c]) > 0
            k = torch.minimum(k, torch.where(eps_pos, amax[j] - a[j],
                                             a[j] - amin[j]))
        k = k.clamp(min=0)
        d[c] = d[c] - s * k
        for j in range(4):
            a[j] = a[j] - s * _HAD2x2[j][c] * k
    new_dc = torch.stack(d, -1)
    nz = (new_dc != 0).any(-1) & ~already_zero
    return torch.where(already_zero[..., None], 0, new_dc), nz


def _encode_4x4(fenc_blk, pred, qp, cqm=None):
    """x264_mb_encode_i4x4 core (macroblock.h:37-63); qp (N,)."""
    q = T.quant4x4(T.sub_dct4x4(fenc_blk, pred), qp, True, cqm, 0)
    nz = (q != 0).flatten(1).any(-1)
    recon = torch.where(nz[:, None, None],
                        T.idct4x4_add(pred, T.dequant4x4(q, qp, cqm, 0)),
                        pred.to(_I32))
    return recon, T.zigzag4x4(q), nz.to(_I32)


def _quads(b8):
    """(..., 8, 8) -> (..., 4, 4, 4) raster quadrants."""
    return torch.stack([b8[..., :4, :4], b8[..., :4, 4:], b8[..., 4:, :4],
                        b8[..., 4:, 4:]], -3)


def _merge_quads(q):
    return torch.cat([torch.cat([q[..., 0, :, :], q[..., 1, :, :]], -1),
                      torch.cat([q[..., 2, :, :], q[..., 3, :, :]], -1)], -2)


def _encode_chroma_channel(fenc8, pred8, qp, cqm=None):
    """One chroma channel of x264_mb_encode_chroma, intra, no decimation
    (macroblock.c:233-300); batched (N, 8, 8), qp (N,); scaling list
    4IC (set 2)."""
    bf, bp = _quads(fenc8), _quads(pred8)
    dct = T.sub_dct4x4(bf, bp)                          # (N, 4, 4, 4)
    dc = T.hadamard2x2(dct[..., 0, 0])
    dct = dct.clone()
    dct[..., 0, 0] = 0
    qb = qp[:, None]
    q_ac = T.quant4x4(dct, qb.expand(-1, 4), True, cqm, 2)
    nnz_ac = (q_ac.flatten(2) != 0).any(-1).to(_I32)
    nz_ac = (nnz_ac != 0).any(-1)
    ac_levels = T.zigzag4x4(q_ac)
    q_dc = T.quant_dc(dc, qp, True, cqm, 2)
    nz_dc = (q_dc != 0).any(-1)
    opt_dc, opt_nz = optimize_chroma_dc(q_dc, qp, cqm, 2)
    use_opt = (~nz_ac) & nz_dc & (qp <= 22)
    dc_final = torch.where(use_opt[:, None], opt_dc, q_dc)
    nz_dc_final = torch.where(use_opt, opt_nz, nz_dc)
    dc_levels = dc_final[:, [0, 2, 1, 3]]
    dq_dc = T.idct_dequant_2x2_dc(dc_final, qp, cqm, 2)
    dq_ac = T.dequant4x4(q_ac, qb.expand(-1, 4), cqm, 2)
    dq_ac[..., 0, 0] = torch.where(nz_dc_final[:, None], dq_dc, 0)
    rec_ac = T.idct4x4_add(bp, dq_ac)
    rec_dc = (bp.to(_I32) + ((dq_dc + 32) >> 6)[..., None, None]).clamp(0, 255)
    rec = torch.where(nz_ac[:, None, None, None], rec_ac,
                      torch.where(nz_dc_final[:, None, None, None], rec_dc,
                                  bp.to(_I32)))
    return dict(recon=_merge_quads(rec), dc_levels=dc_levels,
                ac_levels=torch.where(nz_ac[:, None, None], ac_levels, 0),
                nnz_ac=torch.where(nz_ac[:, None], nnz_ac, 0),
                nz_dc=nz_dc_final.to(_I32), has_ac=nz_ac)


_BY4 = [int(v) * 4 for v in BLOCK_IDX_Y]
_BX4 = [int(v) * 4 for v in BLOCK_IDX_X]


def _encode_i16(fenc16, pred16, qp, cqm=None):
    """x264_mb_encode_i16x16 (macroblock.c:72-170), I slice; scaling
    list 4IY (set 0)."""
    N = fenc16.shape[0]
    blk_f = torch.stack([fenc16[:, y:y + 4, x:x + 4]
                         for y, x in zip(_BY4, _BX4)], 1)   # (N, 16, 4, 4)
    blk_p = torch.stack([pred16[:, y:y + 4, x:x + 4]
                         for y, x in zip(_BY4, _BX4)], 1)
    dct = T.sub_dct4x4(blk_f, blk_p)
    dc_raw = dct[..., 0, 0]
    dct = dct.clone()
    dct[..., 0, 0] = 0
    qb = qp[:, None].expand(-1, 16)
    q = T.quant4x4(dct, qb, True, cqm, 0)
    nnz = (q.flatten(2) != 0).any(-1).to(_I32)
    any_ac = (nnz != 0).any(-1)
    levels = T.zigzag4x4(q)
    dq_ac = T.dequant4x4(q, qb, cqm, 0)
    pos = torch.as_tensor(BLOCK_IDX_Y * 4 + BLOCK_IDX_X,
                          device=fenc16.device).long()
    dc_grid = torch.zeros((N, 16), dtype=_I32, device=fenc16.device)
    dc_grid[:, pos] = dc_raw
    dc_t = T.hadamard4x4(dc_grid.reshape(N, 4, 4), forward=True)
    q_dc = T.quant_dc(dc_t.reshape(N, 16), qp, True, cqm, 0)
    nz_dc = (q_dc != 0).any(-1)
    dc_levels = T.zigzag4x4(q_dc.reshape(N, 4, 4))
    dc_dq = T.dequant_dc4x4(T.hadamard4x4(q_dc.reshape(N, 4, 4), False), qp,
                            cqm, 0)
    dc_blk = torch.where(nz_dc[:, None], dc_dq.reshape(N, 16)[:, pos], 0)
    dq_ac[..., 0, 0] = dc_blk
    rec_ac = T.idct4x4_add(blk_p, dq_ac)
    rec_dc = (blk_p.to(_I32) + ((dc_blk + 32) >> 6)[..., None, None]) \
        .clamp(0, 255)
    rec = torch.where(any_ac[:, None, None, None], rec_ac,
                      torch.where(nz_dc[:, None, None, None], rec_dc,
                                  blk_p.to(_I32)))
    recon = torch.zeros((N, 16, 16), dtype=_I32, device=fenc16.device)
    for i, (y, x) in enumerate(zip(_BY4, _BX4)):
        recon[:, y:y + 4, x:x + 4] = rec[:, i]
    return dict(recon=recon, levels=levels, dc_levels=dc_levels, nnz=nnz,
                nz_dc=nz_dc.to(_I32),
                cbp_luma=torch.where(any_ac, 15, 0).to(_I32))


def _serial_i4(costs, order, mpm, lam, best, mode, fix4):
    """The serial mode loop (analyse.c:723-746): MPM discount, early
    accept at discounted cost <= 0, else strict-less replace."""
    stopped = torch.zeros_like(best, dtype=torch.bool)
    for j in range(order.shape[1]):
        m = order[:, j]
        m_ok = m >= 0
        mc = m.clamp(min=0)
        satd = torch.where(m_ok, costs.gather(1, mc[:, None])[:, 0], COST_MAX)
        is_mpm = m_ok & (mpm == fix4[mc + 1])
        satd = torch.where(is_mpm, satd - lam * 3, satd)
        accept = m_ok & ~stopped & is_mpm & (satd <= 0)
        take = accept | (m_ok & ~stopped & (satd < best))
        best = torch.where(take, satd, best)
        mode = torch.where(take, m, mode)
        stopped = stopped | accept
    return best, mode


def _analyse_encode_i4(fenc16, ytop25, yleft16, qp, lam, thresh, avail_l,
                       avail_t, avail_tl, avail_tr, left_modes, top_modes,
                       use_satd, cqm=None):
    """I4x4 analysis + inline encode (analyse.c:640-760), 16 blocks in
    coding order on a local (N, 17, 25) buffer: row 0 = topleft, top 16,
    8 topright; column 0 = left; interior = reconstruction so far."""
    N = fenc16.shape[0]
    dev = fenc16.device
    fix4 = _c(_FIX4, dev)
    L = torch.zeros((N, 17, 25), dtype=_I32, device=dev)
    L[:, 0, :] = ytop25
    L[:, 1:17, 0] = yleft16
    M = torch.full((N, 5, 5), -1, dtype=torch.long, device=dev)
    M[:, 0, 1:5] = top_modes
    M[:, 1:5, 0] = left_modes
    levels = torch.zeros((N, 16, 16), dtype=_I32, device=dev)
    nnz = torch.zeros((N, 16), dtype=_I32, device=dev)
    cost = lam * 40
    aborted = torch.zeros(N, dtype=torch.bool, device=dev)
    tt = torch.ones(N, dtype=torch.bool, device=dev)
    modes_range = torch.arange(12, device=dev)
    for idx in range(16):
        bx, by = int(BLOCK_IDX_X[idx]), int(BLOCK_IDX_Y[idx])
        x0, y0 = bx * 4, by * 4
        top4 = L[:, y0, x0 + 1:x0 + 5]
        tr4_raw = L[:, y0, x0 + 5:x0 + 9]
        left4 = L[:, y0 + 1:y0 + 5, x0]
        tl = L[:, y0, x0]
        b_l = tt if bx > 0 else avail_l
        b_t = tt if by > 0 else avail_t
        if bx > 0 and by > 0:
            b_tl = tt
        elif by == 0:
            b_tl = avail_t if bx > 0 else avail_tl
        else:
            b_tl = avail_l
        if by == 0:
            b_tr = avail_t if bx < 3 else avail_tr
        else:
            b_tr = tt if _TR_STATIC[idx] else ~tt
        patch = b_t & ~b_tr
        tr4 = torch.where(patch[:, None], top4[:, 3:4].expand(N, 4), tr4_raw)
        lmode = M[:, 1 + by, bx]
        tmode = M[:, by, 1 + bx]
        mm = torch.minimum(fix4[lmode + 1], fix4[tmode + 1])
        mpm = torch.where(mm < 0, 2, mm)

        preds = I.predict_4x4_all(left4, top4, tl, tr4)        # (N, 12, 4, 4)
        fenc_blk = fenc16[:, y0:y0 + 4, x0:x0 + 4]
        costs = (PX.satd_4x4(preds, fenc_blk[:, None]) if use_satd
                 else PX.sad(preds, fenc_blk[:, None]))
        case = _avail_case(b_l, b_t, b_tl)

        favor_v = costs[:, 1] > costs[:, 0]
        disc = costs - torch.where(modes_range[None] == mpm[:, None],
                                   lam[:, None] * 3, 0)
        # case 4: x3/x4 fast path (analyse.c:681-722)
        best4 = disc[:, 2]
        mode4 = torch.full_like(mpm, 2)
        seq = [torch.full_like(mpm, m) for m in (1, 0, 3, 4)]
        seq += [torch.where(favor_v, pv, ph) for pv, ph in ((5, 6), (7, 8))]
        for msel in seq:
            c = disc.gather(1, msel[:, None])[:, 0]
            t = c < best4
            best4 = torch.where(t, c, best4)
            mode4 = torch.where(t, msel, mode4)
        # case 3: x3 over DC/H/V, then the shortcut list if best > 0
        best3 = disc[:, 2]
        mode3 = torch.full_like(mpm, 2)
        for m in (1, 0):
            c = disc[:, m]
            t = c < best3
            best3 = torch.where(t, c, best3)
            mode3 = torch.where(t, m, mode3)
        sc_order = torch.where(favor_v[:, None], _c(_SHORT_V, dev),
                               _c(_SHORT_H, dev))
        b3s, m3s = _serial_i4(costs, sc_order, mpm, lam, best3, mode3, fix4)
        run_serial = best3 > 0
        best3 = torch.where(run_serial, b3s, best3)
        mode3 = torch.where(run_serial, m3s, mode3)
        # cases 0-2: the serial loop over the availability list
        order_low = _c(_I4_LIST, dev)[case.clamp(max=2)]
        best_low, mode_low = _serial_i4(
            costs, order_low, mpm, lam, torch.full_like(best4, COST_MAX),
            torch.full_like(mpm, 11), fix4)
        best = torch.where(case == 4, best4,
                           torch.where(case == 3, best3, best_low))
        mode = torch.where(case == 4, mode4,
                           torch.where(case == 3, mode3, mode_low))
        cost = cost + best + lam * 3
        if idx < 15:
            aborted = aborted | (cost > thresh)

        pred = preds[torch.arange(N, device=dev), mode]
        rec, lv, nz = _encode_4x4(fenc_blk, pred, qp, cqm)
        L[:, y0 + 1:y0 + 5, x0 + 1:x0 + 5] = rec
        M[:, 1 + by, 1 + bx] = mode
        levels[:, idx] = lv
        nnz[:, idx] = nz
    decided = torch.stack([M[:, 1 + by, 1 + bx] for bx, by in
                           zip(BLOCK_IDX_X, BLOCK_IDX_Y)], 1)
    return cost, ~aborted, decided, L[:, 1:17, 1:17], levels, nnz


def encode_mb(fenc16, fenc_u8, fenc_v8, ytop25, yleft16, utop9, uleft8,
              vtop9, vleft8, avail_l, avail_t, avail_tl, avail_tr,
              left_modes, top_modes, qp, qpc, lam, use_satd: bool,
              i4x4_enabled: bool, cqm=None):
    """Analyse + encode N macroblocks (make_encode_mb, intra_frame.py:429);
    cqm: the scaling lists (None flat)."""
    dev = fenc16.device
    case = _avail_case(avail_l, avail_t, avail_tl)
    mbcmp = PX.satd if use_satd else PX.sad

    preds16 = I.predict_16x16_all(yleft16, ytop25[:, 1:17], ytop25[:, 0])
    c16 = mbcmp(preds16, fenc16[:, None]) + lam[:, None] * \
        _c(_BITS16, dev).to(_I32)
    i16_cost, i16_mode = _ordered_pick(c16, _c(_ORDER16, dev)[case])

    N = fenc16.shape[0]
    if i4x4_enabled:
        i4_cost, i4_valid, i4_modes, i4_recon, i4_levels, i4_nnz = \
            _analyse_encode_i4(fenc16, ytop25, yleft16, qp, lam, i16_cost,
                               avail_l, avail_t, avail_tl, avail_tr,
                               left_modes, top_modes, use_satd, cqm)
        i4_cost = torch.where(i4_valid, i4_cost, COST_MAX)
    else:
        i4_cost = torch.full_like(i16_cost, COST_MAX)
        i4_modes = torch.full((N, 16), 2, dtype=torch.long, device=dev)
        i4_recon = torch.zeros((N, 16, 16), dtype=_I32, device=dev)
        i4_levels = torch.zeros((N, 16, 16), dtype=_I32, device=dev)
        i4_nnz = torch.zeros((N, 16), dtype=_I32, device=dev)
    is_i4 = i4_cost < i16_cost

    e16 = _encode_i16(fenc16, preds16[torch.arange(N, device=dev), i16_mode],
                      qp, cqm)
    w1 = is_i4[:, None]
    w2 = is_i4[:, None, None]
    cbp_i4 = sum(((i4_nnz[:, 4 * q:4 * q + 4] != 0).any(-1).to(_I32) << q)
                 for q in range(4))

    predsU = I.predict_8x8c_all(uleft8, utop9[:, 1:9], utop9[:, 0])
    predsV = I.predict_8x8c_all(vleft8, vtop9[:, 1:9], vtop9[:, 0])
    cc = mbcmp(predsU, fenc_u8[:, None]) + mbcmp(predsV, fenc_v8[:, None]) \
        + lam[:, None] * _c(_BITSC, dev).to(_I32)
    _, chroma_mode = _ordered_pick(cc, _c(_ORDERC, dev)[case])
    ar = torch.arange(N, device=dev)
    eu = _encode_chroma_channel(fenc_u8, predsU[ar, chroma_mode], qpc, cqm)
    ev = _encode_chroma_channel(fenc_v8, predsV[ar, chroma_mode], qpc, cqm)
    any_dc = (eu["nz_dc"] | ev["nz_dc"]) != 0
    cbp_chroma = torch.where(eu["has_ac"] | ev["has_ac"], 2,
                             torch.where(any_dc, 1, 0))
    return dict(
        mb_type=is_i4.to(_I32), i16_mode=i16_mode.to(_I32),
        i4_modes=i4_modes.to(_I32), chroma_mode=chroma_mode.to(_I32),
        cbp_luma=torch.where(is_i4, cbp_i4, e16["cbp_luma"]),
        cbp_chroma=cbp_chroma.to(_I32),
        recon_y=torch.where(w2, i4_recon, e16["recon"]),
        recon_u=eu["recon"], recon_v=ev["recon"],
        luma_levels=torch.where(w2, i4_levels, e16["levels"]),
        luma_nnz=torch.where(w1, i4_nnz, e16["nnz"]),
        luma_dc_levels=torch.where(w1, 0, e16["dc_levels"]),
        nz_luma_dc=torch.where(is_i4, 0, e16["nz_dc"]),
        chroma_dc_levels=torch.stack([eu["dc_levels"], ev["dc_levels"]], 1),
        chroma_ac_levels=torch.stack([eu["ac_levels"], ev["ac_levels"]], 1),
        chroma_nnz_ac=torch.stack([eu["nnz_ac"], ev["nnz_ac"]], 1),
        chroma_nz_dc=torch.stack([eu["nz_dc"], ev["nz_dc"]], 1))


_OUT_SHAPES = {
    "mb_type": (), "i16_mode": (), "i4_modes": (16,), "chroma_mode": (),
    "cbp_luma": (), "cbp_chroma": (), "luma_levels": (16, 16),
    "luma_nnz": (16,), "luma_dc_levels": (16,), "nz_luma_dc": (),
    "chroma_dc_levels": (2, 4), "chroma_ac_levels": (2, 4, 16),
    "chroma_nnz_ac": (2, 4), "chroma_nz_dc": (2,)}


def encode_i_frame(fenc_y, fenc_u, fenc_v, qp, qpc, lam, mb_w: int,
                   mb_h: int, use_satd: bool, i4x4_enabled: bool, cqm=None):
    """Encode S I-frames: fenc_* (S, H, W) planes; qp/qpc/lam (S, mb_h,
    mb_w) int32 grids; cqm the scaling lists (None flat). Returns the
    per-MB syntax dict + unfiltered recon planes of the JAX
    encode_i_frame, each with a leading S axis."""
    from ..ops.deblock import diag_schedule
    S = fenc_y.shape[0]
    dev = fenc_y.device
    H, W = 16 * mb_h, 16 * mb_w
    fy, fu, fv = (p.to(_I32) for p in (fenc_y, fenc_u, fenc_v))
    ry = torch.zeros((S, H + 2 * PAD, W + 2 * PAD), dtype=_I32, device=dev)
    ru = torch.zeros((S, H // 2 + 2 * PAD, W // 2 + 2 * PAD), dtype=_I32,
                     device=dev)
    rv = torch.zeros_like(ru)
    out = {k: torch.zeros((S, mb_h, mb_w) + shp, dtype=_I32, device=dev)
           for k, shp in _OUT_SHAPES.items()}
    sidx = torch.arange(S, device=dev)[:, None]
    left_idx = torch.as_tensor(_LEFT_COL_IDX, device=dev)
    top_idx = torch.as_tensor(_TOP_ROW_IDX, device=dev)

    def gather(plane, ys, xs, size, y_off, x_off, h, w):
        r = (ys * size + y_off)[:, None, None] + torch.arange(h, device=dev)[
            None, :, None]
        c = (xs * size + x_off)[:, None, None] + torch.arange(w, device=dev)[
            None, None, :]
        return plane[sidx[:, :, None, None], r[None], c[None]].reshape(
            (-1, h, w))

    for ys_l, xs_l in diag_schedule(mb_w, mb_h):
        K = len(ys_l)
        ys = torch.tensor(ys_l, device=dev)
        xs = torch.tensor(xs_l, device=dev)
        fenc16 = gather(fy, ys, xs, 16, 0, 0, 16, 16)
        fencu = gather(fu, ys, xs, 8, 0, 0, 8, 8)
        fencv = gather(fv, ys, xs, 8, 0, 0, 8, 8)
        ytop25 = gather(ry, ys, xs, 16, PAD - 1, PAD - 1, 1, 25)[:, 0]
        yleft16 = gather(ry, ys, xs, 16, PAD, PAD - 1, 16, 1)[:, :, 0]
        utop9 = gather(ru, ys, xs, 8, PAD - 1, PAD - 1, 1, 9)[:, 0]
        uleft8 = gather(ru, ys, xs, 8, PAD, PAD - 1, 8, 1)[:, :, 0]
        vtop9 = gather(rv, ys, xs, 8, PAD - 1, PAD - 1, 1, 9)[:, 0]
        vleft8 = gather(rv, ys, xs, 8, PAD, PAD - 1, 8, 1)[:, :, 0]

        al = (xs > 0)[None].expand(S, K)
        at = (ys > 0)[None].expand(S, K)
        atr = ((ys > 0) & (xs < mb_w - 1))[None].expand(S, K)

        def eff_modes(y, x, idxs, avail):
            is_i4 = out["mb_type"][:, y, x] == 1                 # (S, K)
            mm = torch.where(is_i4[..., None],
                             out["i4_modes"][:, y, x][..., idxs], 2)
            return torch.where(avail[..., None], mm, -1).long()

        left_modes = eff_modes(ys, (xs - 1).clamp(min=0), left_idx, al)
        top_modes = eff_modes((ys - 1).clamp(min=0), xs, top_idx, at)
        res = encode_mb(
            fenc16, fencu, fencv, ytop25, yleft16, utop9, uleft8, vtop9,
            vleft8, al.reshape(-1), at.reshape(-1), (al & at).reshape(-1),
            atr.reshape(-1), left_modes.reshape(-1, 4),
            top_modes.reshape(-1, 4), qp[:, ys, xs].reshape(-1),
            qpc[:, ys, xs].reshape(-1), lam[:, ys, xs].reshape(-1),
            use_satd, i4x4_enabled, cqm)

        def scatter(plane, size, vals):
            r = (ys * size + PAD)[:, None, None] + torch.arange(
                size, device=dev)[None, :, None]
            c = (xs * size + PAD)[:, None, None] + torch.arange(
                size, device=dev)[None, None, :]
            plane[sidx[:, :, None, None], r[None], c[None]] = vals.reshape(
                S, K, size, size)

        scatter(ry, 16, res["recon_y"])
        scatter(ru, 8, res["recon_u"])
        scatter(rv, 8, res["recon_v"])
        for k, shp in _OUT_SHAPES.items():
            out[k][:, ys, xs] = res[k].reshape((S, K) + shp).to(_I32)
    out["recon_y"] = ry[:, PAD:PAD + H, PAD:PAD + W]
    out["recon_u"] = ru[:, PAD:PAD + H // 2, PAD:PAD + W // 2]
    out["recon_v"] = rv[:, PAD:PAD + H // 2, PAD:PAD + W // 2]
    return out
