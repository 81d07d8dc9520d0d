"""Whole-plane residual pipeline — port of x264dsp_tpu/ops/residual_plane.py.

A frame's 4x4 coefficients are kept coefficient-major: ``cm`` is an
(S, 16, H/4, W/4) int32 tensor, plane c = 4*i + j holding coefficient
(i, j) of every block. The TPU path computes the forward DCT as f32
matmuls with a hi/lo bf16 split (residual_plane.py:63-97) only to keep
the MXU exact; here the same coefficients come from integer butterflies
on (…, 4, 4) block views. Quant, dequant, zigzag and the decimation score
are elementwise over the 16 planes.
"""

from __future__ import annotations

import torch

from . import transforms as T


def _to_blocks(plane):
    """(S, H, W) -> (S, H/4, W/4, 4, 4)."""
    S, H, W = plane.shape
    return plane.reshape(S, H // 4, 4, W // 4, 4).permute(0, 1, 3, 2, 4)


def _from_blocks(blk):
    """(S, Hb, Wb, 4, 4) -> (S, 4Hb, 4Wb)."""
    S, Hb, Wb = blk.shape[:3]
    return blk.permute(0, 1, 3, 2, 4).reshape(S, Hb * 4, Wb * 4)


def sub_dct_cm(fenc, pred):
    """Forward DCT of (fenc - pred) for whole planes (S, H, W) ->
    (S, 16, H/4, W/4) coefficient planes, natural order."""
    d = T.dct4x4(_to_blocks(fenc.to(torch.int32) - pred.to(torch.int32)))
    S, Hb, Wb = d.shape[:3]
    return d.reshape(S, Hb, Wb, 16).permute(0, 3, 1, 2)


def idct_add_plane(pred, dq_cm):
    """Inverse transform + add + clip of a whole plane (add4x4_idct)."""
    S, _, Hb, Wb = dq_cm.shape
    blk = dq_cm.permute(0, 2, 3, 1).reshape(S, Hb, Wb, 4, 4)
    res = _from_blocks(T.idct4x4_res(blk))
    return (pred.to(torch.int32) + res).clamp(0, 255)


def up(x, k: int):
    """(S, mb_h, mb_w, ...) MB grid -> block grid, k blocks per MB axis
    (on the two MB axes)."""
    return x.repeat_interleave(k, 1).repeat_interleave(k, 2)


def quant_cm(cm, qp_mb, intra: bool, k_up: int, cqm=None, cqm_set: int = 0):
    """QUANT_ONE over the 16 planes; qp_mb (S, mb_h, mb_w); cqm / cqm_set
    pick a scaling-list set (transforms.tables)."""
    qmf, qbias, _, _ = T.tables(cm.device, cqm, cqm_set)
    q = qp_mb.long()
    mf = up(qmf[q], k_up).permute(0, 3, 1, 2)          # (S, 16, Hb, Wb)
    bias = up(qbias[int(intra)][q], k_up).permute(0, 3, 1, 2)
    return T.quant_core(cm, mf, bias)


def dequant_cm(q_cm, qp_mb, k_up: int, cqm=None, cqm_set: int = 0):
    """dequant_4x4 over the 16 planes, shl/shr branches per QP."""
    _, _, dmf_t, _ = T.tables(q_cm.device, cqm, cqm_set)
    dmf = up(dmf_t[(qp_mb % 6).long()], k_up).permute(0, 3, 1, 2)
    qb = up(qp_mb // 6 - 4, k_up)[:, None]
    nq = (-qb).clamp(min=0)
    shl = (q_cm * dmf) << qb.clamp(min=0)
    shr = (q_cm * dmf + ((1 << nq) >> 1)) >> nq
    return torch.where(qb >= 0, shl, shr)


def zigzag_order(cm):
    """Natural-order planes -> zigzag scan order (dim 1)."""
    _, _, _, zz = T.tables(cm.device)
    return cm[:, zz]


def decimate_score_cm(z_cm):
    """x264_decimate_score (common/quant.c:227-252) per block of the
    zigzag planes (S, L, Hb, Wb): run-weight (run<1)+(run<3)+(run<6)
    per nonzero, 9 when any |level| > 1."""
    shape = (z_cm.shape[0],) + z_cm.shape[2:]
    score = torch.zeros(shape, dtype=torch.int32, device=z_cm.device)
    run = torch.zeros_like(score)
    big = torch.zeros(shape, dtype=torch.bool, device=z_cm.device)
    for i in range(z_cm.shape[1]):
        lv = z_cm[:, i]
        nz = lv != 0
        tab = ((run < 1).to(torch.int32) + (run < 3).to(torch.int32)
               + (run < 6).to(torch.int32))
        score = score + torch.where(nz, tab, 0)
        run = torch.where(nz, 0, run + 1)
        big = big | (lv.abs() > 1)
    return torch.where(big, 9, score)


def nnz_cm(z_cm):
    """Per-block nonzero flag (S, Hb, Wb) int32."""
    return (z_cm != 0).any(1).to(torch.int32)


def mask_cm(cm, keep):
    return cm * keep.to(cm.dtype)[:, None]


def blockgrid_to_mb(x, mb_h: int, mb_w: int, k: int):
    """(S, mb_h*k, mb_w*k) -> (S, mb_h, mb_w, k, k)."""
    S = x.shape[0]
    return x.reshape(S, mb_h, k, mb_w, k).permute(0, 1, 3, 2, 4)


def mb_to_blockgrid(x, mb_h: int, mb_w: int, k: int):
    """(S, mb_h, mb_w, k, k) -> (S, mb_h*k, mb_w*k)."""
    S = x.shape[0]
    return x.permute(0, 1, 3, 2, 4).reshape(S, mb_h * k, mb_w * k)


def luma_nnz_coding(nnz_bg, mb_h: int, mb_w: int):
    """(S, 4mb_h, 4mb_w) -> (S, mb_h, mb_w, 16) in coding (quadrant)
    order."""
    S = nnz_bg.shape[0]
    g = blockgrid_to_mb(nnz_bg, mb_h, mb_w, 4).reshape(S, mb_h, mb_w, 2, 2,
                                                        2, 2)
    return g.permute(0, 1, 2, 3, 5, 4, 6).reshape(S, mb_h, mb_w, 16)


def luma_levels_coding(z_cm, mb_h: int, mb_w: int):
    """Zigzag planes (S, 16, 4mb_h, 4mb_w) -> (S, mb_h, mb_w, 16, 16)
    levels in coding block order."""
    S = z_cm.shape[0]
    lv = z_cm.reshape(S, 16, mb_h, 2, 2, mb_w, 2, 2)   # c, mby,qy,iy, mbx,qx,ix
    lv = lv.permute(0, 2, 5, 3, 6, 4, 7, 1)            # mby,mbx,qy,qx,iy,ix,c
    return lv.reshape(S, mb_h, mb_w, 16, 16)


def chroma_levels_coding(z_cm, mb_h: int, mb_w: int):
    """Chroma zigzag planes (S, 16, 2mb_h, 2mb_w) -> (S, mb_h, mb_w, 4,
    16) (2x2 quadrants in raster order)."""
    S = z_cm.shape[0]
    lv = z_cm.reshape(S, 16, mb_h, 2, mb_w, 2).permute(0, 2, 4, 3, 5, 1)
    return lv.reshape(S, mb_h, mb_w, 4, 16)
