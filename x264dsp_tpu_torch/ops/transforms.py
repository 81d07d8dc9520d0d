"""4x4 transform and quant kernels — port of x264dsp_tpu/ops/transforms.py
(common/dct.c, common/quant.c), int32 tensors with arbitrary leading
batch dims (..., 4, 4). The quant and dequant functions take the JAX
package's scaling-list arguments: cqm None (flat, the module tables) or a
tuple of 4 16-tuples (4IY/4PY/4IC/4PC), and cqm_set the list's index
(cqm_mf, transforms.py:41-54).

The forward DCT C.X.C^T runs as integer butterflies; the TPU path's
one-hot matmul table lookups (transforms.py:table_rows, zigzag4x4)
become direct indexing.
"""

from __future__ import annotations

import numpy as np
import torch

from .devtab import device_table
from .tables import (DEQUANT4_MF, QUANT4_BIAS_INTER, QUANT4_BIAS_INTRA,
                     QUANT4_MF, ZIGZAG_4x4, cqm_tables)

# coding-order 4x4 block idx -> (x, y) block position in the MB (scan8
# order); copied from x264dsp_tpu/ops/golden.py (which imports JAX)
BLOCK_IDX_X = np.array([0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3])
BLOCK_IDX_Y = np.array([0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3])

_QUANT4_BIAS = np.stack([QUANT4_BIAS_INTER, QUANT4_BIAS_INTRA])
# host tables of one scaling-list set, kept alive for device_table's
# cache: (cqm, cqm_set) -> (quant_mf, bias [inter, intra], dequant_mf)
_CQM_SETS: dict = {}


def cqm_mf(cqm, cqm_set: int):
    """(quant_mf (70, 16), bias (2, 70, 16) [inter, intra], dequant_mf
    (6, 16)) host tables of one scaling-list set (transforms.py:41-54):
    the flat module tables when cqm is None."""
    if cqm is None:
        return QUANT4_MF, _QUANT4_BIAS, DEQUANT4_MF
    key = (cqm, cqm_set)
    hit = _CQM_SETS.get(key)
    if hit is None:
        qmf, bi, binter, dmf = cqm_tables(cqm)
        hit = _CQM_SETS[key] = (qmf[cqm_set],
                                np.stack([binter[cqm_set], bi[cqm_set]]),
                                dmf[cqm_set])
    return hit


def tables(device, cqm=None, cqm_set: int = 0):
    """Device copies of one scaling-list set's quant tables: (quant_mf
    (70, 16), bias (2, 70, 16) [inter, intra], dequant_mf (6, 16),
    zigzag (16,))."""
    qmf, bias, dmf = cqm_mf(cqm, cqm_set)
    return (device_table(qmf, device), device_table(bias, device),
            device_table(dmf, device),
            device_table(ZIGZAG_4x4, device, torch.long))


def _fwd4(x0, x1, x2, x3):
    """One axis of the forward core transform: C rows [1,1,1,1],
    [2,1,-1,-2], [1,-1,-1,1], [1,-2,2,-1] (sub4x4_dct, dct.c:121)."""
    s03, d03 = x0 + x3, x0 - x3
    s12, d12 = x1 + x2, x1 - x2
    return s03 + s12, 2 * d03 + d12, s03 - s12, d03 - 2 * d12


def dct4x4(d):
    """C . d . C^T over the last two axes of an int32 residual."""
    d = d.to(torch.int32)
    rows = torch.stack(_fwd4(*(d[..., i, :] for i in range(4))), dim=-2)
    return torch.stack(_fwd4(*(rows[..., :, j] for j in range(4))), dim=-1)


def sub_dct4x4(pix1, pix2):
    return dct4x4(pix1.to(torch.int32) - pix2.to(torch.int32))


def _inv4(d0, d1, d2, d3):
    s02, d02 = d0 + d2, d0 - d2
    s13 = d1 + (d3 >> 1)
    d13 = (d1 >> 1) - d3
    return s02 + s13, d02 + d13, d02 - d13, s02 - s13


def idct4x4_res(dct):
    """Inverse 4x4 transform without the add (add4x4_idct's residual,
    common/dct.c:197): horizontal pass, vertical pass, (+32) >> 6."""
    d = dct.to(torch.int32)
    t = torch.stack(_inv4(*(d[..., :, j] for j in range(4))), dim=-1)
    o = torch.stack(_inv4(*(t[..., i, :] for i in range(4))), dim=-2)
    return (o + 32) >> 6


def idct4x4_add(pred, dct):
    return (pred.to(torch.int32) + idct4x4_res(dct)).clamp(0, 255)


def _had4(x0, x1, x2, x3):
    """Rows of H = [[1,1,1,1],[1,1,-1,-1],[1,-1,-1,1],[1,-1,1,-1]]."""
    s01, d01 = x0 + x1, x0 - x1
    s23, d23 = x2 + x3, x2 - x3
    return s01 + s23, s01 - s23, d01 - d23, d01 + d23


def hadamard4x4(d, forward: bool):
    """Luma DC hadamard H.D.H^T; forward adds (+1) >> 1 (dct4x4dc,
    dct.c:36; idct4x4dc :72)."""
    d = d.to(torch.int32)
    rows = torch.stack(_had4(*(d[..., i, :] for i in range(4))), dim=-2)
    out = torch.stack(_had4(*(rows[..., :, j] for j in range(4))), dim=-1)
    return (out + 1) >> 1 if forward else out


def hadamard2x2(dc):
    """Chroma 2x2 DC hadamard, reference storage order (dct2x2dc,
    macroblock.c:44-59); dc (..., 4) raster quadrant DCs."""
    d0 = dc[..., 0] + dc[..., 1]
    d1 = dc[..., 2] + dc[..., 3]
    d2 = dc[..., 0] - dc[..., 1]
    d3 = dc[..., 2] - dc[..., 3]
    return torch.stack([d0 + d1, d0 - d1, d2 + d3, d2 - d3], dim=-1)


def dc_dmf(qp, cqm=None, cqm_set: int = 0):
    """dequant_mf[qp % 6][0] << (qp // 6) for an int32 qp tensor."""
    _, _, dmf, _ = tables(qp.device, cqm, cqm_set)
    return dmf[(qp % 6).long(), 0] << (qp // 6)


def idct_dequant_2x2_dc(dc, qp, cqm=None, cqm_set: int = 0):
    """Inverse 2x2 DC + dequant (macroblock.c:17-29); qp (...,)."""
    dmf = dc_dmf(qp, cqm, cqm_set) >> 5
    d0 = dc[..., 0] + dc[..., 1]
    d1 = dc[..., 2] + dc[..., 3]
    d2 = dc[..., 0] - dc[..., 1]
    d3 = dc[..., 2] - dc[..., 3]
    return torch.stack([(d0 + d1) * dmf, (d0 - d1) * dmf,
                        (d2 + d3) * dmf, (d2 - d3) * dmf], dim=-1)


def quant_core(c, mf, bias):
    """QUANT_ONE (common/quant.c:31-38) with sign restore, int32."""
    pos = ((bias + c) * mf) >> 16
    neg = ((bias - c) * mf) >> 16
    return torch.where(c > 0, pos, -neg)


def quant4x4(dct, qp, intra: bool, cqm=None, cqm_set: int = 0):
    """quant_4x4 (common/quant.c:40); qp (...,) int32 per block."""
    qmf, qbias, _, _ = tables(dct.device, cqm, cqm_set)
    q = qp.long()
    mf = qmf[q].reshape(qp.shape + (4, 4))
    bias = qbias[int(intra)][q].reshape(qp.shape + (4, 4))
    return quant_core(dct.to(torch.int32), mf, bias)


def quant_dc(dct, qp, intra: bool, cqm=None, cqm_set: int = 0):
    """DC quant: mf[0] >> 1, bias[0] << 1 (macroblock.c:124); dct
    (..., N) flat DC coefficients, qp (...,)."""
    qmf, qbias, _, _ = tables(dct.device, cqm, cqm_set)
    q = qp.long()
    mf = (qmf[q, 0] >> 1)[..., None]
    bias = (qbias[int(intra)][q, 0] << 1)[..., None]
    return quant_core(dct.to(torch.int32), mf, bias)


def dequant4x4(q, qp, cqm=None, cqm_set: int = 0):
    """dequant_4x4 (common/quant.c:66-83), both shift branches."""
    _, _, dmf_t, _ = tables(q.device, cqm, cqm_set)
    mf = dmf_t[(qp % 6).long()].reshape(qp.shape + (4, 4))
    qbits = (qp // 6 - 4)[..., None, None]
    q = q.to(torch.int32)
    shl = (q * mf) << qbits.clamp(min=0)
    nq = (-qbits).clamp(min=0)
    shr = (q * mf + ((1 << nq) >> 1)) >> nq
    return torch.where(qbits >= 0, shl, shr)


def dequant_dc4x4(q, qp, cqm=None, cqm_set: int = 0):
    """dequant_4x4_dc (common/quant.c:85-103); q (..., 4, 4)."""
    _, _, dmf_t, _ = tables(q.device, cqm, cqm_set)
    dmf = dmf_t[(qp % 6).long(), 0][..., None, None]
    qbits = (qp // 6 - 6)[..., None, None]
    q = q.to(torch.int32)
    shl = q * (dmf << qbits.clamp(min=0))
    nq = (-qbits).clamp(min=0)
    shr = (q * dmf + ((1 << nq) >> 1)) >> nq
    return torch.where(qbits >= 0, shl, shr)


def zigzag4x4(block):
    """(..., 4, 4) -> (..., 16) levels in frame zigzag order."""
    _, _, _, zz = tables(block.device)
    return block.reshape(block.shape[:-2] + (16,))[..., zz]
