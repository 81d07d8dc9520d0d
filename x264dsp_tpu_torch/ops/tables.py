"""Quantization tables and scan orders (common/set.c, common/dct.c).

Flat-CQM tables computed exactly as x264_cqm_init (common/set.c:242-352):
``quant4_mf[qp][i] = SHIFT(quant4_scale[qp%6][j], qp/6 - 1)`` with
``j = (i&1) + ((i>>2)&1)``, bias via the deadzone formula, and
``dequant4_mf[rem][i] = dequant4_scale[rem][j] * 16`` (flat list = 16).

Copied from x264dsp_tpu/ops/tables.py
so that the port imports nothing of the JAX package; only the import
lines differ.
"""

from __future__ import annotations

import numpy as np

QP_MAX = 69

DEQUANT4_SCALE = np.array([
    [10, 13, 16], [11, 14, 18], [13, 16, 20],
    [14, 18, 23], [16, 20, 25], [18, 23, 29]], dtype=np.int32)

QUANT4_SCALE = np.array([
    [13107, 8066, 5243], [11916, 7490, 4660], [10082, 6554, 4194],
    [9362, 5825, 3647], [8192, 5243, 3355], [7282, 4559, 2893]],
    dtype=np.int64)

# position class j for each raster index i in a 4x4 block
_J = np.array([(i & 1) + ((i >> 2) & 1) for i in range(16)], dtype=np.int64)


def _shift(x: np.ndarray, s: int) -> np.ndarray:
    """SHIFT(x,s) from common/set.c:149 (round-half-up on right shift)."""
    if s <= 0:
        return x << (-s)
    return (x + (1 << (s - 1))) >> s


def _make_tables():
    quant_mf = np.zeros((QP_MAX + 1, 16), dtype=np.int32)
    bias_intra = np.zeros((QP_MAX + 1, 16), dtype=np.int32)
    bias_inter = np.zeros((QP_MAX + 1, 16), dtype=np.int32)
    # deadzone: intra 21, inter 11 (common/set.c:175-178; defaults
    # i_luma_deadzone = {21,11}, common/common.c:126-127)
    dz_intra, dz_inter = 32 - 11, 32 - 21
    for q in range(QP_MAX + 1):
        mf = _shift(QUANT4_SCALE[q % 6][_J], q // 6 - 1)
        quant_mf[q] = mf
        bias_intra[q] = np.minimum((dz_intra * 1024 + mf // 2) // mf,
                                   (1 << 15) // mf)
        bias_inter[q] = np.minimum((dz_inter * 1024 + mf // 2) // mf,
                                   (1 << 15) // mf)
    dequant_mf = np.zeros((6, 16), dtype=np.int32)
    for rem in range(6):
        dequant_mf[rem] = DEQUANT4_SCALE[rem][_J] * 16
    return quant_mf, bias_intra, bias_inter, dequant_mf


QUANT4_MF, QUANT4_BIAS_INTRA, QUANT4_BIAS_INTER, DEQUANT4_MF = _make_tables()


# ---------------------------------------------------------------------------
# Custom quantization matrices (common/set.c:287-352, common/set.h:253-328)
# ---------------------------------------------------------------------------

# JVT preset 4x4 scaling lists (x264_cqm_jvt4i/4p, set.h:253-266; spec
# Table 7-3 Default_4x4). Natural raster order — symmetric, so the
# reference's transposed block storage reads them identically.
CQM_JVT4I = (6, 13, 20, 28, 13, 20, 28, 32,
             20, 28, 32, 37, 28, 32, 37, 42)
CQM_JVT4P = (10, 14, 20, 24, 14, 20, 24, 27,
             20, 24, 27, 30, 24, 27, 30, 34)
CQM_FLAT16_4 = (16,) * 16

# scaling-list set order: 0=4IY, 1=4PY, 2=4IC, 3=4PC (set.h:61-64)
CQM_JVT_LISTS = (CQM_JVT4I, CQM_JVT4P, CQM_JVT4I, CQM_JVT4P)
CQM_FLAT_LISTS = (CQM_FLAT16_4,) * 4


def cqm_tables(lists):
    """Quant/dequant/bias tables for 4 scaling lists (4IY/4PY/4IC/4PC).

    dequant follows the fork's general path (common/set.c:330-333):
    ``dequant4_mf[set][rem][i] = dequant4_scale[rem][j] * list[i]``.
    quant uses the matched inverse ``DIV(quant4_scale[rem][j] * 16,
    list[i])`` (upstream x264 semantics — the fork's general path leaves
    quant flat, which mis-rounds reconstruction for any non-flat list;
    the matched form keeps quant∘dequant ≈ identity for every list).
    Returns (quant_mf[4][70][16], bias_intra[4][70][16],
    bias_inter[4][70][16], dequant_mf[4][6][16]) as int32 arrays.
    ``lists`` must be a tuple of 4 16-tuples (hashable: used as a jit
    static arg key)."""
    return _cqm_tables_cached(tuple(tuple(int(v) for v in l)
                                    for l in lists))


def _cqm_tables_cached(lists):
    if lists in _CQM_CACHE:
        return _CQM_CACHE[lists]
    n_sets = len(lists)
    quant_mf = np.zeros((n_sets, QP_MAX + 1, 16), dtype=np.int32)
    bias_intra = np.zeros((n_sets, QP_MAX + 1, 16), dtype=np.int32)
    bias_inter = np.zeros((n_sets, QP_MAX + 1, 16), dtype=np.int32)
    dequant_mf = np.zeros((n_sets, 6, 16), dtype=np.int32)
    dz_intra, dz_inter = 32 - 11, 32 - 21
    for s, lst in enumerate(lists):
        sl = np.asarray(lst, dtype=np.int64)
        for rem in range(6):
            dequant_mf[s, rem] = DEQUANT4_SCALE[rem][_J] * sl
        for q in range(QP_MAX + 1):
            base = QUANT4_SCALE[q % 6][_J] * 16
            mf_unshifted = (base + sl // 2) // sl          # DIV
            mf = _shift(mf_unshifted, q // 6 - 1)
            mf = np.maximum(mf, 1)
            quant_mf[s, q] = mf
            bias_intra[s, q] = np.minimum(
                (dz_intra * 1024 + mf // 2) // mf, (1 << 15) // mf)
            bias_inter[s, q] = np.minimum(
                (dz_inter * 1024 + mf // 2) // mf, (1 << 15) // mf)
    out = (quant_mf, bias_intra, bias_inter, dequant_mf)
    _CQM_CACHE[lists] = out
    return out


_CQM_CACHE: dict = {}

# Zigzag scan for 4x4 frame blocks. The reference's DCT stores blocks
# TRANSPOSED (sub4x4_dct, common/dct.c:121-155 computes C·Xᵀ·Cᵀ) and its
# zigzag_scan_4x4_frame (common/dct.c:330-347) compensates. We store blocks
# in natural (row, col) orientation, so we use the standard H.264 scan;
# the resulting level sequence is identical.
ZIGZAG_4x4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
                      dtype=np.int32)

# chroma QP mapping for spec QP 0..51 (H.264 table 8-15); index with
# clip(qp + chroma_qp_offset, 0, 51)
CHROMA_QP_TABLE = np.array(
    list(range(30)) +
    [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38,
     39, 39, 39, 39], dtype=np.int32)

DECIMATE_TABLE4 = np.array([3, 2, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                           dtype=np.int32)
