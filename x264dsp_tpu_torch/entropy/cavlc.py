"""Host CAVLC entropy stage — twin of encoder/cavlc.c + common/vlc.c.

The device computes per-MB syntax-element tensors (modes, cbp, nnz flags,
zigzagged coefficient levels); this module serializes them. This is the
inherently bit-serial stage the reference also keeps scalar (SURVEY §7.1
"entropy on host").

Level coding follows the spec exactly (the reference's table builder,
common/vlc.c:781-823, including the suffixLength==0 prefix-14 4-bit case);
level-prefix overflow beyond 12 suffix bits sets the overflow flag so the
caller can re-encode the MB at QP+1 (cavlc.c:56-60, encoder.c:1560-1569).

Copied from x264dsp_tpu/entropy/cavlc.py
so that the port imports nothing of the JAX package; only the import
lines differ.
"""

from __future__ import annotations

import numpy as np

from .bitstream import BitWriter
from .cavlc_tables import (COEFF0_TOKEN, COEFF_TOKEN, TOTAL_ZEROS,
                           TOTAL_ZEROS_2x2_DC)

# run_before VLC (ITU-T H.264 Table 9-10), indexed [min(zeros_left,7)-1][run]
_RUN_BEFORE = [
    [(1, 1), (0, 1)],
    [(1, 1), (1, 2), (0, 2)],
    [(3, 2), (2, 2), (1, 2), (0, 2)],
    [(3, 2), (2, 2), (1, 2), (1, 3), (0, 3)],
    [(3, 2), (2, 2), (3, 3), (2, 3), (1, 3), (0, 3)],
    [(3, 2), (0, 3), (1, 3), (3, 3), (2, 3), (5, 3), (4, 3)],
    [(7, 3), (6, 3), (5, 3), (4, 3), (3, 3), (2, 3), (1, 3),
     (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (1, 9), (1, 10), (1, 11)],
]

# ct_index: nC → coeff_token table class (encoder/cavlc.c:146)
_CT_INDEX = [0, 0, 1, 1, 2, 2, 2, 2] + [3] * 9

# cbp → golomb code, 4:2:0 [intra? 0:inter][cbp] (encoder/cavlc.c:9-19)
CBP_TO_GOLOMB_INTRA = [
    3, 29, 30, 17, 31, 18, 37, 8, 32, 38, 19, 9, 20, 10, 11, 2,
    16, 33, 34, 21, 35, 22, 39, 4, 36, 40, 23, 5, 24, 6, 7, 1,
    41, 42, 43, 25, 44, 26, 46, 12, 45, 47, 27, 13, 28, 14, 15, 0]
CBP_TO_GOLOMB_INTER = [
    0, 2, 3, 7, 4, 8, 17, 13, 5, 18, 9, 14, 10, 15, 16, 11,
    1, 32, 33, 36, 34, 37, 44, 40, 35, 45, 38, 41, 39, 42, 43, 19,
    6, 24, 25, 20, 26, 21, 46, 28, 27, 47, 22, 29, 23, 30, 31, 12]


def update_suffix(suffix_len: int, abs_level: int) -> int:
    """Suffix-length adaptation (common/vlc.c:817-821). NOTE: for the first
    coded (sign-adjusted) level the reference adapts on the ORIGINAL level
    (cavlc.c:108 uses val_original), so the caller passes that."""
    if suffix_len == 0:
        suffix_len = 1
    if abs_level > (3 << (suffix_len - 1)) and suffix_len < 6:
        suffix_len += 1
    return suffix_len


def write_coeff_level(bw: BitWriter, level: int, suffix_len: int) -> bool:
    """Write one coefficient level; returns the overflow flag."""
    abs_level = abs(level)
    level_code = 2 * abs_level - 2 + (1 if level < 0 else 0)
    overflow = False
    if suffix_len == 0:
        if level_code < 14:
            bw.write(level_code + 1, 1)
        elif level_code < 30:
            bw.write(15, 1)              # prefix 14 zeros + stop bit
            bw.write(4, level_code - 14)
        else:
            lc = level_code - 30
            prefix = 15
            if lc >= 1 << 12:
                # baseline/main: overflow → caller re-encodes at QP+1
                overflow = True
                lc &= (1 << 12) - 1
            bw.write(prefix + 1, 1)
            bw.write(prefix - 3, lc)
    else:
        if (level_code >> suffix_len) < 15:
            bw.write((level_code >> suffix_len) + 1 + suffix_len,
                     (1 << suffix_len) + (level_code & ((1 << suffix_len) - 1)))
        else:
            lc = level_code - (15 << suffix_len)
            prefix = 15
            if lc >= 1 << 12:
                overflow = True
                lc &= (1 << 12) - 1
            bw.write(prefix + 1, 1)
            bw.write(prefix - 3, lc)
    return overflow


def write_block_residual(bw: BitWriter, levels, nC: int, chroma_dc: bool = False):
    """Serialize one residual block (x264_cavlc_block_residual_internal,
    encoder/cavlc.c:72-144).

    levels: zigzag-ordered coefficient array (len 4/15/16).
    nC: context (-1 handled by caller via chroma_dc flag).
    Returns (total_coeff, overflow)."""
    levels = np.asarray(levels)
    n = len(levels)
    nz_idx = np.flatnonzero(levels)
    if nz_idx.size == 0:
        if chroma_dc:
            bw.write(COEFF0_TOKEN[4][1], COEFF0_TOKEN[4][0])
        else:
            t = COEFF0_TOKEN[_CT_INDEX[min(nC, 16)]]
            bw.write(t[1], t[0])
        return 0, False

    last = int(nz_idx[-1])
    rev = nz_idx[::-1]
    lev = [int(levels[i]) for i in rev]           # reverse scan order
    runs = []                                     # zeros below each coeff
    prev = last
    for i in rev[1:]:
        runs.append(prev - int(i) - 1)
        prev = int(i)
    total = len(lev)
    total_zeros = last + 1 - total

    # trailing ones (max 3, must be consecutive from the highest freq)
    trailing = 0
    while trailing < min(3, total) and abs(lev[trailing]) == 1:
        trailing += 1
    sign_bits = 0
    for k in range(trailing):
        sign_bits = (sign_bits << 1) | (1 if lev[k] < 0 else 0)

    table = 4 if chroma_dc else _CT_INDEX[min(nC, 16)]
    bits, size = COEFF_TOKEN[table][total - 1][trailing]
    bw.write(size, bits)
    bw.write(trailing, sign_bits)

    overflow = False
    suffix_len = 1 if (total > 10 and trailing < 3) else 0
    for k in range(trailing, total):
        val = lev[k]
        if k == trailing and trailing < 3:
            # first non-T1 level cannot be ±1 → shift magnitude toward zero
            val -= 1 if val > 0 else -1
        overflow |= write_coeff_level(bw, val, suffix_len)
        suffix_len = update_suffix(suffix_len, abs(lev[k]))

    if chroma_dc:
        if total < 4:
            b, s = TOTAL_ZEROS_2x2_DC[total - 1][total_zeros]
            bw.write(s, b)
    elif total < n:
        b, s = TOTAL_ZEROS[total - 1][total_zeros]
        bw.write(s, b)

    zeros_left = total_zeros
    for run in runs:
        if zeros_left <= 0:
            break
        b, s = _RUN_BEFORE[min(zeros_left, 7) - 1][run]
        bw.write(s, b)
        zeros_left -= run
    return total, overflow
