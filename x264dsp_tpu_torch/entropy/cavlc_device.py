"""Device-side CAVLC entropy stage — port of
x264dsp_tpu/entropy/cavlc_device.py.

Every macroblock's CAVLC syntax elements are computed as batched
(value, bit length) slots on the device: skip runs, mb_type, te(ref),
se(mvd) off the partition-aware MV predictor, cbp, the dqp chain and the
residual block coder (coeff_token, trailing-one signs, the level
prefix/suffix chain, total_zeros, run_before). The slots are then packed
into the slice payload, so only payload bytes cross to the host. Every
tensor carries a leading stream axis S (the JAX code is per stream and
vmapped).

The bytes are those of the host C++ writers (csrc/host/entropy.cpp,
x264tpu_write_slice_p / _i), which the tests hold this module to: the
element order follows the writers, the tables are ITU-T H.264 Tables
9-5..9-10 (entropy/cavlc_tables.py) and the MV prediction mirrors MvGrid4
there (common/mvpred.c).

What differs from the JAX module is mechanism only. Small tables are read
with indexed loads (the JAX compare-and-select lookups avoid TPU
gathers), the block coder runs on the coded blocks only, and the packer
is a prefix sum and a scatter: the exclusive prefix sum of the slot
lengths in stream order (over the MBs, then over the slots inside each
MB) gives every slot its bit position, and each slot adds its
left-aligned value into the one or two 32-bit words it covers
(``index_add_``; slots own disjoint bits, so adding equals or-ing and the
result does not depend on the order). The JAX packer merges fixed-size
word buffers pairwise (cavlc_device.py:683-832) because the TPU has no
scatter; its buffer sizes are limits that raise the overflow flag, and
``_pack`` raises the flag at the same limits although the scatter needs
none of them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.devtab import device_table
from . import cavlc_tables as T

_I32 = torch.int32
_I64 = torch.int64

# ---------------------------------------------------------------------------
# tables (cavlc_device.py:40-86)
# ---------------------------------------------------------------------------

_CT_INDEX = np.array([0, 0, 1, 1, 2, 2, 2, 2] + [3] * 9, np.int32)

# coeff_token as (6, 17, 4, 2): [table][total][t1] -> (bits, len);
# the total == 0 row holds COEFF0_TOKEN
_CTOK = np.zeros((6, 17, 4, 2), np.int32)
for _t in range(6):
    _CTOK[_t, 0, 0] = T.COEFF0_TOKEN[_t]
    for _total in range(1, 17):
        for _t1 in range(4):
            _CTOK[_t, _total, _t1] = T.COEFF_TOKEN[_t][_total - 1][_t1]

_TZ = np.array(T.TOTAL_ZEROS, np.int32)                  # (15, 16, 2)
_TZ_DC = np.array(T.TOTAL_ZEROS_2x2_DC, np.int32)        # (3, 4, 2)

# run_before (ITU-T Table 9-10), [min(zeros_left, 7) - 1][run] -> (bits, len)
_RUN_BEFORE = np.zeros((7, 15, 2), np.int32)
for _i, _row in enumerate([
    [(1, 1), (0, 1)],
    [(1, 1), (1, 2), (0, 2)],
    [(3, 2), (2, 2), (1, 2), (0, 2)],
    [(3, 2), (2, 2), (1, 2), (1, 3), (0, 3)],
    [(3, 2), (2, 2), (3, 3), (2, 3), (1, 3), (0, 3)],
    [(3, 2), (0, 3), (1, 3), (3, 3), (2, 3), (5, 3), (4, 3)],
    [(7, 3), (6, 3), (5, 3), (4, 3), (3, 3), (2, 3), (1, 3), (1, 4),
     (1, 5), (1, 6), (1, 7), (1, 8), (1, 9), (1, 10), (1, 11)],
]):
    for _j, _bl in enumerate(_row):
        _RUN_BEFORE[_i, _j] = _bl

_CBP_INTER = np.array([
    0, 2, 3, 7, 4, 8, 17, 13, 5, 18, 9, 14, 10, 15, 16, 11,
    1, 32, 33, 36, 34, 37, 44, 40, 35, 45, 38, 41, 39, 42, 43, 19,
    6, 24, 25, 20, 26, 21, 46, 28, 27, 47, 22, 29, 23, 30, 31, 12],
    np.int32)
_CBP_INTRA = np.array([
    3, 29, 30, 17, 31, 18, 37, 8, 32, 38, 19, 9, 20, 10, 11, 2,
    16, 33, 34, 21, 35, 22, 39, 4, 36, 40, 23, 5, 24, 6, 7, 1,
    41, 42, 43, 25, 44, 26, 46, 12, 45, 47, 27, 13, 28, 14, 15, 0],
    np.int32)
_PART_N = np.array([1, 2, 2, 4], np.int32)
# I-slice mode fixups (entropy.cpp:74-76); _FIX4 is indexed by mode + 1
_FIX4 = np.array([0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 2, 2, 2], np.int32)
_FIX16 = np.array([0, 1, 2, 3, 2, 2, 2], np.int32)
_FIXC = np.array([0, 1, 2, 3, 0, 0, 0], np.int32)

N_SLOTS = 34    # slots per residual block: token, signs, 16 levels,
                # total_zeros, 15 run_before
# limits of the JAX packer's buffers, kept as overflow conditions
W_GRP = 20      # words per group (cavlc_device.py:679 _W_GRP)
W_MB = 128      # words per MB (cavlc_device.py:680 _W_MB)


def _tab(values, dev):
    return device_table(values, dev, torch.long)


# ---------------------------------------------------------------------------
# exp-Golomb helpers (cavlc_device.py:94-116)
# ---------------------------------------------------------------------------

def _bitlen(x):
    """floor(log2(x)) + 1 for x >= 1 (0 for x == 0): the exponent of the
    exact float64 value."""
    return torch.frexp(x.to(torch.float64))[1].to(_I32)


def _ue(v):
    """ue(v): (val, len) with val = v + 1, len = 2 * bitlen(v + 1) - 1."""
    x = v + 1
    return x, 2 * _bitlen(x) - 1


def _se(v):
    return _ue(torch.where(v > 0, 2 * v - 1, -2 * v))


# ---------------------------------------------------------------------------
# MV grid + prediction (cavlc_device.py:122-264, MvGrid4 twin)
# ---------------------------------------------------------------------------

def _median3(a, b, c):
    mn = torch.minimum(a, torch.minimum(b, c))
    mx = torch.maximum(a, torch.maximum(b, c))
    return a + b + c - mn - mx


def _predict(nbs, shortcut=None):
    """MvGrid4::predict count/median rules. nbs = [(mv, match, exists)
    for A, B, C] with mv zeroed where not decoded; shortcut = (which, mv)
    of the spec's shortcut neighbour or None."""
    (a, m_a, ex_a), (b, m_b, ex_b), (c, m_c, ex_c) = nbs
    cnt = m_a.to(_I32) + m_b.to(_I32) + m_c.to(_I32)
    one = torch.where(m_a[..., None], a, torch.where(m_b[..., None], b, c))
    only_a = (cnt == 0) & ~ex_b & ~ex_c & ex_a
    out = torch.where((cnt == 1)[..., None], one,
                      torch.where(only_a[..., None], a, _median3(a, b, c)))
    if shortcut is not None:
        which, mv_s = shortcut
        out = torch.where(which[..., None], mv_s, out)
    return out


def mvp_field(mv8, partition, ref, mb_h: int, mb_w: int):
    """Exact entropy MVP for all 4 partition slots of every MB from the
    final mv/ref field. mv8 (S, mb_h, mb_w, 2, 2, 2) quadrant MVs,
    partition and ref (S, mb_h, mb_w). Returns mvp (S, mb_h, mb_w, 4, 2)
    (slots beyond the partition's count are unused) and the P_SKIP
    predictor (S, mb_h, mb_w, 2) (MvGrid4::pskip)."""
    S = mv8.shape[0]
    dev = mv8.device
    mv4 = mv8.repeat_interleave(2, 3).repeat_interleave(2, 4) \
        .permute(0, 1, 3, 2, 4, 5).reshape(S, 4 * mb_h, 4 * mb_w, 2)
    ref4 = ref.repeat_interleave(4, 1).repeat_interleave(4, 2)
    pad_mv = torch.nn.functional.pad(mv4, (0, 0, 4, 4, 4, 4))
    pad_rf = torch.nn.functional.pad(ref4, (4, 4, 4, 4))

    def cell(dy, dx):
        """Grid cell (4 mby + dy, 4 mbx + dx) of every MB; out-of-frame
        cells read 0 (callers mask with their exists flags)."""
        ys = slice(4 + dy, 4 + dy + 4 * mb_h, 4)
        xs = slice(4 + dx, 4 + dx + 4 * mb_w, 4)
        return pad_mv[:, ys, xs], pad_rf[:, ys, xs]

    yy = torch.arange(mb_h, device=dev)[None, :, None].expand(S, mb_h, mb_w)
    xx = torch.arange(mb_w, device=dev)[None, None, :].expand(S, mb_h, mb_w)
    has_l = xx > 0
    has_t = yy > 0
    has_tr = has_t & (xx < mb_w - 1)
    has_tl = has_t & has_l
    true = torch.ones_like(has_l)
    false = torch.zeros_like(has_l)

    def nb(dy, dx, decoded, cur_ref):
        mv, rf = cell(dy, dx)
        mv = torch.where(decoded[..., None], mv, 0)
        return mv, decoded & (rf == cur_ref), decoded

    def predict(c_pos, dec_c, f_pos, dec_f, cur_ref, a_args, b_args,
                shortcut_kind=None):
        """C falls back to the cell f_pos where C itself is not decoded."""
        a = nb(*a_args, cur_ref)
        b = nb(*b_args, cur_ref)
        c_mv, c_rf = cell(*c_pos)
        f_mv, f_rf = cell(*f_pos)
        use_f = ~dec_c
        ex_c = torch.where(use_f, dec_f, dec_c)
        mv_c = torch.where(use_f[..., None], f_mv, c_mv)
        rf_c = torch.where(use_f, f_rf, c_rf)
        mv_c = torch.where(ex_c[..., None], mv_c, 0)
        m_c = ex_c & (rf_c == cur_ref)
        sc = {None: None, "a": (a[1], a[0]), "b": (b[1], b[0]),
              "c": (m_c, mv_c)}[shortcut_kind]
        return _predict([a, b, (mv_c, m_c, ex_c)], sc)

    r = ref
    left, top = (0, -1, has_l), (-1, 0, has_t)
    tr, tl = ((-1, 4), has_tr), ((-1, -1), has_tl)
    p16 = predict(*tr, *tl, r, left, top)
    p_16x8_0 = predict(*tr, *tl, r, left, top, "b")
    p_16x8_1 = predict((1, 4), false, (1, -1), has_l, r,
                       (2, -1, has_l), (1, 0, true), "a")
    p_8x16_0 = predict((-1, 2), has_t, *tl, r, left, top, "a")
    p_8x16_1 = predict(*tr, (-1, 1), has_t, r,
                       (0, 1, true), (-1, 2, has_t), "c")
    p_8x8_0 = predict((-1, 2), has_t, *tl, r, left, top)
    p_8x8_1 = predict(*tr, (-1, 1), has_t, r, (0, 1, true), (-1, 2, has_t))
    p_8x8_2 = predict((1, 2), true, (1, -1), has_l, r,
                      (2, -1, has_l), (1, 0, true))
    p_8x8_3 = predict((1, 4), false, (1, 1), true, r,
                      (2, 1, true), (1, 2, true))

    part = partition[..., None]
    s0 = torch.where(part == 1, p_16x8_0,
                     torch.where(part == 2, p_8x16_0,
                                 torch.where(part == 3, p_8x8_0, p16)))
    s1 = torch.where(part == 1, p_16x8_1,
                     torch.where(part == 2, p_8x16_1, p_8x8_1))
    mvp = torch.stack([s0, s1, p_8x8_2, p_8x8_3], dim=3)

    # P_SKIP predictor (cur_ref = 0)
    a_mv, a_rf = cell(0, -1)
    b_mv, b_rf = cell(-1, 0)
    zero_a = has_l & (a_rf == 0) & (a_mv == 0).all(-1)
    zero_b = has_t & (b_rf == 0) & (b_mv == 0).all(-1)
    p16_r0 = predict(*tr, *tl, torch.zeros_like(ref), left, top)
    force0 = ~has_l | ~has_t | zero_a | zero_b
    return mvp, torch.where(force0[..., None], 0, p16_r0)


# ---------------------------------------------------------------------------
# residual block coder (cavlc_device.py:308-453)
# ---------------------------------------------------------------------------

def _excl_cumsum(x, dim: int):
    return torch.cumsum(x, dim) - x


def _block_elements(levels, n: int, nC, chroma_dc: bool, coded):
    """CAVLC residual coding of a batch of blocks (write_block_residual
    twin). levels (N, n) zigzag levels; nC (N,) context (None when
    chroma_dc); coded (N,) bool. Returns (vals, lens) int32 (N, 34) in
    stream order (zero-length slots carry nothing; all slots of a block
    that is not coded are empty) and a per-block overflow flag (N,): an
    escape level code past 12 bits.

    Only the coded blocks are computed: they are gathered first (one
    host sync for their count) and their slots scattered into the zero
    result. At 1080p most blocks of a P slice are not coded, and the
    block coder is the packer's largest stage on the card."""
    N = levels.shape[0]
    idx = coded.nonzero().squeeze(1)
    Vc, Lc, ov_c = _code_blocks(levels[idx], n,
                                None if chroma_dc else nC[idx], chroma_dc)
    V = Vc.new_zeros((N, N_SLOTS))
    L = Lc.new_zeros((N, N_SLOTS))
    ov = torch.zeros_like(coded)
    V[idx] = Vc
    L[idx] = Lc
    ov[idx] = ov_c
    return V, L, ov


def _code_blocks(levels, n: int, nC, chroma_dc: bool):
    """The slots of coded blocks: levels (N, n), nC (N,) or None for
    chroma DC. Returns (vals, lens) int32 (N, 34) and the overflow flag
    (N,).

    Slot 2 + j holds zigzag position n - 1 - j, so slot order is the
    writer's rank order (descending positions); rank, run and zeros-left
    of each position come from prefix scans, and only the suffix-length
    state of the level chain walks the positions one by one."""
    N = levels.shape[0]
    dev = levels.device
    lv = levels.to(_I32).flip(1)                 # slot order: high pos first
    nzm = lv != 0
    nz_i = nzm.to(_I32)
    total = nz_i.sum(1)
    rank = _excl_cumsum(nz_i, 1)                 # nonzeros above
    is_one = nzm & (lv.abs() == 1)
    bad = nz_i * (~is_one).to(_I32)
    lead_one = is_one & (rank < 3) & (_excl_cumsum(bad, 1) == 0)
    t1 = lead_one.to(_I32).sum(1)
    neg = (lv < 0).to(_I32)
    sign_bits = torch.where(
        lead_one, neg << (t1[:, None] - 1 - rank).clamp(0, 2), 0).sum(1)

    if chroma_dc:
        table = torch.full((N,), 4, dtype=torch.long, device=dev)
    else:
        table = _tab(_CT_INDEX, dev)[nC.clamp(max=16).long()]
    tok = _tab(_CTOK, dev)[table, total.long(),
                           torch.where(total > 0, t1, 0).long()]

    # level chain: the suffix length each slot codes with
    active = nzm & (rank >= t1[:, None])
    abs_orig = lv.abs()
    suffix = ((total > 10) & (t1 < 3)).to(_I32)
    sufs = []
    for j in range(n):
        sufs.append(suffix)
        s1 = suffix.clamp(min=1)
        s1 = s1 + ((abs_orig[:, j] > (3 << (s1 - 1))) & (s1 < 6)).to(_I32)
        suffix = torch.where(active[:, j], s1, suffix)
    suf = torch.stack(sufs, 1)                   # (N, n)

    first = (rank == t1[:, None]) & (t1 < 3)[:, None]
    val_k = torch.where(first, lv - lv.sign(), lv)
    code = 2 * val_k.abs() - 2 + (val_k < 0).to(_I32)
    # suffix length 0: unary, 4-bit escape, 12-bit escape
    lc0 = code - 30
    v0 = torch.where(code < 14, 1,
                     torch.where(code < 30, (1 << 4) | (code - 14),
                                 (1 << 12) | (lc0 & 0xFFF)))
    l0 = torch.where(code < 14, code + 1, torch.where(code < 30, 19, 28))
    # suffix length > 0: prefix + suffix, 12-bit escape
    pre = code >> suf
    lc1 = code - (15 << suf)
    esc1 = pre >= 15
    v1 = torch.where(esc1, (1 << 12) | (lc1 & 0xFFF),
                     (1 << suf) + (code & ((1 << suf) - 1)))
    l1 = torch.where(esc1, 28, pre + 1 + suf)
    s0 = suf == 0
    lev_v = torch.where(s0, v0, v1) * active
    lev_l = torch.where(s0, l0, l1) * active
    ov = torch.where(s0, (code >= 30) & (lc0 >= (1 << 12)),
                     esc1 & (lc1 >= (1 << 12)))
    overflow = (ov & active).any(1)

    # total_zeros
    pos = torch.arange(n - 1, -1, -1, device=dev, dtype=_I32)  # slot -> pos
    last = torch.where(nzm, pos, -1).amax(1)
    total_zeros = last + 1 - total
    tm1 = (total - 1).clamp(min=0).long()
    if chroma_dc:
        tz = _tab(_TZ_DC, dev)[tm1.clamp(max=2),
                               total_zeros.clamp(0, 3).long()]
        tz_on = (total > 0) & (total < 4)
    else:
        tz = _tab(_TZ, dev)[tm1.clamp(max=14),
                            total_zeros.clamp(0, 15).long()]
        tz_on = (total > 0) & (total < n)
    tz = tz * tz_on[:, None]

    # run_before of the nonzero at each position p >= 1: run = gap down
    # to the next nonzero, zeros_left = zeros strictly below p
    below = torch.cummax(torch.where(nzm, pos, -1).flip(1), 1).values \
        .flip(1)                                 # highest nonzero <= p
    nxt = torch.cat([below[:, 1:], below.new_full((N, 1), -1)], 1)
    run = pos - nxt - 1
    zl = pos + rank - total[:, None] + 1
    rb_on = nzm & (rank + 1 < total[:, None]) & (zl > 0)
    rb = _tab(_RUN_BEFORE, dev)[(zl.clamp(1, 7) - 1).long(),
                                run.clamp(0, 14).long()]
    rb = (rb * rb_on[..., None])[:, :n - 1]      # positions n-1 .. 1

    def padded(t, width):
        return torch.nn.functional.pad(t, (0, width - t.shape[1]))

    V = torch.cat([tok[:, :1], sign_bits[:, None], padded(lev_v, 16),
                   tz[:, :1], padded(rb[..., 0], 15)], 1)
    L = torch.cat([tok[:, 1:], t1[:, None], padded(lev_l, 16),
                   tz[:, 1:], padded(rb[..., 1], 15)], 1)
    return V.to(_I32), L.to(_I32), overflow


# ---------------------------------------------------------------------------
# nC context grids (cavlc_device.py:460-488)
# ---------------------------------------------------------------------------

def _nc_from_grid(cnt):
    """nc_ctx over (S, h, w) total_coeff grids: (na + nb + 1) >> 1 with
    border handling."""
    S, h, w = cnt.shape
    dev = cnt.device
    na = torch.nn.functional.pad(cnt, (1, 0))[:, :, :-1]
    nb = torch.nn.functional.pad(cnt, (0, 0, 1, 0))[:, :-1]
    ex_a = (torch.arange(w, device=dev) > 0)[None, None, :]
    ex_b = (torch.arange(h, device=dev) > 0)[None, :, None]
    return torch.where(ex_a & ex_b, (na + nb + 1) >> 1,
                       torch.where(ex_a, na, torch.where(ex_b, nb, 0)))


def _coding_to_grid(vals, mb_h: int, mb_w: int):
    """(S, mb_h, mb_w, 16) per-4x4-block coding-order values ->
    (S, 4 mb_h, 4 mb_w) grid. Coding order: quadrant i >> 2, raster i & 3
    inside (scan8, common/common.h:140-186)."""
    S = vals.shape[0]
    t = vals.reshape(S, mb_h, mb_w, 2, 2, 2, 2)   # (.., qy, qx, by, bx)
    return t.permute(0, 1, 3, 5, 2, 4, 6).reshape(S, mb_h * 4, mb_w * 4)


def _grid_to_coding(grid, mb_h: int, mb_w: int):
    """Inverse of _coding_to_grid: (S, 4h, 4w) -> (S, h*w, 16)."""
    S = grid.shape[0]
    t = grid.reshape(S, mb_h, 2, 2, mb_w, 2, 2)   # (mb_h, qy, by, mb_w, qx, bx)
    return t.permute(0, 1, 4, 2, 5, 3, 6).reshape(S, mb_h * mb_w, 16)


def _chroma_elements(syn, on_mb, S: int, mb_h: int, mb_w: int):
    """The chroma DC and AC block groups (shared by P and I slices).
    on_mb (S, B) bool: the MB is coded (not skipped)."""
    B = mb_h * mb_w
    cch = syn["cbp_chroma"].reshape(S, B)
    cdc = syn["chroma_dc_levels"].to(_I32).reshape(S * B * 2, 4)
    dc_coded = (on_mb & (cch > 0)).repeat_interleave(2, 1).reshape(-1)
    Vd, Ld, ov_d = _block_elements(cdc, 4, None, True, dc_coded)

    cac = syn["chroma_ac_levels"].to(_I32).reshape(S, B, 2, 4, 16)[..., 1:]
    ac_coded_mb = on_mb & (cch == 2)
    ac_nnz = (cac != 0).sum(-1, dtype=_I32) * ac_coded_mb[:, :, None, None]
    # per-channel (2h, 2w) count grids, channels folded into the batch
    g = ac_nnz.permute(0, 2, 1, 3).reshape(S * 2, mb_h, mb_w, 2, 2) \
        .permute(0, 1, 3, 2, 4).reshape(S * 2, mb_h * 2, mb_w * 2)
    nc_ac = _nc_from_grid(g).reshape(S, 2, mb_h, 2, mb_w, 2) \
        .permute(0, 2, 4, 1, 3, 5).reshape(-1)     # (S, B, ch, 4)
    Va, La, ov_a = _block_elements(
        cac.reshape(S * B * 8, 15), 15, nc_ac, False,
        ac_coded_mb.repeat_interleave(8, 1).reshape(-1))
    return (Vd, Ld, 2), (Va, La, 8), \
        ov_d.reshape(S, -1).any(1) | ov_a.reshape(S, -1).any(1)


def _prev_index(mask):
    """(S, B) bool -> for each position the index of the last True
    strictly before it, -1 if none."""
    S, B = mask.shape
    idxs = torch.arange(B, device=mask.device)
    run = torch.cummax(torch.where(mask, idxs, -1), 1).values
    return torch.cat([run.new_full((S, 1), -1), run[:, :-1]], 1), run


def _slice_qp(slice_qp, S: int, dev):
    """slice_qp as an (S, 1) tensor (one shared int, or one per stream)."""
    q = torch.as_tensor(slice_qp, dtype=_I32, device=dev).reshape(-1, 1)
    return q.expand(S, 1)


# ---------------------------------------------------------------------------
# P-slice elements (cavlc_device.py:495-648)
# ---------------------------------------------------------------------------

def cavlc_p_elements(syn, qp_mb, slice_qp, n_ref: int, mb_h: int, mb_w: int):
    """All CAVLC syntax elements of S P-slice bodies in stream order:
    per-MB header slots hdr_V / hdr_L (S, B, 17), the residual groups
    [(V (S*B*nb, 34), L, nb) for luma, chroma DC, chroma AC], the tail
    slots (S, 2) (the end-of-frame skip run and the rbsp stop bit,
    x264tpu_write_slice_p:1245-1249), n_skip (S,) and the element
    overflow flag (S,). syn: partition, ref, cbp_luma, cbp_chroma
    (S, mb_h, mb_w), mv8 (S, mb_h, mb_w, 2, 2, 2) and the level tensors;
    qp_mb (S, mb_h, mb_w); slice_qp an int or (S,)."""
    S = syn["cbp_luma"].shape[0]
    B = mb_h * mb_w
    dev = syn["cbp_luma"].device
    part = syn["partition"].to(_I32)
    ref = syn["ref"].to(_I32) if "ref" in syn else torch.zeros_like(part)
    cl = syn["cbp_luma"].to(_I32)
    cch = syn["cbp_chroma"].to(_I32)
    mv8 = syn["mv8"].to(_I32)
    sqp = _slice_qp(slice_qp, S, dev)

    mvp, pskip = mvp_field(mv8, part, ref, mb_h, mb_w)
    mv16 = mv8[:, :, :, 0, 0]
    is_skip = ((part == 0) & (ref == 0) & (cl == 0) & (cch == 0)
               & (mv16 == pskip).all(-1))
    flat_skip = is_skip.reshape(S, B)
    n_skip = flat_skip.sum(1, dtype=_I32)
    ns = ~flat_skip
    idxs = torch.arange(B, device=dev)
    prev_ns, last_ns = _prev_index(ns)
    skip_run = (idxs - prev_ns - 1).to(_I32)

    # dqp chain: the last coded (cbp != 0, non-skip) MB's qp
    clf, cchf = cl.reshape(S, B), cch.reshape(S, B)
    has_cbp = (clf | cchf) != 0
    prev_coded, _ = _prev_index(ns & has_cbp)
    qp_flat = qp_mb.to(_I32).reshape(S, B)
    last_qp = torch.where(prev_coded >= 0,
                          qp_flat.gather(1, prev_coded.clamp(min=0)), sqp)

    partf = part.reshape(S, B)
    reff = ref.reshape(S, B)
    part_n = _tab(_PART_N, dev)[partf.long()]

    hdr = []

    def put(val_len, on):
        hdr.append((val_len[0] * on, val_len[1] * on))

    put(_ue(skip_run), ns)
    sub_ref0 = (partf == 3) & (n_ref > 1) & (reff == 0)
    put(_ue(torch.where(sub_ref0, 4, partf)), ns)
    # sub_mb_types: 4x ue(0) = 4 one-bits
    on = ns & (partf == 3)
    hdr.append((on * 15, on * 4))
    for pi in range(4):                          # ref te() per partition
        on = ns & (n_ref > 1) & ~sub_ref0 & (pi < part_n)
        put((1 ^ reff, torch.ones_like(reff)) if n_ref == 2 else _ue(reff),
            on)
    # mvd per partition; partition slot -> the quadrant holding its mv:
    # 16x16 q(0,0); 16x8 q(0,0), q(1,0); 8x16 q(0,0), q(0,1); 8x8 all four
    mv8f = mv8.reshape(S, B, 2, 2, 2)
    pm = torch.stack([
        mv8f[:, :, 0, 0],
        torch.where((partf == 1)[..., None], mv8f[:, :, 1, 0],
                    mv8f[:, :, 0, 1]),
        mv8f[:, :, 1, 0], mv8f[:, :, 1, 1]], 2)            # (S, B, 4, 2)
    mvd = pm - mvp.reshape(S, B, 4, 2)
    for pi in range(4):
        on = ns & (pi < part_n)
        for comp in range(2):
            put(_se(mvd[:, :, pi, comp]), on)
    put(_ue(_tab(_CBP_INTER, dev)[((cchf << 4) | clf).long()].to(_I32)), ns)
    put(_se(qp_flat - last_qp), ns & has_cbp)
    hdr_V = torch.stack([v for v, _ in hdr], 2).to(_I32)    # (S, B, 17)
    hdr_L = torch.stack([ln for _, ln in hdr], 2).to(_I32)

    # luma blocks; nC from the total_coeff grid of the coded blocks
    lvl = syn["luma_levels"].to(_I32).reshape(S, B, 16, 16)
    blk = torch.arange(16, device=dev) >> 2
    blk_coded = ns[..., None] & (((clf[..., None] >> blk) & 1) == 1)
    nnz_blk = (lvl != 0).sum(-1, dtype=_I32) * blk_coded
    nc_luma = _grid_to_coding(
        _nc_from_grid(_coding_to_grid(nnz_blk, mb_h, mb_w)), mb_h, mb_w)
    Vl, Ll, ov_l = _block_elements(lvl.reshape(-1, 16), 16,
                                   nc_luma.reshape(-1), False,
                                   blk_coded.reshape(-1))
    g_dc, g_ac, ov_c = _chroma_elements(syn, ns, S, mb_h, mb_w)

    trail = (B - 1 - last_ns[:, -1]).to(_I32)
    tv, tl = _ue(trail)
    on = (trail > 0).to(_I32)
    one = torch.ones_like(trail)
    tail_V = torch.stack([tv * on, one], 1)
    tail_L = torch.stack([tl * on, one], 1)
    return (hdr_V, hdr_L, [(Vl, Ll, 16), g_dc, g_ac], tail_V, tail_L,
            n_skip, ov_l.reshape(S, -1).any(1) | ov_c)


# ---------------------------------------------------------------------------
# I-slice elements (cavlc_device.py:872-1007)
# ---------------------------------------------------------------------------

def cavlc_i_elements(syn, qp_mb, slice_qp, mb_h: int, mb_w: int):
    """CAVLC syntax elements of S I-slice bodies (write_mb_i twin): header
    slots (S, B, 20), groups [luma DC, luma x16, chroma DC x2, chroma AC
    x8], the tail (S, 1) (rbsp stop bit) and the element overflow flag
    (S,)."""
    S = syn["cbp_luma"].shape[0]
    B = mb_h * mb_w
    dev = syn["cbp_luma"].device
    is_i4 = syn["mb_type"] == 1                          # 1 = I_4x4
    i4f = is_i4.reshape(S, B)
    clf = syn["cbp_luma"].to(_I32).reshape(S, B)
    cchf = syn["cbp_chroma"].to(_I32).reshape(S, B)
    nzf = syn["nz_luma_dc"].to(_I32).reshape(S, B)
    qpf = qp_mb.to(_I32).reshape(S, B)
    sqp = _slice_qp(slice_qp, S, dev)

    # dqp chain: i4 updates last_qp iff cbp != 0; i16 iff cbp | nz_dc
    updates = torch.where(i4f, (clf | cchf) != 0,
                          (clf != 0) | (cchf != 0) | (nzf != 0))
    prev_u, _ = _prev_index(updates)
    last_qp = torch.where(prev_u >= 0, qpf.gather(1, prev_u.clamp(min=0)),
                          sqp)

    hdr = []
    # mb_type: I_4x4 -> ue(0); I_16x16 -> the composite ue
    fix16 = _tab(_FIX16, dev)[syn["i16_mode"].reshape(S, B).clamp(0, 6)
                              .long()].to(_I32)
    t16 = 1 + fix16 + cchf * 4 + torch.where(clf != 0, 12, 0)
    hdr.append(_ue(torch.where(i4f, 0, t16)))
    # prev_intra4x4_pred_mode: the most-probable-mode grid
    fixed4 = _tab(_FIX4, dev)[(syn["i4_modes"].to(_I32) + 1).clamp(0, 12)
                              .long()].to(_I32)          # (S, h, w, 16)
    mode_grid = _coding_to_grid(fixed4, mb_h, mb_w)
    eff = torch.where(is_i4.repeat_interleave(4, 1).repeat_interleave(4, 2),
                      mode_grid, 2)
    left = torch.nn.functional.pad(eff, (1, 0), value=-1)[:, :, :-1]
    top = torch.nn.functional.pad(eff, (0, 0, 1, 0), value=-1)[:, :-1]
    pred_g = torch.minimum(left, top)
    pred = _grid_to_coding(torch.where(pred_g < 0, 2, pred_g), mb_h, mb_w)
    mode = fixed4.reshape(S, B, 16)
    same = pred == mode
    i4m = i4f[..., None].to(_I32)
    v4 = torch.where(same, 1, mode - (mode > pred).to(_I32)) * i4m
    l4 = torch.where(same, 1, 4) * i4m
    hdr.extend((v4[..., i], l4[..., i]) for i in range(16))
    hdr.append(_ue(_tab(_FIXC, dev)[syn["chroma_mode"].reshape(S, B)
                                    .clamp(0, 6).long()].to(_I32)))
    # cbp (I_4x4 only; I_16x16 carries it in mb_type)
    v, ln = _ue(_tab(_CBP_INTRA, dev)[((cchf << 4) | clf).long()].to(_I32))
    hdr.append((v * i4f, ln * i4f))
    # dqp: i16 always; i4 iff cbp (an empty I16 codes dqp 0)
    v, ln = _se(torch.where(updates, qpf - last_qp, 0))
    on = (i4f & updates) | ~i4f
    hdr.append((v * on, ln * on))
    hdr_V = torch.stack([v for v, _ in hdr], 2).to(_I32)    # (S, B, 20)
    hdr_L = torch.stack([ln for _, ln in hdr], 2).to(_I32)

    # luma nC grid: i4 -> nnz of the 16-coefficient blocks; i16 -> nnz of
    # the 15 AC coefficients when cbp is set; else 0
    lvl = syn["luma_levels"].to(_I32).reshape(S, B, 16, 16)
    blk = torch.arange(16, device=dev) >> 2
    coded_i4 = i4f[..., None] & (((clf[..., None] >> blk) & 1) == 1)
    coded_i16 = (~i4f & (clf != 0))[..., None].expand(S, B, 16)
    cnt_blk = torch.where(
        coded_i4, (lvl != 0).sum(-1, dtype=_I32),
        torch.where(coded_i16, (lvl[..., 1:] != 0).sum(-1, dtype=_I32), 0))
    nc_grid = _nc_from_grid(_coding_to_grid(cnt_blk, mb_h, mb_w))
    nc_luma = _grid_to_coding(nc_grid, mb_h, mb_w).reshape(-1)

    # luma DC block (I_16x16 only): nC at the MB origin
    Vdc, Ldc, ov0 = _block_elements(
        syn["luma_dc_levels"].to(_I32).reshape(S * B, 16), 16,
        nc_grid[:, ::4, ::4].reshape(-1), False, (~i4f).reshape(-1))
    # luma blocks: 16 coefficients in I_4x4 MBs, the 15 AC ones in I_16x16
    # MBs; a block is coded as one of the two, the other's slots are empty
    V16, L16, ov1 = _block_elements(lvl.reshape(-1, 16), 16, nc_luma,
                                    False, coded_i4.reshape(-1))
    V15, L15, ov2 = _block_elements(lvl[..., 1:].reshape(-1, 15), 15,
                                    nc_luma, False, coded_i16.reshape(-1))
    Vl, Ll = V16 + V15, L16 + L15
    g_dc, g_ac, ov_c = _chroma_elements(syn, torch.ones_like(i4f), S, mb_h,
                                        mb_w)
    tail = torch.ones((S, 1), dtype=_I32, device=dev)       # rbsp stop bit
    ov = ov_c
    for o in (ov0, ov1, ov2):
        ov = ov | o.reshape(S, -1).any(1)
    return (hdr_V, hdr_L, [(Vdc, Ldc, 1), (Vl, Ll, 16), g_dc, g_ac], tail,
            tail, ov)


# ---------------------------------------------------------------------------
# the packer
# ---------------------------------------------------------------------------

def _words_to_bytes(words):
    """(S, n) words (values below 2**32) -> (S, 4n) uint8, MSB first."""
    b = torch.stack([(words >> 24) & 0xFF, (words >> 16) & 0xFF,
                     (words >> 8) & 0xFF, words & 0xFF], -1)
    return b.to(torch.uint8).reshape(words.shape[0], -1)


def _pack(hdr_V, hdr_L, groups, tail_V, tail_L, hv, hl, cap_bytes: int,
          mb_h: int, mb_w: int):
    """Pack S slices: the slice-header slots hv / hl ((n,) shared or
    (S, n)), then the MBs in raster order with their groups in stream
    order (MB header, then each residual group's blocks), then the tail
    slots. Returns (payload (S, cap_bytes) uint8, bits (S,) int64, rows
    (S, mb_h) int64: the bit position at the end of each MB row, slice
    header included and tail excluded, dropped (S,) bool).

    dropped mirrors the JAX packer's buffer limits: a group (the MB
    header or one block) longer than W_GRP words (cavlc_device.py:702,
    :800-805), an MB longer than W_MB words (_tree_3d, :759) or a slice
    longer than cap_bytes (_tree_rows, :780). In the pairwise trees a
    partial sum can only pass a limit if the MB's or the slice's total
    does, so comparing the totals raises the flag in the same cases."""
    S, B = hdr_V.shape[:2]
    dev = hdr_V.device
    cap_words = cap_bytes // 4
    mb_V = torch.cat([hdr_V] + [V.reshape(S, B, -1) for V, _, _ in groups], 2)
    mb_L = torch.cat([hdr_L] + [L.reshape(S, B, -1) for _, L, _ in groups], 2)
    dropped = (hdr_L.sum(2) > 32 * W_GRP).any(1)
    for _, L, _ in groups:
        dropped |= (L.sum(1) > 32 * W_GRP).reshape(S, -1).any(1)
    ln_mb = mb_L.sum(2, dtype=_I64)                          # (S, B)
    dropped |= (ln_mb > 32 * W_MB).any(1)

    hv = torch.as_tensor(hv, device=dev).to(_I32).reshape(-1, hv.shape[-1])
    hl = torch.as_tensor(hl, device=dev).to(_I32).reshape(-1, hl.shape[-1])
    hv, hl = hv.expand(S, -1), hl.expand(S, -1)
    # bit position of every slot: a prefix sum over the MBs' lengths, and
    # one over the slots inside each MB (short int32 rows)
    hbits = hl.sum(1, dtype=_I64)
    mb_end = hbits[:, None] + torch.cumsum(ln_mb, 1)           # (S, B)
    bits = mb_end[:, -1] + tail_L.sum(1, dtype=_I64)
    dropped |= bits > 32 * cap_words
    rows = mb_end.reshape(S, mb_h, mb_w)[:, :, -1]
    buf = torch.zeros(S * (cap_words + 2), dtype=_I64, device=dev)
    base = torch.arange(S, device=dev)[:, None] * (cap_words + 2)

    def scatter(V, L, first):
        """Add the slots V / L (S, ..., n), whose first slot starts at bit
        `first` (S, ...), into the word buffer: each value left-aligned
        in the 64-bit window that starts at the 32-bit word holding its
        first bit. Words past the cap land in two spare words per stream
        that are cut off."""
        start = (first[..., None]
                 + (torch.cumsum(L, -1, dtype=_I32) - L)).reshape(S, -1)
        L64 = L.reshape(S, -1).to(_I64)
        shift = (64 - L64 - (start & 31)).clamp(max=63)
        win = torch.where(L64 > 0, V.reshape(S, -1).to(_I64) << shift, 0)
        word = ((start >> 5).clamp(max=cap_words) + base).reshape(-1)
        buf.index_add_(0, word, ((win >> 32) & 0xFFFFFFFF).reshape(-1))
        buf.index_add_(0, word + 1, (win & 0xFFFFFFFF).reshape(-1))

    scatter(hv, hl, torch.zeros_like(hbits))
    scatter(mb_V, mb_L, mb_end - ln_mb)
    scatter(tail_V, tail_L, mb_end[:, -1])
    payload = _words_to_bytes(buf.reshape(S, cap_words + 2)[:, :cap_words])
    return payload, bits, rows, dropped


def cavlc_p_payload(syn, qp_mb, slice_qp, n_ref: int, mb_h: int, mb_w: int,
                    header_vals, header_lens, cap_bytes: int,
                    with_rows: bool = False):
    """Device CAVLC payloads of S P slices: slice header + MB stream +
    trailing bits, packed. Returns (payload (S, cap_bytes) uint8, bits
    (S,), n_skip (S,), overflow (S,) bool), plus, with_rows, the bit
    position at the end of each MB row (S, mb_h) (the native writers'
    row_bits_out, entropy.cpp:1244-1245). The bytes past a slice's bits
    are zero. overflow is the or of the element overflows (an escape
    level code past 12 bits, cavlc.c:56-60) and the packer limits of
    _pack (cavlc_device.py:852 `ov | d1 | d2`); an overflowed payload is
    not a valid slice."""
    hdr_V, hdr_L, groups, tail_V, tail_L, n_skip, ov = cavlc_p_elements(
        syn, qp_mb, slice_qp, n_ref, mb_h, mb_w)
    payload, bits, rows, dropped = _pack(
        hdr_V, hdr_L, groups, tail_V, tail_L, header_vals, header_lens,
        cap_bytes, mb_h, mb_w)
    out = (payload, bits, n_skip, ov | dropped)
    return out + (rows,) if with_rows else out


def cavlc_i_payload(syn, qp_mb, slice_qp, mb_h: int, mb_w: int, header_vals,
                    header_lens, cap_bytes: int, with_rows: bool = False):
    """Device CAVLC payloads of S I slices. Returns (payload, bits,
    overflow), plus rows with_rows (see cavlc_p_payload)."""
    hdr_V, hdr_L, groups, tail_V, tail_L, ov = cavlc_i_elements(
        syn, qp_mb, slice_qp, mb_h, mb_w)
    payload, bits, rows, dropped = _pack(
        hdr_V, hdr_L, groups, tail_V, tail_L, header_vals, header_lens,
        cap_bytes, mb_h, mb_w)
    out = (payload, bits, ov | dropped)
    return out + (rows,) if with_rows else out


def _merge_streams(payload, bits, cap_bytes: int):
    """Byte-aligned per-stream payloads (S, cap_s) -> one buffer
    (cap_bytes,) with the streams back to back, the byte offsets (S + 1,)
    and a per-stream flag: the stream passed its share cap_s
    (cavlc_device.py:1032-1046 _payload_batched)."""
    S, cap_s = payload.shape
    nbytes = (bits + 7) >> 3
    off = torch.cat([nbytes.new_zeros(1), torch.cumsum(nbytes, 0)])
    i = torch.arange(cap_bytes, device=payload.device)
    s = (torch.searchsorted(off, i, right=True) - 1).clamp(max=S - 1)
    j = i - off[s]
    out = torch.where(j < cap_s, payload[s, j.clamp(max=cap_s - 1)], 0)
    return out, off, nbytes > cap_s


def cavlc_p_payload_batched(syn, qp_mb, slice_qp, n_ref: int, mb_h: int,
                            mb_w: int, header_vals, header_lens,
                            cap_bytes: int):
    """All S P-slice payloads in one byte buffer, byte-aligned and back
    to back (cavlc_device.py:1071). Returns (payload (cap_bytes,) uint8,
    byte_off (S + 1,), n_skip (S,), overflow (S,))."""
    S = syn["cbp_luma"].shape[0]
    payload, bits, n_skip, ov = cavlc_p_payload(
        syn, qp_mb, slice_qp, n_ref, mb_h, mb_w, header_vals, header_lens,
        (cap_bytes // S // 4) * 4)
    out, off, drop = _merge_streams(payload, bits, cap_bytes)
    return out, off, n_skip, ov | drop


def cavlc_i_payload_batched(syn, qp_mb, slice_qp, mb_h: int, mb_w: int,
                            header_vals, header_lens, cap_bytes: int):
    """The I-slice twin of cavlc_p_payload_batched
    (cavlc_device.py:1049). Returns (payload, byte_off, overflow)."""
    S = syn["cbp_luma"].shape[0]
    payload, bits, ov = cavlc_i_payload(
        syn, qp_mb, slice_qp, mb_h, mb_w, header_vals, header_lens,
        (cap_bytes // S // 4) * 4)
    out, off, drop = _merge_streams(payload, bits, cap_bytes)
    return out, off, ov | drop


def header_elements(header: bytes, nbits_partial: int, max_slots: int = 16):
    """Host helper (cavlc_device.py:1100): BitWriter.get_unaligned()
    output as fixed-size (vals, lens) int32 arrays for the packer.
    get_unaligned always appends a trailing partial byte; when the header
    ended byte-aligned (nbits_partial == 0) that byte carries 0 bits."""
    hv = np.zeros(max_slots, np.int32)
    hl = np.zeros(max_slots, np.int32)
    nfull = len(header) - 1
    if len(header) > max_slots:
        raise ValueError(f"slice header of {len(header)} bytes exceeds "
                         f"{max_slots} slots")
    hv[:nfull] = np.frombuffer(header[:nfull], np.uint8)
    hl[:nfull] = 8
    if nbits_partial:
        hv[nfull] = header[nfull] >> (8 - nbits_partial)
        hl[nfull] = nbits_partial
    return hv, hl
