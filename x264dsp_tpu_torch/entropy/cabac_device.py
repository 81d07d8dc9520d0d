"""Device CABAC front half — port of x264dsp_tpu/entropy/cabac_device.py.

The bin-serial arithmetic coder stays on the host (the C++ writer,
csrc/host/entropy.cpp ``x264tpu_write_slice_cabac``), but the residual
bins it codes can be computed on the device: for every 4x4 / 2x2
residual block of a frame this module emits the exact (context, bin)
decision and bypass sequence that x264_cabac_block_residual
(encoder/cabac.c:489-556) produces: the significance map, the last
flags, the level prefix chains with the node_ctx automaton, the UEG0
escapes and the sign bypasses. Given that stream (``res_ops`` /
``res_off`` of ``native.write_slice_cabac``) the writer replaces its
per-block binarization with a consume loop over the ops, with the same
bytes. No encoder path calls it, as in the JAX package.

Op encoding (int16):
    0..551    -> decision(ctx = op >> 1, bin = op & 1)   [ctx < 276]
    1024/1025 -> bypass(bit = op & 1)

Block slots per MB (the C++ writer's emission order; the writer walks
the MBs in raster order and consumes the slots of the blocks it codes):
    0        luma DC      (cat0, 16 coeffs; i16 MBs only)
    1..16    luma 4x4 i   (cat1 15 coeffs if i16 else cat2 16 coeffs)
    17..18   chroma DC ch (cat3, 4 coeffs)
    19..26   chroma AC    (cat4, 15 coeffs, ch*4 + i)

The JAX module maps one block's function over the blocks (jax.vmap);
here every step runs on a chunk of CHUNK blocks of the (MB * 27, 16) at
once, and each block's ops are laid out over PAD positions, each
position finding its coefficient with a batched searchsorted, as the JAX
code does per block.
"""

from __future__ import annotations

import torch

from ..ops.devtab import device_table

# residual tables (encoder/cabac.c:458-487), as in cabac_device.py:37-51
_SIG_OFF = (105, 120, 134, 149, 152)
_LAST_OFF = (166, 181, 195, 210, 213)
_LEVEL_OFF = (227, 237, 247, 257, 266)
_COUNT_M1 = (15, 14, 15, 3, 14)
_LEVEL1_CTX = (1, 2, 3, 4, 0, 0, 0, 0)
_LEVELGT1_CTX = (5, 5, 5, 5, 6, 7, 8, 9)
_LEVEL_TRANS = ((1, 2, 3, 3, 4, 5, 6, 7),
                (4, 4, 4, 4, 5, 6, 7, 7))

_BYPASS = 1024
SLOTS = 27          # residual block slots per MB (module docstring)
PAD = 320           # per-block op capacity; > 31 + 16*15 = 271 (the
                    # worst escape-free block); longer escape chains raise
                    # the overflow flag
CHUNK = 1 << 14     # blocks per block_ops call: the (CHUNK, PAD)
                    # temporaries stay near 20-40 MB each (a 1080p frame's
                    # 220320 blocks at once would take 0.3-0.6 GB each)
_I32 = torch.int32


def _ilog2(x):
    """floor(log2(x)) for int32 x >= 1, exact (cabac_device.py:55-61:
    counted up to 2**15, the dctcoef escape range)."""
    m = torch.zeros_like(x)
    for k in range(1, 16):
        m += (x >= (1 << k)).to(_I32)
    return m


def block_ops(levels, cat):
    """Op streams of B residual blocks (cabac_device.py:62-174 under
    vmap). levels: (B, 16) int32 zigzag (positions >= the category's
    coefficient count zeroed by the caller); cat: (B,) int. Returns (ops
    (B, PAD) int16, count (B,) int32). An empty block has count 0 (the
    writer consumes only the blocks it codes, cbf = 1); a count of PAD or
    more is exact, its ops a PAD-long prefix."""
    dev = levels.device
    B = levels.shape[0]
    levels = levels.to(_I32)
    cat = cat.long()
    idx = torch.arange(16, dtype=_I32, device=dev)
    nz = levels != 0
    any_nz = nz.any(1)
    last = torch.where(nz, idx, -1).amax(1)
    count_m1 = device_table(_COUNT_M1, dev)[cat]
    sig_off = device_table(_SIG_OFF, dev)[cat][:, None]
    last_off = device_table(_LAST_OFF, dev)[cat][:, None]
    level_off = device_table(_LEVEL_OFF, dev)[cat][:, None]

    # phase A: significance + last flags (cabac.c:519-538). Coefficient i
    # is visited for i <= min(last, count_m1 - 1): a sig decision, and a
    # last decision where it is nonzero; when last == count_m1 the loop
    # never reaches it and it is coded without sig / last bins
    last_eff = torch.minimum(last, count_m1 - 1)
    present = idx <= last_eff[:, None]
    a_cnt = present.to(_I32) + (present & nz).to(_I32)
    a_end = torch.cumsum(a_cnt, 1, dtype=_I32)
    a_pref = a_end - a_cnt                              # ops before slot i
    count_a = a_end[:, -1]

    # phase B: the levels in reversed scan order (cabac.c:540-556): the
    # reversed block stable-sorted by "is zero", nonzeros first in order
    rev = levels.flip(1)
    order = torch.argsort((rev == 0).to(torch.uint8), dim=1, stable=True)
    coeffs = torch.gather(rev, 1, order)
    k_valid = idx < nz.sum(1, dtype=_I32)[:, None]
    absv = coeffs.abs()
    gt1 = (absv > 1) & k_valid
    # bins per coefficient: abs 1 -> 2 (gt1 bin + sign); 2 <= abs < 15 ->
    # abs + 1; abs >= 15 -> 16 + 2 * floor(log2(abs - 14))
    esc = absv >= 15
    m = torch.where(esc, _ilog2((absv - 15).clamp(min=0) + 1), 0)
    b_cnt = torch.where(absv <= 1, 2, torch.where(esc, 16 + 2 * m, absv + 1)
                        ).to(_I32) * k_valid
    b_end = torch.cumsum(b_cnt, 1, dtype=_I32)
    b_pref = b_end - b_cnt
    count_b = b_end[:, -1]

    # the node_ctx automaton over the reversed coefficients
    trans = device_table(_LEVEL_TRANS, dev)
    nodes = [torch.zeros(B, dtype=_I32, device=dev)]
    for k in range(15):
        nodes.append(trans[gt1[:, k].long(), nodes[-1].long()])
    node_k = torch.stack(nodes, 1)

    count = torch.where(any_nz, count_a + count_b, 0)

    # the ops, by position over the PAD slots of each block
    pos = torch.arange(PAD, dtype=_I32, device=dev).expand(B, PAD)

    # phase A: which coefficient i does position p fall in?
    ia = torch.searchsorted(a_end, pos.contiguous(), right=True,
                            out_int32=True).clamp(max=15).long()
    sub_a = pos - torch.gather(a_pref, 1, ia)          # 0 = sig, 1 = last
    op_a = torch.where(
        sub_a == 0,
        (sig_off + ia) * 2 + torch.gather(nz, 1, ia).to(_I32),
        (last_off + ia) * 2 + (ia == last[:, None]).to(_I32))

    # phase B: which reversed coefficient k, which op j of it?
    pb = (pos - count_a[:, None]).contiguous()
    kb = torch.searchsorted(b_end, pb, right=True,
                            out_int32=True).clamp(max=15).long()
    j = pb - torch.gather(b_pref, 1, kb)
    a_k = torch.gather(absv, 1, kb)
    sgn_k = (torch.gather(coeffs, 1, kb) < 0).to(_I32)
    node = torch.gather(node_k, 1, kb).long()
    esc_k = a_k >= 15
    v_k = (a_k - 15).clamp(min=0)
    m_k = torch.where(esc_k, _ilog2(v_k + 1), 0)
    reps = (a_k.clamp(max=15) - 2).clamp(min=0)
    ctx1 = level_off + device_table(_LEVEL1_CTX, dev)[node]
    ctxg = level_off + device_table(_LEVELGT1_CTX, dev)[node]
    gt1_bin = (a_k > 1).to(_I32)
    nb_k = torch.gather(b_cnt, 1, kb)
    # j == 0: the gt1 decision; j == nb - 1: the sign bypass. Between:
    # 1 < abs < 15: j <= reps -> GT1 ctx bin 1, then one GT1 bin 0;
    # abs >= 15: j <= 13 -> GT1 bin 1; j in [14, 13 + m] -> bypass 1;
    #   j == 14 + m -> bypass 0; then the suffix v + 1 - 2^m over m bits,
    #   MSB first
    suffix = v_k + 1 - (1 << m_k)
    bit_ix = m_k - 1 - (j - (15 + m_k))
    suffix_bit = (suffix >> bit_ix.clamp(0, 30)) & 1
    op_b = torch.where(
        j == 0, ctx1 * 2 + gt1_bin,
        torch.where(
            j == nb_k - 1, _BYPASS + sgn_k,
            torch.where(
                ~esc_k,
                torch.where(j <= reps, ctxg * 2 + 1, ctxg * 2),
                torch.where(
                    j <= 13, ctxg * 2 + 1,
                    torch.where(j <= 13 + m_k, _BYPASS + 1,
                                torch.where(j == 14 + m_k, _BYPASS,
                                            _BYPASS + suffix_bit))))))

    ops = torch.where(pos < count[:, None],
                      torch.where(pos < count_a[:, None], op_a, op_b), 0)
    return ops.to(torch.int16), count


def _pad16(x, n: int):
    """x (..., 16) with the positions from n on zeroed."""
    return torch.where(torch.arange(16, device=x.device) < n, x, 0)


def residual_ops_frame(luma_levels, luma_dc_levels, chroma_dc_levels,
                       chroma_ac_levels, is_i16, mb_h: int, mb_w: int,
                       cap_ops: int):
    """Per-frame residual op streams for the CABAC writer's consume loop
    (cabac_device.py:176-233), on the inputs' device.

    luma_levels (MB, 16, 16), luma_dc_levels (MB, 16), chroma_dc_levels
    (MB, 2, 4), chroma_ac_levels (MB, 2, 4, 16) int zigzag (any leading
    shape of MB = mb_h * mb_w entries); is_i16 (MB,) bool (cat1 15-coeff
    AC against cat2 16 coefficients in the luma slots).

    Returns (ops_flat (cap_ops,) int16, block_off (MB * SLOTS + 1,)
    int32, overflow () bool). Block b's ops are ops_flat[block_off[b]:
    block_off[b + 1]], zeros past the total. overflow is set when a block
    has PAD ops or more (a long escape chain) or the frame more than
    cap_ops: the caller then passes no ops, and the writer binarizes the
    slice itself, with the same bytes."""
    nmb = mb_h * mb_w
    dev = luma_levels.device
    i16 = is_i16.reshape(nmb).to(torch.bool)

    # luma slots: i16 MBs code AC coefficients 1..15 as cat1, others 0..15
    # as cat2
    ll = luma_levels.reshape(nmb, 16, 16).to(_I32)
    lev_luma = torch.where(i16[:, None, None],
                           _pad16(torch.roll(ll, -1, dims=-1), 15), ll)
    cat_luma = torch.where(i16, 1, 2)[:, None].expand(nmb, 16)
    lev_dc = luma_dc_levels.reshape(nmb, 1, 16).to(_I32)
    cdc = chroma_dc_levels.reshape(nmb, 2, 4).to(_I32)
    lev_cdc = torch.nn.functional.pad(cdc, (0, 12))
    cac = chroma_ac_levels.reshape(nmb, 8, 16).to(_I32)
    lev_cac = _pad16(torch.roll(cac, -1, dims=-1), 15)
    levels = torch.cat([lev_dc, lev_luma, lev_cdc, lev_cac], 1)
    cats = torch.cat([torch.zeros((nmb, 1), dtype=torch.long, device=dev),
                      cat_luma,
                      torch.full((nmb, 2), 3, device=dev),
                      torch.full((nmb, 8), 4, device=dev)], 1)
    B = nmb * SLOTS
    levels, cats = levels.reshape(B, 16), cats.reshape(B)
    parts = [block_ops(levels[i:i + CHUNK], cats[i:i + CHUNK])
             for i in range(0, B, CHUNK)]
    ops_pad = torch.cat([ops for ops, _ in parts])
    counts = torch.cat([count for _, count in parts])

    off = torch.nn.functional.pad(torch.cumsum(counts, 0, dtype=_I32), (1, 0))
    total = off[-1]
    overflow = (counts >= PAD).any() | (total > cap_ops)

    # the compaction (cabac_device.py:224-232): ops_flat[p] is op
    # p - off[b] of the block b that position p falls in (a block past PAD
    # repeats its last op; the overflow flag voids it)
    p = torch.arange(cap_ops, dtype=_I32, device=dev)
    blk = torch.searchsorted(off[1:], p, right=True,
                             out_int32=True).clamp(max=B - 1)
    l = (p - off[blk]).clamp(0, PAD - 1)
    flat = ops_pad.reshape(-1)[blk.long() * PAD + l]
    ops_flat = torch.where(p < total, flat, 0).to(torch.int16)
    return ops_flat, off, overflow
