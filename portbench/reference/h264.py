"""Plain H.264 decoder for the streams the benchmark judges.

Decodes what the encoder under test wrote, by ITU-T Rec. H.264 alone:
Annex-B NAL units, the sequence and picture parameter sets, I and P
slices coded with CAVLC (one slice per picture, one reference, 4:2:0,
8-bit, progressive), every macroblock type of an I slice but I_PCM, and
P_Skip, P_L0_16x16, 16x8, 8x16 and P_8x8 with 8x8 sub-macroblocks (and
intra macroblocks) in a P slice. Reconstruction and the deblocking
filter are plain PyTorch on any device; the parse is Python. It shares
no code and no table with the encoder: the tables are the standard's
(reference/tables.py).

What it cannot decode (I_PCM, sub-8x8 partitions, more than one slice or
reference, CABAC, scaling matrices) raises ``Unsupported``; a stream
that breaks the syntax raises ``BitstreamError``.
"""

from __future__ import annotations

from functools import cache

import numpy as np
import torch

from . import tables as T


class BitstreamError(ValueError):
    """The bytes do not follow the H.264 syntax."""


class Unsupported(BitstreamError):
    """Valid syntax that this decoder does not implement."""


# ----------------------------------------------------------------------
# NAL units
# ----------------------------------------------------------------------
def split_nals(stream: bytes) -> list[bytes]:
    """Annex-B byte stream -> NAL units (start codes removed)."""
    out, i, n = [], 0, len(stream)
    starts = []
    while True:
        j = stream.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        starts.append(j + 3)
        i = j + 3
    for k, s in enumerate(starts):
        e = starts[k + 1] - 3 if k + 1 < len(starts) else n
        nal = stream[s:e]
        while nal.endswith(b"\x00"):     # the next start code's zero byte
            nal = nal[:-1]
        out.append(nal)
    return out


def unescape(nal: bytes) -> bytes:
    """NAL payload -> RBSP (emulation_prevention_three_byte removed)."""
    return nal.replace(b"\x00\x00\x03", b"\x00\x00")


# ----------------------------------------------------------------------
# Bits
# ----------------------------------------------------------------------
_M64 = (1 << 64) - 1


class Bits:
    """MSB-first reader over an RBSP."""

    __slots__ = ("buf", "pos", "nbits")

    def __init__(self, data: bytes):
        self.buf = bytes(data) + bytes(16)
        self.pos = 0
        self.nbits = 8 * len(data)

    def _word(self) -> int:
        p = self.pos
        return (int.from_bytes(self.buf[p >> 3:(p >> 3) + 8], "big")
                << (p & 7)) & _M64

    def peek(self, n: int) -> int:
        return self._word() >> (64 - n)

    def u(self, n: int) -> int:
        if n == 0:
            return 0
        v = self._word() >> (64 - n)
        self.pos += n
        return v

    def zeros(self) -> int:
        """Count and skip leading zero bits and the one that ends them."""
        lz = 64 - self._word().bit_length()
        if lz > 31:
            raise BitstreamError("more than 31 leading zero bits")
        self.pos += lz + 1
        return lz

    def ue(self) -> int:
        lz = self.zeros()
        return (1 << lz) - 1 + self.u(lz)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) >> 1 if k & 1 else -(k >> 1)

    def check(self):
        if self.pos > self.nbits:
            raise BitstreamError("read past the end of the slice")


# ----------------------------------------------------------------------
# VLC lookup tables: peek `width` bits -> (value, length)
# ----------------------------------------------------------------------
def _lut(entries, width: int) -> list:
    lut = [None] * (1 << width)
    for (code, size), value in entries:
        if not size:
            continue
        lo = code << (width - size)
        lut[lo:lo + (1 << (width - size))] = [(value, size)] * (
            1 << (width - size))
    return lut


@cache
def _coeff_token_luts():
    luts = []
    for table in range(4):
        ent = [(T.COEFF0_TOKEN[table], (0, 0))]
        for t in range(16):
            for tr in range(4):
                ent.append((T.COEFF_TOKEN[table][t][tr], (t + 1, tr)))
        luts.append(_lut(ent, 16))
    ent = [(T.COEFF0_TOKEN[4], (0, 0))]
    for t in range(4):
        for tr in range(4):
            ent.append((T.COEFF_TOKEN[4][t][tr], (t + 1, tr)))
    luts.append(_lut(ent, 16))
    return luts


@cache
def _total_zeros_luts():
    luma = [_lut([(c, z) for z, c in enumerate(row)], 16)
            for row in T.TOTAL_ZEROS]
    dc = [_lut([(c, z) for z, c in enumerate(row)], 16)
          for row in T.TOTAL_ZEROS_2x2_DC]
    return luma, dc


@cache
def _run_before_luts():
    return [_lut([(c, r) for r, c in enumerate(row)], 16)
            for row in T.RUN_BEFORE]


def _vlc(br: Bits, lut) -> object:
    e = lut[br.peek(16)]
    if e is None:
        raise BitstreamError("invalid VLC code")
    br.pos += e[1]
    return e[0]


def residual_block(br: Bits, nc: int, max_coeff: int, out: np.ndarray,
                   start: int) -> int:
    """residual_block_cavlc (7.3.5.3.2, 9.2): writes the levels into
    out[start:] in scan order and returns total_coeff. nc -1 is the
    chroma DC table."""
    ct = _coeff_token_luts()
    if nc == -1:
        total, trailing = _vlc(br, ct[4])
    elif nc >= 8:
        v = br.u(6)
        if v == 3:
            total, trailing = 0, 0
        else:
            total, trailing = (v >> 2) + 1, v & 3
            if total > max_coeff:
                raise BitstreamError("total_coeff beyond the block")
    else:
        total, trailing = _vlc(br, ct[T.NC_TABLE[nc]])
    if total == 0:
        return 0
    if total > max_coeff or trailing > total:
        raise BitstreamError("total_coeff beyond the block")
    levels = [0] * total
    suffix_len = 1 if total > 10 and trailing < 3 else 0
    for i in range(total):
        if i < trailing:
            levels[i] = -1 if br.u(1) else 1
            continue
        prefix = br.zeros()
        code = min(15, prefix) << suffix_len
        if prefix == 14 and suffix_len == 0:
            size = 4
        elif prefix >= 15:
            size = prefix - 3
        else:
            size = suffix_len
        if size:
            code += br.u(size)
        if prefix >= 15 and suffix_len == 0:
            code += 15
        if prefix >= 16:
            code += (1 << (prefix - 3)) - 4096
        if i == trailing and trailing < 3:
            code += 2
        lv = (code + 2) >> 1 if code % 2 == 0 else (-code - 1) >> 1
        levels[i] = lv
        if suffix_len == 0:
            suffix_len = 1
        if abs(lv) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
    if total < max_coeff:
        tz_luma, tz_dc = _total_zeros_luts()
        zeros_left = _vlc(br, (tz_dc if nc == -1 else tz_luma)[total - 1])
        if total + zeros_left > max_coeff:
            raise BitstreamError("total_zeros beyond the block")
    else:
        zeros_left = 0
    rb = _run_before_luts()
    pos = total + zeros_left - 1
    for i in range(total):
        out[start + pos] = levels[i]
        if i == total - 1:
            break
        run = _vlc(br, rb[min(zeros_left, 7) - 1]) if zeros_left > 0 else 0
        if run > zeros_left:
            raise BitstreamError("run_before beyond zeros_left")
        zeros_left -= run
        pos -= 1 + run
    return total


# ----------------------------------------------------------------------
# Parameter sets and slice header
# ----------------------------------------------------------------------
def parse_sps(rbsp: bytes) -> dict:
    br = Bits(rbsp)
    s = {"profile": br.u(8)}
    br.u(8)
    s["level"] = br.u(8)
    s["id"] = br.ue()
    if s["profile"] in (100, 110, 122, 244, 44, 83, 86, 118, 128):
        if br.ue() != 1:
            raise Unsupported("chroma format other than 4:2:0")
        if br.ue() or br.ue():
            raise Unsupported("bit depth above 8")
        br.u(1)
        if br.u(1):
            raise Unsupported("sequence scaling matrices")
    s["log2_max_frame_num"] = br.ue() + 4
    s["poc_type"] = br.ue()
    if s["poc_type"] == 0:
        s["log2_max_poc_lsb"] = br.ue() + 4
    elif s["poc_type"] == 1:
        raise Unsupported("pic_order_cnt_type 1")
    s["num_ref_frames"] = br.ue()
    br.u(1)
    s["mb_w"] = br.ue() + 1
    s["mb_h"] = br.ue() + 1
    if not br.u(1):
        raise Unsupported("field coding")
    br.u(1)
    s["crop"] = (0, 0, 0, 0)
    if br.u(1):
        s["crop"] = tuple(2 * br.ue() for _ in range(4))
    br.check()
    return s


def parse_pps(rbsp: bytes) -> dict:
    br = Bits(rbsp)
    p = {"id": br.ue(), "sps_id": br.ue()}
    if br.u(1):
        raise Unsupported("CABAC")
    p["pic_order_present"] = br.u(1)
    if br.ue():
        raise Unsupported("slice groups")
    p["num_ref_l0"] = br.ue() + 1
    br.ue()
    if br.u(1) or br.u(2):
        raise Unsupported("weighted prediction")
    p["pic_init_qp"] = 26 + br.se()
    br.se()
    p["chroma_qp_offset"] = br.se()
    p["deblock_control"] = br.u(1)
    if br.u(1):
        raise Unsupported("constrained intra prediction")
    p["redundant_pic_cnt"] = br.u(1)
    br.check()
    return p


def parse_slice_header(nal: bytes, sps: dict, pps: dict):
    """One slice NAL (with its header byte) -> (header dict, Bits at the
    slice data)."""
    if not nal:
        raise BitstreamError("empty NAL")
    nal_type = nal[0] & 0x1F
    if nal_type not in (1, 5):
        raise BitstreamError(f"NAL type {nal_type} is no slice")
    br = Bits(unescape(nal[1:]))
    h = {"nal_type": nal_type, "nal_ref_idc": (nal[0] >> 5) & 3,
         "first_mb": br.ue(), "slice_type": br.ue() % 5, "pps_id": br.ue()}
    if h["slice_type"] not in (0, 2):
        raise Unsupported(f"slice type {h['slice_type']}")
    h["frame_num"] = br.u(sps["log2_max_frame_num"])
    idr = nal_type == 5
    if idr:
        h["idr_pic_id"] = br.ue()
    if sps["poc_type"] == 0:
        h["poc_lsb"] = br.u(sps["log2_max_poc_lsb"])
        if pps["pic_order_present"]:
            br.se()
    if pps["redundant_pic_cnt"]:
        br.ue()
    n_ref = pps["num_ref_l0"]
    if h["slice_type"] == 0:
        if br.u(1):
            n_ref = br.ue() + 1
        if br.u(1):
            raise Unsupported("reference list modification")
    if n_ref != 1 and h["slice_type"] == 0:
        raise Unsupported("more than one active reference")
    if h["nal_ref_idc"]:
        if idr:
            br.u(1)
            if br.u(1):
                raise Unsupported("long-term reference")
        elif br.u(1):
            raise Unsupported("memory management operations")
    h["qp"] = pps["pic_init_qp"] + br.se()
    h["deblock"], h["alpha_off"], h["beta_off"] = 1, 0, 0
    if pps["deblock_control"]:
        h["deblock"] = br.ue()
        if h["deblock"] != 1:
            h["alpha_off"], h["beta_off"] = 2 * br.se(), 2 * br.se()
    if not 0 <= h["qp"] <= 51:
        raise BitstreamError("slice QP outside 0..51")
    br.check()
    return h, br


# ----------------------------------------------------------------------
# Macroblock layer
# ----------------------------------------------------------------------
# luma 4x4 block index (8.2.1 order) -> (x, y) in 4x4 units in the MB
BLK_X = [0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3]
BLK_Y = [0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3]
_BLK_AT = {(BLK_X[i], BLK_Y[i]): i for i in range(16)}
_CBP_INTRA = {c: i for i, c in enumerate(T.CBP_CODE_INTRA)}
_CBP_INTER = {c: i for i, c in enumerate(T.CBP_CODE_INTER)}

# mb kinds
P_SKIP, P_16x16, P_16x8, P_8x16, P_8x8, I_4x4, I_16x16 = range(7)
# partitions per kind: (x4, y4, w4, h4)
_PARTS = {P_16x16: [(0, 0, 4, 4)],
          P_16x8: [(0, 0, 4, 2), (0, 2, 4, 2)],
          P_8x16: [(0, 0, 2, 4), (2, 0, 2, 4)],
          P_8x8: [(0, 0, 2, 2), (2, 0, 2, 2), (0, 2, 2, 2), (2, 2, 2, 2)]}


class Frame:
    """The syntax of one coded picture, as arrays over its macroblocks
    (MB index = raster order)."""

    def __init__(self, mb_w: int, mb_h: int):
        n = mb_w * mb_h
        self.mb_w, self.mb_h = mb_w, mb_h
        self.kind = np.zeros(n, np.int64)
        self.qp = np.zeros(n, np.int64)
        self.cbp = np.zeros(n, np.int64)
        self.i16_mode = np.zeros(n, np.int64)
        self.chroma_mode = np.zeros(n, np.int64)
        self.i4_mode = np.zeros((n, 16), np.int64)
        # levels in scan order: luma (blk, 16) with AC at 1..15 for I16,
        # the I16 DC, chroma DC (plane, 4) and AC (plane, blk, 16)
        self.luma = np.zeros((n, 16, 16), np.int64)
        self.luma_dc = np.zeros((n, 16), np.int64)
        self.chroma_dc = np.zeros((n, 2, 4), np.int64)
        self.chroma_ac = np.zeros((n, 2, 4, 16), np.int64)
        # per 4x4 block of the picture: total_coeff (luma) and MV
        self.nnz = np.zeros((mb_h * 4, mb_w * 4), np.int64)
        self.mv = np.zeros((mb_h * 4, mb_w * 4, 2), np.int64)


def _nc(cnt, avail, x: int, y: int) -> int:
    a = cnt[y][x - 1] if x > 0 and avail[y][x - 1] else -1
    b = cnt[y - 1][x] if y > 0 and avail[y - 1][x] else -1
    if a >= 0 and b >= 0:
        return (a + b + 1) >> 1
    return a if a >= 0 else (b if b >= 0 else 0)


class _Parser:
    """Walks the slice data of one picture in MB order."""

    def __init__(self, br: Bits, f: Frame, qp: int, is_p: bool):
        self.br, self.f, self.qp, self.is_p = br, f, qp, is_p
        W4, H4 = f.mb_w * 4, f.mb_h * 4
        self.cnt = [[0] * W4 for _ in range(H4)]
        self.ccnt = [[[0] * (f.mb_w * 2) for _ in range(f.mb_h * 2)]
                     for _ in range(2)]
        self.cavail = [[False] * (f.mb_w * 2) for _ in range(f.mb_h * 2)]
        self.avail = [[False] * W4 for _ in range(H4)]
        self.mode4 = [[-1] * W4 for _ in range(H4)]   # -1 unavailable
        self.mvx = [[0] * W4 for _ in range(H4)]
        self.mvy = [[0] * W4 for _ in range(H4)]
        self.done = [[False] * W4 for _ in range(H4)]  # MV decoded
        self.intra = [[False] * W4 for _ in range(H4)]

    # -- motion vectors (8.4.1) -------------------------------------
    def _nb(self, x: int, y: int):
        """(available, is inter, mvx, mvy) of 4x4 block (x, y)."""
        f = self.f
        if x < 0 or y < 0 or x >= f.mb_w * 4 or not self.done[y][x]:
            return False, False, 0, 0
        if self.intra[y][x]:
            return True, False, 0, 0
        return True, True, self.mvx[y][x], self.mvy[y][x]

    def predict(self, x0: int, y0: int, w4: int, shape: int, idx: int):
        a = self._nb(x0 - 1, y0)
        b = self._nb(x0, y0 - 1)
        c = self._nb(x0 + w4, y0 - 1)
        if not c[0]:
            c = self._nb(x0 - 1, y0 - 1)
        if not b[0] and not c[0] and a[0]:
            b = c = a
        if shape == P_16x8:
            if idx == 0 and b[1]:
                return b[2], b[3]
            if idx == 1 and a[1]:
                return a[2], a[3]
        elif shape == P_8x16:
            if idx == 0 and a[1]:
                return a[2], a[3]
            if idx == 1 and c[1]:
                return c[2], c[3]
        match = [n for n in (a, b, c) if n[1]]
        if len(match) == 1:
            return match[0][2], match[0][3]
        xs = sorted((a[2], b[2], c[2]))
        ys = sorted((a[3], b[3], c[3]))
        return xs[1], ys[1]

    def pskip(self, x0: int, y0: int):
        a = self._nb(x0 - 1, y0)
        b = self._nb(x0, y0 - 1)
        if not a[0] or not b[0]:
            return 0, 0
        if (a[1] and a[2] == 0 and a[3] == 0) or (b[1] and b[2] == 0
                                                   and b[3] == 0):
            return 0, 0
        return self.predict(x0, y0, 4, P_16x16, 0)

    def _store_mv(self, x0, y0, w4, h4, mvx, mvy):
        f = self.f
        for y in range(y0, y0 + h4):
            for x in range(x0, x0 + w4):
                self.mvx[y][x], self.mvy[y][x] = mvx, mvy
                self.done[y][x] = True
        f.mv[y0:y0 + h4, x0:x0 + w4] = (mvx, mvy)

    # -- residual (7.3.5.3) -----------------------------------------
    def _luma_block(self, m: int, i: int, x: int, y: int, ac_only: bool):
        row = self.f.luma[m, i]
        if ac_only:
            n = residual_block(self.br, _nc(self.cnt, self.avail, x, y), 15,
                               row, 1)
        else:
            n = residual_block(self.br, _nc(self.cnt, self.avail, x, y), 16,
                               row, 0)
        self.cnt[y][x] = n
        self.f.nnz[y, x] = n

    def residual(self, m: int, mbx: int, mby: int, cbp: int, i16: bool):
        br, f = self.br, self.f
        if i16:
            residual_block(br, _nc(self.cnt, self.avail, mbx * 4, mby * 4),
                           16, f.luma_dc[m], 0)
        for i in range(16):
            x, y = mbx * 4 + BLK_X[i], mby * 4 + BLK_Y[i]
            self.avail[y][x] = True
            if (cbp >> (i >> 2)) & 1:
                self._luma_block(m, i, x, y, i16)
            else:
                self.cnt[y][x] = 0
        cc = cbp >> 4
        if cc:
            for ch in range(2):
                residual_block(br, -1, 4, f.chroma_dc[m, ch], 0)
        for ch in range(2):
            for i in range(4):
                x, y = mbx * 2 + (i & 1), mby * 2 + (i >> 1)
                self.cavail[y][x] = True
                if cc == 2:
                    self.ccnt[ch][y][x] = residual_block(
                        br, _nc(self.ccnt[ch], self.cavail, x, y), 15,
                        f.chroma_ac[m, ch, i], 1)
                else:
                    self.ccnt[ch][y][x] = 0

    def qp_delta(self, m: int):
        d = self.br.se()
        if not -26 <= d <= 25:
            raise BitstreamError("mb_qp_delta outside -26..25")
        self.qp = (self.qp + d + 52) % 52
        self.f.qp[m] = self.qp

    # -- macroblocks -------------------------------------------------
    def intra_mb(self, m: int, mbx: int, mby: int, mb_type: int):
        br, f = self.br, self.f
        x0, y0 = mbx * 4, mby * 4
        for y in range(y0, y0 + 4):
            for x in range(x0, x0 + 4):
                self.intra[y][x] = True
                self.done[y][x] = True
        if mb_type == 0:
            f.kind[m] = I_4x4
            for i in range(16):
                x, y = x0 + BLK_X[i], y0 + BLK_Y[i]
                a = self.mode4[y][x - 1] if x > 0 else -1
                b = self.mode4[y - 1][x] if y > 0 else -1
                pred = 2 if a < 0 or b < 0 else min(a, b)
                if br.u(1):
                    mode = pred
                else:
                    rem = br.u(3)
                    mode = rem + (rem >= pred)
                self.mode4[y][x] = mode
                f.i4_mode[m, i] = mode
            f.chroma_mode[m] = br.ue()
            code = br.ue()
            if code not in _CBP_INTRA:
                raise BitstreamError("coded_block_pattern out of range")
            cbp = _CBP_INTRA[code]
        elif mb_type <= 24:
            f.kind[m] = I_16x16
            t = mb_type - 1
            f.i16_mode[m] = t % 4
            cbp = (15 if t >= 12 else 0) | (((t // 4) % 3) << 4)
            for y in range(y0, y0 + 4):
                for x in range(x0, x0 + 4):
                    self.mode4[y][x] = 2
            f.chroma_mode[m] = br.ue()
        else:
            raise Unsupported("I_PCM")
        if f.chroma_mode[m] > 3:
            raise BitstreamError("intra_chroma_pred_mode out of range")
        f.cbp[m] = cbp
        f.qp[m] = self.qp
        i16 = f.kind[m] == I_16x16
        if i16 or cbp:
            self.qp_delta(m)
        self.residual(m, mbx, mby, cbp, i16)

    def inter_mb(self, m: int, mbx: int, mby: int, mb_type: int):
        br, f = self.br, self.f
        x0, y0 = mbx * 4, mby * 4
        if mb_type == 4:
            raise Unsupported("P_8x8ref0")
        shape = (P_16x16, P_16x8, P_8x16, P_8x8)[mb_type]
        f.kind[m] = shape
        if shape == P_8x8:
            for _ in range(4):
                if br.ue() != 0:
                    raise Unsupported("sub-8x8 partitions")
        for y in range(y0, y0 + 4):
            for x in range(x0, x0 + 4):
                self.mode4[y][x] = 2
        for idx, (px, py, w4, h4) in enumerate(_PARTS[shape]):
            mvpx, mvpy = self.predict(x0 + px, y0 + py, w4, shape, idx)
            mvx, mvy = mvpx + br.se(), mvpy + br.se()
            self._store_mv(x0 + px, y0 + py, w4, h4, mvx, mvy)
        code = br.ue()
        if code not in _CBP_INTER:
            raise BitstreamError("coded_block_pattern out of range")
        cbp = _CBP_INTER[code]
        f.cbp[m] = cbp
        f.qp[m] = self.qp
        if cbp:
            self.qp_delta(m)
        self.residual(m, mbx, mby, cbp, False)

    def skip_mb(self, m: int, mbx: int, mby: int):
        f = self.f
        f.kind[m] = P_SKIP
        f.qp[m] = self.qp
        x0, y0 = mbx * 4, mby * 4
        mvx, mvy = self.pskip(x0, y0)
        self._store_mv(x0, y0, 4, 4, mvx, mvy)
        for y in range(y0, y0 + 4):
            for x in range(x0, x0 + 4):
                self.cnt[y][x] = 0
                self.avail[y][x] = True
                self.mode4[y][x] = 2
        for y in range(mby * 2, mby * 2 + 2):
            for x in range(mbx * 2, mbx * 2 + 2):
                self.cavail[y][x] = True
                self.ccnt[0][y][x] = self.ccnt[1][y][x] = 0

    def run(self):
        br, f = self.br, self.f
        n = f.mb_w * f.mb_h
        m = 0
        while m < n:
            if self.is_p:
                skip = br.ue()
                if m + skip > n:
                    raise BitstreamError("mb_skip_run past the picture")
                for _ in range(skip):
                    self.skip_mb(m, m % f.mb_w, m // f.mb_w)
                    m += 1
                if m == n:
                    break
            mbx, mby = m % f.mb_w, m // f.mb_w
            mb_type = br.ue()
            if self.is_p:
                if mb_type < 5:
                    self.inter_mb(m, mbx, mby, mb_type)
                else:
                    self.intra_mb(m, mbx, mby, mb_type - 5)
            else:
                self.intra_mb(m, mbx, mby, mb_type)
            m += 1
            br.check()
        # rbsp_slice_trailing_bits: the stop bit, then zeros to the end
        if br.nbits - br.pos < 1 or br.u(1) != 1 or br.u(-br.pos % 8) \
                or any(br.buf[br.pos >> 3:br.nbits >> 3]):
            raise BitstreamError("slice data does not end at its stop bit")


def parse_picture(nal: bytes, sps: dict, pps: dict):
    """One slice NAL covering a whole picture -> (header, Frame)."""
    h, br = parse_slice_header(nal, sps, pps)
    if h["first_mb"] != 0:
        raise Unsupported("more than one slice per picture")
    f = Frame(sps["mb_w"], sps["mb_h"])
    _Parser(br, f, h["qp"], h["slice_type"] == 0).run()
    return h, f


def parse_frame(nals: list[bytes], sps: dict, pps: dict):
    """A picture's slice NALs -> (header, Frame). This decoder takes
    pictures of one slice."""
    if len(nals) != 1:
        raise Unsupported(f"{len(nals)} slices in one picture")
    return parse_picture(nals[0], sps, pps)


# ----------------------------------------------------------------------
# Residual (8.5): dequantisation and the inverse transforms, batched
# ----------------------------------------------------------------------
_ZZ = torch.tensor(T.ZIGZAG_4x4)
# LevelScale4x4 position class of each raster position
# LevelScale4x4 column of each raster position: 0 both even, 1 one odd,
# 2 both odd (T.LEVEL_SCALE's order)
_POS = torch.tensor([(r & 1) + (c & 1) for r in range(4) for c in range(4)])


def _raster(levels):
    """(..., 16) scan-order levels -> (..., 4, 4) raster."""
    out = torch.zeros_like(levels)
    out[..., _ZZ.to(levels.device)] = levels
    return out.reshape(*levels.shape[:-1], 4, 4)


def _scale(qp):
    """(...,) qp -> (..., 4, 4) LevelScale4x4 with the flat weights."""
    v = torch.tensor(T.LEVEL_SCALE, device=qp.device)
    return 16 * v[qp % 6][..., _POS.to(qp.device)].reshape(*qp.shape, 4, 4)


def dequant4x4(c, qp):
    """(N, 4, 4) levels, (N,) qp -> scaled coefficients (8.5.12.1)."""
    ls = _scale(qp)
    sh = (qp // 6)[:, None, None]
    d = c * ls
    return torch.where(sh >= 4, d << (sh - 4).clamp(min=0),
                       (d + (1 << (3 - sh).clamp(min=0))) >> (4 - sh)
                       .clamp(min=0))


def idct4x4(d):
    """(N, 4, 4) coefficients -> (N, 4, 4) residual, (x + 32) >> 6
    (8.5.12.2)."""
    def butterfly(x, dim):
        a, b, c, e = x.unbind(dim)
        s02, d02 = a + c, a - c
        s13, d13 = b + (e >> 1), (b >> 1) - e
        return torch.stack([s02 + s13, d02 + d13, d02 - d13, s02 - s13], dim)
    return (butterfly(butterfly(d, 2), 1) + 32) >> 6


def luma_dc(levels, qp):
    """(N, 16) I16 DC levels (scan order) -> (N, 4, 4) dcY by block
    position (8.5.10)."""
    c = _raster(levels)
    h = torch.tensor([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1],
                      [1, -1, 1, -1]], dtype=c.dtype, device=c.device)
    # float64 holds these sums exactly (CUDA has no int64 matmul)
    f = (h.double() @ c.double() @ h.double()).long()
    ls = _scale(qp)[:, 0, 0][:, None, None]
    sh = (qp // 6)[:, None, None]
    d = f * ls
    return torch.where(sh >= 6, d << (sh - 6).clamp(min=0),
                       (d + (1 << (5 - sh).clamp(min=0))) >> (6 - sh)
                       .clamp(min=0))


def chroma_dc(levels, qpc):
    """(N, 4) chroma DC levels -> (N, 4) dcC of blocks 0..3 (8.5.11)."""
    c0, c1, c2, c3 = levels.unbind(-1)
    f = torch.stack([c0 + c1 + c2 + c3, c0 - c1 + c2 - c3,
                     c0 + c1 - c2 - c3, c0 - c1 - c2 + c3], -1)
    ls = _scale(qpc)[:, 0, 0][:, None]
    return ((f * ls) << (qpc // 6)[:, None]) >> 5


def chroma_qp(qp, offset: int):
    tab = torch.tensor(T.CHROMA_QP, device=qp.device)
    return tab[(qp + offset).clamp(0, 51)]


def residuals(f: Frame, device, chroma_offset: int):
    """The picture's residual planes: luma (mb_h*16, mb_w*16) and chroma
    (2, mb_h*8, mb_w*8), int64 on `device`."""
    n = f.mb_w * f.mb_h
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    qp = t(f.qp)
    kind = t(f.kind)
    c = _raster(t(f.luma)).reshape(n * 16, 4, 4)
    d = dequant4x4(c, qp.repeat_interleave(16)).reshape(n, 16, 4, 4)
    i16 = kind == I_16x16
    if bool(i16.any()):
        dc = luma_dc(t(f.luma_dc)[i16], qp[i16])      # (k, 4, 4)
        bx = torch.tensor(BLK_X, device=device)
        by = torch.tensor(BLK_Y, device=device)
        d[i16, :, 0, 0] = dc[:, by, bx]
    r = idct4x4(d.reshape(n * 16, 4, 4)).reshape(n, 16, 4, 4)
    # blocks (coding order) -> raster within the MB
    order = [_BLK_AT[(x, y)] for y in range(4) for x in range(4)]
    r = r[:, order].reshape(f.mb_h, f.mb_w, 4, 4, 4, 4)
    luma = r.permute(0, 2, 4, 1, 3, 5).reshape(f.mb_h * 16, f.mb_w * 16)
    qpc = chroma_qp(qp, chroma_offset)
    ac = _raster(t(f.chroma_ac)).reshape(n * 8, 4, 4)
    dq = dequant4x4(ac, qpc.repeat_interleave(8)).reshape(n, 2, 4, 4, 4)
    dcc = chroma_dc(t(f.chroma_dc).reshape(n * 2, 4),
                    qpc.repeat_interleave(2)).reshape(n, 2, 4)
    dq[..., 0, 0] = dcc
    rc = idct4x4(dq.reshape(n * 8, 4, 4)).reshape(f.mb_h, f.mb_w, 2, 2, 2,
                                                    4, 4)
    chroma = rc.permute(2, 0, 3, 5, 1, 4, 6).reshape(2, f.mb_h * 8,
                                                     f.mb_w * 8)
    return luma, chroma


# ----------------------------------------------------------------------
# Inter prediction (8.4.2.2), every 4x4 block at once
# ----------------------------------------------------------------------
def _tap6(p, dim):
    """6-tap (1, -5, 20, 20, -5, 1) along `dim` at positions i+1/2 for
    i = 2 .. len-4 (unrounded)."""
    n = p.shape[dim]
    s = [p.narrow(dim, k, n - 5) for k in range(6)]
    return s[0] - 5 * s[1] + 20 * s[2] + 20 * s[3] - 5 * s[4] + s[5]


def inter_pred(ref_y, ref_c, mv, mb_w: int, mb_h: int):
    """ref_y (H, W), ref_c (2, H/2, W/2) uint8 reference planes, mv
    (4mb_h, 4mb_w, 2) quarter-sample MVs -> luma (H, W) and chroma
    (2, H/2, W/2) int64 prediction. Samples outside the picture repeat
    its edge."""
    dev = ref_y.device
    H, W = ref_y.shape
    P = int(mv.abs().max()) // 4 + 8
    g = torch.nn.functional.pad(ref_y[None, None].float(), (P + 3,) * 4,
                                mode="replicate")[0, 0].long()
    # half samples on the grid of g[3:-3, 3:-3]: b at (x+1/2, y), h at
    # (x, y+1/2), j at the centre (8.4.2.2.1)
    full = g[3:-3, 3:-3]
    Hf, Wf = full.shape
    b1 = _tap6(g[3:-3], 1)[:, 1:1 + Wf]
    h1 = _tap6(g[:, 3:-3], 0)[1:1 + Hf]
    j1 = _tap6(_tap6(g, 0), 1)[1:1 + Hf, 1:1 + Wf]
    b = ((b1 + 16) >> 5).clamp(0, 255)
    h = ((h1 + 16) >> 5).clamp(0, 255)
    j = ((j1 + 512) >> 10).clamp(0, 255)
    planes = torch.stack([full, b, h, j])         # padded by P
    # per sample: the block's MV
    mvs = mv.repeat_interleave(4, 0).repeat_interleave(4, 1)  # (H, W, 2)
    mvx, mvy = mvs[..., 0], mvs[..., 1]
    yy = torch.arange(H, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, device=dev)[None, :].expand(H, W)
    xq, yq = mvx & 3, mvy & 3
    fx, fy = xx + (mvx >> 2) + P, yy + (mvy >> 2) + P
    q = yq * 4 + xq
    ref0 = torch.tensor([0, 1, 1, 1, 0, 1, 1, 1, 2, 3, 3, 3, 0, 1, 1, 1],
                        device=dev)[q]
    ref1 = torch.tensor([0, 0, 0, 0, 2, 2, 3, 2, 2, 2, 3, 2, 2, 2, 3, 2],
                        device=dev)[q]
    a = planes[ref0, fy + (yq == 3).long(), fx]
    two = ((xq & 1) | (yq & 1)).bool()
    bb = planes[ref1, fy, fx + (xq == 3).long()]
    luma = torch.where(two, (a + bb + 1) >> 1, a)
    # chroma: eighth samples, bilinear (8.4.2.2.2)
    Hc, Wc = H // 2, W // 2
    Pc = P // 2 + 2
    gc = torch.nn.functional.pad(ref_c[None].float(), (Pc, Pc + 1) * 2,
                                 mode="replicate")[0].long()
    mvc = mv.repeat_interleave(2, 0).repeat_interleave(2, 1)
    cx, cy = mvc[..., 0], mvc[..., 1]
    yc = torch.arange(Hc, device=dev)[:, None].expand(Hc, Wc)
    xc = torch.arange(Wc, device=dev)[None, :].expand(Hc, Wc)
    dx, dy = cx & 7, cy & 7
    X, Y = xc + (cx >> 3) + Pc, yc + (cy >> 3) + Pc
    A, B = gc[:, Y, X], gc[:, Y, X + 1]
    C, D = gc[:, Y + 1, X], gc[:, Y + 1, X + 1]
    chroma = ((8 - dx) * (8 - dy) * A + dx * (8 - dy) * B
              + (8 - dx) * dy * C + dx * dy * D + 32) >> 6
    return luma, chroma


# ----------------------------------------------------------------------
# Intra prediction (8.3), macroblock by macroblock
# ----------------------------------------------------------------------
def _pred4(mode, L, T_, TL, TR):
    """Intra_4x4 prediction (8.3.1.2); L, T_, TR lists of 4 or None,
    TL an int or None. Returns a 4x4 list of rows."""
    if mode == 0:
        return [list(T_)] * 4
    if mode == 1:
        return [[v] * 4 for v in L]
    if mode == 2:
        if L and T_:
            s = (sum(L) + sum(T_) + 4) >> 3
        elif L:
            s = (sum(L) + 2) >> 2
        elif T_:
            s = (sum(T_) + 2) >> 2
        else:
            s = 128
        return [[s] * 4 for _ in range(4)]
    t = list(T_) + list(TR) if T_ else None
    if mode == 3:      # diagonal down left
        o = [[0] * 4 for _ in range(4)]
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    o[y][x] = (t[6] + 3 * t[7] + 2) >> 2
                else:
                    o[y][x] = (t[x + y] + 2 * t[x + y + 1] + t[x + y + 2]
                               + 2) >> 2
        return o
    if mode == 8:      # horizontal up
        o = [[0] * 4 for _ in range(4)]
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                if z < 6 and z % 2 == 0:
                    o[y][x] = (L[y + (x >> 1)] + L[y + (x >> 1) + 1] + 1) >> 1
                elif z < 5:
                    o[y][x] = (L[y + (x >> 1)] + 2 * L[y + (x >> 1) + 1]
                               + L[y + (x >> 1) + 2] + 2) >> 2
                elif z == 5:
                    o[y][x] = (L[2] + 3 * L[3] + 2) >> 2
                else:
                    o[y][x] = L[3]
        return o
    # modes 4-7 use p[-1, -1] .. : index e(k) with k = -1 the corner
    def P(x, y):      # noqa: N802 - the standard's p[x, y]
        if y == -1:
            return TL if x == -1 else t[x]
        return L[y]
    o = [[0] * 4 for _ in range(4)]
    for y in range(4):
        for x in range(4):
            if mode == 4:      # diagonal down right
                if x > y:
                    v = (P(x - y - 2, -1) + 2 * P(x - y - 1, -1)
                         + P(x - y, -1) + 2) >> 2
                elif x < y:
                    v = (P(-1, y - x - 2) + 2 * P(-1, y - x - 1)
                         + P(-1, y - x) + 2) >> 2
                else:
                    v = (P(0, -1) + 2 * P(-1, -1) + P(-1, 0) + 2) >> 2
            elif mode == 5:    # vertical right
                z = 2 * x - y
                if z >= 0 and z % 2 == 0:
                    v = (P(x - (y >> 1) - 1, -1) + P(x - (y >> 1), -1)
                         + 1) >> 1
                elif z >= 0:
                    v = (P(x - (y >> 1) - 2, -1) + 2 * P(x - (y >> 1) - 1, -1)
                         + P(x - (y >> 1), -1) + 2) >> 2
                elif z == -1:
                    v = (P(-1, 0) + 2 * P(-1, -1) + P(0, -1) + 2) >> 2
                else:
                    v = (P(-1, y - 1) + 2 * P(-1, y - 2) + P(-1, y - 3)
                         + 2) >> 2
            elif mode == 6:    # horizontal down
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    v = (P(-1, y - (x >> 1) - 1) + P(-1, y - (x >> 1))
                         + 1) >> 1
                elif z >= 0:
                    v = (P(-1, y - (x >> 1) - 2) + 2 * P(-1, y - (x >> 1) - 1)
                         + P(-1, y - (x >> 1)) + 2) >> 2
                elif z == -1:
                    v = (P(-1, 0) + 2 * P(-1, -1) + P(0, -1) + 2) >> 2
                else:
                    v = (P(x - 1, -1) + 2 * P(x - 2, -1) + P(x - 3, -1)
                         + 2) >> 2
            else:              # 7, vertical left
                if y % 2 == 0:
                    v = (t[x + (y >> 1)] + t[x + (y >> 1) + 1] + 1) >> 1
                else:
                    v = (t[x + (y >> 1)] + 2 * t[x + (y >> 1) + 1]
                         + t[x + (y >> 1) + 2] + 2) >> 2
            o[y][x] = v
    return o


def _pred_plane(L, T_, TL, n: int):
    """Intra_16x16 (n 16) or chroma (n 8) plane prediction."""
    half = n // 2
    top = [TL] + list(T_)
    left = [TL] + list(L)
    Hs = sum((x + 1) * (top[half + 1 + x] - top[half - 1 - x])
             for x in range(half))
    Vs = sum((y + 1) * (left[half + 1 + y] - left[half - 1 - y])
             for y in range(half))
    a = 16 * (L[n - 1] + T_[n - 1])
    if n == 16:
        b, c = (5 * Hs + 32) >> 6, (5 * Vs + 32) >> 6
    else:
        b, c = (34 * Hs + 32) >> 6, (34 * Vs + 32) >> 6
    o = half - 1
    return np.clip((a + b * (np.arange(n)[None, :] - o)
                    + c * (np.arange(n)[:, None] - o) + 16) >> 5, 0, 255)


def _pred16(mode, L, T_, TL):
    if mode == 0:
        if T_ is None:
            raise BitstreamError("vertical prediction without a top")
        return np.tile(np.array(T_), (16, 1))
    if mode == 1:
        if L is None:
            raise BitstreamError("horizontal prediction without a left")
        return np.tile(np.array(L)[:, None], (1, 16))
    if mode == 2:
        if L is not None and T_ is not None:
            s = (sum(L) + sum(T_) + 16) >> 5
        elif L is not None:
            s = (sum(L) + 8) >> 4
        elif T_ is not None:
            s = (sum(T_) + 8) >> 4
        else:
            s = 128
        return np.full((16, 16), s)
    if L is None or T_ is None or TL is None:
        raise BitstreamError("plane prediction without its neighbours")
    return _pred_plane(L, T_, TL, 16)


def _pred_chroma(mode, L, T_, TL):
    if mode == 0:      # DC per 4x4 block (8.3.4.1-3)
        o = np.zeros((8, 8), np.int64)
        for by in range(2):
            for bx in range(2):
                lsum = sum(L[by * 4:by * 4 + 4]) if L is not None else None
                tsum = sum(T_[bx * 4:bx * 4 + 4]) if T_ is not None else None
                if (bx, by) in ((0, 0), (1, 1)):
                    if lsum is not None and tsum is not None:
                        s = (lsum + tsum + 4) >> 3
                    elif lsum is not None:
                        s = (lsum + 2) >> 2
                    elif tsum is not None:
                        s = (tsum + 2) >> 2
                    else:
                        s = 128
                elif (bx, by) == (1, 0):
                    if tsum is not None:
                        s = (tsum + 2) >> 2
                    elif lsum is not None:
                        s = (lsum + 2) >> 2
                    else:
                        s = 128
                else:
                    if lsum is not None:
                        s = (lsum + 2) >> 2
                    elif tsum is not None:
                        s = (tsum + 2) >> 2
                    else:
                        s = 128
                o[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = s
        return o
    if mode == 1:
        if L is None:
            raise BitstreamError("horizontal prediction without a left")
        return np.tile(np.array(L)[:, None], (1, 8))
    if mode == 2:
        if T_ is None:
            raise BitstreamError("vertical prediction without a top")
        return np.tile(np.array(T_), (8, 1))
    if L is None or T_ is None or TL is None:
        raise BitstreamError("plane prediction without its neighbours")
    return _pred_plane(L, T_, TL, 8)


def _intra_mb(f: Frame, m: int, y, c, ry, rc, done):
    """Reconstruct intra macroblock m into the int64 numpy planes y (H, W)
    and c (2, H/2, W/2) from the residual planes ry, rc; `done` marks the
    macroblocks already reconstructed (the neighbours it may read)."""
    mb_w, mb_h = f.mb_w, f.mb_h
    mbx, mby = m % mb_w, m // mb_w
    X, Y = mbx * 16, mby * 16
    has_l = mbx > 0 and done[mby, mbx - 1]
    has_t = mby > 0 and done[mby - 1, mbx]
    has_tl = has_l and has_t and done[mby - 1, mbx - 1]
    has_tr = mby > 0 and mbx + 1 < mb_w and done[mby - 1, mbx + 1]
    if f.kind[m] == I_16x16:
        L = [int(v) for v in y[Y:Y + 16, X - 1]] if has_l else None
        T_ = [int(v) for v in y[Y - 1, X:X + 16]] if has_t else None
        TL = int(y[Y - 1, X - 1]) if has_tl else None
        pred = _pred16(int(f.i16_mode[m]), L, T_, TL)
        y[Y:Y + 16, X:X + 16] = np.clip(pred + ry[Y:Y + 16, X:X + 16], 0,
                                        255)
    else:
        for i in range(16):
            bx, by = BLK_X[i], BLK_Y[i]
            x0, y0 = X + 4 * bx, Y + 4 * by
            bl = has_l if bx == 0 else True
            bt = has_t if by == 0 else True
            btl = (has_tl if (bx == 0 and by == 0) else has_l if bx == 0
                   else has_t if by == 0 else True)
            if by == 0:
                btr = has_tr if bx == 3 else has_t
            else:
                btr = bx < 3 and _BLK_AT[(bx + 1, by - 1)] < i
            L = [int(v) for v in y[y0:y0 + 4, x0 - 1]] if bl else None
            T_ = [int(v) for v in y[y0 - 1, x0:x0 + 4]] if bt else None
            TL = int(y[y0 - 1, x0 - 1]) if btl else None
            TR = None
            if T_ is not None:
                TR = ([int(v) for v in y[y0 - 1, x0 + 4:x0 + 8]] if btr
                      else [T_[3]] * 4)
            mode = int(f.i4_mode[m, i])
            need_t = mode in (0, 3, 4, 5, 6, 7)
            need_l = mode in (1, 4, 5, 6, 8)
            if (need_t and T_ is None) or (need_l and L is None) or (
                    mode in (4, 5, 6) and TL is None) or mode > 8:
                raise BitstreamError("Intra_4x4 mode without its neighbours")
            pred = np.array(_pred4(mode, L, T_, TL, TR))
            y[y0:y0 + 4, x0:x0 + 4] = np.clip(
                pred + ry[y0:y0 + 4, x0:x0 + 4], 0, 255)
    Xc, Yc = mbx * 8, mby * 8
    for ch in range(2):
        p = c[ch]
        L = [int(v) for v in p[Yc:Yc + 8, Xc - 1]] if has_l else None
        T_ = [int(v) for v in p[Yc - 1, Xc:Xc + 8]] if has_t else None
        TL = int(p[Yc - 1, Xc - 1]) if has_tl else None
        pred = _pred_chroma(int(f.chroma_mode[m]), L, T_, TL)
        p[Yc:Yc + 8, Xc:Xc + 8] = np.clip(
            pred + rc[ch, Yc:Yc + 8, Xc:Xc + 8], 0, 255)


# ----------------------------------------------------------------------
# Deblocking (8.7), one wavefront over the macroblocks of many pictures
# ----------------------------------------------------------------------
def strengths(f: Frame, device):
    """bS (8.7.2.1) of every edge: (mb_h, mb_w, 2 dir, 4 edge, 16 line)
    for luma, vertical edges first (dir 0)."""
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    H4, W4 = f.mb_h * 4, f.mb_w * 4
    intra_mb = t(f.kind >= I_4x4).reshape(f.mb_h, f.mb_w)
    intra = intra_mb.repeat_interleave(4, 0).repeat_interleave(4, 1)
    nz = t(f.nnz) > 0
    mv = t(f.mv)
    bs = torch.zeros((2, H4, W4), dtype=torch.int64, device=device)
    for d in range(2):
        # q block at (y, x), p block left of it (d 0) or above (d 1)
        if d == 0:
            qi, pi_ = (slice(None), slice(1, None)), (slice(None),
                                                      slice(0, -1))
        else:
            qi, pi_ = (slice(1, None), slice(None)), (slice(0, -1),
                                                      slice(None))
        mb_edge = torch.zeros((H4, W4), dtype=torch.bool, device=device)
        if d == 0:
            mb_edge[:, 0::4] = True
        else:
            mb_edge[0::4, :] = True
        dmv = (mv[qi] - mv[pi_]).abs()
        v = torch.where(nz[qi] | nz[pi_], 2,
                        ((dmv[..., 0] >= 4) | (dmv[..., 1] >= 4)).long())
        any_intra = intra[qi] | intra[pi_]
        v = torch.where(any_intra, torch.where(mb_edge[qi], 4, 3), v)
        bs[d][qi] = v
    # (2, H4, W4) -> (mb_h, mb_w, dir, edge, line 0..15)
    out = torch.zeros((f.mb_h, f.mb_w, 2, 4, 16), dtype=torch.int64,
                      device=device)
    b0 = bs[0].reshape(f.mb_h, 4, f.mb_w, 4)      # [mby, row4, mbx, col4]
    out[:, :, 0] = b0.permute(0, 2, 3, 1).repeat_interleave(4, -1)
    b1 = bs[1].reshape(f.mb_h, 4, f.mb_w, 4)
    out[:, :, 1] = b1.permute(0, 2, 1, 3).repeat_interleave(4, -1)
    return out


def _filter(p, q, bs, alpha, beta, tc0, chroma: bool):
    """p (M, L, k) samples p0..p{k-1} moving away from the edge, q
    likewise; bs (M, L); alpha, beta, tc0 (M, L). Returns new p, q
    (8.7.2.3, 8.7.2.4)."""
    p0, p1, q0, q1 = p[..., 0], p[..., 1], q[..., 0], q[..., 1]
    on = (bs > 0) & ((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta) \
        & ((q1 - q0).abs() < beta)
    np_, nq = p.clone(), q.clone()
    if chroma:
        tc = tc0 + 1
        delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
        weak_p0 = (p0 + delta).clamp(0, 255)
        weak_q0 = (q0 - delta).clamp(0, 255)
        strong_p0 = (2 * p1 + p0 + q1 + 2) >> 2
        strong_q0 = (2 * q1 + q0 + p1 + 2) >> 2
        s = bs == 4
        np_[..., 0] = torch.where(on, torch.where(s, strong_p0, weak_p0), p0)
        nq[..., 0] = torch.where(on, torch.where(s, strong_q0, weak_q0), q0)
        return np_, nq
    p2, q2, p3, q3 = p[..., 2], q[..., 2], p[..., 3], q[..., 3]
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta
    tc = tc0 + ap.long() + aq.long()
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    w_p0 = (p0 + delta).clamp(0, 255)
    w_q0 = (q0 - delta).clamp(0, 255)
    avg = (p0 + q0 + 1) >> 1
    w_p1 = p1 + torch.clamp((p2 + avg - (p1 << 1)) >> 1, -tc0, tc0)
    w_q1 = q1 + torch.clamp((q2 + avg - (q1 << 1)) >> 1, -tc0, tc0)
    small = (p0 - q0).abs() < ((alpha >> 2) + 2)
    sp = ap & small
    sq = aq & small
    s_p0 = torch.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                       (2 * p1 + p0 + q1 + 2) >> 2)
    s_p1 = torch.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    s_p2 = torch.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    s_q0 = torch.where(sq, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                       (2 * q1 + q0 + p1 + 2) >> 2)
    s_q1 = torch.where(sq, (p0 + q0 + q1 + q2 + 2) >> 2, q1)
    s_q2 = torch.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    strong = bs == 4
    weak = on & ~strong
    st = on & strong
    np_[..., 0] = torch.where(st, s_p0, torch.where(weak, w_p0, p0))
    np_[..., 1] = torch.where(st, s_p1, torch.where(weak & ap, w_p1, p1))
    np_[..., 2] = torch.where(st, s_p2, p2)
    nq[..., 0] = torch.where(st, s_q0, torch.where(weak, w_q0, q0))
    nq[..., 1] = torch.where(st, s_q1, torch.where(weak & aq, w_q1, q1))
    nq[..., 2] = torch.where(st, s_q2, q2)
    return np_, nq


def deblock(planes, bs, qp, qpc, alpha_off, beta_off, mb_w: int, mb_h: int):
    """In place on planes = [y (N, H, W), u, v (N, H/2, W/2)] int64: the
    deblocking filter of N pictures of one size. bs (N, mb_h, mb_w, 2, 4,
    16), qp / qpc (N, mb_h, mb_w) luma and chroma QPs (qpc (N, 2, mb_h,
    mb_w) for the two planes), alpha_off / beta_off (N,). Macroblocks
    are filtered in raster order's dependencies: MB (x, y) at step
    x + 2y, so each step's macroblocks are independent."""
    dev = planes[0].device
    alpha_t = torch.tensor(T.ALPHA, device=dev)
    beta_t = torch.tensor(T.BETA, device=dev)
    tc0_t = torch.tensor(T.TC0, device=dev)
    N = planes[0].shape[0]
    n_idx = torch.arange(N, device=dev)
    for step in range(mb_w + 2 * (mb_h - 1)):
        ys = torch.arange(max(0, (step - mb_w + 2) // 2), min(mb_h,
                          step // 2 + 1), device=dev)
        xs = step - 2 * ys
        keep = (xs >= 0) & (xs < mb_w)
        ys, xs = ys[keep], xs[keep]
        if ys.numel() == 0:
            continue
        K = ys.numel()
        nn = n_idx.repeat_interleave(K)
        my, mx = ys.repeat(N), xs.repeat(N)
        for d in range(2):
            for plane_i, plane in enumerate(planes):
                chroma = plane_i > 0
                size = 8 if chroma else 16
                edges = (0, 4) if chroma else (0, 4, 8, 12)
                for e_i, e in enumerate(edges):
                    luma_edge = 2 * e_i if chroma else e_i
                    b = bs[nn, my, mx, d, luma_edge]          # (M, 16)
                    if chroma:
                        b = b[:, ::2]                         # (M, 8)
                    if e == 0:
                        at_border = (mx == 0) if d == 0 else (my == 0)
                        b = torch.where(at_border[:, None], 0, b)
                    q_grid = qpc[:, plane_i - 1] if chroma else qp
                    qcur = q_grid[nn, my, mx]
                    if e == 0:
                        if d == 0:
                            qn = q_grid[nn, my, (mx - 1).clamp(min=0)]
                        else:
                            qn = q_grid[nn, (my - 1).clamp(min=0), mx]
                        qav = (qcur + qn + 1) >> 1
                    else:
                        qav = qcur
                    ia = (qav + alpha_off[nn]).clamp(0, 51)
                    ib = (qav + beta_off[nn]).clamp(0, 51)
                    alpha = alpha_t[ia][:, None].expand_as(b)
                    beta = beta_t[ib][:, None].expand_as(b)
                    tc0 = tc0_t[ia[:, None], b.clamp(max=3)]
                    k = 2 if chroma else 4
                    line = torch.arange(size, device=dev)
                    tap = torch.arange(k, device=dev)
                    base_y = my * size
                    base_x = mx * size
                    if d == 0:
                        rows = (base_y[:, None, None] + line[None, :, None])
                        pc = (base_x + e)[:, None, None] - 1 - tap
                        qc = (base_x + e)[:, None, None] + tap
                        rows = rows.expand(-1, -1, k)
                        pidx = (nn[:, None, None].expand_as(rows), rows,
                                pc.expand_as(rows))
                        qidx = (nn[:, None, None].expand_as(rows), rows,
                                qc.expand_as(rows))
                    else:
                        cols = (base_x[:, None, None] + line[None, :, None])
                        pr = (base_y + e)[:, None, None] - 1 - tap
                        qr = (base_y + e)[:, None, None] + tap
                        cols = cols.expand(-1, -1, k)
                        pidx = (nn[:, None, None].expand_as(cols),
                                pr.expand_as(cols), cols)
                        qidx = (nn[:, None, None].expand_as(cols),
                                qr.expand_as(cols), cols)
                    newp, newq = _filter(plane[pidx], plane[qidx], b, alpha,
                                         beta, tc0, chroma)
                    plane[pidx] = newp
                    plane[qidx] = newq


# ----------------------------------------------------------------------
# Pictures
# ----------------------------------------------------------------------
def reconstruct(f: Frame, ref, device, chroma_offset: int):
    """The picture before the deblocking filter: int64 (H, W) and (2, H/2,
    W/2) on `device`. `ref` is the reference picture (y (H, W), c (2, H/2,
    W/2) uint8) for a P picture, None for an I picture."""
    ry, rc = residuals(f, device, chroma_offset)
    intra = f.kind >= I_4x4
    if ref is not None:
        py, pc = inter_pred(ref[0].to(device), ref[1].to(device),
                            torch.as_tensor(f.mv, device=device), f.mb_w,
                            f.mb_h)
        y = (py + ry).clamp(0, 255)
        c = (pc + rc).clamp(0, 255)
    else:
        if not intra.all():
            raise BitstreamError("inter macroblock in an I slice")
        y = torch.zeros_like(ry)
        c = torch.zeros_like(rc)
    if intra.any():
        yn, cn = y.cpu().numpy(), c.cpu().numpy()
        ryn, rcn = ry.cpu().numpy(), rc.cpu().numpy()
        done = ~intra.reshape(f.mb_h, f.mb_w)
        for m in np.flatnonzero(intra):
            _intra_mb(f, int(m), yn, cn, ryn, rcn, done)
            done[m // f.mb_w, m % f.mb_w] = True
        y, c = torch.as_tensor(yn, device=device), torch.as_tensor(
            cn, device=device)
    return y, c


def deblock_pictures(items, sps: dict, pps: dict, device):
    """items: [(header, Frame, (y, c) int64 before the filter)] of one
    size -> [(y (H, W), c (2, H/2, W/2)) uint8], the pictures whose
    header enables the filter deblocked together."""
    off = pps["chroma_qp_offset"]
    mb_w, mb_h = sps["mb_w"], sps["mb_h"]
    if not items:
        return []
    ys = torch.stack([y for _, _, (y, _) in items])
    cs = torch.stack([c for _, _, (_, c) in items])
    filt = [i for i, (h, _, _) in enumerate(items) if h["deblock"] != 1]
    if filt:
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        idx = torch.tensor(filt, device=device)
        fs = [items[i][1] for i in filt]
        bs = torch.stack([strengths(f, device) for f in fs])
        qp = torch.stack([t(f.qp).reshape(mb_h, mb_w) for f in fs])
        qpc = chroma_qp(qp, off)[:, None].expand(-1, 2, -1, -1)
        planes = [ys[idx], cs[idx, 0], cs[idx, 1]]
        deblock(planes, bs, qp, qpc,
                t([items[i][0]["alpha_off"] for i in filt]),
                t([items[i][0]["beta_off"] for i in filt]), mb_w, mb_h)
        ys[idx] = planes[0]
        cs[idx, 0], cs[idx, 1] = planes[1], planes[2]
    return [(ys[i].to(torch.uint8), cs[i].to(torch.uint8))
            for i in range(len(items))]


def decode_pictures(items, sps: dict, pps: dict, device):
    """items: [(slice NAL bytes, reference or None)] -> [(header, (y
    (H, W), c (2, H/2, W/2)) uint8 decoded and deblocked)] on `device`.
    A picture that does not decode raises."""
    done = []
    for nal, ref in items:
        h, f = parse_picture(nal, sps, pps)
        done.append((h, f, reconstruct(f, ref, device,
                                       pps["chroma_qp_offset"])))
    out = deblock_pictures(done, sps, pps, device)
    return [(h, planes) for (h, _, _), planes in zip(done, out)]
