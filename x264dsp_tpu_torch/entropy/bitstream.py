"""Host bitstream writer — equivalent of common/bitstream.c/h (bs_t).

The reference keeps a 32-bit accumulator (``bs_t``, common/bitstream.h:22)
and flushes whole words; we keep the same structure so the eventual C++
implementation is a drop-in. Exp-Golomb codes follow bs_write_ue_big /
bs_write_se / bs_write_te (common/bitstream.h).

NAL emulation-prevention escaping (``x264_nal_escape``,
common/bitstream.c / bitstream-a.sa:21) is vectorized with NumPy rather
than byte-serial.

Copied from x264dsp_tpu/entropy/bitstream.py
so that the port imports nothing of the JAX package; only the import
lines differ.
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    """Bit-serial writer with MSB-first packing (bs_t twin)."""

    __slots__ = ("_buf", "_cur", "_nbits")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._cur = 0      # bit accumulator (python int)
        self._nbits = 0    # bits currently in accumulator

    # -- core ---------------------------------------------------------------
    def write(self, n_bits: int, value: int) -> None:
        assert 0 <= n_bits <= 32
        if n_bits == 0:
            return
        value &= (1 << n_bits) - 1
        self._cur = (self._cur << n_bits) | value
        self._nbits += n_bits
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._cur >> self._nbits) & 0xFF)
        self._cur &= (1 << self._nbits) - 1

    def write1(self, bit: int) -> None:
        self.write(1, bit)

    def write32(self, value: int) -> None:
        self.write(16, value >> 16)
        self.write(16, value & 0xFFFF)

    # -- exp-golomb -----------------------------------------------------------
    def write_ue(self, value: int) -> None:
        """ue(v) exp-golomb (bs_write_ue_big)."""
        assert value >= 0
        v = value + 1
        size = v.bit_length()
        self.write(2 * size - 1, v)

    def write_se(self, value: int) -> None:
        """se(v): positive → 2v-1, negative/zero → -2v (bs_write_se)."""
        self.write_ue(2 * value - 1 if value > 0 else -2 * value)

    def write_te(self, x: int, value: int) -> None:
        """te(v) — truncated exp-golomb (bs_write_te)."""
        if x == 1:
            self.write1(1 ^ value)
        elif x > 1:
            self.write_ue(value)

    # -- trailing/alignment ---------------------------------------------------
    def rbsp_trailing(self) -> None:
        """rbsp_stop_one_bit + alignment zeros (bs_rbsp_trailing)."""
        self.write1(1)
        if self._nbits:
            self.write(8 - self._nbits, 0)

    def align_10(self) -> None:
        if self._nbits:
            self.write1(1)
        if self._nbits:
            self.write(8 - self._nbits, 0)

    def align_0(self) -> None:
        if self._nbits:
            self.write(8 - self._nbits, 0)

    def align_1(self) -> None:
        """cabac_alignment_one_bit padding (bs_align_1)."""
        if self._nbits:
            self.write(8 - self._nbits, (1 << (8 - self._nbits)) - 1)

    # -- state ----------------------------------------------------------------
    @property
    def bit_pos(self) -> int:
        """bs_pos: number of bits written so far."""
        return len(self._buf) * 8 + self._nbits

    def byte_aligned(self) -> bool:
        return self._nbits == 0

    def get_bytes(self) -> bytes:
        assert self._nbits == 0, "bitstream not byte-aligned"
        return bytes(self._buf)

    def get_unaligned(self) -> tuple:
        """Returns (bytes including a trailing partial byte, n_partial_bits).
        The partial bits are MSB-aligned in the final byte."""
        partial = ((self._cur << (8 - self._nbits)) & 0xFF
                   if self._nbits else 0)
        return bytes(self._buf) + bytes([partial]), self._nbits

    def append_bytes(self, data: bytes) -> None:
        assert self._nbits == 0
        self._buf.extend(data)


def size_ue(value: int) -> int:
    """bs_size_ue_big: bits needed for ue(v)."""
    return 2 * (value + 1).bit_length() - 1


def size_se(value: int) -> int:
    return size_ue(2 * value - 1 if value > 0 else -2 * value)


def size_te(x: int, value: int) -> int:
    if x == 1:
        return 1
    if x > 1:
        return size_ue(value)
    return 0


def nal_escape(payload: bytes) -> bytes:
    """Insert emulation-prevention 0x03 bytes (x264_nal_escape,
    common/bitstream.c; TI kernel bitstream-a.sa:21).

    A 0x03 is inserted before any byte <= 3 that follows two zero bytes.
    Vectorized: find positions i where buf[i-2]==0 and buf[i-1]==0 and
    buf[i]<=3, scanning left to right with escape resets.
    """
    buf = np.frombuffer(payload, dtype=np.uint8)
    n = buf.size
    if n < 3:
        return payload
    # Candidate positions where an escape *might* be needed.
    cand = np.flatnonzero((buf[2:] <= 3) & (buf[1:-1] == 0) & (buf[:-2] == 0)) + 2
    if cand.size == 0:
        return payload
    # An inserted 0x03 breaks the zero run, so two candidates at distance 1
    # (e.g. 00 00 00 00) both need escapes, but a candidate whose zero-run
    # was already broken by a previous escape at i-1 does not. Resolve
    # serially over the (rare) candidates only.
    out_positions = []
    last_escaped = -10
    for i in cand.tolist():
        if i - 1 == last_escaped:
            # previous escape consumed buf[i-1]==0 as the byte after 0x03;
            # the zero-run before buf[i] is now length 1 → no escape
            continue
        out_positions.append(i)
        last_escaped = i
    pieces = []
    prev = 0
    for i in out_positions:
        pieces.append(payload[prev:i])
        pieces.append(b"\x03")
        prev = i
    pieces.append(payload[prev:])
    return b"".join(pieces)


def nal_unit(nal_type: int, nal_ref_idc: int, rbsp: bytes,
             long_startcode: bool = True, annexb: bool = True) -> bytes:
    """Wrap an RBSP payload into an (escaped) Annex-B NAL unit
    (x264_nal_encode, common/bitstream.c; encoder/encoder.c:687-731)."""
    header = bytes([(nal_ref_idc << 5) | nal_type])
    body = header + nal_escape(rbsp)
    if not annexb:
        return len(body).to_bytes(4, "big") + body
    start = b"\x00\x00\x00\x01" if long_startcode else b"\x00\x00\x01"
    return start + body
