"""Annex-B muxing/demuxing — equivalent of the reference CLI's output.c
(writer) plus a start-code parser used by tests and the conformance
decoder.

Copied from x264dsp_tpu/utils/annexb.py.
"""

from __future__ import annotations


class AnnexBWriter:
    """cli_output vtable twin (output.c:46): write headers then frames."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write_headers(self, nal_payloads: bytes) -> None:
        self._f.write(nal_payloads)

    def write_frame(self, payload: bytes) -> None:
        self._f.write(payload)

    def close(self):
        self._f.close()


def split_nals(stream: bytes) -> list[bytes]:
    """Split an Annex-B byte stream into NAL units (header byte + EBSP,
    start codes stripped)."""
    nals = []
    i = 0
    n = len(stream)
    starts = []
    while i + 2 < n:
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        e = n if k + 1 == len(starts) else starts[k + 1] - 3
        # trailing zero_byte before the next start code belongs to no NAL
        while e > s and stream[e - 1] == 0 and k + 1 < len(starts):
            e -= 1
        nals.append(stream[s:e])
    return nals


def unescape_ebsp(data: bytes) -> bytes:
    """Remove emulation-prevention 0x03 bytes from an EBSP payload."""
    out = bytearray()
    zeros = 0
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        if zeros >= 2 and b == 3 and i + 1 < n and data[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)
