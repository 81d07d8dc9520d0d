"""Raw YUV (I420) file demuxer — equivalent of the reference CLI's input.c.

Parses ``WxH`` from the filename (input.c:117-121), derives the frame count
from the file size (input.c:143-150), and supports seeking by frame index
(input.c:172-173). Returns planar I420 NumPy arrays.

Copied from x264dsp_tpu/utils/yuv.py.
"""

from __future__ import annotations

import os
import re

import numpy as np


_RES_RE = re.compile(r"(\d+)x(\d+)")


def parse_resolution(filename: str) -> tuple[int, int]:
    """Extract WxH from a filename like ``foreman_352x288.yuv``."""
    matches = _RES_RE.findall(os.path.basename(filename))
    if not matches:
        raise ValueError(f"cannot parse WxH from filename: {filename!r}")
    w, h = map(int, matches[-1])
    return w, h


class YUVReader:
    def __init__(self, path: str, width: int | None = None,
                 height: int | None = None):
        if width is None or height is None:
            width, height = parse_resolution(path)
        self.width = width
        self.height = height
        self.frame_size = width * height * 3 // 2
        self._f = open(path, "rb")
        self.num_frames = os.fstat(self._f.fileno()).st_size // self.frame_size

    def read_frame(self, index: int | None = None):
        """Return (y, u, v) uint8 planes, or None at EOF."""
        if index is not None:
            self._f.seek(index * self.frame_size)
        data = self._f.read(self.frame_size)
        if len(data) < self.frame_size:
            return None
        w, h = self.width, self.height
        buf = np.frombuffer(data, dtype=np.uint8)
        y = buf[:w * h].reshape(h, w)
        u = buf[w * h:w * h + w * h // 4].reshape(h // 2, w // 2)
        v = buf[w * h + w * h // 4:].reshape(h // 2, w // 2)
        return y, u, v

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_yuv(path: str, frames) -> None:
    """Write a list of (y, u, v) planes as raw I420."""
    with open(path, "wb") as f:
        for y, u, v in frames:
            f.write(np.ascontiguousarray(y, dtype=np.uint8).tobytes())
            f.write(np.ascontiguousarray(u, dtype=np.uint8).tobytes())
            f.write(np.ascontiguousarray(v, dtype=np.uint8).tobytes())
