"""Frames of all streams whose NALs came back in the window, over the
window's wall time (the drain's slot included); host clock."""


def read(r):
    return r.frames_done / r.window_s if r.window_s > 0 else None
