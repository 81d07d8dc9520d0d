"""Shared by tests/test_torch_deblock_routes.py and tests/test_torch_gpu.py:
filter lanes for the wave deblock (K5a / K5b) drawn at random. JAX-free."""

import numpy as np

from x264dsp_tpu_torch.ops.deblock import diag_slots


def random_lanes(rng, S: int, mb_w: int, mb_h: int, border: bool = True):
    """Lanes in the layout of ``ops.deblock.wave_lanes`` (luma tc0y, eny,
    uiy, aly, bly; chroma tcc, enc, uic, alc, blc with (u, v) slot pairs),
    int32 numpy arrays, with every edge of every MB enabled: tc0 in
    -1..25 per pixel line (chroma tc0 + 1), alpha 0..255, beta 0..18,
    intra flags 0 or 1 per edge. With ``border`` the edges on the frame's
    left and top border are enabled too; without it they are off (the
    draws are the same). Unused slots have every enable 0, as the lanes'
    contract asks."""
    ys, xs = diag_slots(mb_w, mb_h)
    D, K = ys.shape
    out = []
    for NP, E, N in ((1, 4, 16), (2, 2, 8)):   # luma; chroma (u, v)
        shp = (S, D, NP * K)
        tc = rng.integers(-1, 26, shp + (2 * E * N,)) + (NP - 1)
        ui = rng.integers(0, 2, shp + (2 * E,))
        al = rng.integers(0, 256, shp + (2 * E,))
        bl = rng.integers(0, 19, shp + (2 * E,))
        en = np.ones(shp + (2 * E,), np.int64)
        en[:, np.repeat(ys < 0, NP, axis=1)] = 0
        if not border:
            en[:, np.repeat(xs == 0, NP, axis=1), 0] = 0      # left
            en[:, np.repeat(ys == 0, NP, axis=1), E] = 0      # top
        out.append(tuple(a.astype(np.int32) for a in (tc, en, ui, al, bl)))
    return out
