"""Shared by tests/test_torch_me_walk.py and tests/test_torch_gpu.py: the
inputs of one DIA / HEX full-pel walk (ops/me_walk.pattern_walk) drawn at
random, and a per-MB sequential walk in plain Python, the loop that the
kernel csrc/me_walk.cu runs in each thread. JAX-free."""

import numpy as np
import torch

from x264dsp_tpu_torch import params as P
from x264dsp_tpu_torch.encoder.inter_frame import fullpel_bounds
from x264dsp_tpu_torch.ops import me_walk as ME


def walk_case(seed: int, S: int, mb_w: int, mb_h: int, R: int, lanes: bool,
              later: bool, cut: bool, device="cpu"):
    """pattern_walk's arguments (surf16, lanes, lam, bounds, prev, R) as
    int32 tensors on `device`. Each MB's surface is a bowl around a target
    up to R + 2 from the origin plus noise of its own scale (from none to
    ten times the bowl's steepest step), so walks run from one step to
    the cap; lambda 0..40. With `cut` the legal range is drawn per row and
    column (it may exclude (0, 0), the MVP's point or everything),
    otherwise it is the frame's (fullpel_bounds at mv_range 2048). With
    `later`, prev is a full-pel field in [-2R, 2R], so MVPs and candidates
    fall outside [-R, R]; otherwise None (the first walk)."""
    rng = np.random.default_rng(seed)
    n = 2 * R + 1
    shape = (S, mb_h, mb_w)
    off = np.arange(-R, R + 1)
    tx, ty = (rng.integers(-R - 2, R + 3, shape) for _ in range(2))
    a, b = (rng.integers(1, 200, shape) for _ in range(2))
    amp = rng.integers(0, 10, shape) * np.maximum(a, b)
    surf = (a[..., None, None] * np.abs(off[None, :] - tx[..., None, None])
            + b[..., None, None] * np.abs(off[:, None] - ty[..., None, None])
            + (rng.random(shape + (n, n)) * amp[..., None, None]).astype(
                np.int64))                           # (S, mb_h, mb_w, n, n)
    if lanes:
        surf = surf.transpose(0, 1, 3, 4, 2)         # (S, mb_h, n, n, mb_w)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int32,
                               device=device)
    if cut:
        bounds = tuple(t(rng.integers(lo, hi, size)) for lo, hi, size in (
            (-R - 3, 3, mb_w), (-3, R + 4, mb_w), (-R - 3, 3, mb_h),
            (-3, R + 4, mb_h)))
    else:
        bounds = tuple(x.to(device) for x in fullpel_bounds(mb_w, mb_h, 2048,
                                                            "cpu"))
    prev = t(rng.integers(-2 * R, 2 * R + 1, shape + (2,))) if later else None
    return (t(np.minimum(surf, 65280)), lanes, t(rng.integers(0, 41, shape)),
            bounds, prev, R)


def serial_walk(surf16, lanes, lam, bounds, prev, R, method):
    """The walk of each MB on its own, in plain Python: the median MVP of
    the previous field (zero on the first walk), its full-pel point costed
    without bias, the candidates (the MB's previous MV, left, top,
    top-right) and (0, 0) with lambda * mv_bits, then diamonds or
    hexagons until a step leaves the centre where it was, HEX's square.
    Returns (best (S, mb_h, mb_w, 2), cost (S, mb_h, mb_w), mvp (S, mb_h,
    mb_w, 2)) int32 tensors and the number of legal surface reads."""
    surf = surf16.numpy()
    if lanes:
        surf = surf.transpose(0, 1, 4, 2, 3)        # (S, mb_h, mb_w, n, n)
    S, mb_h, mb_w = surf.shape[:3]
    lo_x, hi_x, lo_y, hi_y = (b.tolist() for b in bounds)
    lam = lam.numpy()
    pv = None if prev is None else prev.numpy()
    bits = ME._MVBITS
    best = np.zeros((S, mb_h, mb_w, 2), np.int32)
    cost = np.zeros((S, mb_h, mb_w), np.int32)
    mvps = np.zeros((S, mb_h, mb_w, 2), np.int32)
    reads = 0
    for s in range(S):
        for y in range(mb_h):
            for x in range(mb_w):
                if pv is None:
                    mvp, cands = [0, 0], []
                else:
                    def nb(yy, xx, ok):
                        return [int(v) for v in pv[s, yy, xx]] if ok \
                            else [0, 0]
                    ok_a, ok_b = x >= 1, y >= 1
                    ok_c, ok_d = y >= 1 and x + 1 < mb_w, y >= 1 and x >= 1
                    left, top = nb(y, x - 1, ok_a), nb(y - 1, x, ok_b)
                    top_r = nb(y - 1, x + 1, ok_c)
                    c_mv = top_r if ok_c else nb(y - 1, x - 1, ok_d)
                    count = ok_a + ok_b + (ok_c or ok_d)
                    mvp = []
                    for k in range(2):
                        v = [4 * left[k], 4 * top[k], 4 * c_mv[k]]
                        mvp.append(v[0] if count == 1 and ok_a
                                   else v[1] if count == 1 and ok_b
                                   else v[2] if count == 1
                                   else sorted(v)[1])
                    cands = [nb(y, x, True), left, top, top_r]
                lam_mb = int(lam[s, y, x])

                def at(px, py, bias=True):
                    nonlocal reads
                    if not (lo_x[x] <= px <= hi_x[x] and lo_y[y] <= py
                            <= hi_y[y] and abs(px) <= R and abs(py) <= R):
                        return ME.BIG
                    reads += 1
                    c = int(surf[s, y, x, py + R, px + R])
                    if bias:
                        c += lam_mb * (
                            int(bits[min(abs(4 * px - mvp[0]), 4095)])
                            + int(bits[min(abs(4 * py - mvp[1]), 4095)]))
                    return c

                def clamp(v):
                    return min(max(v, -R), R)
                bx, by = clamp((mvp[0] + 2) >> 2), clamp((mvp[1] + 2) >> 2)
                bcost = at(bx, by, bias=False)
                for cx, cy in cands:
                    cx, cy = clamp(cx), clamp(cy)
                    c = at(cx, cy)
                    if c < bcost:
                        bcost, bx, by = c, cx, cy
                if (bx, by) != (0, 0):
                    c = at(0, 0)
                    if c < bcost:
                        bcost, bx, by = c, 0, 0

                def step(pts):
                    nonlocal bcost, bx, by
                    ox, oy = bx, by
                    for dx, dy in pts:
                        c = at(ox + dx, oy + dy)
                        if c < bcost:
                            bcost, bx, by = c, ox + dx, oy + dy
                    return (bx, by) != (ox, oy)
                if method == P.ME_DIA:
                    for _ in range(R):
                        if not step(ME._DIA_PTS):
                            break
                else:
                    for _ in range(max(R >> 1, 1)):
                        if not step(ME._HEX_PTS):
                            break
                    step(ME._SQUARE_PTS)
                best[s, y, x] = bx, by
                cost[s, y, x] = bcost
                mvps[s, y, x] = mvp
    return (torch.from_numpy(best), torch.from_numpy(cost),
            torch.from_numpy(mvps), reads)
