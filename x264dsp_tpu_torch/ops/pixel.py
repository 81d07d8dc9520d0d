"""Pixel metrics — port of x264dsp_tpu/ops/pixel.py (SAD and SATD of
common/pixel.c, int32 over arbitrary leading batch dims, and the SSIM of
two planes)."""

from __future__ import annotations

import torch


def sad(a, b):
    """SAD over the last two dims: (..., H, W) -> (...,) int32."""
    d = a.to(torch.int32) - b.to(torch.int32)
    return d.abs().sum(dim=(-1, -2), dtype=torch.int32)


def _hadamard_abs(d4):
    """(..., 4, 4) diff blocks -> (...,) sum of |H . d . H^T| with the
    pixel.c butterfly order H = [[1,1,1,1],[1,-1,1,-1],[1,1,-1,-1],
    [1,-1,-1,1]]."""
    def butterfly(x0, x1, x2, x3):
        return (x0 + x1 + x2 + x3, x0 - x1 + x2 - x3,
                x0 + x1 - x2 - x3, x0 - x1 - x2 + x3)

    rows = butterfly(*(d4[..., i, :] for i in range(4)))   # combine rows
    t = torch.stack(rows, dim=-2)
    cols = butterfly(*(t[..., :, j] for j in range(4)))    # combine cols
    return torch.stack(cols, dim=-1).abs().sum(dim=(-1, -2),
                                               dtype=torch.int32)


def _blocks4(d):
    """(..., H, W) -> (..., H/4, W/4, 4, 4)."""
    *lead, H, W = d.shape
    return d.reshape(*lead, H // 4, 4, W // 4, 4).transpose(-3, -2)


def satd(a, b):
    """SATD with the reference's composition: W >= 8 -> per-8x4 halved
    sums (x264_pixel_satd_8x4 base, pixel.c:293-330); W == 4 -> per-4x4."""
    d = a.to(torch.int32) - b.to(torch.int32)
    W = d.shape[-1]
    habs = _hadamard_abs(_blocks4(d))            # (..., H/4, W/4)
    if W >= 8:
        pairs = habs.reshape(habs.shape[:-1] + (W // 8, 2)).sum(
            -1, dtype=torch.int32)
        return (pairs >> 1).sum(dim=(-1, -2), dtype=torch.int32)
    return (habs >> 1).sum(dim=(-1, -2), dtype=torch.int32)


def satd_4x4(a, b):
    """(..., 4, 4) -> (...,) — pixel_satd_4x4 (common/pixel.c:267-291)."""
    return _hadamard_abs(a.to(torch.int32) - b.to(torch.int32)) >> 1


def ssim_wxh(pix1, pix2):
    """Structural similarity of two (H, W) planes — pixel.py:80 ssim_wxh
    (x264_pixel_ssim_wxh, common/pixel.c:565-658): per-4x4-block integer
    sums over overlapping 8x8 windows (2x2 neighbouring blocks), x264's
    integer ssim_end1 constants, the ratio in float32. Returns (ssim_sum,
    cnt) with cnt = (h//4 - 1) * (w//4 - 1)."""
    h4, w4 = pix1.shape[0] // 4, pix1.shape[1] // 4
    a = pix1[:h4 * 4, :w4 * 4].to(torch.int64).reshape(h4, 4, w4, 4)
    b = pix2[:h4 * 4, :w4 * 4].to(torch.int64).reshape(h4, 4, w4, 4)
    s1, s2 = a.sum((1, 3)), b.sum((1, 3))
    ss = (a * a).sum((1, 3)) + (b * b).sum((1, 3))
    s12 = (a * b).sum((1, 3))

    def win(x):  # 2x2 block-window sums -> (h4-1, w4-1)
        return x[:-1, :-1] + x[:-1, 1:] + x[1:, :-1] + x[1:, 1:]

    fs1, fs2, fss, fs12 = win(s1), win(s2), win(ss), win(s12)
    c1 = int(.01 * .01 * 255 * 255 * 64 + .5)
    c2 = int(.03 * .03 * 255 * 255 * 64 * 63 + .5)
    vars_ = fss * 64 - fs1 * fs1 - fs2 * fs2
    covar = fs12 * 64 - fs1 * fs2
    f32 = torch.float32
    num = (2 * fs1 * fs2 + c1).to(f32) * (2 * covar + c2).to(f32)
    den = (fs1 * fs1 + fs2 * fs2 + c1).to(f32) * (vars_ + c2).to(f32)
    return (num / den).sum(), (h4 - 1) * (w4 - 1)
