"""Full-pel SAD cost surfaces — port of x264dsp_tpu/ops/pallas/me_sad.py
(``make_ref_strips``, ``sad_cost_surface16_lanes`` and
``sad_cost_surfaces_8x8``).

``sad_cost_surface16_lanes`` launches kernel K1 and
``sad_cost_surfaces_8x8`` kernel K4 (both in ``csrc/me_sad.cu``) on a
CUDA tensor and runs its ``*_plain`` version on a CPU tensor. K1 returns
the lane layout [row, dy, dx, mbx] that the no-partitions walk reads;
K4 returns the four 8x8-quadrant surfaces in the JAX layout [row, mbx,
qy, qx, dy, dx] that partition analysis reads; both with a leading
stream axis. K1 replaces the Pallas kernel ``_kernel16`` and K4
``_kernel``. On the H100 both pack the pixels to bytes in shared-memory
search tiles and sum four absolute differences per instruction
(``vabsdiff4`` with accumulate), where the TPU kernels took a hi/lo-byte
bf16 dot (see the source note in the .cu).

Precondition of the kernels: every value of ``fenc_y`` and ``strips`` is
a pixel, 0..255 (the kernels use the low byte of each int32). The
dispatchers ``sad_cost_surface16_lanes`` / ``sad_cost_surfaces_8x8``
check it on either device (``check_pixels``: one ``aminmax`` per input
and one host sync) and raise on other values, so that the CPU and the
card refuse the same inputs; the ``*_cuda`` launchers do not scan.
"""

from __future__ import annotations

import torch

from .. import _build

# CUDA launches of K1 / K4 (chip_smoke.py checks the main paths)
launches = {"sad_surface16": 0, "sad_surfaces_8x8": 0}


def make_ref_strips(ref_full_pad, pad: int, mb_w: int, mb_h: int, R: int):
    """(S, Hp, Wp) padded full-pel planes -> (S, mb_h, 16+2R, 16mb_w+2R)
    search strips: strip i covers rows 16i-R .. 16i+15+R."""
    dev = ref_full_pad.device
    rows = (torch.arange(mb_h, device=dev)[:, None] * 16 + pad - R
            + torch.arange(16 + 2 * R, device=dev)[None, :])
    cols = pad - R + torch.arange(16 * mb_w + 2 * R, device=dev)
    return ref_full_pad[:, rows[:, :, None], cols[None, None, :]].contiguous()


def _check_args(fenc_y, strips, mb_w: int, mb_h: int, R: int):
    S = fenc_y.shape[0]
    _build.require_cuda(fenc_y, torch.int32, (S, 16 * mb_h, 16 * mb_w),
                        "fenc_y")
    _build.require_cuda(strips, torch.int32,
                        (S, mb_h, 16 + 2 * R, 16 * mb_w + 2 * R), "strips")


def check_pixels(fenc_y, strips) -> None:
    """Raise ValueError unless every value of both inputs is 0..255."""
    lo_hi = torch.stack([*torch.aminmax(fenc_y), *torch.aminmax(strips)])
    lo_f, hi_f, lo_s, hi_s = lo_hi.tolist()
    if min(lo_f, lo_s) < 0 or max(hi_f, hi_s) > 255:
        raise ValueError("SAD surfaces: fenc_y and strips must hold pixels "
                         f"0..255, got {min(lo_f, lo_s)}..{max(hi_f, hi_s)}")


def sad_cost_surface16_lanes_plain(fenc_y, strips, mb_w: int, mb_h: int,
                                   R: int):
    """fenc_y (S, 16mb_h, 16mb_w) int32, strips from make_ref_strips ->
    (S, mb_h, 2R+1, 2R+1, mb_w) int32 whole-MB SADs."""
    S = fenc_y.shape[0]
    W = 16 * mb_w
    n = 2 * R + 1
    f = fenc_y.to(torch.int32).reshape(S, mb_h, 16, W)
    out = torch.empty((S, mb_h, n, n, mb_w), dtype=torch.int32,
                      device=fenc_y.device)
    for dy in range(n):
        rows = strips[:, :, dy:dy + 16, :]
        for dx in range(n):
            ad = (f - rows[..., dx:dx + W]).abs()
            out[:, :, dy, dx, :] = ad.reshape(S, mb_h, 16, mb_w, 16).sum(
                dim=(2, 4), dtype=torch.int32)
    return out


def sad_cost_surface16_lanes_cuda(fenc_y, strips, mb_w: int, mb_h: int,
                                  R: int):
    """Kernel K1 (arguments as the plain version, int32 CUDA tensors
    holding values 0..255)."""
    S = fenc_y.shape[0]
    n = 2 * R + 1
    _check_args(fenc_y, strips, mb_w, mb_h, R)
    out = torch.empty((S, mb_h, n, n, mb_w), dtype=torch.int32,
                      device=fenc_y.device)
    code = _build.lib().x264t_sad_surface16(
        fenc_y.data_ptr(), strips.data_ptr(), out.data_ptr(), S, mb_h, mb_w,
        R, _build.stream_ptr(fenc_y.device))
    _build.check(code, "x264t_sad_surface16")
    _build.count_launch(launches, "sad_surface16")
    return out


def sad_cost_surface16_lanes(fenc_y, strips, mb_w: int, mb_h: int, R: int):
    check_pixels(fenc_y, strips)
    fn = (sad_cost_surface16_lanes_cuda if fenc_y.is_cuda
          else sad_cost_surface16_lanes_plain)
    return fn(fenc_y, strips, mb_w, mb_h, R)


def sad_cost_surfaces_8x8_plain(fenc_y, strips, mb_w: int, mb_h: int,
                                R: int):
    """fenc_y (S, 16mb_h, 16mb_w) int32, strips from make_ref_strips ->
    (S, mb_h, mb_w, 2, 2, 2R+1, 2R+1) int32 quadrant SADs [qy][qx] at
    every full-pel offset (the per-offset loop of
    x264dsp_tpu/encoder/inter_frame.py:118-134)."""
    S = fenc_y.shape[0]
    W = 16 * mb_w
    n = 2 * R + 1
    f = fenc_y.to(torch.int32).reshape(S, mb_h, 16, W)
    out = torch.empty((S, mb_h, mb_w, 2, 2, n, n), dtype=torch.int32,
                      device=fenc_y.device)
    for dy in range(n):
        rows = strips[:, :, dy:dy + 16, :]
        for dx in range(n):
            ad = (f - rows[..., dx:dx + W]).abs()
            tile = ad.reshape(S, mb_h, 2, 8, mb_w, 2, 8).sum(
                dim=(3, 6), dtype=torch.int32)      # (S, mb_h, qy, mb_w, qx)
            out[..., dy, dx] = tile.permute(0, 1, 3, 2, 4)
    return out


def sad_cost_surfaces_8x8_cuda(fenc_y, strips, mb_w: int, mb_h: int,
                               R: int):
    """Kernel K4 (arguments as the plain version, int32 CUDA tensors
    holding values 0..255)."""
    S = fenc_y.shape[0]
    n = 2 * R + 1
    _check_args(fenc_y, strips, mb_w, mb_h, R)
    out = torch.empty((S, mb_h, mb_w, 2, 2, n, n), dtype=torch.int32,
                      device=fenc_y.device)
    code = _build.lib().x264t_sad_surfaces_8x8(
        fenc_y.data_ptr(), strips.data_ptr(), out.data_ptr(), S, mb_h, mb_w,
        R, _build.stream_ptr(fenc_y.device))
    _build.check(code, "x264t_sad_surfaces_8x8")
    _build.count_launch(launches, "sad_surfaces_8x8")
    return out


def sad_cost_surfaces_8x8(fenc_y, strips, mb_w: int, mb_h: int, R: int):
    check_pixels(fenc_y, strips)
    fn = (sad_cost_surfaces_8x8_cuda if fenc_y.is_cuda
          else sad_cost_surfaces_8x8_plain)
    return fn(fenc_y, strips, mb_w, mb_h, R)
