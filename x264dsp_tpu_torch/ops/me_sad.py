"""Full-pel 16x16 SAD cost surface — port of
x264dsp_tpu/ops/pallas/me_sad.py (``make_ref_strips`` and
``sad_cost_surface16_lanes``).

``sad_cost_surface16_lanes`` launches kernel K1 (``csrc/me_sad.cu``) on a
CUDA tensor and runs ``sad_cost_surface16_lanes_plain`` on a CPU tensor.
Both return the lane layout [row, dy, dx, mbx] that the DIA walk reads,
with a leading stream axis. K1 replaces the Pallas kernel ``_kernel16``;
on the H100 it is bound by load issue (2 x 256 int32 reads per output,
cached in L1/L2), and the TPU's hi/lo-byte bf16 dot becomes plain int32
sums (see the source note in the .cu).
"""

from __future__ import annotations

import torch

from .. import _build

launches = 0            # K1 launches (chip_smoke.py checks the main path)


def make_ref_strips(ref_full_pad, pad: int, mb_w: int, mb_h: int, R: int):
    """(S, Hp, Wp) padded full-pel planes -> (S, mb_h, 16+2R, 16mb_w+2R)
    search strips: strip i covers rows 16i-R .. 16i+15+R."""
    dev = ref_full_pad.device
    rows = (torch.arange(mb_h, device=dev)[:, None] * 16 + pad - R
            + torch.arange(16 + 2 * R, device=dev)[None, :])
    cols = pad - R + torch.arange(16 * mb_w + 2 * R, device=dev)
    return ref_full_pad[:, rows[:, :, None], cols[None, None, :]].contiguous()


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
    """Kernel K1 (arguments as the plain version, int32 CUDA tensors)."""
    global launches
    S = fenc_y.shape[0]
    n = 2 * R + 1
    _build.require_cuda(fenc_y, torch.int32, (S, 16 * mb_h, 16 * mb_w),
                        "fenc_y")
    _build.require_cuda(strips, torch.int32,
                        (S, mb_h, 16 + 2 * R, 16 * mb_w + 2 * R), "strips")
    out = torch.empty((S, mb_h, n, n, mb_w), dtype=torch.int32,
                      device=fenc_y.device)
    code = _build.lib().x264t_sad_surface16(
        fenc_y.data_ptr(), strips.data_ptr(), out.data_ptr(), S, mb_h, mb_w,
        R, _build.stream_ptr(fenc_y.device))
    _build.check(code, "x264t_sad_surface16")
    launches += 1
    return out


def sad_cost_surface16_lanes(fenc_y, strips, mb_w: int, mb_h: int, R: int):
    fn = (sad_cost_surface16_lanes_cuda if fenc_y.is_cuda
          else sad_cost_surface16_lanes_plain)
    return fn(fenc_y, strips, mb_w, mb_h, R)
