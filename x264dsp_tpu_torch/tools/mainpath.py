"""The measured configurations' settings and clips.

- main path: bench.py:429-454's BatchEncoder parameters and a torch twin
  of its synthetic clip (bench.py:91-135 make_synth_device: a smooth
  gradient, two moving sinusoid textures and light noise, made on the
  device);
- faster-1ref: x264's ``--preset faster`` analysis (HEX search, subme 4,
  the p8x8 partitions) cut to what the baseline BatchEncoder codes (no
  i8x8, one reference, no B-frames), on a device twin of the
  split-motion clip of tests/test_partitions.py:21 (two halves moving
  in different directions, so partitions win on some MBs).

The parameter helpers set their fields on ``p`` when given (any Param
with the package's fields: the tests pass the JAX package's so that both
encoders get the same settings), else on the port's ``param_default()``.
"""

from __future__ import annotations

import numpy as np
import torch


def main_path_param(w: int, h: int, qp: int = 26, keyint: int = 50, p=None):
    """param_default() analysis with CQP at `qp`, CAVLC, IPPP `keyint`."""
    from .. import params as P
    p = P.param_default() if p is None else p
    p.i_width, p.i_height = w, h
    p.b_cabac = 0
    p.rc.i_rc_method = P.RC_CQP
    p.rc.i_qp_constant = qp
    p.i_keyint_max = keyint
    p.i_scenecut_threshold = 0
    p.rc.i_lookahead = 0
    return p


def faster_1ref_param(w: int, h: int, qp: int = 26, keyint: int = 50,
                      p=None):
    """The main path's settings with x264 --preset faster's P analysis:
    HEX over +-16, subme 4, 16x8/8x16/8x8 partitions, fast P-skip and DCT
    decimation on, one reference."""
    from .. import params as P
    p = main_path_param(w, h, qp, keyint, p)
    a = p.analyse
    a.inter = P.ANALYSE_PSUB16x16
    a.i_me_method = P.ME_HEX
    a.i_subpel_refine = 4
    a.i_me_range = 16
    a.b_fast_pskip = 1
    a.b_dct_decimate = 1
    p.i_frame_reference = 1
    return p


def synth_clip(w: int, h: int, device):
    """Returns frame(t) -> (y, u, v) uint8 planes of size h x w on
    `device`; t is the (fractional) frame phase."""
    rng = np.random.default_rng(0)
    noise = torch.as_tensor(rng.normal(0, 2.0, (h, w)).astype(np.float32),
                            device=device)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None] \
        .expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :] \
        .expand(h, w)
    base = 96 + 48 * torch.sin(yy / 97.0) + 32 * torch.cos(xx / 131.0)

    def frame(t: float):
        dx, dy = 2.6 * t, 1.3 * t
        tex = (28 * torch.sin((xx + dx) / 11.0 + (yy + dy) / 17.0)
               + 22 * torch.cos((xx - 1.7 * dx) / 23.0))
        y = (base + tex + noise).clamp(0, 255).to(torch.uint8)
        yc, xc = yy[::2, ::2], xx[::2, ::2]
        u = (120 + 40 * torch.sin((xc + dx) / 53.0)).clamp(0, 255) \
            .to(torch.uint8)
        v = (128 + 40 * torch.cos((yc + dy) / 47.0)).clamp(0, 255) \
            .to(torch.uint8)
        return y, u, v
    return frame


def split_motion_clip(w: int, h: int, device, seed: int = 11):
    """Device twin of tests/test_partitions.py:21 _split_motion_clip:
    frame(t) -> (y, u, v) uint8 planes on `device`, equal to that clip's
    frame t (integer t). The top half moves down and the bottom half
    right, 3 px per frame, over a textured base made once with numpy
    (the same seed and draws) and kept on the device."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h * 2, 0:w * 2]
    base = (110 + 70 * np.sin(xx / 7.3) * np.cos(yy / 5.1)
            + rng.normal(0, 4, (h * 2, w * 2))).clip(0, 255)
    base = torch.as_tensor(base.astype(np.uint8), device=device)
    xc, yc = xx[:h:2, :w:2], yy[:h:2, :w:2]

    def frame(t: float):
        d = 3 * int(t)
        if 8 + d + h // 2 > 2 * h:
            raise ValueError(f"frame {t} lies beyond the base texture")
        y = torch.cat([base[8 + d:8 + d + h // 2, 8:8 + w],
                       base[8:8 + h - h // 2, 8 + d:8 + d + w]])
        u = (120 + 30 * np.sin((xc + d) / 9.0)).clip(0, 255)
        v = (128 + 30 * np.cos((yc + d) / 11.0)).clip(0, 255)
        return (y, torch.as_tensor(u.astype(np.uint8), device=device),
                torch.as_tensor(v.astype(np.uint8), device=device))
    return frame


def stacked_slot(frame, t: int, S: int):
    """Slot t of S streams; stream s shows the clip at phase 1 + t + 3s.
    Returns stacked (S, H, W) y and (S, H/2, W/2) u, v."""
    fr = [frame(1.0 + t + 3 * s) for s in range(S)]
    return tuple(torch.stack([f[i] for f in fr]) for i in range(3))
