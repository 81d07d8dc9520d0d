"""The main path's settings and clip: bench.py:429-454's BatchEncoder
parameters and a torch twin of its synthetic clip (bench.py:91-135
make_synth_device: a smooth gradient, two moving sinusoid textures and
light noise, made on the device)."""

from __future__ import annotations

import numpy as np
import torch


def main_path_param(w: int, h: int, qp: int = 26, keyint: int = 50):
    """param_default() analysis with CQP at `qp`, CAVLC, IPPP `keyint`."""
    import x264dsp_tpu_torch as xtt
    p = xtt.param_default()
    p.i_width, p.i_height = w, h
    p.b_cabac = 0
    p.rc.i_rc_method = xtt.RC_CQP
    p.rc.i_qp_constant = qp
    p.i_keyint_max = keyint
    p.i_scenecut_threshold = 0
    p.rc.i_lookahead = 0
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


def stacked_slot(frame, t: int, S: int):
    """Slot t of S streams; stream s shows the clip at phase 1 + t + 3s.
    Returns stacked (S, H, W) y and (S, H/2, W/2) u, v."""
    fr = [frame(1.0 + t + 3 * s) for s in range(S)]
    return tuple(torch.stack([f[i] for f in fr]) for i in range(3))
