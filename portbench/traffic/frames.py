"""The benchmark's frame generator: rings of distinct 1080p frames per
stream, made on the device from the seed.

Two scenes, both PyTorch rewrites of the port's measured clips, frozen
here so that a change to the port cannot move them:

- ``pan``: a smooth gradient under two moving sinusoid textures and a
  static luma noise (x264dsp_tpu_torch/tools/mainpath.py synth_clip),
  with a speed of 1-3 px per frame in a direction of its own per stream
  and the noise sigma cycled over the streams;
- ``split``: a textured base whose top half moves down and bottom half
  right, ``step_px`` per frame (mainpath.py split_motion_clip), with a
  start offset of its own per stream.

Each mix is a fixed set of S parts (speeds, directions, noise levels,
offsets); the seed deals the parts out to the streams and draws the
noise, so every seed asks the encoder for the same amount of work.

A stream's ring holds ``ring`` consecutive frames; slot i shows ring
entry ``walk(i)``, a triangle wave over the ring, so the motion reverses
at the ends and never jumps (a jump would be a free scene cut).
"""

from __future__ import annotations

import math

import torch


def walk(i: int, ring: int) -> int:
    """Ring entry of slot i: 0, 1, ..., ring-1, ring-2, ..., 1, 0, 1, ..."""
    if ring == 1:
        return 0
    k = i % (2 * (ring - 1))
    return k if k < ring else 2 * (ring - 1) - k


def _deal(seed: int, S: int) -> torch.Tensor:
    """The seed's permutation of the streams: stream s plays part
    perm[s] of the mix's fixed set."""
    g = torch.Generator().manual_seed(seed % (1 << 63))
    return torch.randperm(S, generator=g)


def _pan(traffic: dict, S: int, W: int, H: int, seed: int, device):
    """Part k of the mix: speed k of S evenly spaced over speed_px,
    direction k of S evenly spaced angles, noise sigma k of the cycled
    list and texture phase 37 k. Every seed gets the same parts, dealt
    to the streams in its own order, and its own noise draw: the seed
    moves the content and not the amount of motion the encoder has to
    find."""
    R = int(traffic["ring"])
    lo, hi = traffic["speed_px"]
    sig = traffic["noise_sigma"]
    perm = _deal(seed, S)
    y = torch.empty((R, S, H, W), dtype=torch.uint8, device=device)
    u = torch.empty((R, S, H // 2, W // 2), dtype=torch.uint8, device=device)
    v = torch.empty_like(u)
    yy = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    base = 96 + 48 * torch.sin(yy / 97.0) + 32 * torch.cos(xx / 131.0)
    yc, xc = yy[::2], xx[:, ::2]
    t = torch.arange(R, dtype=torch.float32, device=device)[:, None, None]
    g = torch.Generator(device=device)
    for s in range(S):
        k = int(perm[s])
        speed = lo + (hi - lo) * k / max(S - 1, 1)
        ang = 2 * math.pi * k / S
        t0 = 37.0 * k
        vx, vy = speed * math.cos(ang), speed * math.sin(ang)
        g.manual_seed((seed * 1000003 + s) % (1 << 63))
        noise = float(sig[k % len(sig)]) * torch.randn(
            (H, W), generator=g, device=device)
        dx, dy = vx * (t0 + t), vy * (t0 + t)
        tex = (28 * torch.sin((xx + dx) / 11.0 + (yy + dy) / 17.0)
               + 22 * torch.cos((xx - 1.7 * dx) / 23.0))
        y[:, s] = (base + tex + noise).clamp(0, 255).to(torch.uint8)
        u[:, s] = (120 + 40 * torch.sin((xc + dx) / 53.0)).clamp(
            0, 255).to(torch.uint8).expand(R, H // 2, W // 2)
        v[:, s] = (128 + 40 * torch.cos((yc + dy) / 47.0)).clamp(
            0, 255).to(torch.uint8).expand(R, H // 2, W // 2)
    return y, u, v


def _split(traffic: dict, S: int, W: int, H: int, seed: int, device):
    R = int(traffic["ring"])
    step = int(traffic["step_px"])
    lo, hi = traffic["offset_px"]
    if 8 + hi + step * (R - 1) + H > 2 * H or 8 + hi + step * (R - 1) + W \
            > 2 * W:
        raise ValueError("the ring walks beyond the base texture")
    perm = _deal(seed, S)
    y = torch.empty((R, S, H, W), dtype=torch.uint8, device=device)
    u = torch.empty((R, S, H // 2, W // 2), dtype=torch.uint8, device=device)
    v = torch.empty_like(u)
    yy = torch.arange(2 * H, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(2 * W, dtype=torch.float32, device=device)[None, :]
    tex = 110 + 70 * torch.sin(xx / 7.3) * torch.cos(yy / 5.1)
    xc = torch.arange(0, W, 2, dtype=torch.float32, device=device)[None, :]
    yc = torch.arange(0, H, 2, dtype=torch.float32, device=device)[:, None]
    g = torch.Generator(device=device)
    h2 = H // 2
    for s in range(S):
        # part k: offsets evenly spaced over offset_px (ox reversed)
        k = int(perm[s])
        oy = lo + (hi - lo) * k // max(S - 1, 1)
        ox = hi - (hi - lo) * k // max(S - 1, 1)
        g.manual_seed((seed * 1000003 + s) % (1 << 63))
        base = (tex + 4 * torch.randn((2 * H, 2 * W), generator=g,
                                      device=device)).clamp(0, 255).to(
            torch.uint8)
        for k in range(R):
            dk = step * k
            y[k, s, :h2] = base[8 + oy + dk:8 + oy + dk + h2,
                                8 + ox:8 + ox + W]
            y[k, s, h2:] = base[8 + oy:8 + oy + H - h2,
                                8 + ox + dk:8 + ox + dk + W]
            u[k, s] = (120 + 30 * torch.sin((xc + ox + dk) / 9.0)).clamp(
                0, 255).to(torch.uint8).expand(H // 2, W // 2)
            v[k, s] = (128 + 30 * torch.cos((yc + oy + dk) / 11.0)).clamp(
                0, 255).to(torch.uint8).expand(H // 2, W // 2)
    return y, u, v


SCENES = {"pan": _pan, "split": _split}


def make_ring(traffic: dict, W: int, H: int, seed: int, device):
    """The rings of all streams: y (ring, S, H, W), u and v (ring, S, H/2,
    W/2) uint8 on `device`, the same for the same seed."""
    S = int(traffic["streams"])
    return SCENES[traffic["scene"]](traffic, S, W, H, int(seed), device)
