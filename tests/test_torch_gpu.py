"""GPU checks of the port's CUDA kernels (marked `gpu`; skipped without a
CUDA device). JAX-free, so they also run on a machine without JAX:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py

Each CUDA kernel must equal its plain PyTorch version on the same CUDA
tensors and count its launch; the wrappers must refuse bad arguments.
"""

import numpy as np
import pytest
import torch

import x264dsp_tpu_torch as xtt
from x264dsp_tpu_torch.ops import deblock as TDB
from x264dsp_tpu_torch.ops import mc as TMC
from x264dsp_tpu_torch.ops import mcgather as TMG
from x264dsp_tpu_torch.ops import me_sad as TSAD

MB_W, MB_H, R = 6, 4, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    return torch.device("cuda")


def _case(cuda, seed=0, S=3):
    rng = np.random.default_rng(seed)
    H, W = MB_H * 16, MB_W * 16

    def t(a, dt=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=cuda)
    recon = t(rng.integers(0, 256, (S, H, W)), torch.uint8)
    return dict(fenc=t(rng.integers(0, 256, (S, H, W))),
                ref4=TMC.make_ref_planes(recon).contiguous(),
                refc=TMC.pad_chroma(t(rng.integers(0, 256, (S, H // 2, W // 2)),
                                      torch.uint8)).contiguous(), t=t,
                rng=rng, S=S)


@pytest.mark.gpu
def test_sad_surface_kernel_matches_plain(cuda):
    c = _case(cuda)
    strips = TSAD.make_ref_strips(c["ref4"][:, 0], TMC.PAD_MC, MB_W, MB_H, R)
    n0 = TSAD.launches["sad_surface16"]
    got = TSAD.sad_cost_surface16_lanes(c["fenc"], strips, MB_W, MB_H, R)
    want = TSAD.sad_cost_surface16_lanes_plain(c["fenc"], strips, MB_W, MB_H,
                                               R)
    assert torch.equal(got, want)
    assert TSAD.launches["sad_surface16"] == n0 + 1


@pytest.mark.gpu
def test_sad_surfaces_8x8_kernel_matches_plain(cuda):
    """K4 against its plain version, and its quadrant sums against K1."""
    c = _case(cuda, 5)
    strips = TSAD.make_ref_strips(c["ref4"][:, 0], TMC.PAD_MC, MB_W, MB_H, R)
    n0 = TSAD.launches["sad_surfaces_8x8"]
    got = TSAD.sad_cost_surfaces_8x8(c["fenc"], strips, MB_W, MB_H, R)
    torch.cuda.synchronize()
    assert TSAD.launches["sad_surfaces_8x8"] == n0 + 1
    want = TSAD.sad_cost_surfaces_8x8_plain(c["fenc"], strips, MB_W, MB_H, R)
    assert torch.equal(got, want)
    lanes = TSAD.sad_cost_surface16_lanes(c["fenc"], strips, MB_W, MB_H, R)
    assert torch.equal(got.sum((3, 4), dtype=torch.int32),
                       lanes.permute(0, 1, 4, 2, 3))


@pytest.mark.gpu
def test_window_kernels_match_plain(cuda):
    c = _case(cuda, 1)
    assert torch.equal(TMG.luma_windows(c["ref4"], MB_W, MB_H),
                       TMG.luma_windows_plain(c["ref4"], MB_W, MB_H))
    assert torch.equal(TMG.chroma_windows(c["refc"], MB_W, MB_H),
                       TMG.chroma_windows_plain(c["refc"], MB_W, MB_H))


@pytest.mark.gpu
@pytest.mark.parametrize("intra", [False, True])
def test_deblock_kernel_matches_plain(cuda, intra):
    c = _case(cuda, 2)
    t, rng, S = c["t"], c["rng"], c["S"]
    H, W = MB_H * 16, MB_W * 16
    grid = (S, MB_H, MB_W)
    y = np.kron(rng.integers(0, 256, (S, MB_H * 4, MB_W * 4)),
                np.ones((1, 4, 4), int)) + rng.integers(-6, 7, (S, H, W))
    u = np.kron(rng.integers(0, 256, (S, MB_H * 2, MB_W * 2)),
                np.ones((1, 4, 4), int))
    qp = rng.integers(16, 50, grid)
    if intra:
        bs, im, feo = np.full(grid + (2, 4, 4), 3), np.ones(grid), \
            np.zeros(grid)
    else:
        bs, im = rng.integers(0, 3, grid + (2, 4, 4)), np.zeros(grid)
        feo = rng.random(grid) < 0.2
    args = [t(a) for a in (y.clip(0, 255), u, 255 - u, bs, im, feo, qp,
                           np.minimum(qp, 39))]
    got = TDB.deblock_frame(*args, 2, -2, MB_W, MB_H)
    want = TDB.deblock_frame_plain(*args, 2, -2, MB_W, MB_H)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _deblock_args(c, intra):
    t, rng, S = c["t"], c["rng"], c["S"]
    H, W = MB_H * 16, MB_W * 16
    grid = (S, MB_H, MB_W)
    y = np.kron(rng.integers(0, 256, (S, MB_H * 4, MB_W * 4)),
                np.ones((1, 4, 4), int)) + rng.integers(-6, 7, (S, H, W))
    u = np.kron(rng.integers(0, 256, (S, MB_H * 2, MB_W * 2)),
                np.ones((1, 4, 4), int))
    qp = rng.integers(16, 50, grid)
    if intra:
        bs, im, feo = np.full(grid + (2, 4, 4), 3), np.ones(grid), \
            np.zeros(grid)
    else:
        im = (rng.random(grid) < 0.3).astype(int)
        bs = rng.integers(0, 3, grid + (2, 4, 4))
        bs[im > 0] = 3
        feo = (rng.random(grid) < 0.2) & (im == 0)
    return [t(a) for a in (y.clip(0, 255), u, 255 - u, bs, im, feo, qp,
                           np.minimum(qp, 39))]


@pytest.mark.gpu
@pytest.mark.parametrize("intra", [False, True])
def test_wave_kernels_match_plain(cuda, intra):
    """K5a and K5b against their plain versions on the same lanes, and the
    wave route against K3."""
    args = _deblock_args(_case(cuda, 6), intra)
    luma_l, chroma_l = TDB.wave_lanes(*args[3:], 2, -2, MB_W, MB_H)
    n0 = dict(TDB.launches)
    gy = TDB.deblock_wave_luma(args[0], *luma_l, MB_W, MB_H)
    gu, gv = TDB.deblock_wave_chroma(args[1], args[2], *chroma_l, MB_W, MB_H)
    torch.cuda.synchronize()
    assert TDB.launches["deblock_wave_luma"] == n0["deblock_wave_luma"] + 1
    assert TDB.launches["deblock_wave_chroma"] == \
        n0["deblock_wave_chroma"] + 1
    assert torch.equal(gy, TDB.deblock_wave_luma_plain(args[0], *luma_l,
                                                       MB_W, MB_H))
    wu, wv = TDB.deblock_wave_chroma_plain(args[1], args[2], *chroma_l,
                                           MB_W, MB_H)
    assert torch.equal(gu, wu) and torch.equal(gv, wv)
    k3 = TDB.deblock_frame(*args, 2, -2, MB_W, MB_H)
    for g, w in zip((gy, gu, gv), k3):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("intra", [False, True])
def test_filter_regions_kernel_matches_plain(cuda, intra):
    """K6 against its plain version on random regions with a frame's
    lanes, and the region route against K3 (one launch per diagonal)."""
    c = _case(cuda, 7)
    args = _deblock_args(c, intra)
    luma_l, chroma_l = TDB.wave_lanes(*args[3:], 0, 0, MB_W, MB_H)
    K = 48
    ly = [t.reshape(-1, t.shape[-1])[:K].contiguous() for t in luma_l]
    lc = [t.reshape(-1, t.shape[-1])[:2 * K].contiguous() for t in chroma_l]
    regy = c["t"](c["rng"].integers(0, 256, (K, 20, 20)))
    regc = c["t"](c["rng"].integers(0, 256, (2 * K, 12, 12)))
    lanes = (ly[0], lc[0], ly[1], ly[2], lc[1], lc[2], ly[3], ly[4], lc[3],
             lc[4])
    n0 = TDB.launches["filter_regions"]
    got = TDB.filter_regions(regy, regc, *lanes)
    torch.cuda.synchronize()
    assert TDB.launches["filter_regions"] == n0 + 1
    want = TDB.filter_regions_plain(regy, regc, *lanes)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        TDB.filter_regions(regy[:5], regc[:10], *(t[:5] for t in lanes))
    n0 = TDB.launches["filter_regions"]
    routed = TDB.deblock_frame(*args, 0, 0, MB_W, MB_H, route="region")
    assert TDB.launches["filter_regions"] == n0 + MB_W + 2 * MB_H - 2
    for g, w in zip(routed, TDB.deblock_frame(*args, 0, 0, MB_W, MB_H)):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_device_payload_matches_host_writers(cuda):
    """An I and two P slots on the card (faster-1ref, so partitioned MBs):
    every stream's device payload against the host C++ writers on the
    pulled syntax."""
    from x264dsp_tpu_torch.tools.mainpath import (faster_1ref_param,
                                                  payload_vs_writers,
                                                  split_motion_clip,
                                                  stacked_slot)
    S, w, h = 2, 64, 64
    be = xtt.BatchEncoder(faster_1ref_param(w, h, 26, 8), S)
    be.keep_syntax = True
    frame = split_motion_clip(w, h, cuda)
    for t in range(3):
        be.encode_batch(tuple(torch.stack([frame(1 + t + s)[i]
                                           for s in range(S)])
                              for i in range(3)))
        assert min(payload_vs_writers(be)) > 0
    be.close()


@pytest.mark.gpu
def test_wrappers_reject_bad_arguments(cuda):
    c = _case(cuda, 3)
    with pytest.raises(ValueError):
        TMG.luma_windows_cuda(c["ref4"].to(torch.int64), MB_W, MB_H)
    with pytest.raises(ValueError):
        TMG.chroma_windows_cuda(c["refc"][:, :, ::2], MB_W, MB_H)
    strips = TSAD.make_ref_strips(c["ref4"][:, 0], TMC.PAD_MC, MB_W, MB_H, R)
    with pytest.raises(ValueError):
        TSAD.sad_cost_surface16_lanes_cuda(c["fenc"].cpu(), strips, MB_W,
                                           MB_H, R)
    with pytest.raises(ValueError):
        TSAD.sad_cost_surfaces_8x8_cuda(c["fenc"], strips[:, :, 1:], MB_W,
                                        MB_H, R)


@pytest.mark.gpu
def test_batch_encoder_counts_kernel_launches(cuda):
    """A CUDA BatchEncoder I P P run launches every kernel of its path:
    the main path K1, K2a, K2b and K3; faster-1ref (partitions) K4 in
    place of K1."""
    from x264dsp_tpu_torch.tools.mainpath import (faster_1ref_param,
                                                  main_path_param)
    S, w, h = 2, 64, 48
    rng = np.random.default_rng(4)
    k1, k4 = "sad_surface16", "sad_surfaces_8x8"
    for make, off in ((main_path_param, k4), (faster_1ref_param, k1)):
        xtt.reset_kernel_launches()
        be = xtt.BatchEncoder(make(w, h, 26, 8), S)
        for _ in range(3):
            planes = tuple(torch.as_tensor(rng.integers(
                0, 256, (S, hh, ww)).astype(np.uint8))
                for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
            be.encode_batch(planes)
        be.close()
        launches = xtt.kernel_launches()
        assert launches.pop(off) == 0
        # the default deblock route runs K3, not K5a / K5b / K6
        for k in ("deblock_wave_luma", "deblock_wave_chroma",
                  "filter_regions"):
            assert launches.pop(k) == 0
        assert all(n > 0 for n in launches.values()), launches


@pytest.mark.gpu
def test_batch_encoder_routes_on_the_card(cuda):
    """Slots on the wave and region routes write the default route's bytes
    and launch K5a, K5b and K6 (one launch per diagonal)."""
    from x264dsp_tpu_torch.tools.mainpath import main_path_param
    S, w, h = 2, 64, 48
    rng = np.random.default_rng(5)
    frames = [tuple(torch.as_tensor(rng.integers(
        0, 256, (S, hh, ww)).astype(np.uint8))
        for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
        for _ in range(3)]
    streams = {}
    for routes in ((None, None, None), ("wave", "region", "wave")):
        xtt.reset_kernel_launches()
        be = xtt.BatchEncoder(main_path_param(w, h, 26, 8), S)
        out = [b""] * S
        for item, route in zip(frames + [None], routes + (None,)):
            be.deblock_route = route
            nals = be.encode_batch(item)
            for s, nl in enumerate(nals or []):
                out[s] += b"".join(n.payload for n in nl)
        be.close()
        streams[routes] = out
        launches = xtt.kernel_launches()
    assert len(set(map(tuple, streams.values()))) == 1
    assert launches["deblock_wave_luma"] == 2
    assert launches["deblock_wave_chroma"] == 2
    assert launches["filter_regions"] == 4 + 2 * 3 - 2
    assert launches["deblock"] == 0
