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
        assert all(n > 0 for n in launches.values()), launches
