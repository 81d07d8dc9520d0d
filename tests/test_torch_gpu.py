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
from x264dsp_tpu_torch.ops import me_walk as TME
from x264dsp_tpu_torch import params as TP
from torch_lanes import random_lanes
from torch_walk import walk_case

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


def _sad_inputs(cuda, seed, S, mb_w, mb_h, R, fill=None):
    """Source planes and search strips: random pixels, or the source all
    `fill` against strips all 255 - fill."""
    rng = np.random.default_rng(seed)
    fshape = (S, 16 * mb_h, 16 * mb_w)
    sshape = (S, mb_h, 16 + 2 * R, 16 * mb_w + 2 * R)
    if fill is None:
        f, s = rng.integers(0, 256, fshape), rng.integers(0, 256, sshape)
    else:
        f, s = np.full(fshape, fill), np.full(sshape, 255 - fill)
    return (torch.as_tensor(f, dtype=torch.int32, device=cuda),
            torch.as_tensor(s, dtype=torch.int32, device=cuda))


def _check_sad_kernels(fenc, strips, mb_w, mb_h, R):
    """K1 and K4 against their plain versions, K4's quadrant sums against
    K1, and one launch of each counted; returns (K1, K4)."""
    n1 = TSAD.launches["sad_surface16"]
    n4 = TSAD.launches["sad_surfaces_8x8"]
    k1 = TSAD.sad_cost_surface16_lanes(fenc, strips, mb_w, mb_h, R)
    k4 = TSAD.sad_cost_surfaces_8x8(fenc, strips, mb_w, mb_h, R)
    torch.cuda.synchronize()
    assert TSAD.launches["sad_surface16"] == n1 + 1
    assert TSAD.launches["sad_surfaces_8x8"] == n4 + 1
    assert torch.equal(k1, TSAD.sad_cost_surface16_lanes_plain(
        fenc, strips, mb_w, mb_h, R))
    assert torch.equal(k4, TSAD.sad_cost_surfaces_8x8_plain(
        fenc, strips, mb_w, mb_h, R))
    assert torch.equal(k4.sum((3, 4), dtype=torch.int32),
                       k1.permute(0, 1, 4, 2, 3))
    return k1, k4


@pytest.mark.gpu
@pytest.mark.parametrize("mb_w, mb_h, S, R", [
    (1, 1, 1, 4), (1, 4, 3, 16), (9, 1, 1, 16), (9, 2, 3, 4), (8, 1, 3, 16),
    (3, 2, 1, 5), (13, 3, 1, 32), (2, 2, 1, 64), (1, 1, 3, 64)])
def test_sad_kernels_edge_shapes(cuda, mb_w, mb_h, S, R):
    """K1 and K4 on one MB column, column counts that are no multiple of
    the CTA's 8-MB group, one MB row, S in {1, 3}, and search ranges that
    take one dx / dy tile (R <= 16), several (32, 64) or an odd strip
    width (R = 5: no 16-byte loads)."""
    fenc, strips = _sad_inputs(cuda, 20 + R, S, mb_w, mb_h, R)
    _check_sad_kernels(fenc, strips, mb_w, mb_h, R)


@pytest.mark.gpu
@pytest.mark.parametrize("fill", [0, 255])
def test_sad_kernels_extreme_pixels(cuda, fill):
    """All 0 against all 255 (and the reverse): every sum is the largest,
    65,280 for a 16x16 MB and 16,320 for a quadrant."""
    fenc, strips = _sad_inputs(cuda, 0, 2, 9, 2, 16, fill)
    k1, k4 = _check_sad_kernels(fenc, strips, 9, 2, 16)
    assert (k1 == 16 * 16 * 255).all() and (k4 == 8 * 8 * 255).all()


@pytest.mark.gpu
def test_sad_kernels_back_to_back(cuda):
    """K1, K4, K1 on other inputs, with no sync between the launches."""
    a = _sad_inputs(cuda, 1, 3, 10, 2, 16)
    b = _sad_inputs(cuda, 2, 3, 10, 2, 16)
    got = [TSAD.sad_cost_surface16_lanes(*a, 10, 2, 16),
           TSAD.sad_cost_surfaces_8x8(*a, 10, 2, 16),
           TSAD.sad_cost_surface16_lanes(*b, 10, 2, 16)]
    torch.cuda.synchronize()
    assert torch.equal(got[0], TSAD.sad_cost_surface16_lanes_plain(
        *a, 10, 2, 16))
    assert torch.equal(got[1], TSAD.sad_cost_surfaces_8x8_plain(
        *a, 10, 2, 16))
    assert torch.equal(got[2], TSAD.sad_cost_surface16_lanes_plain(
        *b, 10, 2, 16))


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


def _frame_args(t, rng, S, mb_w, mb_h, intra):
    """Planes and grids of S frames with per-MB QP: P-like (some intra MBs
    with bS 3, random bS 0..2, first-edge-only MBs) or all-intra."""
    H, W = mb_h * 16, mb_w * 16
    grid = (S, mb_h, mb_w)
    y = np.kron(rng.integers(0, 256, (S, mb_h * 4, mb_w * 4)),
                np.ones((1, 4, 4), int)) + rng.integers(-6, 7, (S, H, W))
    u = np.kron(rng.integers(0, 256, (S, mb_h * 2, mb_w * 2)),
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


def _deblock_args(c, intra):
    return _frame_args(c["t"], c["rng"], c["S"], MB_W, MB_H, intra)


@pytest.mark.gpu
@pytest.mark.parametrize("intra", [False, True])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("mb_w, mb_h", [(1, 1), (1, 5), (5, 1), (2, 9),
                                        (9, 2), (6, 4)])
def test_deblock_kernel_edge_shapes(cuda, mb_w, mb_h, S, intra):
    """K3's row pipeline on thin, short and tall frames: one row, one
    column, fewer MBs per row than the 2-MB lag between rows."""
    c = _case(cuda, 8, S)
    args = _frame_args(c["t"], c["rng"], S, mb_w, mb_h, intra)
    n0 = TDB.launches["deblock"]
    got = TDB.deblock_frame_cuda(*args, 3, -2, mb_w, mb_h)
    torch.cuda.synchronize()
    assert TDB.launches["deblock"] == n0 + 1
    for g, w in zip(got, TDB.deblock_frame_plain(*args, 3, -2, mb_w, mb_h)):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_deblock_kernel_back_to_back_and_side_stream(cuda):
    """Two K3 launches with no sync between them (each zeroes its own
    counters on the stream), then one on a non-default stream."""
    mb_w, mb_h, S = 7, 5, 2
    c = _case(cuda, 9, S)
    a = _frame_args(c["t"], c["rng"], S, mb_w, mb_h, False)
    b = _frame_args(c["t"], c["rng"], S, mb_w, mb_h, True)
    got_a = TDB.deblock_frame_cuda(*a, 1, 2, mb_w, mb_h)
    got_b = TDB.deblock_frame_cuda(*b, 1, 2, mb_w, mb_h)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got_c = TDB.deblock_frame_cuda(*a, -1, 0, mb_w, mb_h)
    torch.cuda.synchronize()
    for got, args, offs in ((got_a, a, (1, 2)), (got_b, b, (1, 2)),
                            (got_c, a, (-1, 0))):
        for g, w in zip(got, TDB.deblock_frame_plain(*args, *offs, mb_w,
                                                     mb_h)):
            assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("mb_h", [1, 4])
@pytest.mark.parametrize("mb_w", [1, 6, 9])
def test_luma_windows_kernel_edge_shapes(cuda, mb_w, mb_h):
    """K2a's column groups of 8 MBs: one ragged group, a full group plus a
    ragged one, a single MB column; one MB row and several."""
    rng = np.random.default_rng(11)
    recon = torch.as_tensor(rng.integers(0, 256, (2, 16 * mb_h, 16 * mb_w)),
                            dtype=torch.uint8, device=cuda)
    ref4 = TMC.make_ref_planes(recon).contiguous()
    n0 = TMG.launches["luma_windows"]
    got = TMG.luma_windows_cuda(ref4, mb_w, mb_h)
    torch.cuda.synchronize()
    assert TMG.launches["luma_windows"] == n0 + 1
    assert torch.equal(got, TMG.luma_windows_plain(ref4, mb_w, mb_h))


@pytest.mark.gpu
def test_luma_windows_rejects_unaligned_ref4(cuda):
    """K2a loads 16 bytes at a time: a strided or misaligned ref4 raises."""
    ref4 = _case(cuda, 12)["ref4"]
    S, P, Hp, Wp = ref4.shape
    wide = torch.zeros((S, P, Hp, Wp + 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        TMG.luma_windows_cuda(wide[..., :Wp], MB_W, MB_H)
    flat = torch.zeros(ref4.numel() + 1, dtype=torch.int32, device=cuda)
    shifted = flat[1:].view(ref4.shape)
    shifted.copy_(ref4)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    with pytest.raises(ValueError):
        TMG.luma_windows_cuda(shifted, MB_W, MB_H)


@pytest.mark.gpu
@pytest.mark.parametrize("mb_w, mb_h, S", [
    (w, h, s) for w in (1, 6, 9, 17) for h in (1, 4) for s in (1, 3)]
    + [(17, 67, 3)])
def test_chroma_windows_kernel_edge_shapes(cuda, mb_w, mb_h, S):
    """K2b's column groups of 8 MBs (one ragged group, full groups plus a
    ragged one, one MB column), one MB row and several, S in {1, 3}; at
    17 x 67 x 3 the grid's 9 column groups x streams take bands of 2 MB
    rows, the last band 1 row (67 is no multiple of 2)."""
    rng = np.random.default_rng(13)
    c = torch.as_tensor(rng.integers(0, 256, (S, 8 * mb_h, 8 * mb_w)),
                        dtype=torch.uint8, device=cuda)
    refc = TMC.pad_chroma(c).contiguous()
    n0 = TMG.launches["chroma_windows"]
    got = TMG.chroma_windows_cuda(refc, mb_w, mb_h)
    torch.cuda.synchronize()
    assert TMG.launches["chroma_windows"] == n0 + 1
    assert torch.equal(got, TMG.chroma_windows_plain(refc, mb_w, mb_h))


@pytest.mark.gpu
def test_chroma_windows_rejects_unaligned_refc(cuda):
    """K2b loads 16 bytes at a time: a strided refc, a misaligned one and
    one whose width is no multiple of 4 raise."""
    refc = _case(cuda, 14)["refc"]
    S, Hc, Wc = refc.shape
    wide = torch.zeros((S, Hc, Wc + 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        TMG.chroma_windows_cuda(wide[..., :Wc], MB_W, MB_H)
    flat = torch.zeros(refc.numel() + 1, dtype=torch.int32, device=cuda)
    shifted = flat[1:].view(refc.shape)
    shifted.copy_(refc)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="aligned"):
        TMG.chroma_windows_cuda(shifted, MB_W, MB_H)
    odd = torch.zeros((S, Hc, Wc + 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        TMG.chroma_windows_cuda(odd, MB_W, MB_H)


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


def _check_wave_kernels(args, luma_l, chroma_l, mb_w, mb_h):
    """K5a and K5b against their plain versions on the same lanes, one
    launch of each counted; returns their planes."""
    n0 = dict(TDB.launches)
    gy = TDB.deblock_wave_luma_cuda(args[0], *luma_l, mb_w, mb_h)
    gu, gv = TDB.deblock_wave_chroma_cuda(args[1], args[2], *chroma_l, mb_w,
                                          mb_h)
    torch.cuda.synchronize()
    for k in ("deblock_wave_luma", "deblock_wave_chroma"):
        assert TDB.launches[k] == n0[k] + 1
    assert torch.equal(gy, TDB.deblock_wave_luma_plain(args[0], *luma_l,
                                                       mb_w, mb_h))
    wu, wv = TDB.deblock_wave_chroma_plain(args[1], args[2], *chroma_l, mb_w,
                                           mb_h)
    assert torch.equal(gu, wu) and torch.equal(gv, wv)
    return gy, gu, gv


@pytest.mark.gpu
@pytest.mark.parametrize("intra", [False, True])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("mb_w, mb_h", [(1, 1), (1, 5), (5, 1), (2, 9),
                                        (9, 2), (11, 3)])
def test_wave_kernels_edge_shapes(cuda, mb_w, mb_h, S, intra):
    """K5a / K5b's row pipeline on one MB, a frame one MB wide (whose odd
    diagonals are empty), one MB row, tall frames and frames wider than
    twice their height: equal to their plain versions and to K3."""
    c = _case(cuda, 15, S)
    args = _frame_args(c["t"], c["rng"], S, mb_w, mb_h, intra)
    luma_l, chroma_l = TDB.wave_lanes(*args[3:], 3, -2, mb_w, mb_h)
    got = _check_wave_kernels(args, luma_l, chroma_l, mb_w, mb_h)
    for g, w in zip(got, TDB.deblock_frame_cuda(*args, 3, -2, mb_w, mb_h)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("mb_w, mb_h", [(1, 1), (1, 5), (5, 1), (2, 9),
                                        (6, 4), (11, 3)])
def test_wave_kernels_random_lanes(cuda, mb_w, mb_h, S):
    """K5a / K5b on random lanes with every edge enabled, the frame-border
    edges too (tc0 -1..25, alpha 0..255, beta 0..18, random intra flags):
    pixels outside the frame read as 0 at every MB (a stale top halo in
    row 0 would show here) and nothing is stored outside the frame."""
    c = _case(cuda, 16, S)
    args = _frame_args(c["t"], c["rng"], S, mb_w, mb_h, False)
    luma_l, chroma_l = ([c["t"](a) for a in fam]
                        for fam in random_lanes(c["rng"], S, mb_w, mb_h))
    gy, gu, gv = _check_wave_kernels(args, luma_l, chroma_l, mb_w, mb_h)
    assert not torch.equal(gy, args[0])


@pytest.mark.gpu
def test_wave_kernels_back_to_back_and_side_stream(cuda):
    """K5a and K5b twice back to back on other inputs with no sync between
    the launches (each allocates its own counters, zeroed on the stream),
    then once more on a non-default stream."""
    mb_w, mb_h, S = 7, 5, 2
    c = _case(cuda, 17, S)
    runs = []
    for intra, border in ((False, True), (True, False)):
        args = _frame_args(c["t"], c["rng"], S, mb_w, mb_h, intra)
        lanes = [[c["t"](a) for a in fam] for fam in random_lanes(
            c["rng"], S, mb_w, mb_h, border)]
        runs.append((args, lanes))

    def launch(args, lanes):
        return (TDB.deblock_wave_luma_cuda(args[0], *lanes[0], mb_w, mb_h),
                *TDB.deblock_wave_chroma_cuda(args[1], args[2], *lanes[1],
                                              mb_w, mb_h))
    got = [launch(*r) for r in runs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got.append(launch(*runs[0]))
    torch.cuda.synchronize()
    for out, (args, lanes) in zip(got, runs + runs[:1]):
        assert torch.equal(out[0], TDB.deblock_wave_luma_plain(
            args[0], *lanes[0], mb_w, mb_h))
        wu, wv = TDB.deblock_wave_chroma_plain(args[1], args[2], *lanes[1],
                                               mb_w, mb_h)
        assert torch.equal(out[1], wu) and torch.equal(out[2], wv)


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


def _region_args(cuda, K, intra, seed):
    """K6's arguments for K regions: random 20x20 / 12x12 regions and the
    first K (2K for chroma) lane rows of a 20 x 12 MB, 3-stream frame
    batch, padded slots among them (zero enables)."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                               device=cuda)
    mb_w, mb_h = 20, 12
    args = _frame_args(t, rng, 3, mb_w, mb_h, intra)
    luma_l, chroma_l = TDB.wave_lanes(*args[3:], 1, -1, mb_w, mb_h)
    ly = [x.reshape(-1, x.shape[-1])[:K].contiguous() for x in luma_l]
    lc = [x.reshape(-1, x.shape[-1])[:2 * K].contiguous() for x in chroma_l]
    assert ly[0].shape[0] == K and int(ly[1].sum()) > 0
    return (t(rng.integers(0, 256, (K, 20, 20))),
            t(rng.integers(0, 256, (2 * K, 12, 12))), ly[0], lc[0], ly[1],
            ly[2], lc[1], lc[2], ly[3], ly[4], lc[3], lc[4])


@pytest.mark.gpu
@pytest.mark.parametrize("intra", [False, True])
@pytest.mark.parametrize("K", [16, 32, 496])
def test_filter_regions_kernel_sizes(cuda, K, intra):
    """K6 at K regions (one CTA of 4 MBs and more), intra and non-intra
    lanes: two launches back to back on other inputs with no sync between
    them, then one on a non-default stream."""
    a = _region_args(cuda, K, intra, 30 + K)
    b = _region_args(cuda, K, intra, 31 + K)
    n0 = TDB.launches["filter_regions"]
    got_a = TDB.filter_regions_cuda(*a)
    got_b = TDB.filter_regions_cuda(*b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got_c = TDB.filter_regions_cuda(*a)
    torch.cuda.synchronize()
    assert TDB.launches["filter_regions"] == n0 + 3
    for got, args in ((got_a, a), (got_b, b), (got_c, a)):
        want = TDB.filter_regions_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("which", [0, 4, 11])
def test_filter_regions_rejects_unaligned_tensors(cuda, which):
    """K6 copies 16 bytes at a time: a region or lane tensor whose base is
    not 16-byte aligned raises (regy, eny and blc here)."""
    args = list(_region_args(cuda, 16, False, 40))
    x = args[which]
    flat = torch.zeros(x.numel() + 1, dtype=torch.int32, device=cuda)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    args[which] = shifted
    with pytest.raises(ValueError, match="aligned"):
        TDB.filter_regions_cuda(*args)


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


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["crf_umh_param", "abr_esa_param"])
def test_rate_controlled_batch_encoder_card_equals_cpu(cuda, name):
    """Per-stream CRF / ABR with the UMH / ESA search on a 64x48 clip whose
    two streams differ in detail, I P P P I P, pipelined: the card's
    Annex-B bytes and per-stream QPs equal the CPU's, and the two
    streams' QPs differ in some slot."""
    from x264dsp_tpu_torch.tools import mainpath
    S, w, h, n = 2, 64, 48, 6
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = [tuple(torch.as_tensor(np.stack(a)) for a in zip(*[
        ((110 + 60 * np.sin((xx + 2 * t) / 13.0) * np.cos(yy / 17.0)
          + rng.normal(0, sigma, (h, w))).clip(0, 255).astype(np.uint8),
         np.full((h // 2, w // 2), 120 + t, np.uint8),
         np.full((h // 2, w // 2), 128 - t, np.uint8))
        for sigma in (2.0, 8.0)])) for t in range(n)]
    runs = {}
    for dev in ("cuda", "cpu"):
        be = xtt.BatchEncoder(getattr(mainpath, name)(w, h, 4), S,
                              device=dev)
        out, qps = [b""] * S, []
        for item in frames + [None]:
            for s, nl in enumerate(be.encode_batch(item) or []):
                out[s] += b"".join(nal.payload for nal in nl)
            if item is not None:
                qps.append(be.last_qps)
        be.close()
        runs[dev] = (out, qps)
    assert runs["cuda"] == runs["cpu"]
    assert all(runs["cpu"][0])
    assert any(qps[0] != qps[1] for qps in runs["cpu"][1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["param_default", "cqp_forced"])
def test_encoder_card_equals_cpu(cuda, case):
    """The single-stream Encoder on the 56x40 scene-cut clip, at
    param_default() (CRF 28, CABAC, scenecut) and at CQP 20 + CABAC + HEX,
    subme 4, partitions with forced frame types and QPs: the card's
    headers, NALs, frame types, QPs, pic_out planes and summary equal the
    CPU's (the card's frames given as CUDA tensors)."""
    from x264dsp_tpu_torch.tools.mainpath import (ENCODER_FORCED,
                                                  encode_clip, encode_diff,
                                                  encoder_cqp_param,
                                                  encoder_param,
                                                  scene_cut_clip)
    make, forced = ((encoder_param, {}) if case == "param_default"
                    else (encoder_cqp_param, ENCODER_FORCED))
    frames = scene_cut_clip()
    xtt.reset_kernel_launches()
    card = encode_clip(xtt.Encoder(make(56, 40)),
                       [[torch.as_tensor(a, device=cuda) for a in f]
                        for f in frames], forced)
    launches = xtt.kernel_launches()
    cpu = encode_clip(xtt.Encoder(make(56, 40), device="cpu"), frames,
                      forced)
    assert encode_diff(card, cpu) is None, encode_diff(card, cpu)
    assert launches["luma_windows"] > 0 and launches["deblock"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cabac", [1, 0])
def test_encoder_cbr_card_equals_cpu(cuda, cabac):
    """The live-stream CBR settings (NAL HRD, variance AQ, the lookahead
    queue of 4) cut to 40 kbit/s with a 6 kbit buffer on the 56x40
    scene-cut clip, under CABAC and CAVLC (row bits from the device
    packer): the card's headers, waiting calls, NALs (SEIs and filler
    included), types, QPs, pic_out planes and summary equal the CPU's;
    the row-VBV walk re-encodes some frame and the CPB overflows into a
    filler NAL."""
    from x264dsp_tpu_torch import params as P
    from x264dsp_tpu_torch.tools.mainpath import (encode_clip, encode_diff,
                                                  encoder_cbr_param,
                                                  scene_cut_clip)

    def make():
        p = encoder_cbr_param(56, 40, 40)
        p.rc.i_vbv_buffer_size = 6
        p.b_cabac = cabac
        return p
    frames = scene_cut_clip()
    xtt.reset_kernel_launches()
    card = xtt.Encoder(make())
    run = encode_clip(card, [[torch.as_tensor(a, device=cuda) for a in f]
                             for f in frames])
    launches = xtt.kernel_launches()
    cpu = encode_clip(xtt.Encoder(make(), device="cpu"), frames)
    assert encode_diff(run, cpu) is None, encode_diff(run, cpu)
    assert run["waiting"] == [0, 1, 2, 3] and len(run["pics"]) == len(frames)
    assert any(t == P.NAL_FILLER for nl in run["nals"] for t, _ in nl)
    assert launches["sad_surface16"] > 0 and launches["deblock"] > 0


@pytest.mark.gpu
def test_aq_log2_card_equals_cpu(cuda):
    """ratecontrol.log2_f32 (the JAX package's float32 log2) gives the
    same bits on the card as on the CPU at every integer energy below
    2**23, and aq_offsets the same offsets on random planes."""
    from x264dsp_tpu_torch.encoder import ratecontrol as TRC
    e = torch.arange(1, 1 << 23, dtype=torch.float32)
    assert torch.equal(TRC.log2_f32(e.to(cuda)).cpu().view(torch.int32),
                       TRC.log2_f32(e).view(torch.int32))
    rng = np.random.default_rng(4)
    planes = [rng.integers(0, 256, shape).astype(np.uint8)
              for shape in ((64, 80), (32, 40), (32, 40))]
    want = TRC.aq_offsets(*(torch.from_numpy(a) for a in planes), 1.0, 5, 4)
    got = TRC.aq_offsets(*(torch.from_numpy(a).to(cuda) for a in planes),
                         1.0, 5, 4)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_stream_mesh_card_equals_cpu(cuda):
    """The P pipeline (ESA) of 4 streams over a mesh of the card twice
    equals the same over a CPU mesh, output for output, and launches K4,
    K2a, K2b and K3 once per shard."""
    from x264dsp_tpu_torch.parallel import dryrun as D
    from x264dsp_tpu_torch.parallel import mesh as M
    planes = [D.synthetic_planes(64, 48, 4, seed) for seed in (0, 1)]
    refs = [TMC.make_ref_planes(torch.from_numpy(planes[0][0])),
            TMC.pad_chroma(torch.from_numpy(planes[0][1])),
            TMC.pad_chroma(torch.from_numpy(planes[0][2]))]
    args = [torch.from_numpy(a) for a in planes[1]] + refs
    out = {}
    for devs in (["cuda:0"] * 2, ["cpu"] * 2):
        mesh = M.make_stream_mesh(devs)
        xtt.reset_kernel_launches()
        out[devs[0]] = M.encode_p_pipeline_batched(
            *M.shard_streams(mesh, *args), D.QP, D.QPC, D.LAMBDA, 4, 3,
            D.ME_RANGE, D.MV_RANGE, True)
        launches = xtt.kernel_launches()
        if devs[0] == "cuda:0":
            assert all(launches[k] == n for k, n in (
                ("sad_surfaces_8x8", 2), ("luma_windows", 2),
                ("chroma_windows", 4), ("deblock", 2)))
    (card, card_refs), (cpu, cpu_refs) = out["cuda:0"], out["cpu"]
    for k in cpu:
        assert torch.equal(card[k].gather("cpu"), cpu[k].gather("cpu")), k
    for a, b in zip(card_refs, cpu_refs):
        assert torch.equal(a.gather("cpu"), b.gather("cpu"))


@pytest.mark.gpu
def test_residual_ops_frame_card_equals_cpu(cuda):
    """The device CABAC front half on the card gives the CPU's ops,
    offsets and flag on a random 1080p-wide band of 4 MB rows, levels up
    to 40."""
    from x264dsp_tpu_torch.entropy.cabac_device import residual_ops_frame
    rng = np.random.default_rng(9)
    mb_h, mb_w = 4, 120
    n = mb_h * mb_w

    def lv(shape):
        a = rng.integers(-40, 41, shape) * (rng.random(shape) < 0.3)
        return torch.from_numpy(a.astype(np.int32))
    args = [lv((n, 16, 16)), lv((n, 16)), lv((n, 2, 4)), lv((n, 2, 4, 16)),
            torch.from_numpy(rng.random(n) < 0.5)]
    want = residual_ops_frame(*args, mb_h, mb_w, 1 << 20)
    got = residual_ops_frame(*(a.to(cuda) for a in args), mb_h, mb_w,
                             1 << 20)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
@pytest.mark.parametrize("R", [4, 16])
@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("later", [False, True])
@pytest.mark.parametrize("lanes", [True, False])
@pytest.mark.parametrize("method", [TP.ME_DIA, TP.ME_HEX])
def test_pattern_walk_kernel_matches_plain(cuda, method, lanes, later, cut,
                                           R):
    """The walk kernel against the lockstep walk on the same CUDA tensors:
    DIA and HEX, K1's lanes and the classic layout, walk 1 and a later
    walk (median MVP and four candidates from a field reaching 2R), the
    frame's legal range or one drawn per row and column, 3 streams of
    9x7 MBs (every frame edge), one launch."""
    case = walk_case(3 * R + 2 * lanes + later + 5 * cut, 3, 9, 7, R, lanes,
                     later, cut, cuda)
    n0 = TME.launches["pattern_walk"]
    got = TME.pattern_walk(*case, method)
    assert TME.launches["pattern_walk"] == n0 + 1
    want = TME.pattern_walk_plain(*case, method)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("method", [TP.ME_DIA, TP.ME_HEX])
def test_pattern_walk_kernel_chain_at_1080p(cuda, method):
    """A P frame's three walks at 1080p (2 streams, R = 16), each walk
    starting from the kernel's own field before, against the plain
    chain."""
    case = list(walk_case(11, 2, 120, 68, 16, method == TP.ME_DIA, False,
                          False, cuda))
    got, want = case[:], case[:]
    for _ in range(3):
        g = TME.pattern_walk_cuda(*got, method)
        w = TME.pattern_walk_plain(*want, method)
        for a, b in zip(g, w):
            assert torch.equal(a, b)
        got[4], want[4] = g[0], w[0]


@pytest.mark.gpu
def test_pattern_walk_rejects_bad_arguments(cuda):
    """The wrapper refuses a wrong dtype, shape, layout, device, a
    non-contiguous field and a method that is no pattern."""
    surf, lanes, lam, bounds, prev, R = walk_case(1, 2, 5, 4, 4, True, True,
                                                  False, cuda)
    with pytest.raises(ValueError):
        TME.pattern_walk_cuda(surf.long(), lanes, lam, bounds, prev, R,
                              TP.ME_DIA)
    with pytest.raises(ValueError):
        TME.pattern_walk_cuda(surf, lanes, lam, bounds, prev, R + 1,
                              TP.ME_DIA)
    with pytest.raises(ValueError):
        TME.pattern_walk_cuda(surf, not lanes, lam, bounds, prev, R,
                              TP.ME_DIA)
    with pytest.raises(ValueError):
        TME.pattern_walk_cuda(surf, lanes, lam.cpu(), bounds, prev, R,
                              TP.ME_DIA)
    with pytest.raises(ValueError):
        TME.pattern_walk_cuda(surf, lanes, lam, bounds, prev[:, :, ::2], R,
                              TP.ME_DIA)
    strided = prev.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        TME.pattern_walk_cuda(surf, lanes, lam, bounds, strided, R,
                              TP.ME_DIA)
    with pytest.raises(ValueError):
        TME.pattern_walk_cuda(surf, lanes, lam, bounds, prev, R, TP.ME_UMH)


@pytest.mark.gpu
@pytest.mark.parametrize("make, walks", [("main_path_param", 3),
                                         ("faster_1ref_param", 3),
                                         ("crf_umh_param", 0)])
def test_batch_encoder_walk_launches_per_p_slot(cuda, make, walks):
    """A CUDA BatchEncoder I P P run launches the walk kernel 3 times per
    P slot under DIA (the main path) and HEX (faster-1ref), and never
    under UMH."""
    from x264dsp_tpu_torch.tools import mainpath
    S, w, h = 2, 64, 48
    rng = np.random.default_rng(6)
    param = (mainpath.crf_umh_param(w, h, 8) if make == "crf_umh_param"
             else getattr(mainpath, make)(w, h, 26, 8))
    xtt.reset_kernel_launches()
    be = xtt.BatchEncoder(param, S)
    for _ in range(3):
        be.encode_batch(tuple(torch.as_tensor(rng.integers(
            0, 256, (S, hh, ww)).astype(np.uint8))
            for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2))))
    be.close()
    assert xtt.kernel_launches()["pattern_walk"] == 2 * walks


@pytest.mark.gpu
@pytest.mark.parametrize("method", [TP.ME_DIA, TP.ME_HEX])
def test_decide_mvs_pattern_fullpel_stage_never_syncs(cuda, method,
                                                      monkeypatch):
    """decide_mvs_pattern up to its subpel refine (the bounds, the
    lambdas, the three walks) issues no synchronizing CUDA call once its
    per-shape tables exist: with torch's sync debug mode at "error" none
    raises. The refine is cut off here; its diamonds still sync."""
    from x264dsp_tpu_torch.encoder import inter_frame as TIF
    surf, lanes, lam, _, _, R = walk_case(2, 2, 9, 7, 16,
                                          method == TP.ME_DIA, False, False,
                                          cuda)
    seen = []
    monkeypatch.setattr(TIF, "subpel_refine_batch",
                        lambda mv_field, *a: seen.append(mv_field))
    # the BatchEncoder's lambdas are int64
    args = (surf, lanes, None, None, lam.long(), 9, 7, R, 512, method, 1)
    TIF.decide_mvs_pattern(*args)       # builds the kernels and the tables
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        TIF.decide_mvs_pattern(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(seen[0], seen[1]) and seen[1].shape == (2, 7, 9, 2)
