"""The port's kernel modules (x264dsp_tpu_torch) against the JAX package.

On the CPU every kernel wrapper runs its plain PyTorch version; these
tests hold those versions to the JAX Pallas kernels in interpret mode
and to their XLA twins, with exact equality (the codec is integer
exact). The CUDA kernels themselves are compared with the plain
versions on the GPU by tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from x264dsp_tpu.ops import deblock as JDB
from x264dsp_tpu.ops import mc as JMC
from x264dsp_tpu.ops import mcgather as JMG
from x264dsp_tpu.ops.pallas.me_sad import make_ref_strips as j_strips
from x264dsp_tpu.ops.pallas.me_sad import sad_cost_surface16_lanes
from x264dsp_tpu.ops.pallas.windows import (chroma_windows_pallas,
                                            luma_windows_pallas)
from x264dsp_tpu.ops.tables import CHROMA_QP_TABLE
import x264dsp_tpu_torch as xtt
from x264dsp_tpu_torch.ops import deblock as TDB
from x264dsp_tpu_torch.ops import mc as TMC
from x264dsp_tpu_torch.ops import mcgather as TMG
from x264dsp_tpu_torch.ops import me_sad as TSAD

MB_W, MB_H, R = 4, 3, 8


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(17)
    H, W = MB_H * 16, MB_W * 16
    fenc = rng.integers(0, 256, (2, H, W)).astype(np.int32)
    recon = rng.integers(0, 256, (2, H, W)).astype(np.uint8)
    chroma = rng.integers(0, 256, (2, H // 2, W // 2)).astype(np.uint8)
    ref4 = np.stack([np.asarray(JMC.make_ref_planes(jnp.asarray(r)))
                     for r in recon])
    refc = np.stack([np.asarray(JMC.pad_chroma(jnp.asarray(c)))
                     for c in chroma])
    return dict(fenc=fenc, recon=recon, chroma=chroma, ref4=ref4, refc=refc)


def test_ref_planes_match_jax(planes):
    got = TMC.make_ref_planes(_t(planes["recon"])).numpy()
    np.testing.assert_array_equal(got, planes["ref4"])
    got_c = TMC.pad_chroma(_t(planes["chroma"])).numpy()
    np.testing.assert_array_equal(got_c, planes["refc"])


def test_sad_surface_matches_pallas_interpret(planes):
    """K1 plain version vs sad_cost_surface16_lanes(interpret=True)."""
    strips_t = TSAD.make_ref_strips(_t(planes["ref4"][:, 0]), TMC.PAD_MC,
                                    MB_W, MB_H, R)
    got = TSAD.sad_cost_surface16_lanes(_t(planes["fenc"]), strips_t, MB_W,
                                        MB_H, R).numpy()
    for s in range(2):
        strips = j_strips(jnp.asarray(planes["ref4"][s, 0]), JMC.PAD_MC,
                          MB_W, MB_H, R)
        np.testing.assert_array_equal(strips_t[s].numpy(),
                                      np.asarray(strips))
        want = np.asarray(sad_cost_surface16_lanes(
            jnp.asarray(planes["fenc"][s]), strips, mb_w=MB_W, mb_h=MB_H,
            R=R, interpret=True))
        np.testing.assert_array_equal(got[s], want)


def test_luma_windows_match_pallas_interpret(planes):
    """K2a: uint8 windows hold the same values as the bf16 Pallas ones."""
    got = TMG.luma_windows(_t(planes["ref4"]), MB_W, MB_H)
    assert got.dtype == torch.uint8
    for s in range(2):
        want = np.asarray(luma_windows_pallas(
            planes["ref4"][s], MB_W, MB_H, JMG.M_LUMA, JMC.PAD_MC,
            interpret=True)).astype(np.int32)
        np.testing.assert_array_equal(got[s].numpy().astype(np.int32), want)
        xla = np.asarray(JMG.luma_windows(jnp.asarray(planes["ref4"][s]),
                                          MB_W, MB_H)).astype(np.int32)
        np.testing.assert_array_equal(got[s].numpy().astype(np.int32), xla)


def test_chroma_windows_match_pallas_interpret(planes):
    """K2b against chroma_windows_pallas(interpret=True) and the XLA
    twin."""
    got = TMG.chroma_windows(_t(planes["refc"]), MB_W, MB_H)
    assert got.dtype == torch.uint8
    for s in range(2):
        want = np.asarray(chroma_windows_pallas(
            planes["refc"][s], MB_W, MB_H, JMG.M_CHROMA, JMC.PAD_MC // 2,
            interpret=True)).astype(np.int32)
        np.testing.assert_array_equal(got[s].numpy().astype(np.int32), want)
        xla = np.asarray(JMG.chroma_windows(jnp.asarray(planes["refc"][s]),
                                            MB_W, MB_H)).astype(np.int32)
        np.testing.assert_array_equal(got[s].numpy().astype(np.int32), xla)


def _deblock_case(seed, mode, per_mb_qp):
    """Blocky planes for S = 2 streams; mode 'none' = P frame (no intra
    MBs, random bS 0..2 and first-edge-only MBs), 'all' = I frame."""
    rng = np.random.default_rng(seed)
    S, H, W = 2, MB_H * 16, MB_W * 16
    y = np.kron(rng.integers(0, 256, (S, MB_H * 4, MB_W * 4)),
                np.ones((1, 4, 4), int)) + rng.integers(-6, 7, (S, H, W))
    y = y.clip(0, 255).astype(np.int32)
    u = np.kron(rng.integers(0, 256, (S, MB_H * 2, MB_W * 2)),
                np.ones((1, 4, 4), int)).astype(np.int32)
    v = (255 - u).astype(np.int32)
    grid = (S, MB_H, MB_W)
    if mode == "all":
        intra = np.ones(grid, np.int32)
        bs = np.full(grid + (2, 4, 4), 3, np.int32)
        feo = np.zeros(grid, np.int32)
    else:
        intra = np.zeros(grid, np.int32)
        bs = rng.integers(0, 3, grid + (2, 4, 4)).astype(np.int32)
        feo = (rng.random(grid) < 0.2).astype(np.int32)
    if per_mb_qp:
        qp = rng.integers(18, 46, grid).astype(np.int32)
    else:
        qp = np.full(grid, 30, np.int32)
    qpc = CHROMA_QP_TABLE[qp].astype(np.int32)
    return y, u, v, bs, intra, feo, qp, qpc


@pytest.mark.parametrize("mode,per_mb_qp,seed", [
    ("none", False, 1), ("none", True, 2), ("all", False, 3),
    ("all", True, 4)])
def test_deblock_matches_jax(mode, per_mb_qp, seed):
    """K3 plain version vs deblock_frame_skew_batched(interpret=True, the
    TPU kernel) and deblock_frame(use_pallas=False), P and I frames."""
    y, u, v, bs, intra, feo, qp, qpc = _deblock_case(seed, mode, per_mb_qp)
    got = TDB.deblock_frame(*(_t(a) for a in (y, u, v, bs, intra, feo, qp,
                                              qpc)), 0, 0, MB_W, MB_H)
    skew = JDB.deblock_frame_skew_batched(
        *(jnp.asarray(a) for a in (y, u, v, bs, intra, feo, qp, qpc)),
        0, 0, mb_w=MB_W, mb_h=MB_H, interpret=True, intra_mode=mode)
    for g, w in zip(got, skew):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for s in range(2):
        xla = JDB.deblock_frame(y[s], u[s], v[s], bs[s], intra[s], feo[s],
                                qp[s], qpc[s], 0, 0, mb_w=MB_W, mb_h=MB_H,
                                use_pallas=False)
        for g, w in zip(got, xla):
            np.testing.assert_array_equal(g[s].numpy(), np.asarray(w))


def test_deblock_offsets_match_jax():
    """Nonzero slice alpha/beta offsets shift the table indices the same
    way in both packages."""
    y, u, v, bs, intra, feo, qp, qpc = _deblock_case(9, "none", True)
    got = TDB.deblock_frame(*(_t(a) for a in (y, u, v, bs, intra, feo, qp,
                                              qpc)), 4, -2, MB_W, MB_H)
    for s in range(2):
        xla = JDB.deblock_frame(y[s], u[s], v[s], bs[s], intra[s], feo[s],
                                qp[s], qpc[s], 4, -2, mb_w=MB_W, mb_h=MB_H,
                                use_pallas=False)
        for g, w in zip(got, xla):
            np.testing.assert_array_equal(g[s].numpy(), np.asarray(w))


def test_cpu_calls_launch_no_kernel(planes):
    """On CPU tensors the wrappers take the plain versions: every launch
    counter stays 0."""
    xtt.reset_kernel_launches()
    TMG.luma_windows(_t(planes["ref4"]), MB_W, MB_H)
    TMG.chroma_windows(_t(planes["refc"]), MB_W, MB_H)
    strips = TSAD.make_ref_strips(_t(planes["ref4"][:, 0]), TMC.PAD_MC,
                                  MB_W, MB_H, R)
    TSAD.sad_cost_surface16_lanes(_t(planes["fenc"]), strips, MB_W, MB_H, R)
    y, u, v, bs, intra, feo, qp, qpc = _deblock_case(5, "none", False)
    TDB.deblock_frame(*(_t(a) for a in (y, u, v, bs, intra, feo, qp, qpc)),
                      0, 0, MB_W, MB_H)
    assert all(n == 0 for n in xtt.kernel_launches().values())


@pytest.mark.parametrize("fn", ["sad_cost_surface16_lanes",
                                "sad_cost_surfaces_8x8"])
@pytest.mark.parametrize("where", ["fenc", "strips"])
@pytest.mark.parametrize("value", [256, -1])
def test_sad_dispatchers_refuse_non_pixels(planes, fn, where, value):
    """K1 / K4 read the low byte of each int32, so their dispatchers refuse
    any value outside 0..255 on either device; here on the CPU."""
    fenc = _t(planes["fenc"])
    strips = TSAD.make_ref_strips(_t(planes["ref4"][:, 0]), TMC.PAD_MC,
                                  MB_W, MB_H, R)
    bad = (fenc if where == "fenc" else strips).clone()
    bad.view(-1)[bad.numel() // 2] = value
    args = (bad, strips) if where == "fenc" else (fenc, bad)
    with pytest.raises(ValueError, match="0..255"):
        getattr(TSAD, fn)(*args, MB_W, MB_H, R)
    getattr(TSAD, fn)(fenc, strips, MB_W, MB_H, R)      # pixels pass
