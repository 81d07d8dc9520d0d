"""The port's CRF/ABR cost pass and its UMH / ESA searches against the JAX
package, on the CPU, exactly.

- ops/mc.lowres_planes, encoder/slicetype.lowres_costs (I cost, P cost,
  lowres MVs) and frame_summary (the vector the BatchEncoder's per-stream
  rate control reads) on numpy-seeded two-stream frames of 4x3 and 6x4
  MBs, whose texture moves by up to 9 lowres pixels (past the +-8
  full-pel search, so the MVs reach the clip of the JAX window and the
  reads leave the frame), and on an all-flat frame, where every block
  takes the mv0 fast skip;
- encoder/inter_frame.decide_mvs_parallel (UMH) and decide_mvs (ESA, the
  exact-MVP wavefront) on seeded surfaces with many tied costs and on
  seeded windows, at R = 4 and subme 0 and at R = 8 and subme 2.

The JAX references are jax.jit-wrapped and compiled side by side in
threads inside light_xla().
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from x264dsp_tpu.encoder import inter_frame as JIF
from x264dsp_tpu.encoder import slicetype as JST
from x264dsp_tpu.ops import mc as JMC
from x264dsp_tpu.ops import mcgather as JMG
from x264dsp_tpu_torch.encoder import inter_frame as TIF
from x264dsp_tpu_torch.encoder import slicetype as TST
from x264dsp_tpu_torch.ops import mc as TMC
from x264dsp_tpu_torch.ops import mcgather as TMG
from torch_jaxref import light_xla

S = 2


def _frames(mb_w, mb_h, seed, motion):
    """(cur, prev) (S, H, W) uint8: a smooth texture that moves by
    `motion` (dx, dy) pixels from prev to cur, with per-stream noise; or
    both all 128 (motion None)."""
    H, W = 16 * mb_h, 16 * mb_w
    if motion is None:
        f = np.full((S, H, W), 128, np.uint8)
        return f, f.copy()
    rng = np.random.default_rng(seed)
    m = 24
    yy, xx = np.mgrid[0:H + 2 * m, 0:W + 2 * m].astype(np.float32)
    base = (120 + 60 * np.sin(xx / 9.0 + seed) * np.cos(yy / 11.0)
            + 40 * np.sin((xx + 2 * yy) / 31.0))

    def frame(dx, dy):
        return np.stack([
            (base[m + dy:m + dy + H, m + dx:m + dx + W]
             + rng.normal(0, 2.0 + 6.0 * s, (H, W))).clip(0, 255)
            for s in range(S)]).astype(np.uint8)
    return frame(*motion), frame(0, 0)


# case: (mb_w, mb_h, seed, motion, do_edges of the summary); at 4x3 MBs
# the motion (9, -7 lowres pixels) runs past the +-8 full-pel search
CASES = {"4x3": (4, 3, 1, (18, -14), False),
         "6x4": (6, 4, 2, (-11, 7), True),
         "flat": (4, 3, 0, None, False)}


_planes = jax.jit(jax.vmap(JMC.lowres_planes))
_costs = jax.jit(jax.vmap(JST.lowres_costs, in_axes=(0, 0, None, None)),
                 static_argnums=(2, 3))


def _jax_lowres(case):
    mb_w, mb_h, seed, motion, do_edges = CASES[case]
    cur, prev = _frames(mb_w, mb_h, seed, motion)
    low, low_prev = _planes(jnp.asarray(cur)), _planes(jnp.asarray(prev))
    icost, pcost, (mvx, mvy) = _costs(low[:, 0], low_prev, mb_w, mb_h)
    summary = JST._summary_fn(mb_w, mb_h, do_edges)
    vec = [summary(low[s, 0], low_prev[s]) for s in range(S)]
    return {"planes": np.asarray(low), "icost": np.asarray(icost),
            "pcost": np.asarray(pcost), "mv": np.stack([mvx, mvy], -1),
            "summary": np.stack([np.asarray(v) for v in vec])}


def _port_lowres(case):
    mb_w, mb_h, seed, motion, do_edges = CASES[case]
    cur, prev = (torch.from_numpy(a)
                 for a in _frames(mb_w, mb_h, seed, motion))
    low, low_prev = TMC.lowres_planes(cur), TMC.lowres_planes(prev)
    icost, pcost, (mvx, mvy) = TST.lowres_costs(low[:, 0], low_prev, mb_w,
                                                mb_h)
    summary = TST.frame_summary(low[:, 0], low_prev, mb_w, mb_h, do_edges)
    assert summary.dtype == torch.int64
    return {"planes": low.numpy(), "icost": icost.numpy(),
            "pcost": pcost.numpy(), "mv": torch.stack([mvx, mvy], -1).numpy(),
            "summary": summary.numpy()}


# (method, R, subme)
ME_CASES = {"umh-r4-subme0": ("umh", 4, 0), "umh-r8-subme2": ("umh", 8, 2),
            "esa-r4-subme0": ("esa", 4, 0), "esa-r8-subme2": ("esa", 8, 2)}
ME_FNS = {"umh": (JIF.decide_mvs_parallel, TIF.decide_mvs_parallel),
          "esa": (JIF.decide_mvs, TIF.decide_mvs)}
MB_W, MB_H, MV_RANGE = 5, 4, 512


def _me_inputs(case):
    _, R, subme = ME_CASES[case]
    n = 2 * R + 1
    rng = np.random.default_rng(70 + R + subme)
    # nearly flat surfaces: many tied minima, so the first-minimum rule and
    # the MVP (through the mv bits) decide
    surf = rng.integers(100, 104, (S, MB_H, MB_W, n, n)).astype(np.int32)
    surf[:, 1, 2, R + 2, R - 3] = 40            # a clear minimum
    fenc = rng.integers(0, 256, (S, 16 * MB_H, 16 * MB_W)).astype(np.int32)
    recon = rng.integers(0, 256, (S, 16 * MB_H, 16 * MB_W)).astype(np.uint8)
    lam = rng.integers(0, 6, (S, MB_H, MB_W)).astype(np.int32)
    ref4 = TMC.make_ref_planes(torch.from_numpy(recon))
    return surf, fenc, lam, ref4


def _jax_me(case):
    method, R, subme = ME_CASES[case]
    surf, fenc, lam, ref4 = _me_inputs(case)
    fn = jax.jit(lambda c, f, w, l: ME_FNS[method][0](
        c, f, w, l, MB_W, MB_H, R, MV_RANGE, subme=subme))
    return np.stack([np.asarray(fn(
        jnp.asarray(surf[s]), jnp.asarray(fenc[s]),
        JMG.luma_windows(jnp.asarray(ref4[s].numpy()), MB_W, MB_H),
        jnp.asarray(lam[s]))) for s in range(S)])


@pytest.fixture(scope="module")
def jax_results():
    """Every JAX reference, compiled side by side in threads."""
    jobs = [(_jax_lowres, c) for c in CASES] + [(_jax_me, c) for c in ME_CASES]
    with light_xla(), ThreadPoolExecutor(4) as pool:
        out = list(pool.map(lambda job: job[0](job[1]), jobs))
    return dict(zip([c for _, c in jobs], out))


@pytest.fixture(scope="module")
def port_lowres():
    return {c: _port_lowres(c) for c in CASES}


@pytest.mark.parametrize("key", ["planes", "icost", "pcost", "mv",
                                 "summary"])
@pytest.mark.parametrize("case", list(CASES))
def test_lowres_matches_jax(jax_results, port_lowres, case, key):
    np.testing.assert_array_equal(port_lowres[case][key],
                                  jax_results[case][key])


def test_flat_frame_takes_the_mv0_skip(port_lowres):
    """On the flat frame every block's P cost is its zero-MV SATD (0) plus
    the lowres penalty, with zero MVs; the textured cases move."""
    got = port_lowres["flat"]
    assert (got["pcost"] == TST.LOWRES_PENALTY).all()
    assert (got["mv"] == 0).all()
    assert (port_lowres["4x3"]["mv"] != 0).any()


@pytest.mark.parametrize("case", list(ME_CASES))
def test_decide_mvs_matches_jax(jax_results, case):
    method, R, subme = ME_CASES[case]
    surf, fenc, lam, ref4 = _me_inputs(case)
    wins = TMG.luma_windows(ref4, MB_W, MB_H).reshape(
        S * MB_H * MB_W, 4, TMG.WIN_L, TMG.WIN_L)
    got = ME_FNS[method][1](torch.from_numpy(surf), torch.from_numpy(fenc),
                            wins, torch.from_numpy(lam), MB_W, MB_H, R,
                            MV_RANGE, subme)
    assert got.shape == (S, MB_H, MB_W, 2)
    np.testing.assert_array_equal(got.numpy(), jax_results[case])


def test_subme0_leaves_the_full_pel_mvs():
    """subme 0 runs no subpel step: the refine returns its input MVs, for
    the 16x16 MVs and for a partition block."""
    surf, fenc, lam, ref4 = _me_inputs("umh-r4-subme0")
    B = S * MB_H * MB_W
    wins = TMG.luma_windows(ref4, MB_W, MB_H).reshape(B, 4, TMG.WIN_L,
                                                      TMG.WIN_L)
    rng = np.random.default_rng(3)
    mv = torch.from_numpy(4 * rng.integers(-4, 5, (S, MB_H, MB_W, 2))
                          .astype(np.int32))
    cost = torch.from_numpy(rng.integers(0, 999, (S, MB_H, MB_W))
                            .astype(np.int32))
    ranges = TIF.make_mv_ranges(MB_W, MB_H, MV_RANGE, "cpu")
    f = torch.from_numpy(fenc)
    got = TIF.subpel_refine_batch(mv, cost, torch.zeros_like(mv), f, wins,
                                  torch.from_numpy(lam), MB_W, MB_H, ranges,
                                  0)
    assert torch.equal(got, mv)
    f16 = TIF.tile_mb(f, MB_W, MB_H, 16)
    bmx, bmy = mv[..., 0].reshape(B), mv[..., 1].reshape(B)
    out = TIF._refine_block_batch(
        wins, f16[:, :8, :8], bmx, bmy, cost.reshape(B), bmx, bmy,
        torch.from_numpy(lam).reshape(B),
        TIF._flat_ranges(ranges, S, MB_W, MB_H), 0, 0,
        torch.ones(B, dtype=torch.bool), 0)
    assert torch.equal(out[0], bmx) and torch.equal(out[1], bmy)
