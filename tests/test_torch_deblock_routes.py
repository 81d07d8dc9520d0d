"""The port's wave and region deblock routes against the JAX package.

On the CPU the wrappers of kernels K5a, K5b and K6 run their plain
PyTorch versions; these tests hold the filter lanes to the JAX
_wave_lanes tensor by tensor, the plain versions to the Pallas kernels
in interpret mode (deblock_wave_luma / _chroma, filter_regions), and all
three routes of deblock_frame to the scalar golden model and to the JAX
deblock_frame_wave_batched (which runs the Pallas wave kernels, as
tests/test_deblock.py does). Every comparison is exact; inputs come from
numpy seeds: P-type frames with an intra mix, first-edge-only MBs and
per-MB QP grids, and all-intra frames.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from x264dsp_tpu.ops import deblock as JDB
from x264dsp_tpu.ops import golden as G
from x264dsp_tpu.ops.pallas.deblock_filter import filter_regions
from x264dsp_tpu.ops.tables import CHROMA_QP_TABLE
import x264dsp_tpu_torch as xtt
from x264dsp_tpu_torch.ops import deblock as TDB

S = 2
ARG_NAMES = ("y", "u", "v", "bs", "intra", "feo", "qp", "qpc")
CASES = {"p": dict(all_intra=False, seed=1),
         "intra": dict(all_intra=True, seed=2)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(mb_w, mb_h, seed, all_intra):
    """Blocky planes, so that edges trigger the filters, for S streams."""
    rng = np.random.default_rng(seed)
    H, W = mb_h * 16, mb_w * 16
    grid = (S, mb_h, mb_w)
    y = np.kron(rng.integers(0, 256, (S, mb_h * 4, mb_w * 4)),
                np.ones((1, 4, 4), int)) + rng.integers(-6, 7, (S, H, W))
    u = np.kron(rng.integers(0, 256, (S, mb_h * 2, mb_w * 2)),
                np.ones((1, 4, 4), int))
    if all_intra:
        intra = np.ones(grid, int)
        bs = np.full(grid + (2, 4, 4), 3)
        feo = np.zeros(grid, int)
    else:
        intra = (rng.random(grid) < 0.3).astype(int)
        bs = rng.integers(0, 3, grid + (2, 4, 4))
        bs[intra > 0] = 3
        feo = ((rng.random(grid) < 0.3) & (intra == 0)).astype(int)
    qp = rng.integers(18, 46, grid)
    vals = (y.clip(0, 255), u, 255 - u, bs, intra, feo, qp,
            CHROMA_QP_TABLE[qp])
    return {k: v.astype(np.int32) for k, v in zip(ARG_NAMES, vals)}


def _args(case):
    return [_t(case[k]) for k in ARG_NAMES]


def _lanes(case, mb_w, mb_h, a_off=0, b_off=0):
    return TDB.wave_lanes(*_args(case)[3:], a_off, b_off, mb_w, mb_h)


# --------------------------------------------------------------------------
# (a) the lanes
# --------------------------------------------------------------------------

MB_W, MB_H = 5, 4


@pytest.fixture(scope="module")
def jax_lanes():
    """_wave_lanes as one compiled program (the offsets are traced)."""
    return jax.jit(lambda b, i, f, q, qc, a, bo: JDB._wave_lanes(
        b, i, f, q, qc, a, bo, MB_W, MB_H))


@pytest.mark.parametrize("kind,offs", [("p", (0, 0)), ("intra", (0, 0)),
                                       ("p", (4, -2)), ("p", (-6, 12))])
def test_lanes_match_jax(jax_lanes, kind, offs):
    mb_w, mb_h = MB_W, MB_H
    case = _case(mb_w, mb_h, **CASES[kind])
    got = _lanes(case, mb_w, mb_h, *offs)
    D = mb_w + 2 * mb_h - 2
    assert got[0][0].shape[:2] == (S, D)
    names = (("tc0y", "eny", "uiy", "aly", "bly"),
             ("tcc", "enc", "uic", "alc", "blc"))
    for s in range(S):
        want = jax_lanes(*(jnp.asarray(case[k][s]) for k in ARG_NAMES[3:]),
                         *offs)
        for g_fam, w_fam, n_fam in zip(got, want, names):
            for g, w, name in zip(g_fam, w_fam, n_fam):
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g[s].numpy(), np.asarray(w),
                                              err_msg=f"{name}, stream {s}")


def test_diag_slots_match_jax_schedule():
    for mb_w, mb_h in ((5, 4), (7, 3), (1, 1), (2, 5)):
        n_diag, dmax, ys, xs = JDB._diag_schedule(mb_w, mb_h)
        got_ys, got_xs = TDB.diag_slots(mb_w, mb_h)
        assert got_ys.shape == (n_diag, dmax)
        np.testing.assert_array_equal(got_ys, np.asarray(ys))
        np.testing.assert_array_equal(got_xs, np.asarray(xs))


# --------------------------------------------------------------------------
# (b) the plain versions against the Pallas kernels in interpret mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(CASES))
def test_filter_regions_plain_matches_pallas(kind):
    """K6: 32 regions (two blocks of the Pallas grid) with the lanes of a
    frame's first 32 slots, random blocky pixels."""
    case = _case(MB_W, MB_H, **CASES[kind])
    luma_l, chroma_l = _lanes(case, MB_W, MB_H)
    K = 32
    ly = [t[0].reshape(-1, t.shape[-1])[:K].contiguous() for t in luma_l]
    lc = [t[0].reshape(-1, t.shape[-1])[:2 * K].contiguous()
          for t in chroma_l]
    assert ly[1].any() and (kind == "p") == (not ly[2].all(0)[0])
    rng = np.random.default_rng(7)
    regy = np.kron(rng.integers(0, 256, (K, 5, 5)), np.ones((1, 4, 4), int)) \
        + rng.integers(-6, 7, (K, 20, 20))
    regc = np.kron(rng.integers(0, 256, (2 * K, 3, 3)),
                   np.ones((1, 4, 4), int))
    regy = regy.clip(0, 255).astype(np.int32)
    regc = regc.astype(np.int32)
    # argument order: regy, regc, tc0y, tcc, eny, uiy, enc, uic, aly, bly,
    # alc, blc
    lanes = (ly[0], lc[0], ly[1], ly[2], lc[1], lc[2], ly[3], ly[4], lc[3],
             lc[4])
    xtt.reset_kernel_launches()
    got = TDB.filter_regions(_t(regy), _t(regc), *lanes)
    assert xtt.kernel_launches()["filter_regions"] == 0
    want = filter_regions(jnp.asarray(regy), jnp.asarray(regc),
                          *(jnp.asarray(t.numpy()) for t in lanes),
                          interpret=True)
    for g, w, src in zip(got, want, (regy, regc)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert (g.numpy() != src).any()


# --------------------------------------------------------------------------
# (c) the routes
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(CASES))
def routed(request):
    """One case through the three routes of the port, the golden model
    and the JAX wave route."""
    case = _case(MB_W, MB_H, **CASES[request.param])
    outs = {r: TDB.deblock_frame(*_args(case), 0, 0, MB_W, MB_H, route=r)
            for r in (None, "wave", "region")}
    golden = [G.deblock_frame_golden(*(case[k][s] for k in ARG_NAMES))
              for s in range(S)]
    jax_wave = JDB.deblock_frame_wave_batched(
        *(jnp.asarray(case[k]) for k in ARG_NAMES), 0, 0, mb_w=MB_W,
        mb_h=MB_H, interpret=True)
    return outs, golden, [np.asarray(p) for p in jax_wave], case


def test_wave_plain_matches_pallas(routed):
    """K5a / K5b: the plain wavefronts on the port's lanes (equal to the
    JAX lanes, see above) against deblock_wave_luma and deblock_wave_chroma
    in interpret mode, which deblock_frame_wave_batched runs."""
    _, _, jax_wave, case = routed
    y, u, v = _args(case)[:3]
    luma_l, chroma_l = _lanes(case, MB_W, MB_H)
    xtt.reset_kernel_launches()
    gy = TDB.deblock_wave_luma(y, *luma_l, MB_W, MB_H)
    gu, gv = TDB.deblock_wave_chroma(u, v, *chroma_l, MB_W, MB_H)
    assert all(n == 0 for n in xtt.kernel_launches().values())
    for g, w, name in zip((gy, gu, gv), jax_wave, "yuv"):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        assert (g.numpy() != case[name]).any()


@pytest.mark.parametrize("route", [None, "wave", "region"])
def test_route_matches_golden_and_jax_wave(routed, route):
    outs, golden, jax_wave, _ = routed
    for i, name in enumerate("yuv"):
        got = outs[route][i].numpy()
        np.testing.assert_array_equal(got, jax_wave[i], err_msg=name)
        for s in range(S):
            np.testing.assert_array_equal(got[s], golden[s][i],
                                          err_msg=f"{name}, stream {s}")


@pytest.mark.parametrize("mb_w,mb_h,offs", [(7, 3, (0, 0)), (2, 5, (2, -2)),
                                            (1, 1, (0, 0))])
def test_routes_agree_on_other_grids(mb_w, mb_h, offs):
    """Wide, tall and single-MB frames, slice offsets: the wave and region
    routes return the default route's planes (and the golden model's)."""
    case = _case(mb_w, mb_h, seed=5, all_intra=False)
    want = TDB.deblock_frame(*_args(case), *offs, mb_w, mb_h)
    for s in range(S):
        gold = G.deblock_frame_golden(*(case[k][s] for k in ARG_NAMES),
                                      *offs)
        for w, g in zip(want, gold):
            np.testing.assert_array_equal(w[s].numpy(), g)
    for route in ("wave", "region"):
        got = TDB.deblock_frame(*_args(case), *offs, mb_w, mb_h, route=route)
        for g, w in zip(got, want):
            assert torch.equal(g, w), route


def test_unknown_route_raises():
    case = _case(2, 2, seed=3, all_intra=False)
    with pytest.raises(ValueError, match="route"):
        TDB.deblock_frame(*_args(case), 0, 0, 2, 2, route="skew")
