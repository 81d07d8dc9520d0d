"""The port's P analysis against the JAX package, on the CPU: the 8x8
quadrant SAD surfaces (kernel K4's plain version), decide_partitions,
and encode_p_frame with the DIA or HEX walk, the subme recipes and the
16x8/8x16/8x8 partitions. Every comparison is exact (the codec is
integer exact); inputs come from numpy seeds.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from x264dsp_tpu.encoder import core as JC
from x264dsp_tpu.encoder import inter_frame as JIF
from x264dsp_tpu.ops import mc as JMC
from x264dsp_tpu.ops import mcgather as JMG
from x264dsp_tpu.ops.pallas.me_sad import make_ref_strips as j_strips
from x264dsp_tpu.ops.pallas.me_sad import sad_cost_surfaces_8x8
from x264dsp_tpu.ops.tables import CHROMA_QP_TABLE
import x264dsp_tpu_torch as xtt
from x264dsp_tpu_torch.encoder import inter_frame as TIF
from x264dsp_tpu_torch.ops import mc as TMC
from x264dsp_tpu_torch.ops import mcgather as TMG
from x264dsp_tpu_torch.ops import me_sad as TSAD
from x264dsp_tpu_torch.tools.mainpath import split_motion_clip
from torch_jaxref import light_xla

ME_RANGE, MV_RANGE = 16, 512


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# K4: the quadrant SAD surfaces
# --------------------------------------------------------------------------

def test_sad_surfaces_8x8_match_pallas_interpret_and_xla():
    """K4's plain version vs sad_cost_surfaces_8x8(interpret=True) and the
    XLA twin fullpel_cost_surfaces_8x8, 64x48, R = 16, two streams."""
    mb_w, mb_h, R = 4, 3, 16
    H, W = mb_h * 16, mb_w * 16
    rng = np.random.default_rng(41)
    fenc = rng.integers(0, 256, (2, H, W)).astype(np.int32)
    recon = rng.integers(0, 256, (2, H, W)).astype(np.uint8)
    ref_full = TMC.make_ref_planes(_t(recon))[:, 0].contiguous()
    strips = TSAD.make_ref_strips(ref_full, TMC.PAD_MC, mb_w, mb_h, R)
    xtt.reset_kernel_launches()
    got = TSAD.sad_cost_surfaces_8x8(_t(fenc), strips, mb_w, mb_h, R)
    assert got.shape == (2, mb_h, mb_w, 2, 2, 2 * R + 1, 2 * R + 1)
    assert got.dtype == torch.int32
    got16 = TIF.fullpel_cost_surfaces(_t(fenc), ref_full, mb_w, mb_h, R)
    assert xtt.kernel_launches()["sad_surfaces_8x8"] == 0
    for s in range(2):
        ref_j = jnp.asarray(ref_full[s].numpy())
        want = np.asarray(sad_cost_surfaces_8x8(
            jnp.asarray(fenc[s]), j_strips(ref_j, JMC.PAD_MC, mb_w, mb_h, R),
            mb_w=mb_w, mb_h=mb_h, R=R, interpret=True))
        np.testing.assert_array_equal(got[s].numpy(), want)
        xla = np.asarray(JIF.fullpel_cost_surfaces_8x8(
            jnp.asarray(fenc[s]), ref_j, mb_w, mb_h, R))
        np.testing.assert_array_equal(got[s].numpy(), xla)
        np.testing.assert_array_equal(got16[s].numpy(), xla.sum((2, 3)))


def test_argmin_takes_the_first_minimum():
    """decide_partitions relies on torch.argmin returning the first of
    equal minima, as jnp.argmin does."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 3, (64, 289)).astype(np.int32)
    np.testing.assert_array_equal(torch.argmin(_t(x), -1).numpy(),
                                  np.argmin(x, -1))


# --------------------------------------------------------------------------
# decide_partitions on surfaces with planted ties
# --------------------------------------------------------------------------

@pytest.mark.parametrize("subme", [1, 4])
def test_decide_partitions_matches_jax_with_ties(subme):
    mb_w, mb_h, R = 4, 3, 8
    n = 2 * R + 1
    H, W = mb_h * 16, mb_w * 16
    rng = np.random.default_rng(60 + subme)
    # flat surfaces of nearly equal costs: many ties at offsets whose mv
    # bits are equal too (symmetric about a full-pel 16x16 MV)
    cost8 = rng.integers(100, 103, (2, mb_h, mb_w, 2, 2, n, n)).astype(
        np.int32)
    mv16 = 4 * rng.integers(-3, 4, (2, mb_h, mb_w, 2)).astype(np.int32)
    mv16[:, 2] += rng.integers(-3, 4, (2, mb_w, 2)).astype(np.int32)
    mv16[:, 1] = 0
    lam = rng.integers(1, 6, (2, mb_h, mb_w)).astype(np.int32)

    def plant(mbx, quads, dx, dy):
        """Zero cost at offsets (dx, dy) of `quads` of MB (1, mbx), and at
        the mirror offset about the 16x16 MV: two equal minima."""
        cx, cy = mv16[:, 1, mbx, 0] // 4 + R, mv16[:, 1, mbx, 1] // 4 + R
        for s in range(2):
            for qy, qx in quads:
                cost8[s, 1, mbx, qy, qx, cy[s] + dy, cx[s] + dx] = 0
                cost8[s, 1, mbx, qy, qx, cy[s] - dy, cx[s] - dx] = 0
    for q, d in zip(((0, 0), (0, 1), (1, 0), (1, 1)), (1, 2, 3, 4)):
        plant(0, [q], d, 5 - d)                         # 8x8 wins
    plant(1, [(0, 0), (0, 1)], 2, 0)                    # 16x8 wins
    plant(1, [(1, 0), (1, 1)], 0, 3)
    plant(2, [(0, 0), (1, 0)], 3, 1)                    # 8x16 wins
    plant(2, [(0, 1), (1, 1)], 1, 3)
    # MBs whose four quadrants are equal: with lambda 0 every shape costs
    # the same, so the strict-less compare must keep 16x16
    cost8[:, 0, 1] = cost8[:, 0, 1, :1, :1]
    lam[:, 0, :2] = 0
    skip = rng.random((2, mb_h, mb_w)) < 0.2
    skip[:, 1, :3] = False
    fenc = rng.integers(0, 256, (2, H, W)).astype(np.int32)
    recon = rng.integers(0, 256, (2, H, W)).astype(np.uint8)
    ref4 = TMC.make_ref_planes(_t(recon))
    ties = (cost8 == cost8.min((-1, -2), keepdims=True)).sum((-1, -2))
    assert (ties > 1).any()

    wins_t = TMG.luma_windows(ref4, mb_w, mb_h).reshape(
        2 * mb_h * mb_w, 4, TMG.WIN_L, TMG.WIN_L)
    part, mv8 = TIF.decide_partitions(
        _t(cost8), _t(mv16), _t(fenc), wins_t, _t(lam), mb_w, mb_h, R,
        MV_RANGE, _t(skip), subme)
    got = part.numpy()
    assert (got[:, 0, 1] == 0).all()
    assert (got[:, 1, :3] == [3, 1, 2]).all()
    # one compiled program for both streams (eager JAX compiles every
    # small op on its own)
    j_decide = jax.jit(lambda c, m, f, w, l, k: JIF.decide_partitions(
        c, m, f, w, l, mb_w, mb_h, R, MV_RANGE, skip_mask=k, subme=subme))
    for s in range(2):
        wins_j = JMG.luma_windows(jnp.asarray(ref4[s].numpy()), mb_w, mb_h)
        with light_xla():
            jp, jmv8 = j_decide(
                jnp.asarray(cost8[s]), jnp.asarray(mv16[s]),
                jnp.asarray(fenc[s]), wins_j, jnp.asarray(lam[s]),
                jnp.asarray(skip[s]))
        np.testing.assert_array_equal(part[s].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(mv8[s].numpy(), np.asarray(jmv8))


# --------------------------------------------------------------------------
# encode_p_frame, four analysis settings
# --------------------------------------------------------------------------

MB_W = MB_H = 4
QPS = (26, 30)                  # one QP per stream
# (me_method, subme, partitions)
SETTINGS = {"dia-subme2-parts": (0, 2, True),
            "hex-subme4-parts": (1, 4, True),
            "hex-subme7": (1, 7, False),
            "dia-subme9-parts": (0, 9, True)}
P_KEYS = JC._DEV_SYN_P + ("mv", "bs", "feo", "recon_y", "recon_u", "recon_v",
                          "luma_nnz", "chroma_nnz_ac", "chroma_nz_dc")


@pytest.fixture(scope="module")
def split_frames():
    """Stream s codes split-motion frame 2 + s against frame 1 + s (the
    64x64 clip's first pair has no partition wins)."""
    frame = split_motion_clip(64, 64, torch.device("cpu"))
    return [[tuple(p.numpy() for p in frame(t)) for t in (1 + s, 2 + s)]
            for s in range(2)]


def _encode_both(name, split_frames):
    """One setting through the JAX encode_p_frame (per stream) and the
    port's (both streams stacked)."""
    method, subme, parts = SETTINGS[name]
    refs = []
    for s in range(2):
        y0, u0, v0 = split_frames[s][0]
        refs.append((np.asarray(JMC.make_ref_planes(jnp.asarray(y0))),
                     np.asarray(JMC.pad_chroma(jnp.asarray(u0))),
                     np.asarray(JMC.pad_chroma(jnp.asarray(v0)))))
    jax_out = []
    for s, qp in enumerate(QPS):
        g = lambda x: jnp.full((MB_H, MB_W), x, jnp.int32)  # noqa: E731
        out = JIF.encode_p_frame(
            *(jnp.asarray(a) for a in split_frames[s][1]),
            *(jnp.asarray(r) for r in refs[s]), g(qp),
            g(int(CHROMA_QP_TABLE[qp])), g(int(JC.LAMBDA_TAB[qp])),
            mb_w=MB_W, mb_h=MB_H, me_range=ME_RANGE, mv_range=MV_RANGE,
            dct_decimate=True, fast_pskip=True, partitions=parts, n_ref=1,
            subme=subme, me_method=method)
        jax_out.append({k: np.asarray(a) for k, a in out.items()})

    def grid(vals):
        return torch.tensor(vals, dtype=torch.int32)[:, None, None].expand(
            2, MB_H, MB_W).contiguous()

    def stack(rows, i):
        return torch.from_numpy(np.stack([r[i] for r in rows]))
    cur = [split_frames[s][1] for s in range(2)]
    port = TIF.encode_p_frame(
        stack(cur, 0), stack(cur, 1), stack(cur, 2),
        *(stack(refs, i) for i in range(3)), grid(QPS),
        grid([int(CHROMA_QP_TABLE[q]) for q in QPS]),
        grid([int(JC.LAMBDA_TAB[q]) for q in QPS]), MB_W, MB_H, ME_RANGE,
        MV_RANGE, True, fast_pskip=True, me_method=method, subme=subme,
        partitions=parts)
    return name, jax_out, port


@pytest.fixture(scope="module")
def all_p_frames(split_frames):
    """Every setting, the four JAX compiles side by side: XLA compiles
    outside the interpreter lock, so the threads overlap."""
    with light_xla(), ThreadPoolExecutor(len(SETTINGS)) as pool:
        return dict(zip(SETTINGS, pool.map(
            lambda name: _encode_both(name, split_frames), SETTINGS)))


@pytest.fixture(scope="module", params=list(SETTINGS))
def p_frames(request, all_p_frames):
    return all_p_frames[request.param]


@pytest.mark.parametrize("key", P_KEYS)
def test_encode_p_frame_matches_jax(p_frames, key):
    _, jax_out, port = p_frames
    for s in range(2):
        np.testing.assert_array_equal(port[key][s].numpy(), jax_out[s][key],
                                      err_msg=f"stream {s}")


def test_partitions_win_on_split_motion(p_frames):
    """With partitions on, the clip makes some MBs pick 16x8, 8x16 or
    8x8, so the comparison covers the partition path; with them off every
    MB is 16x16."""
    name, _, port = p_frames
    used = (port["partition"] > 0).any().item()
    assert used == SETTINGS[name][2]
