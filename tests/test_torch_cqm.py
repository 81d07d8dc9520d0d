"""The port's scaling lists and noise reduction at the unit level, against
the JAX package on the CPU (no JAX Encoder is compiled here):

  - quant, DC quant, dequant, DC dequant and the 2x2 chroma DC dequant
    (ops/transforms.py), the plane quant / dequant (ops/residual_plane.py)
    and the chroma DC rounding (optimize_chroma_dc) for a custom list set
    and the JVT set, each of the four lists 4IY/4PY/4IC/4PC, at QPs over
    the whole range, exactly;
  - the Encoder's scaling lists (the JAX core's cqm key), JVT and custom;
  - x264_denoise_dct over the coefficient planes (inter_frame._denoise_cm)
    with its sums over the live blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import x264dsp_tpu as xt
import x264dsp_tpu_torch as xtt
from x264dsp_tpu import params as P
from x264dsp_tpu.ops import residual_plane as JRP
from x264dsp_tpu.ops import transforms as JT
from x264dsp_tpu.ops.tables import CQM_JVT_LISTS
from x264dsp_tpu_torch.encoder import core as TC
from x264dsp_tpu_torch.encoder import inter_frame as TIF
from x264dsp_tpu_torch.encoder import intra_frame as TIFR
from x264dsp_tpu_torch.ops import residual_plane as TRP
from x264dsp_tpu_torch.ops import transforms as TT

_rng = np.random.default_rng(17)
CUSTOM = tuple(tuple(int(v) for v in _rng.integers(4, 81, 16))
               for _ in range(4))
LISTS = {"custom": CUSTOM, "jvt": CQM_JVT_LISTS}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _coefs(rng, shape, scale=3000):
    return rng.integers(-scale, scale + 1, shape).astype(np.int32)


@pytest.mark.parametrize("lists", list(LISTS))
@pytest.mark.parametrize("cqm_set", [0, 1, 2, 3])
def test_block_quant_dequant_match_jax(lists, cqm_set):
    cqm = LISTS[lists]
    rng = np.random.default_rng(cqm_set)
    dct = _coefs(rng, (52, 4, 4))
    qp = np.arange(52, dtype=np.int32)
    intra = cqm_set in (0, 2)

    @jax.jit
    def ref(dct, qp):
        q = JT.quant4x4(dct, qp, intra, cqm, cqm_set)
        dc = JT.quant_dc(dct.reshape(52, 16), qp, intra, cqm, cqm_set)
        return (q, JT.dequant4x4(q, qp, cqm, cqm_set), dc,
                JT.dequant_dc4x4(dc.reshape(52, 4, 4) // 8, qp, cqm, cqm_set),
                JT.idct_dequant_2x2_dc(dc[:, :4], qp, cqm, cqm_set))
    want = [np.asarray(a) for a in ref(jnp.asarray(dct), jnp.asarray(qp))]
    d, q_t = _t(dct), _t(qp)
    q = TT.quant4x4(d, q_t, intra, cqm, cqm_set)
    dc = TT.quant_dc(d.reshape(52, 16), q_t, intra, cqm, cqm_set)
    got = (q, TT.dequant4x4(q, q_t, cqm, cqm_set), dc,
           TT.dequant_dc4x4(torch.div(dc.reshape(52, 4, 4), 8,
                                      rounding_mode="floor"), q_t, cqm,
                            cqm_set),
           TT.idct_dequant_2x2_dc(dc[:, :4], q_t, cqm, cqm_set))
    for name, g, w in zip(("quant", "dequant", "quant_dc", "dequant_dc",
                           "idct_dequant_2x2_dc"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # the lists are not flat: the flat tables give other levels
    assert not torch.equal(q, TT.quant4x4(d, q_t, intra))


@pytest.mark.parametrize("lists", list(LISTS))
@pytest.mark.parametrize("cqm_set,k_up", [(1, 4), (3, 2)])
def test_plane_quant_dequant_match_jax(lists, cqm_set, k_up):
    """quant_cm / dequant_cm over coefficient planes with a per-MB QP
    grid (the P residual's luma and chroma sets)."""
    cqm = LISTS[lists]
    rng = np.random.default_rng(k_up)
    mb_h, mb_w = 3, 4
    cm = _coefs(rng, (16, mb_h * k_up, mb_w * k_up))
    qp = rng.integers(0, 52, (mb_h, mb_w)).astype(np.int32)

    @jax.jit
    def ref(cm, qp):
        q = JRP.quant_cm(list(cm), qp, False, k_up, cqm, cqm_set)
        return jnp.stack(q), jnp.stack(JRP.dequant_cm(q, qp, k_up, cqm,
                                                      cqm_set))
    wq, wd = (np.asarray(a) for a in ref(jnp.asarray(cm), jnp.asarray(qp)))
    q = TRP.quant_cm(_t(cm)[None], _t(qp)[None], False, k_up, cqm, cqm_set)
    d = TRP.dequant_cm(q, _t(qp)[None], k_up, cqm, cqm_set)
    np.testing.assert_array_equal(q[0].numpy(), wq)
    np.testing.assert_array_equal(d[0].numpy(), wd)


@pytest.mark.parametrize("lists", list(LISTS))
@pytest.mark.parametrize("cqm_set", [2, 3])
def test_optimize_chroma_dc_matches_jax(lists, cqm_set):
    from x264dsp_tpu.encoder.intra_frame import _optimize_chroma_dc
    cqm = LISTS[lists]
    rng = np.random.default_rng(cqm_set + 7)
    dc = rng.integers(-6, 7, (2000, 4)).astype(np.int32)
    qp = rng.integers(0, 23, 2000).astype(np.int32)
    w_dc, w_nz = jax.jit(lambda d, q: _optimize_chroma_dc(d, q, cqm,
                                                          cqm_set))(
        jnp.asarray(dc), jnp.asarray(qp))
    g_dc, g_nz = TIFR.optimize_chroma_dc(_t(dc), _t(qp), cqm, cqm_set)
    np.testing.assert_array_equal(g_dc.numpy(), np.asarray(w_dc))
    np.testing.assert_array_equal(g_nz.numpy(), np.asarray(w_nz))


@pytest.mark.parametrize("preset", [P.CQM_JVT, P.CQM_CUSTOM])
def test_cqm_key_matches_jax(preset):
    """The frame step's scaling lists (core.cqm_lists) are the JAX core's
    cqm key (x264dsp_tpu/encoder/core.py:383-393); the SPS and PPS bytes
    are held in test_torch_hostcopies.py."""
    ps = []
    for pkg in (xt, xtt):
        p = pkg.param_default()
        p.i_width, p.i_height = 56, 40
        p.i_cqm_preset = preset
        if preset == P.CQM_CUSTOM:
            p.cqm_4iy, p.cqm_4py, p.cqm_4ic, p.cqm_4pc = CUSTOM
        ps.append(p)
    want = xt.Encoder(ps[0])._core.cqm
    got = xtt.Encoder(ps[1], device="cpu")
    assert TC.cqm_lists(got.param) == want
    assert want == (CQM_JVT_LISTS if preset == P.CQM_JVT else CUSTOM)


def test_denoise_matches_jax():
    from x264dsp_tpu.encoder.inter_frame import _denoise_cm
    rng = np.random.default_rng(5)
    cm = _coefs(rng, (16, 8, 12), 400)
    off = rng.integers(0, 60, 16).astype(np.int32)
    live = rng.random((8, 12)) < 0.7
    w_out, w_sums = jax.jit(lambda c, o, lv: _denoise_cm(list(c), o, lv))(
        jnp.asarray(cm), jnp.asarray(off), jnp.asarray(live))
    g_out, g_sums = TIF._denoise_cm(_t(cm)[None], _t(off),
                                    torch.from_numpy(live)[None])
    np.testing.assert_array_equal(g_out[0].numpy(), np.stack(w_out))
    np.testing.assert_array_equal(g_sums[0].numpy(), np.asarray(w_sums))
