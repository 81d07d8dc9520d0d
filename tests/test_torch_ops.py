"""The port's leaf ops (pixel, transforms, intra predictors, the plane
residual pipeline, MC) against their JAX counterparts, exact equality on
seeded random inputs. The larger JAX references run under jax.jit (one
compiled program instead of one per small eager op)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from x264dsp_tpu.encoder import intra_frame as JIN
from x264dsp_tpu.ops import intra as JI
from x264dsp_tpu.ops import mc as JMC
from x264dsp_tpu.ops import mcgather as JMG
from x264dsp_tpu.ops import pixel as JPX
from x264dsp_tpu.ops import residual_plane as JRP
from x264dsp_tpu.ops import transforms as JT
from x264dsp_tpu_torch.encoder import intra_frame as TIN
from x264dsp_tpu_torch.ops import intra as TI
from x264dsp_tpu_torch.ops import mc as TMC
from x264dsp_tpu_torch.ops import mcgather as TMG
from x264dsp_tpu_torch.ops import pixel as TPX
from x264dsp_tpu_torch.ops import residual_plane as TRP
from x264dsp_tpu_torch.ops import transforms as TT


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(123)


@pytest.mark.parametrize("shape", [(6, 4, 4), (5, 16, 16), (3, 8, 8)])
def test_sad_satd_match_jax(rng, shape):
    a = rng.integers(0, 256, shape).astype(np.int32)
    b = rng.integers(0, 256, shape).astype(np.int32)
    _eq(TPX.sad(_t(a), _t(b)), JPX.sad(a, b))
    _eq(TPX.satd(_t(a), _t(b)), JPX.satd(a, b))
    if shape[-1] == 4:
        _eq(TPX.satd_4x4(_t(a), _t(b)), JPX.satd_4x4(a, b))


def test_dct_idct_hadamard_match_jax(rng):
    a = rng.integers(0, 256, (40, 4, 4)).astype(np.int32)
    b = rng.integers(0, 256, (40, 4, 4)).astype(np.int32)
    _eq(TT.sub_dct4x4(_t(a), _t(b)), JT.sub_dct4x4(a, b))
    coef = rng.integers(-3000, 3000, (40, 4, 4)).astype(np.int32)
    _eq(TT.idct4x4_add(_t(b), _t(coef)), JT.idct4x4_add(b, coef))
    for fwd in (True, False):
        _eq(TT.hadamard4x4(_t(coef), fwd), JT.hadamard4x4(coef, fwd))
    dc = rng.integers(-500, 500, (40, 4)).astype(np.int32)
    _eq(TT.hadamard2x2(_t(dc)), JT.hadamard2x2(dc))


@pytest.mark.parametrize("intra", [False, True])
def test_quant_dequant_zigzag_match_jax(rng, intra):
    coef = rng.integers(-4000, 4000, (52, 4, 4)).astype(np.int32)
    qp = np.arange(52, dtype=np.int32)
    q = TT.quant4x4(_t(coef), _t(qp), intra)
    _eq(q, JT.quant4x4(coef, qp, intra))
    _eq(TT.dequant4x4(q, _t(qp)), JT.dequant4x4(np.asarray(q), qp))
    _eq(TT.dequant_dc4x4(q, _t(qp)), JT.dequant_dc4x4(np.asarray(q), qp))
    dc = coef[:, 0]
    _eq(TT.quant_dc(_t(dc), _t(qp), intra), JT.quant_dc(dc, qp, intra))
    _eq(TT.zigzag4x4(_t(coef)), JT.zigzag4x4(coef))
    _eq(TT.idct_dequant_2x2_dc(_t(dc), _t(qp)),
        JT.idct_dequant_2x2_dc(dc, qp))


def test_optimize_chroma_dc_matches_jax(rng):
    dc = rng.integers(-6, 7, (200, 4)).astype(np.int32)
    qp = rng.integers(0, 30, 200).astype(np.int32)
    got_dc, got_nz = TIN.optimize_chroma_dc(_t(dc), _t(qp))
    want_dc, want_nz = JIN._optimize_chroma_dc(jnp.asarray(dc),
                                               jnp.asarray(qp))
    _eq(got_dc, want_dc)
    _eq(got_nz, want_nz)


def test_intra_predictors_match_jax(rng):
    n = 30
    l16, t16 = rng.integers(0, 256, (2, n, 16))
    tl = rng.integers(0, 256, n)
    _eq(TI.predict_16x16_all(_t(l16), _t(t16), _t(tl)),
        jax.jit(JI.predict_16x16_all)(l16, t16, tl))
    _eq(TI.predict_8x8c_all(_t(l16[:, :8]), _t(t16[:, :8]), _t(tl)),
        jax.jit(JI.predict_8x8c_all)(l16[:, :8], t16[:, :8], tl))
    l4, t4, tr4 = rng.integers(0, 256, (3, n, 4))
    _eq(TI.predict_4x4_all(_t(l4), _t(t4), _t(tl), _t(tr4)),
        jax.jit(JI.predict_4x4_all)(l4, t4, tl, tr4))


def test_plane_residual_pipeline_matches_jax(rng):
    mb_h, mb_w = 3, 4
    H, W = mb_h * 16, mb_w * 16
    fenc = rng.integers(0, 256, (H, W)).astype(np.int32)
    pred = np.clip(fenc + rng.integers(-20, 21, (H, W)), 0, 255).astype(
        np.int32)
    qp = rng.integers(10, 45, (mb_h, mb_w)).astype(np.int32)
    sub_dct_j = jax.jit(JRP.sub_dct_cm)
    cm_j = sub_dct_j(jnp.asarray(fenc), jnp.asarray(pred))
    cm_t = TRP.sub_dct_cm(_t(fenc)[None], _t(pred)[None])
    _eq(cm_t[0], np.stack([np.asarray(c) for c in cm_j]))
    for intra in (False, True):
        q_j = jax.jit(lambda c, q: JRP.quant_cm(c, q, intra, 4))(
            cm_j, jnp.asarray(qp))
        q_t = TRP.quant_cm(cm_t, _t(qp)[None], intra, 4)
        _eq(q_t[0], np.stack([np.asarray(c) for c in q_j]))
    z_j = jax.jit(JRP.zigzag_order)(q_j)
    z_t = TRP.zigzag_order(q_t)
    _eq(TRP.decimate_score_cm(z_t)[0], jax.jit(JRP.decimate_score_cm)(z_j))
    _eq(TRP.nnz_cm(z_t)[0], JRP.nnz_cm(z_j))
    _eq(TRP.luma_levels_coding(z_t, mb_h, mb_w)[0],
        JRP.luma_levels_coding(z_j, mb_h, mb_w))
    _eq(TRP.luma_nnz_coding(TRP.nnz_cm(z_t), mb_h, mb_w)[0],
        JRP.luma_nnz_coding(JRP.nnz_cm(z_j), mb_h, mb_w))
    dq_j = jax.jit(lambda c, q: JRP.dequant_cm(c, q, 4))(q_j,
                                                          jnp.asarray(qp))
    dq_t = TRP.dequant_cm(q_t, _t(qp)[None], 4)
    _eq(dq_t[0], np.stack([np.asarray(c) for c in dq_j]))
    _eq(TRP.idct_add_plane(_t(pred)[None], dq_t)[0],
        jax.jit(JRP.idct_add_plane)(jnp.asarray(pred), dq_j))
    zc_j = JRP.zigzag_order(sub_dct_j(jnp.asarray(fenc[:24, :32]),
                                      jnp.asarray(pred[:24, :32])))
    zc_t = TRP.zigzag_order(TRP.sub_dct_cm(_t(fenc[:24, :32])[None],
                                           _t(pred[:24, :32])[None]))
    _eq(TRP.chroma_levels_coding(zc_t, mb_h, mb_w)[0],
        JRP.chroma_levels_coding(zc_j, mb_h, mb_w))


def test_mc_matches_jax(rng):
    """mc_luma_multi / mc_chroma_batched / extract_windows4 by indexed
    loads equal the JAX one-hot matmul versions on every qpel phase."""
    mb_w, mb_h = 3, 2
    recon = rng.integers(0, 256, (mb_h * 16, mb_w * 16)).astype(np.uint8)
    ref4 = np.asarray(JMC.make_ref_planes(jnp.asarray(recon)))
    refc = np.asarray(JMC.pad_chroma(jnp.asarray(recon[::2, ::2])))
    wj = JMG.luma_windows(jnp.asarray(ref4), mb_w, mb_h)
    wcj = JMG.chroma_windows(jnp.asarray(refc), mb_w, mb_h)
    wt = TMG.luma_windows(_t(ref4)[None], mb_w, mb_h)[0]
    wct = TMG.chroma_windows(_t(refc)[None], mb_w, mb_h)[0]
    B = mb_w * mb_h
    mvx = rng.integers(-60, 60, (B, 5)).astype(np.int32)
    mvy = rng.integers(-60, 60, (B, 5)).astype(np.int32)
    _eq(TMG.mc_luma_multi(wt, _t(mvx), _t(mvy), 16, 16),
        jax.jit(lambda w, x, y: JMG.mc_luma_multi(w, x, y, 16, 16))(
            wj, jnp.asarray(mvx), jnp.asarray(mvy)))
    _eq(TMG.mc_luma_batched(wt, _t(mvx[:, 0]), _t(mvy[:, 0]), 8, 8, 8, 0),
        jax.jit(lambda w, x, y: JMG.mc_luma_batched(w, x, y, 8, 8, 8, 0))(
            wj, jnp.asarray(mvx[:, 0]), jnp.asarray(mvy[:, 0])))
    _eq(TMG.mc_chroma_batched(wct, _t(mvx[:, 1]), _t(mvy[:, 1]), 4, 4, 4, 0),
        jax.jit(lambda w, x, y: JMG.mc_chroma_batched(w, x, y, 4, 4, 4, 0))(
            wcj, jnp.asarray(mvx[:, 1]), jnp.asarray(mvy[:, 1])))
    bx = rng.integers(-15, 16, B).astype(np.int32)
    by = rng.integers(-15, 16, B).astype(np.int32)
    got = TMG.extract_windows4(wt, _t(bx), _t(by), 16, 16, 3)
    want = jax.jit(lambda w, x, y: JMG.extract_windows4(w, x, y, 16, 16, 3))(
        wj, jnp.asarray(bx), jnp.asarray(by))
    _eq(got.to(torch.int32), np.asarray(want).astype(np.int32))


def test_hpel_filter_matches_jax(rng):
    p = rng.integers(0, 256, (40, 56)).astype(np.int32)
    for got, want in zip(TMC.hpel_filter(_t(p)), JMC.hpel_filter(p)):
        _eq(got, want)
