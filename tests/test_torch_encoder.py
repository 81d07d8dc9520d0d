"""The port's single-stream Encoder (the x264.h API) against the JAX one.

On the CPU, x264dsp_tpu_torch.Encoder and the JAX Encoder get the same
56x40 clip (padded to 64x48, cropped back in the SPS), eight frames with
a hard cut at frame 6, with the settings of tools/mainpath.py:
  (a) encoder_param, param_default(): CRF 28, CABAC, scenecut 20,
      keyint 50;
  (b) encoder_cqp_param with ENCODER_FORCED: CQP 20 with CABAC, HEX, subme 4 and the partitions, deblock offsets
      (-2, 1), a chroma QP offset, PSNR and SSIM, no in-band headers, a
      forced IDR, a forced I inside keyint_min and a P frame forced to
      QP 18: the slice headers turn the filter off on the I frames (QP
      17) and on that P frame, and on on the other P frames (QP 20);
  (abr) param_default() under ABR at 30 kbit/s, where the in-band
      SPS/PPS are a large share of frame 0's bits, so a rate control
      that missed them would move later QPs;
and must write the same NALs, byte for byte, with equal pic_out planes,
QPs, frame types, headers and close() summary (SSIM, a float32 sum in
another order, to 1e-6). The JAX runs compile in two threads side by
side, with most XLA optimizations off. The port alone: (c) under CRF + CAVLC
its Encoder equals its BatchEncoder at S = 1; (d) (a)'s stream decodes
to the port's pic_out; (h) torch pictures give numpy pictures' bytes;
and (a)'s CAVLC twin at its QPs (mainpath.cabac_twin, the check that
chip_smoke.py runs at 1080p) rewrites (a)'s slices.
"""

import copy
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import x264dsp_tpu as xt
import x264dsp_tpu_torch as xtt
from torch_jaxref import light_xla
from x264dsp_tpu import params as P
from x264dsp_tpu_torch.encoder import core as TC
from x264dsp_tpu_torch.tools.mainpath import (ENCODER_FORCED, cabac_twin,
                                              encode_clip, encoder_cqp_param,
                                              encoder_param, scene_cut_clip)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
from h264_decode import Decoder  # noqa: E402

W, H, N, CUT = 56, 40, 8, 6


def _default(pkg):
    return encoder_param(W, H, pkg.param_default())


def _cqp_cabac(pkg):
    return encoder_cqp_param(W, H, pkg.param_default())


def _abr(pkg):
    p = _default(pkg)
    p.rc.i_rc_method = P.RC_ABR
    p.rc.i_bitrate = 30
    return p


CASES = {"a": (_default, {}), "b": (_cqp_cabac, ENCODER_FORCED),
         "abr": (_abr, {})}


def _encode(pkg, param, frames, forced, make_enc=None, as_tensor=False):
    """Encode `frames` with pkg's Encoder and Picture
    (mainpath.encode_clip); no frame may wait (no VBV, so no lookahead
    queue) and encode(None) must return nothing."""
    enc = make_enc(param) if make_enc else pkg.Encoder(param)
    if as_tensor:
        frames = [[torch.from_numpy(a) for a in f] for f in frames]
    run = encode_clip(enc, frames, forced, pkg.Picture)
    assert run["tail"] == ([], None)
    assert not run["waiting"] and len(run["pics"]) == len(frames)
    return run


def _port(param, frames, forced, **kw):
    return _encode(xtt, param, frames, forced,
                   lambda p: xtt.Encoder(p, device="cpu"), **kw)


@pytest.fixture(scope="module")
def frames():
    return scene_cut_clip(W, H, N, CUT)


@pytest.fixture(scope="module")
def jax_runs(frames):
    """The JAX Encoders, (a) then ABR (which reuses (a)'s compiles) beside
    (b): XLA compiles outside the interpreter lock."""
    def run(names):
        return {name: _encode(xt, CASES[name][0](xt), frames, CASES[name][1])
                for name in names}
    runs = {}
    with light_xla(), ThreadPoolExecutor(2) as pool:
        for part in pool.map(run, (("a", "abr"), ("b",))):
            runs.update(part)
    return runs


@pytest.fixture(scope="module")
def port_runs(frames):
    """The port's runs on the CPU; every call of the C++ CABAC writer is
    recorded (its arguments and result) for the writer test."""
    calls = []
    writer = TC.native.write_slice_cabac

    def recording(*a, **k):
        out = writer(*a, **k)
        calls.append((a, k, out))
        return out
    TC.native.write_slice_cabac = recording
    try:
        runs = {name: _port(make(xtt), frames, forced)
                for name, (make, forced) in CASES.items()}
    finally:
        TC.native.write_slice_cabac = writer
    runs["writer_calls"] = calls
    return runs


def _types(run):
    return [po.i_frame_type for po in run["pics"]]


@pytest.mark.parametrize("name", list(CASES))
def test_nals_match_jax_encoder(jax_runs, port_runs, name):
    want, got = jax_runs[name], port_runs[name]
    assert got["headers"] == want["headers"]
    for t in range(N):
        assert got["nals"][t] == want["nals"][t], f"frame {t}"


@pytest.mark.parametrize("name", list(CASES))
def test_pic_out_matches_jax_encoder(jax_runs, port_runs, name):
    for t, (g, w) in enumerate(zip(port_runs[name]["pics"],
                                   jax_runs[name]["pics"])):
        assert (g.i_frame_qp, g.i_frame_type, g.i_pts) == \
            (w.i_frame_qp, w.i_frame_type, w.i_pts), f"frame {t}"
        for plane in "yuv":
            np.testing.assert_array_equal(getattr(g, plane),
                                          getattr(w, plane),
                                          err_msg=f"{plane} frame {t}")
        assert g.y.shape == (H, W)


@pytest.mark.parametrize("name", list(CASES))
def test_close_summary_matches_jax_encoder(jax_runs, port_runs, name):
    got = dict(port_runs[name]["summary"])
    want = dict(jax_runs[name]["summary"])
    assert got.pop("ssim_y", None) == pytest.approx(want.pop("ssim_y", None),
                                                    rel=1e-6)
    assert got == want


def test_default_has_a_scenecut_idr(port_runs):
    """(a) is not vacuous: the cut gives an IDR after frame 0, the CRF
    QPs move, and the stream is CABAC (cabac_init_idc in P headers)."""
    types = _types(port_runs["a"])
    assert types[0] == P.TYPE_IDR and types[CUT] == P.TYPE_IDR
    assert types.count(P.TYPE_IDR) == 2
    assert len({po.i_frame_qp for po in port_runs["a"]["pics"]}) > 2
    assert port_runs["writer_calls"]


def test_forced_types_and_qp(port_runs):
    """(b): the forced IDR, the non-IDR I inside keyint_min and the forced
    QP of ENCODER_FORCED; the filter is off at the I frames' QP 17 and the
    forced 18, on at the P frames' 20."""
    pics = port_runs["b"]["pics"]
    assert _types(port_runs["b"])[2] == P.TYPE_IDR
    assert pics[4].i_frame_type == P.TYPE_I
    assert [t for t, _ in port_runs["b"]["nals"][4]] == [P.NAL_SLICE]
    assert pics[5].i_frame_qp == 18
    p = xtt.validate_parameters(_cqp_cabac(xtt))
    assert pics[4].i_frame_qp == 17 and pics[6].i_frame_qp == 20
    assert not TC.deblock_enabled(p, 17) and not TC.deblock_enabled(p, 18)
    assert TC.deblock_enabled(p, 20)


def test_analysis_does_not_read_the_entropy_mode(frames, port_runs):
    """(b) with CAVLC in place of CABAC: other bytes, the same pic_out
    planes, QPs and types (what the card's CQP + CAVLC twin relies on)."""
    p = _cqp_cabac(xtt)
    p.b_cabac = 0
    cavlc = _port(p, frames, ENCODER_FORCED)
    for t, (g, w) in enumerate(zip(cavlc["pics"], port_runs["b"]["pics"])):
        assert (g.i_frame_qp, g.i_frame_type) == (w.i_frame_qp,
                                                  w.i_frame_type)
        for plane in "yuv":
            np.testing.assert_array_equal(getattr(g, plane),
                                          getattr(w, plane))
    assert cavlc["nals"] != port_runs["b"]["nals"]


def test_cabac_twin_rewrites_the_cabac_run(frames, port_runs):
    """(a)'s CAVLC twin, each frame forced to (a)'s QP, over the whole
    clip (the scenecut IDR included): the same types, QPs and pic_out; a
    device payload equal to the host writers'; and its syntax, written by
    the C++ CABAC writer with the twin's slice header fields, gives (a)'s
    slice NALs byte for byte."""
    bits = cabac_twin(_default(xtt), port_runs["a"], frames, N)
    assert len(bits) == N and min(bits) > 0


def test_cabac_stream_decodes_to_pic_out(port_runs):
    """(d) the CABAC stream of (a) decodes (tools/h264_decode.py) to the
    port's cropped pic_out."""
    run = port_runs["a"]
    stream = b"".join(b for _, b in run["headers"])
    stream += b"".join(b for nl in run["nals"] for _, b in nl)
    dec = Decoder().decode(stream)
    assert len(dec) == N
    for t, (planes, po) in enumerate(zip(dec, run["pics"])):
        for d, plane in zip(planes, "yuv"):
            np.testing.assert_array_equal(d, getattr(po, plane),
                                          err_msg=f"{plane} frame {t}")


def test_slicetype_decider_matches_jax(frames, jax_runs):
    """(e) decide() of both deciders over (a)'s clip: type, key, cost
    and the per-row costs (the JAX one's summary is compiled by then)."""
    from x264dsp_tpu.encoder.slicetype import SlicetypeDecider as JD
    from x264dsp_tpu_torch.encoder.slicetype import SlicetypeDecider as TD
    p = xtt.validate_parameters(_default(xtt))
    jd, td = JD(xt.validate_parameters(_default(xt))), TD(p)
    keys = []
    with light_xla():
        for y, _, _ in frames:
            fy = TC.pad_mod16(y, 16)
            want = jd.decide(fy)
            got = td.decide(torch.from_numpy(fy))
            assert got == want
            np.testing.assert_array_equal(td.row_costs, jd.row_costs)
            keys.append(got[1])
    assert keys.count(True) == 2


def test_cabac_writer_matches_jax(port_runs):
    """(f) the port's native.write_slice_cabac against the JAX package's
    on the syntax of every frame of every case."""
    from x264dsp_tpu.entropy import native as JN
    calls = port_runs["writer_calls"]
    assert len(calls) == len(CASES) * N
    for a, k, (payload, counts) in calls:
        want, want_counts = JN.write_slice_cabac(*a, **k)
        assert payload == want
        np.testing.assert_array_equal(counts, want_counts)


def test_encoder_equals_batch_encoder_at_one_stream(frames):
    """(c) CRF + CAVLC, scenecut off, keyint 4: the port's Encoder writes
    its BatchEncoder's bytes at S = 1 when each slot is drained before the
    next (so that each rate control sees every frame's size in time), and
    pic_out is the batch's recon."""
    p = _default(xtt)
    p.b_cabac = 0
    p.i_scenecut_threshold = 0
    p.i_keyint_max = 4
    enc = _port(copy.deepcopy(p), frames, {})
    be = xtt.BatchEncoder(p, 1, device="cpu")
    for t, planes in enumerate(frames):
        assert be.encode_batch([xtt.Picture.from_planes(*planes)]) is None
        nals = be.encode_batch(None)[0]
        assert [(n.i_type, n.payload) for n in nals] == enc["nals"][t]
        assert be.last_qps == [enc["pics"][t].i_frame_qp]
        for r, plane in zip(be.last_recon, "yuv"):
            want = getattr(enc["pics"][t], plane)
            np.testing.assert_array_equal(
                r[0].numpy()[:want.shape[0], :want.shape[1]], want)
    be.close()
    assert [po.i_frame_type for po in enc["pics"]].count(P.TYPE_IDR) == 2


def test_torch_picture_gives_numpy_bytes(frames, port_runs):
    """(h) tensors pass Picture.from_planes unconverted and are padded on
    their device; the bytes and planes are the numpy pictures'."""
    pic = xtt.Picture.from_planes(*(torch.from_numpy(a) for a in frames[0]))
    assert torch.is_tensor(pic.y)
    run = _port(_default(xtt), frames, {}, as_tensor=True)
    assert run["nals"] == port_runs["a"]["nals"]
    for g, w in zip(run["pics"], port_runs["a"]["pics"]):
        np.testing.assert_array_equal(g.y, w.y)
        np.testing.assert_array_equal(g.v, w.v)


REFUSED = {
    "slice count": lambda p: setattr(p, "i_slice_count", 2),
    "slice max mbs": lambda p: setattr(p, "i_slice_max_mbs", 4),
    "slice max size": lambda p: setattr(p, "i_slice_max_size", 400),
    "intra refresh": lambda p: setattr(p, "b_intra_refresh", 1),
}
FEATURE = {"slice count": "slice", "slice max mbs": "slice",
           "slice max size": "slice", "intra refresh": "intra refresh"}


@pytest.mark.parametrize("name", list(REFUSED))
def test_unported_settings_raise(name):
    """(g) every setting of the JAX Encoder that the port does not take
    (the multi-slice settings and intra refresh) raises ValidationError
    naming the feature; the JAX Encoder takes it."""
    pj, pt = _default(xt), _default(xtt)
    REFUSED[name](pj)
    REFUSED[name](pt)
    xt.Encoder(pj)
    with pytest.raises(xtt.ValidationError, match=FEATURE[name]):
        xtt.Encoder(pt, device="cpu")


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xtt.Encoder(_default(xtt))


def test_api_helpers():
    pic = xtt.picture_alloc(W, H)
    assert pic.y.shape == (H, W) and pic.u.shape == (H // 2, W // 2)
    pic.i_type = P.TYPE_I
    xtt.picture_init(pic)
    assert pic.i_type == P.TYPE_AUTO and pic.y is None
    pic = xtt.picture_alloc(W, H)
    xtt.picture_clean(pic)
    assert pic.y is None
    with pytest.raises(ValueError):
        xtt.picture_alloc(W, H, i_csp=0)
    nal = xtt.NAL(P.NAL_SPS, 3, b"\x00\x00\x00\x01\x67")
    assert xtt.nal_encode(nal) == nal.payload
    assert (xtt.BIT_DEPTH, xtt.CHROMA_FORMAT) == (xt.BIT_DEPTH,
                                                  xt.CHROMA_FORMAT)
    enc = xtt.Encoder(_default(xtt), device="cpu")
    q = enc.parameters()
    assert q.rc.f_rf_constant == 28.0 and q is not enc.param
    assert enc.stats["frames"] == {P.SLICE_TYPE_I: 0, P.SLICE_TYPE_P: 0}


def test_ssim_matches_jax():
    from x264dsp_tpu.ops.pixel import ssim_wxh as jssim
    from x264dsp_tpu_torch.ops.pixel import ssim_wxh as tssim
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (38, 54)).astype(np.uint8)
    b = np.clip(a + rng.integers(-9, 10, a.shape), 0, 255).astype(np.uint8)
    ws, wc = jssim(a, b)
    gs, gc = tssim(torch.from_numpy(a), torch.from_numpy(b))
    assert gc == wc
    assert float(gs) == pytest.approx(float(ws), rel=1e-6)
