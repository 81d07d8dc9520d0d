"""The port's own copies of the JAX package's JAX-free host modules
(params, api, sets, ratecontrol, bitstream, the C++ CAVLC writers, the
Python CAVLC block writer and the core's overflow detector that runs it,
the CLI's utils/annexb.py and utils/yuv.py) against their originals, on
the CPU.

Each test builds the port's parameters with the port's param_default()
and the JAX package's with its own, through one helper that sets the
same fields on both.
"""

import dataclasses

import numpy as np
import pytest
import torch

import x264dsp_tpu as xt
from x264dsp_tpu import params as JP
from x264dsp_tpu.encoder.ratecontrol import RateControl as JRateControl
from x264dsp_tpu.encoder.sets import PPS as JPPS
from x264dsp_tpu.encoder.sets import SPS as JSPS
from x264dsp_tpu.entropy import native as jnative
from x264dsp_tpu.entropy.bitstream import BitWriter as JBitWriter
import x264dsp_tpu_torch as xtt
from x264dsp_tpu_torch import params as TP
from x264dsp_tpu_torch.encoder import intra_frame as TIN
from x264dsp_tpu_torch.encoder.ratecontrol import RateControl as TRateControl
from x264dsp_tpu_torch.encoder.sets import PPS as TPPS
from x264dsp_tpu_torch.encoder.sets import SPS as TSPS
from x264dsp_tpu_torch.entropy import native as tnative
from x264dsp_tpu_torch.entropy.bitstream import BitWriter as TBitWriter
from x264dsp_tpu_torch.ops.tables import CHROMA_QP_TABLE
from x264dsp_tpu_torch.tools import mainpath

# name -> field changes (dotted paths), applied to both packages' params
SETTINGS = {
    "default": {"i_width": 64, "i_height": 48},
    "no-size": {},
    "main-path": "main_path_param",
    "faster-1ref": "faster_1ref_param",
    "1080p-crf": {"i_width": 1920, "i_height": 1080, "rc.i_rc_method": 1,
                  "rc.f_rf_constant": 20.0, "i_keyint_max": 30},
    "clipped": {"i_width": 352, "i_height": 288,
                "analyse.i_subpel_refine": 20, "analyse.i_me_method": 9,
                "i_frame_reference": 20, "rc.i_qp_constant": 70,
                "i_deblocking_filter_alphac0": 9},
    "cqp-vui": {"i_width": 640, "i_height": 360, "rc.i_rc_method": 0,
                "rc.i_qp_constant": 33, "i_fps_num": 30000,
                "i_fps_den": 1001, "vui.i_sar_width": 4,
                "vui.i_sar_height": 3, "b_cabac": 0},
    # the scaling lists in the PPS (profile High), 3 references in the PPS
    # default, noise reduction
    "cqm-jvt": {"i_width": 56, "i_height": 40, "i_cqm_preset": 1,
                "i_frame_reference": 3, "analyse.i_noise_reduction": 100},
    "cqm-custom": {"i_width": 56, "i_height": 40, "i_cqm_preset": 2,
                   "cqm_4iy": tuple(range(6, 22)),
                   "cqm_4py": (16,) * 8 + (40,) * 8,
                   "cqm_4ic": tuple(range(30, 14, -1)),
                   "cqm_4pc": (8, 9, 10, 11) * 4, "b_cabac": 0},
}


def _set(p, changes):
    for path, val in changes.items():
        obj = p
        *parents, leaf = path.split(".")
        for name in parents:
            obj = getattr(obj, name)
        assert hasattr(obj, leaf), path
        setattr(obj, leaf, val)
    return p


def _both(name):
    """(port param, JAX param) with the setting's fields set on both."""
    spec = SETTINGS[name]
    if isinstance(spec, str):
        make = getattr(mainpath, spec)
        return (make(64, 64, 26, 4, TP.param_default()),
                make(64, 64, 26, 4, JP.param_default()))
    return _set(TP.param_default(), spec), _set(JP.param_default(), spec)


def test_param_default_matches_jax():
    assert dataclasses.asdict(xtt.param_default()) == \
        dataclasses.asdict(xt.param_default())


@pytest.mark.parametrize("name", list(SETTINGS))
def test_validate_parameters_matches_jax(name):
    tp, jp = _both(name)
    if name == "no-size":
        for validate, err in ((TP.validate_parameters, TP.ValidationError),
                              (JP.validate_parameters, JP.ValidationError)):
            with pytest.raises(err, match="invalid width x height"):
                validate(tp if validate is TP.validate_parameters else jp)
        return
    tv, jv = TP.validate_parameters(tp), JP.validate_parameters(jp)
    assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
    assert TP.param2string(tv) == JP.param2string(jv)


@pytest.mark.parametrize("name", [n for n in SETTINGS if n != "no-size"])
def test_sps_pps_bytes_match_jax(name):
    tp, jp = (f(p) for f, p in zip((TP.validate_parameters,
                                    JP.validate_parameters), _both(name)))
    out = []
    for p, sps_cls, pps_cls, bw_cls in ((tp, TSPS, TPPS, TBitWriter),
                                        (jp, JSPS, JPPS, JBitWriter)):
        sps = sps_cls.init(p, p.i_sps_id)
        pps = pps_cls.init(p, sps, p.i_sps_id)
        got = []
        for unit in (sps, pps):
            bw = bw_cls()
            unit.write(bw)
            got.append(bw.get_bytes())
        out.append(got)
    assert out[0] == out[1]


@pytest.mark.parametrize("qp", [12, 26, 40])
def test_cqp_ratecontrol_qps_match_jax(qp):
    tp, jp = (mainpath.main_path_param(64, 48, qp, 4, p)
              for p in (TP.param_default(), JP.param_default()))
    tp.rc.f_ip_factor = jp.rc.f_ip_factor = 1.6
    t_rc = TRateControl(TP.validate_parameters(tp), 12)
    j_rc = JRateControl(JP.validate_parameters(jp), 12)
    for st in (TP.SLICE_TYPE_I, TP.SLICE_TYPE_P, TP.SLICE_TYPE_P,
               TP.SLICE_TYPE_I):
        assert t_rc.start(st, 0) == j_rc.start(st, 0)


def test_crf_ratecontrol_matches_jax():
    """The whole RateControl was copied: a CRF run of start/end calls
    gives the same QPs."""
    tp, jp = _both("1080p-crf")
    t_rc = TRateControl(TP.validate_parameters(tp), 120 * 68)
    j_rc = JRateControl(JP.validate_parameters(jp), 120 * 68)
    rng = np.random.default_rng(3)
    for t in range(12):
        st = TP.SLICE_TYPE_I if t % 6 == 0 else TP.SLICE_TYPE_P
        satd = int(rng.integers(200_000, 2_000_000))
        bits = int(rng.integers(50_000, 900_000))
        assert t_rc.start(st, satd) == j_rc.start(st, satd)
        assert t_rc.end(st, bits) == j_rc.end(st, bits)


def test_api_types_match_jax():
    y = np.zeros((32, 48), np.uint8)
    u = np.ones((16, 24), np.uint8)
    tp = xtt.Picture.from_planes(y, u, u)
    jp = xt.Picture.from_planes(y, u, u)
    assert [f.name for f in dataclasses.fields(tp)] == \
        [f.name for f in dataclasses.fields(jp)]
    assert xtt.NAL(5, 3, b"\x01").payload == xt.NAL(5, 3, b"\x01").payload


# --------------------------------------------------------------------------
# the C++ CAVLC writers
# --------------------------------------------------------------------------

MB_W, MB_H = 6, 5


def _header(bw_cls):
    hw = bw_cls()
    for ue in (0, 5, 0):
        hw.write_ue(ue)
    hw.write(4, 1)
    for bit in (0, 0, 0):
        hw.write1(bit)
    hw.write_se(0)
    hw.write_ue(0)
    hw.write_se(0)
    hw.write_se(-1)
    return hw.get_unaligned()


def _rand_syn_p(rng, density, partitions, skip_frac, level_scale):
    """Random P syntax whose quadrant MVs fit each MB's partition shape."""
    part = (rng.integers(0, 4, (MB_H, MB_W)) if partitions
            else np.zeros((MB_H, MB_W), np.int64))
    mv8 = rng.integers(-40, 40, (MB_H, MB_W, 2, 2, 2)).astype(np.int16)
    for y in range(MB_H):
        for x in range(MB_W):
            if part[y, x] == 0:
                mv8[y, x, :, :] = mv8[y, x, 0, 0]
            elif part[y, x] == 1:
                mv8[y, x, :, 1] = mv8[y, x, :, 0]
            elif part[y, x] == 2:
                mv8[y, x, 1, :] = mv8[y, x, 0, :]

    def levels(shape):
        lv = rng.integers(-level_scale, level_scale + 1, shape)
        return (lv * (rng.random(shape) < density)).astype(np.int16)
    luma = levels((MB_H, MB_W, 16, 16))
    cdc = levels((MB_H, MB_W, 2, 4))
    cac = levels((MB_H, MB_W, 2, 4, 16))
    cac[..., 0] = 0
    cl = rng.integers(0, 16, (MB_H, MB_W))
    cch = rng.integers(0, 3, (MB_H, MB_W))
    skip = rng.random((MB_H, MB_W)) < skip_frac
    for a in (luma, cdc, cac, cl, cch, part, mv8):
        a[skip] = 0
    return dict(partition=part.astype(np.int16),
                ref=np.zeros((MB_H, MB_W), np.int16),
                cbp_luma=cl.astype(np.int16), cbp_chroma=cch.astype(np.int16),
                mv8=mv8, mv=mv8[:, :, 0, 0].copy(), luma_levels=luma,
                chroma_dc_levels=cdc, chroma_ac_levels=cac)


@pytest.mark.parametrize("seed,density,parts,scale", [
    (0, 0.3, False, 3), (1, 0.5, True, 3), (2, 0.15, True, 2),
    (3, 0.7, True, 40)])
def test_native_write_slice_p_matches_jax(seed, density, parts, scale):
    assert jnative.get_lib() is not None
    rng = np.random.default_rng(seed)
    syn = _rand_syn_p(rng, density, parts, 0.3, scale)
    qp_mb = rng.integers(20, 40, (MB_H, MB_W)).astype(np.int16)
    header = _header(TBitWriter)
    assert header == _header(JBitWriter)
    got = tnative.write_slice_p(header, MB_W, MB_H, 28, syn, qp_mb=qp_mb)
    want = jnative.write_slice_p(header, MB_W, MB_H, 28, syn, qp_mb=qp_mb)
    assert got[0] == want[0] and got[1] == want[1]
    assert len(got[0]) > len(header[0])


@pytest.mark.parametrize("qp", [18, 34])
def test_native_write_slice_i_matches_jax(qp):
    """I-slice syntax from the port's intra encode of a random frame."""
    rng = np.random.default_rng(qp)
    H, W = MB_H * 16, MB_W * 16
    planes = [torch.from_numpy(rng.integers(0, 256, (1, h, w)).astype(
        np.uint8)) for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]

    def grid(v):
        return torch.full((1, MB_H, MB_W), int(v), dtype=torch.int32)
    out = TIN.encode_i_frame(*planes, grid(qp), grid(CHROMA_QP_TABLE[qp]),
                             grid(20), MB_W, MB_H, True, True)
    syn = {k: v[0].numpy() for k, v in out.items()}
    header = _header(TBitWriter)
    got = tnative.write_slice_i(header, MB_W, MB_H, qp, syn)
    want = jnative.write_slice_i(header, MB_W, MB_H, qp, syn)
    assert got == want and len(got) > len(header[0])


def test_native_library_builds_in_the_checkout():
    tnative.get_lib()
    libs = list(tnative.LIB_DIR.glob("libx264t_entropy_*.so"))
    assert libs and all(p.parent.parent.parent == tnative._PKG.parent
                        for p in libs)


@pytest.mark.parametrize("chroma_dc", [False, True])
def test_cavlc_block_writer_matches_jax(chroma_dc):
    """entropy/cavlc.py (the copy the overflow detector runs): the bits,
    total_coeff and overflow flag of write_block_residual on random
    blocks, levels past the escape range included, at every nC class."""
    from x264dsp_tpu.entropy import cavlc as jcavlc
    from x264dsp_tpu_torch.entropy import cavlc as tcavlc
    rng = np.random.default_rng(8 + chroma_dc)
    n = 4 if chroma_dc else 16
    n_ov = 0
    for k in range(300):
        lv = np.zeros(n, np.int64)
        m = int(rng.integers(1, n + 1))
        scale = (2, 30, 5000)[k % 3]
        lv[rng.choice(n, m, replace=False)] = rng.integers(-scale, scale + 1,
                                                           m)
        nc = 0 if chroma_dc else int(rng.choice([0, 2, 4, 8]))
        outs = []
        for mod, bw in ((tcavlc, TBitWriter()), (jcavlc, JBitWriter())):
            res = mod.write_block_residual(bw, lv, nc, chroma_dc=chroma_dc)
            outs.append((res, bw.get_unaligned()))
        assert outs[0] == outs[1]
        n_ov += outs[0][0][1]
    assert n_ov > 0


def test_overflow_detector_matches_jax():
    """EncoderCore._detect_cavlc_overflow (a copy of the JAX core's) on a
    random I syntax with a few huge levels: the same flagged MBs."""
    from x264dsp_tpu.encoder.core import EncoderCore as JCore
    from x264dsp_tpu_torch.encoder.core import EncoderCore as TCore
    tp, jp = _both("default")
    rng = np.random.default_rng(4)
    t, j = TCore(tp, device="cpu"), JCore(jp)
    mb_h, mb_w = t.mb_h, t.mb_w
    syn = {"luma_levels": rng.integers(-3, 4, (mb_h, mb_w, 16, 16)),
           "chroma_dc_levels": rng.integers(-3, 4, (mb_h, mb_w, 2, 4)),
           "chroma_ac_levels": rng.integers(-3, 4, (mb_h, mb_w, 2, 4, 16)),
           "luma_dc_levels": rng.integers(-3, 4, (mb_h, mb_w, 16)),
           "cbp_luma": rng.choice([0, 15], (mb_h, mb_w)),
           "cbp_chroma": rng.integers(0, 3, (mb_h, mb_w)),
           "mb_type": rng.integers(0, 2, (mb_h, mb_w))}
    for key, idx in (("luma_dc_levels", (0, 1, 0)),
                     ("luma_levels", (1, 2, 5, 0)),
                     ("chroma_ac_levels", (2, 0, 1, 3, 1)),
                     ("luma_levels", (2, 3, 0, 3))):
        syn[key][idx] = 6000
    for st in (TP.SLICE_TYPE_I, TP.SLICE_TYPE_P):
        got = t._detect_cavlc_overflow(syn, st)
        want = j._detect_cavlc_overflow(syn, st)
        np.testing.assert_array_equal(got, want)
        assert got.any()


def test_annexb_and_yuv_copies_match_jax(tmp_path):
    """utils/annexb.py and utils/yuv.py, the CLI's copies: NAL split and
    EBSP unescape of an Encoder stream, the WxH parse and a frame read."""
    from x264dsp_tpu.utils import annexb as jab
    from x264dsp_tpu.utils import yuv as jyuv
    from x264dsp_tpu_torch.utils import annexb as tab
    from x264dsp_tpu_torch.utils import yuv as tyuv
    frames = mainpath.scene_cut_clip(32, 32, 2)
    run = mainpath.encode_clip(
        xtt.Encoder(_set(TP.param_default(), {"i_width": 32,
                                              "i_height": 32}),
                    device="cpu"), frames)
    stream = b"".join(b for _, b in run["headers"]) + b"".join(
        b for nl in run["nals"] for _, b in nl)
    nals = tab.split_nals(stream)
    assert nals == jab.split_nals(stream) and len(nals) >= 5
    assert [tab.unescape_ebsp(n) for n in nals] == \
        [jab.unescape_ebsp(n) for n in nals]
    path = tmp_path / "clip_32x32.yuv"
    tyuv.write_yuv(str(path), frames)
    assert tyuv.parse_resolution(str(path)) == \
        jyuv.parse_resolution(str(path)) == (32, 32)
    with tyuv.YUVReader(str(path)) as a, jyuv.YUVReader(str(path)) as b:
        for x, y in zip(a.read_frame(1), b.read_frame(1)):
            np.testing.assert_array_equal(x, y)
