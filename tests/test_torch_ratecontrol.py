"""The port's Encoder under variance AQ and VBV, against the JAX Encoder.

On the CPU both Encoders get the same 64x96 clips (4 x 6 MBs) at the
analysis settings of param_default(), so that one set of JAX compiles
serves every run, and must write the same NALs byte for byte, with the
same calls returning no frame, frame types, QPs, per-MB QP grids
(_last_qp_mb), pic_out planes and close() summary:
  aq-cabac / aq-cavlc: CRF 26 with variance AQ (strength 1.0) on a clip
      with a busy left half and a flat right half (tests/test_aq.py's
      idea), so the per-MB QPs spread;
  cbr-hrd: CBR with the NAL HRD (ABR = VBV max rate = buffer = 200
      kbit/s, tests/test_hrd_filler.py's shape), AQ, i_lookahead 3 and
      keyint 4 on a flat clip with one busy band: the queue holds three
      frames and encode(None) drains them, the buffering-period SEI comes
      on both IDRs, a pic-timing SEI on every frame, and the CPB
      overflows into filler NALs;
  tight-cabac / tight-cavlc: ABR 80 kbit/s with a 10 kbit buffer on a
      flat-top, busy-bottom clip (tests/test_row_vbv.py,
      tests/test_recovery.py::test_vbv_frame_reencode): the row-VBV walk
      and the frame re-encode fire (asserted), under CABAC and under CAVLC
      (whose row bits come from the device packer).
The cbr-hrd stream decodes (tools/h264_decode.py) to the port's pic_out.
Unit cases hold ratecontrol.aq_offsets and its log2 to JAX, the device
packer's row bits to the C++ writers', and the C++ CABAC writer's row
bits to the JAX package's. The JAX runs compile in two threads inside
light_xla.
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
from x264dsp_tpu_torch.encoder import ratecontrol as TRC
from x264dsp_tpu_torch.tools.mainpath import encode_clip

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
from h264_decode import Decoder  # noqa: E402

W, H, N = 64, 96, 6


def _textured_clip(seed=5):
    """A busy left half and a flat right half (tests/test_aq.py)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    frames = []
    for t in range(N):
        y = np.full((H, W), 128.0)
        y[:, :W // 2] += 70 * np.sin((xx[:, :W // 2] + 2 * t) / 2.3) \
            * np.cos(yy[:, :W // 2] / 3.1)
        y += rng.normal(0, 2, (H, W))
        u = (128 + 25 * np.sin((xx[::2, ::2] + t) / 7.0)).clip(0, 255)
        v = (128 + 25 * np.cos(yy[::2, ::2] / 9.0)).clip(0, 255)
        frames.append((y.clip(0, 255).astype(np.uint8), u.astype(np.uint8),
                       v.astype(np.uint8)))
    return frames


def _banded_clip():
    """A flat frame (tests/test_hrd_filler.py) with one busy band, so that
    AQ has a spread and the CPB still overflows."""
    yy, xx = np.mgrid[0:H, 0:W]
    band = np.s_[H // 4:H // 2, :W // 2]
    frames = []
    for t in range(N):
        y = np.full((H, W), 120.0 + (t & 1))
        y[band] += 70 * np.sin((xx[band] + 2 * t) / 2.3) * np.cos(
            yy[band] / 3.1)
        c = np.full((H // 2, W // 2), 128, np.uint8)
        frames.append((y.clip(0, 255).astype(np.uint8), c, c.copy()))
    return frames


def _bottom_heavy_clip(seed=9):
    """Flat top half, heavy texture in the bottom half
    (tests/test_row_vbv.py): the frame's bits arrive late."""
    rng = np.random.default_rng(seed)
    frames = []
    for t in range(N):
        y = np.full((H, W), 120, np.float64)
        y[H // 2:] += rng.normal(0, 40, (H // 2, W))
        y[H // 2:] += 50 * np.sin(np.arange(W) / 2.3 + t)[None, :]
        frames.append((y.clip(0, 255).astype(np.uint8),
                       np.full((H // 2, W // 2), 120, np.uint8),
                       np.full((H // 2, W // 2), 130, np.uint8)))
    return frames


def _param(pkg, cabac=True):
    p = pkg.param_default()
    p.i_width, p.i_height = W, H
    p.b_cabac = int(cabac)
    return p


def _aq(pkg, cabac):
    p = _param(pkg, cabac)
    p.rc.i_rc_method = P.RC_CRF
    p.rc.f_rf_constant = 26.0
    p.rc.i_aq_mode = P.AQ_VARIANCE
    p.rc.f_aq_strength = 1.0
    return p


def _cbr_hrd(pkg, cabac):
    p = _param(pkg, cabac)
    p.rc.i_rc_method = P.RC_ABR
    p.rc.i_bitrate = p.rc.i_vbv_max_bitrate = p.rc.i_vbv_buffer_size = 200
    p.i_nal_hrd = P.NAL_HRD_CBR
    p.rc.i_aq_mode = P.AQ_VARIANCE
    p.rc.i_lookahead = 3
    p.i_keyint_max = 4
    return p


def _tight(pkg, cabac):
    p = _param(pkg, cabac)
    p.rc.i_rc_method = P.RC_ABR
    p.rc.i_bitrate = p.rc.i_vbv_max_bitrate = 80
    p.rc.i_vbv_buffer_size = 10
    return p


RUNS = {"aq-cabac": (_aq, True, _textured_clip),
        "aq-cavlc": (_aq, False, _textured_clip),
        "cbr-hrd": (_cbr_hrd, True, _banded_clip),
        "tight-cabac": (_tight, True, _bottom_heavy_clip),
        "tight-cavlc": (_tight, False, _bottom_heavy_clip)}


class _Recorder:
    """An Encoder that keeps each encoded frame's per-MB QP grid (and, for
    the port, its last_frame record) and runs `after` after each one."""

    def __init__(self, enc, after=None):
        self.enc, self.after = enc, after
        self.qp_mb, self.frames = [], []

    def headers(self):
        return self.enc.headers()

    def encode(self, pic):
        out, po = self.enc.encode(pic)
        if po is not None:
            core = self.enc._core
            self.qp_mb.append(np.array(core._last_qp_mb))
            self.frames.append(getattr(core, "last_frame", None))
            if self.after is not None:
                self.after(core)
        return out, po

    def close(self):
        return self.enc.close()


def _run(pkg, name, make_enc, after=None):
    make, cabac, clip = RUNS[name]
    rec = _Recorder(make_enc(make(pkg, cabac)), after)
    run = encode_clip(rec, clip(), picture=pkg.Picture)
    return dict(run, qp_mb=rec.qp_mb, frames=rec.frames)


@pytest.fixture(scope="module")
def runs():
    """(JAX runs, port runs). The JAX Encoders run in two threads, those
    without VBV beside those with it (which compile the lowres pass with
    its edge ring), while the port's runs go on in this one: XLA compiles
    outside the interpreter lock."""
    def run_jax(names):
        return {n: _run(xt, n, xt.Encoder) for n in names}
    with light_xla(), ThreadPoolExecutor(2) as pool:
        parts = pool.map(run_jax, (("aq-cabac", "aq-cavlc"),
                                   ("cbr-hrd", "tight-cavlc", "tight-cabac")))
        port = _port_runs()
        jax = {k: v for part in parts for k, v in part.items()}
    return jax, port


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port_runs(runs):
    return runs[1]


def _port_runs():
    """The port's runs on the CPU. Every call of the C++ CABAC writer is
    recorded (its arguments and results, the row bits included); after
    each tight-cavlc frame its final encode's device payload and row bits
    are held to the C++ CAVLC writers on the pulled syntax."""
    calls, row_checks = [], []
    writer = TC.native.write_slice_cabac

    def recording(*a, **k):
        out = writer(*a, **k)
        calls.append((a, {**k, "row_bits": k["row_bits"].copy()}, out))
        return out

    def hold_rows(core):
        slot = core.last_slot
        is_p = slot["slice_type"] == P.SLICE_TYPE_P
        host = TC.pull_syntax(slot["syn"], TC.SYN_P if is_p else TC.SYN_I,
                              1)[0]
        rb = np.zeros(core.mb_h, np.int64)
        args = (slot["headers"][0], core.mb_w, core.mb_h, slot["qps"][0],
                host)
        grid = core._last_qp_mb
        want = (TC.native.write_slice_p(*args, qp_mb=grid, row_bits=rb)[0]
                if is_p else
                TC.native.write_slice_i(*args, qp_mb=grid, row_bits=rb))
        nbytes = (int(slot["bits"][0]) + 7) // 8
        hb, hn = slot["headers"][0]
        row_checks.append(dict(
            payload=slot["payload"][0, :nbytes].numpy().tobytes(),
            want=want, rows=slot["rows"][0].numpy().astype(np.int64),
            rb=rb, row_bits=core._row_bits,
            want_row_bits=np.diff(rb, prepend=(len(hb) - 1) * 8 + hn),
            qp_spread=int(grid.max() - grid.min())))

    def port(name, after=None):
        def make_enc(p):
            enc = xtt.Encoder(p, device="cpu")
            enc._core.keep_syntax = after is not None
            return enc
        return _run(xtt, name, make_enc, after)

    TC.native.write_slice_cabac = recording
    try:
        runs = {n: port(n, hold_rows if n == "tight-cavlc" else None)
                for n in RUNS}
    finally:
        TC.native.write_slice_cabac = writer
    runs["writer_calls"] = calls
    runs["row_checks"] = row_checks
    return runs


@pytest.mark.parametrize("name", list(RUNS))
def test_nals_match_jax_encoder(jax_runs, port_runs, name):
    want, got = jax_runs[name], port_runs[name]
    assert got["headers"] == want["headers"]
    assert got["waiting"] == want["waiting"]
    assert got["tail"] == want["tail"] == ([], None)
    assert len(got["nals"]) == len(want["nals"]) == N
    for t in range(N):
        assert got["nals"][t] == want["nals"][t], f"frame {t}"


@pytest.mark.parametrize("name", list(RUNS))
def test_pic_out_and_qp_grids_match_jax_encoder(jax_runs, port_runs, name):
    want, got = jax_runs[name], port_runs[name]
    for t, (g, w) in enumerate(zip(got["pics"], want["pics"])):
        assert (g.i_frame_qp, g.i_frame_type, g.i_pts) == \
            (w.i_frame_qp, w.i_frame_type, w.i_pts), f"frame {t}"
        for plane in "yuv":
            np.testing.assert_array_equal(getattr(g, plane),
                                          getattr(w, plane),
                                          err_msg=f"{plane} frame {t}")
        np.testing.assert_array_equal(got["qp_mb"][t], want["qp_mb"][t],
                                      err_msg=f"qp_mb frame {t}")
        assert got["qp_mb"][t].dtype == np.int32


@pytest.mark.parametrize("name", list(RUNS))
def test_close_summary_matches_jax_encoder(jax_runs, port_runs, name):
    assert port_runs[name]["summary"] == jax_runs[name]["summary"]


@pytest.mark.parametrize("name", ["aq-cabac", "aq-cavlc", "cbr-hrd"])
def test_aq_spreads_the_qp(port_runs, name):
    """AQ is not vacuous: the per-MB QPs of some frame span 2 or more."""
    assert max(int(g.max() - g.min()) for g in port_runs[name]["qp_mb"]) >= 2


def test_cbr_hrd_queue_seis_and_filler(port_runs):
    """cbr-hrd: the lookahead queue holds 3 frames (the first three calls
    return nothing, encode(None) drains three); the IDRs (keyint 4) carry a
    buffering-period SEI before the pic-timing SEI, every frame a
    pic-timing SEI, and the CPB overflows into filler NALs."""
    run = port_runs["cbr-hrd"]
    assert run["waiting"] == [0, 1, 2]
    types = [po.i_frame_type for po in run["pics"]]
    assert [po.i_pts for po in run["pics"]] == list(range(N))
    assert types == [P.TYPE_IDR, P.TYPE_P, P.TYPE_P, P.TYPE_P, P.TYPE_IDR,
                     P.TYPE_P]
    for t, nl in enumerate(run["nals"]):
        kinds = [k for k, _ in nl if k != P.NAL_FILLER]
        if t == 0:
            kinds = kinds[2:]   # the in-band SPS and PPS
        slice_t = P.NAL_SLICE_IDR if types[t] == P.TYPE_IDR else P.NAL_SLICE
        sei = [P.NAL_SEI] * (2 if types[t] == P.TYPE_IDR else 1)
        assert kinds == sei + [slice_t], f"frame {t}"
    fillers = [t for t, nl in enumerate(run["nals"])
               if any(k == P.NAL_FILLER for k, _ in nl)]
    assert fillers and all(run["frames"][t]["filler"] > 0 for t in fillers)


@pytest.mark.parametrize("name", ["tight-cabac", "tight-cavlc"])
def test_tight_vbv_reencodes(port_runs, name):
    """The tight buffer makes the row-VBV walk re-encode some frame with a
    new row ramp, and the frame re-encode (recovery path (b)) raise the QP
    of some frame; a row ramp shows in some final QP grid."""
    frames = port_runs[name]["frames"]
    assert any(f["row_vbv"] > 0 for f in frames)
    assert any(f["reencodes"] > 0 for f in frames)
    assert all(f["encodes"] == 1 + f["row_vbv"] + f["reencodes"]
               for f in frames)
    assert any(np.unique(g.mean(axis=1)).size > 1
               for g in port_runs[name]["qp_mb"])


def test_cbr_stream_decodes_to_pic_out(port_runs):
    """The cbr-hrd stream (SEIs, filler NALs, AQ's mb_qp_delta) decodes
    with tools/h264_decode.py to the port's cropped pic_out."""
    run = port_runs["cbr-hrd"]
    stream = b"".join(b for _, b in run["headers"])
    stream += b"".join(b for nl in run["nals"] for _, b in nl)
    dec = Decoder().decode(stream)
    assert len(dec) == N
    for t, (planes, po) in enumerate(zip(dec, run["pics"])):
        for d, plane in zip(planes, "yuv"):
            np.testing.assert_array_equal(d, getattr(po, plane),
                                          err_msg=f"{plane} frame {t}")


def test_device_row_bits_match_cavlc_writers(port_runs):
    """tight-cavlc, every frame's final encode: the device payload equals
    the C++ writers' on its syntax at its per-MB QPs (row ramps, so
    mb_qp_delta), the packer's end-of-row positions equal the writers'
    row_bits, and the Encoder's row bits are their differences with the
    slice header's bits prepended (core.py:1715-1720)."""
    checks = port_runs["row_checks"]
    assert len(checks) == N
    assert any(c["qp_spread"] > 0 for c in checks)
    for t, c in enumerate(checks):
        assert c["payload"] == c["want"], f"frame {t}"
        np.testing.assert_array_equal(c["rows"], c["rb"])
        np.testing.assert_array_equal(c["row_bits"], c["want_row_bits"])


def test_cabac_writer_matches_jax(port_runs):
    """The port's native.write_slice_cabac against the JAX package's on
    the syntax of every write of every CABAC run (re-encodes included):
    payload, MB-type counts and row bits."""
    from x264dsp_tpu.entropy import native as JN
    calls = port_runs["writer_calls"]
    encodes = sum(f["encodes"] for n in ("aq-cabac", "cbr-hrd",
                                         "tight-cabac")
                  for f in port_runs[n]["frames"])
    assert len(calls) == encodes > 3 * N
    for a, k, (payload, counts) in calls:
        rb = np.zeros_like(k["row_bits"])
        want, want_counts = JN.write_slice_cabac(*a, **dict(k, row_bits=rb))
        assert payload == want
        np.testing.assert_array_equal(counts, want_counts)
        np.testing.assert_array_equal(k["row_bits"], rb)
        assert rb[-1] > 1


def test_log2_matches_jax_at_every_energy():
    """ratecontrol.log2_f32 equals jnp.log2 bit for bit at every float32
    value an AQ energy can take: the integers 1 .. 2**23 - 1 (the largest
    energy is 6242400); torch.log2 does not. The offsets of those
    energies equal aq_offsets' JAX expression, strength 1.0."""
    import jax.numpy as jnp
    e = torch.arange(1, 1 << 23, dtype=torch.float32)
    je = jnp.asarray(e.numpy())
    want = np.asarray(jnp.log2(je)).view(np.int32)
    got = TRC.log2_f32(e).numpy().view(np.int32)
    assert (got != want).sum() == 0
    assert (torch.log2(e).numpy().view(np.int32) != want).any()
    want = np.asarray(1.0 * 1.0397 * (jnp.log2(je) - 14.427))
    got = TRC.energy_offsets(e.to(torch.int64), 1.0).numpy()
    assert (got.view(np.int32) != want.view(np.int32)).sum() == 0


@pytest.mark.parametrize("strength", [1.0, 0.6, 1.7])
def test_aq_offsets_match_jax(strength):
    """aq_offsets against JAX's on random planes with flat and saturated
    blocks, float32 bit for bit, and the QP grid core.py:866-870 takes
    from them at every frame QP."""
    import jax.numpy as jnp
    from x264dsp_tpu.encoder.ratecontrol import aq_offsets as jaq
    rng = np.random.default_rng(int(strength * 10))
    mb_w, mb_h = 5, 4
    y = rng.integers(0, 256, (16 * mb_h, 16 * mb_w)).astype(np.uint8)
    y[:16, :32] = 77
    y[16:32, :16] = np.where(np.indices((16, 16)).sum(0) & 1, 255, 0)
    u = rng.integers(0, 256, (8 * mb_h, 8 * mb_w)).astype(np.uint8)
    v = (u // 5 + 100).astype(np.uint8)
    want = np.asarray(jaq(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                          strength, mb_w, mb_h))
    got = TRC.aq_offsets(torch.from_numpy(y), torch.from_numpy(u),
                         torch.from_numpy(v), strength, mb_w, mb_h).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    p = _aq(xtt, True)
    p.i_width, p.i_height = 16 * mb_w, 16 * mb_h
    p.rc.f_aq_strength = strength
    core = TC.EncoderCore(p, device="cpu")
    lo, hi = core.param.rc.i_qp_min, min(core.param.rc.i_qp_max, 51)
    planes = [torch.from_numpy(a) for a in (y, u, v)]
    for qp in range(lo, hi + 1):
        np.testing.assert_array_equal(
            core._qp_grid(planes, qp),
            np.clip(np.floor(qp + want + 0.5), lo, hi).astype(np.int32))


@pytest.mark.parametrize("setting", ["aq", "vbv"])
def test_batch_encoder_still_refuses(setting):
    """The BatchEncoder keeps refusing AQ and VBV, as the JAX one does."""
    p = (_aq(xtt, False) if setting == "aq" else _tight(xtt, False))
    pj = (_aq(xt, False) if setting == "aq" else _tight(xt, False))
    with pytest.raises(P.ValidationError):
        xt.BatchEncoder(pj, 1)
    with pytest.raises(xtt.ValidationError, match=setting.upper()):
        xtt.BatchEncoder(copy.deepcopy(p), 1, device="cpu")
