"""The port's Encoder with several slices per frame and with periodic intra
refresh, against the JAX Encoder.

On the CPU both Encoders get tools/mainpath.py's slices_clip (64x96, 4x6
MBs; a moving sinusoid texture with light noise, tests/test_slices.py's)
of 5 frames, IPPP, at encoder_slices_param (param_default() with CQP 26)
and the settings of SLICE_CASES:
  (count3-cavlc) i_slice_count 3 under CAVLC: 3 bands of 2 MB rows;
  (count3-cabac) the same under CABAC;
  (max-mbs8) i_slice_max_mbs 8 under CAVLC: 8 MBs are 2 rows, 3 bands;
  (max-size400) i_slice_count 3 and i_slice_max_size 400 under CAVLC
      (tests/test_slices.py:101-108): the I frame's last band passes the
      budget and is split into two bands of 1 row, so the frame holds bands
      of two heights;
  (intra-refresh) b_intra_refresh with i_slice_count 3, keyint 4 and no
      scenecut (tests/test_intra_refresh.py:59-72): keyint applies to
      frame 0 only, so frame 4 stays P;
  (vbv-slices) i_slice_count 3 under CAVLC and a tight VBV (ABR 20 kbit/s,
      a 2 kbit buffer): the VBV re-encode measures the frame's slices
      together (the I frame is encoded again), and the row-VBV walk does
      not run on a frame of several slices;
  (refs2) i_slice_count 3 with 2 references: the P frames past the first
      read each band's rows of both references, stacked (K4 on the card).
Each must write the same NALs, byte for byte, with equal pic_out planes,
QPs and frame types and an equal close() summary, and the port's stream
decodes (tools/h264_decode.py) to its pic_out.

Every case shares one JAX compile set of four programs: the I frame at
band heights 2 and 1 and the P frame at band height 2 with one and with
two references (the JAX Encoder encodes each band as a
frame of its rows; x264dsp_tpu/encoder/core.py:937-1010), compiled ahead of
time and side by side in threads inside light_xla().
"""

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import x264dsp_tpu as xt
import x264dsp_tpu_torch as xtt
from torch_jaxref import light_xla
from x264dsp_tpu import params as P
from x264dsp_tpu.encoder import core as JC
from x264dsp_tpu.encoder import inter_frame as JIF
from x264dsp_tpu.encoder import intra_frame as JIFR
from x264dsp_tpu.ops import mc as JMC
from x264dsp_tpu.ops import mcgather as JMG
from x264dsp_tpu_torch.encoder import core as TC
from x264dsp_tpu_torch.encoder import inter_frame as TIF
from x264dsp_tpu_torch.tools.mainpath import (SLICE_CASES, MarkingEncoder,
                                              encode_clip,
                                              encoder_slices_param,
                                              slices_clip)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
from h264_decode import Decoder  # noqa: E402

W, H, N = 64, 96, 5
MB_W, MB_H = W // 16, H // 16


def _param(pkg, name):
    return encoder_slices_param(W, H, name, pkg.param_default())


def _clip():
    return slices_clip(W, H, N)


def _warm(job):
    """Compile one JAX band program ahead of time (lower and compile, no
    run), at the arguments' shapes and types
    (x264dsp_tpu/encoder/core.py:950-995): the I or the P frame at mb_h
    band rows, the P frame's references cropped to the band's rows and
    their padding (n_ref of them stacked when more than one); the runs
    then find it in the jit cache."""
    is_p, mb_h, n_ref = job
    planes = [np.zeros((16 * mb_h >> (i > 0), W >> (i > 0)), np.uint8)
              for i in range(3)]
    grids = [jnp.zeros((mb_h, MB_W), jnp.int32) for _ in range(3)]
    p = xt.validate_parameters(_param(xt, "count3-cavlc"))
    if not is_p:
        JIFR.encode_i_frame.lower(
            *planes, *grids, mb_w=MB_W, mb_h=mb_h,
            use_satd=p.analyse.i_subpel_refine > 0,
            i4x4_enabled=bool(p.analyse.intra & P.ANALYSE_I4x4),
            cqm=None).compile()
        return
    pad = JMC.PAD_MC
    stack = (n_ref,) if n_ref > 1 else ()
    refs = [jnp.zeros(stack + (4, 16 * mb_h + 2 * pad, W + 2 * pad),
                      jnp.int32)]
    refs += [jnp.zeros(stack + (8 * mb_h + pad, W // 2 + pad), jnp.int32)
             for _ in range(2)]
    JIF.encode_p_frame.lower(
        *planes, *refs, *grids, mb_w=MB_W, mb_h=mb_h,
        me_range=p.analyse.i_me_range, mv_range=p.analyse.i_mv_range,
        dct_decimate=bool(p.analyse.b_dct_decimate),
        me_method=min(max(p.analyse.i_me_method, 0), 3),
        fast_pskip=bool(p.analyse.b_fast_pskip),
        partitions=bool(p.analyse.inter & P.ANALYSE_PSUB16x16), n_ref=n_ref,
        subme=p.analyse.i_subpel_refine, cqm=None, nr_offset=None).compile()


def _count_row_walks(enc):
    """Count the calls of the Encoder's row-VBV walk: returns a list whose
    length is the number of calls so far."""
    calls = []
    rc = enc._core.rc
    walk = rc.row_vbv_adjust

    def counted(*a, **k):
        calls.append(1)
        return walk(*a, **k)
    rc.row_vbv_adjust = counted
    return calls


@pytest.fixture(scope="module")
def jax_runs():
    with light_xla():
        with ThreadPoolExecutor(4) as pool:
            list(pool.map(_warm, [(False, 2, 1), (False, 1, 1), (True, 2, 1),
                                  (True, 2, 2)]))
        return {name: encode_clip(xt.Encoder(_param(xt, name)), _clip(),
                                  picture=xt.Picture)
                for name in SLICE_CASES}


@pytest.fixture(scope="module")
def port_runs():
    """The port's runs on the CPU, with each frame's last_frame record
    and the number of row-VBV walks."""
    runs = {}
    for name in SLICE_CASES:
        enc = MarkingEncoder(xtt.Encoder(_param(xtt, name), device="cpu"), {})
        walks = _count_row_walks(enc.enc)
        run = encode_clip(enc, _clip(), picture=xtt.Picture)
        assert run["tail"] == ([], None) and len(run["pics"]) == N
        run["frames"], run["row_walks"] = enc.frames, len(walks)
        runs[name] = run
    return runs


@pytest.mark.parametrize("name", list(SLICE_CASES))
def test_nals_match_jax_encoder(jax_runs, port_runs, name):
    want, got = jax_runs[name], port_runs[name]
    assert got["headers"] == want["headers"]
    assert got["waiting"] == want["waiting"]
    assert len(got["nals"]) == len(want["nals"]) == N
    for t in range(N):
        assert got["nals"][t] == want["nals"][t], f"frame {t}"


@pytest.mark.parametrize("name", list(SLICE_CASES))
def test_pic_out_matches_jax_encoder(jax_runs, port_runs, name):
    for t, (g, w) in enumerate(zip(port_runs[name]["pics"],
                                   jax_runs[name]["pics"])):
        assert (g.i_frame_qp, g.i_frame_type, g.i_pts) == \
            (w.i_frame_qp, w.i_frame_type, w.i_pts), f"frame {t}"
        for plane in "yuv":
            np.testing.assert_array_equal(getattr(g, plane),
                                          getattr(w, plane),
                                          err_msg=f"{plane} frame {t}")


@pytest.mark.parametrize("name", list(SLICE_CASES))
def test_close_summary_matches_jax_encoder(jax_runs, port_runs, name):
    assert port_runs[name]["summary"] == jax_runs[name]["summary"]


@pytest.mark.parametrize("name", list(SLICE_CASES))
def test_slice_nals_per_frame(port_runs, name):
    """One slice NAL per band of the frame's final encode; every case but
    the size budget's keeps its 3 bands of 2 rows, which tile the frame."""
    run = port_runs[name]
    bands = [f["slices"] for f in run["frames"]]
    assert [sum(t in (P.NAL_SLICE, P.NAL_SLICE_IDR) for t, _ in nl)
            for nl in run["nals"]] == [len(b) for b in bands]
    for b in bands:
        assert b[0][0] == 0 and b[-1][1] == MB_H
        assert all(x[1] == y[0] for x, y in zip(b, b[1:]))
    if name != "max-size400":
        assert bands == [[(0, 2), (2, 4), (4, 6)]] * N


@pytest.mark.parametrize("name", list(SLICE_CASES))
def test_stream_decodes_to_pic_out(port_runs, name):
    run = port_runs[name]
    stream = b"".join(b for _, b in run["headers"])
    stream += b"".join(b for nl in run["nals"] for _, b in nl)
    dec = Decoder().decode(stream)
    assert len(dec) == N
    for t, (planes, po) in enumerate(zip(dec, run["pics"])):
        for d, plane in zip(planes, "yuv"):
            np.testing.assert_array_equal(d, getattr(po, plane),
                                          err_msg=f"{plane} frame {t}")


def test_max_size_splits_within_budget(port_runs):
    """Every slice NAL of the size-budget case fits 400 bytes, start code
    and escapes included, and the I frame was split (into bands of 1 and
    2 rows: two heights in one frame) in one extra pass."""
    run = port_runs["max-size400"]
    sizes = [len(b) for nl in run["nals"] for t, b in nl
             if t in (P.NAL_SLICE, P.NAL_SLICE_IDR)]
    assert max(sizes) <= 400
    first = run["frames"][0]
    assert first["max_size_passes"] >= 1 and len(first["slices"]) > 3
    assert len({y1 - y0 for y0, y1 in first["slices"]}) == 2
    assert all(f["encodes"] == 1 + f["max_size_passes"]
               for f in run["frames"])


def test_intra_refresh_keeps_p_past_keyint(port_runs):
    """Under intra refresh keyint applies to frame 0 only
    (x264dsp_tpu/encoder/slicetype.py:267-270), so frame 4 is P, where
    keyint 4 alone makes it an IDR."""
    types = [po.i_frame_type for po in port_runs["intra-refresh"]["pics"]]
    assert types == [P.TYPE_IDR] + [P.TYPE_P] * (N - 1)
    p = _param(xtt, "intra-refresh")
    p.b_intra_refresh = 0
    run = encode_clip(xtt.Encoder(p, device="cpu"), _clip(),
                      picture=xtt.Picture)
    assert run["pics"][4].i_frame_type == P.TYPE_IDR


def test_vbv_measures_all_slices(port_runs):
    """Under VBV a frame of several slices is encoded again while their
    sum passes the frame's limit, and the row-VBV walk never runs: its
    condition in the JAX Encoder (x264dsp_tpu/encoder/core.py:1217-1220)
    is VBV with one slice and row costs over the whole frame."""
    run = port_runs["vbv-slices"]
    assert any(f["reencodes"] > 0 for f in run["frames"])
    assert all(len(f["slices"]) == 3 and f["row_vbv"] == 0
               for f in run["frames"])
    assert run["row_walks"] == 0


def test_row_vbv_walks_with_one_slice():
    """The same tight VBV with one slice: the walk runs on every frame,
    as the JAX condition says."""
    p = _param(xtt, "vbv-slices")
    p.i_slice_count = 1
    enc = MarkingEncoder(xtt.Encoder(p, device="cpu"), {})
    walks = _count_row_walks(enc.enc)
    encode_clip(enc, _clip()[:3], picture=xtt.Picture)
    assert len(walks) >= 3
    assert all(f["slices"] == [(0, MB_H)] for f in enc.frames)


def test_two_references_per_band(port_runs):
    """With 2 references every P frame past the first encodes its 3 bands
    on both (the stacked crops of _encode_bands), and some MB takes the
    farther one."""
    run = port_runs["refs2"]
    assert [f["n_ref"] for f in run["frames"]] == [1, 1, 2, 2, 2]
    assert all(len(f["slices"]) == 3 for f in run["frames"])
    assert sum(run["summary"]["ref_histogram"][1:]) > 0


class _Geometry:
    def __init__(self, mb_h, count, max_mbs, mb_w=MB_W):
        self.param = xtt.param_default()
        self.param.i_slice_count = count
        self.param.i_slice_max_mbs = max_mbs
        self.mb_w, self.mb_h = mb_w, mb_h


@pytest.mark.parametrize("mb_h", [1, 5, 6, 10, 68])
def test_slice_ranges_match_jax(mb_h):
    """EncoderCore._slice_ranges against the JAX formula over slice counts
    and MB budgets, with bounds that fall on halves (Python's round to
    even: 5 rows in 2 slices, 10 in 4)."""
    for count in range(0, 9):
        for max_mbs in (0, 1, 3, 4, 7, 8, 12, 40):
            g = _Geometry(mb_h, count, max_mbs)
            got = TC.EncoderCore._slice_ranges(g)
            assert got == JC.EncoderCore._slice_ranges(g), (count, max_mbs)
            assert got[0][0] == 0 and got[-1][1] == mb_h


def test_band_syn_matches_jax():
    """_band_syn cuts the same rows, QP grid and first MB as the JAX one
    and drops what is not an MB-grid array."""
    g = _Geometry(6, 3, 0)
    rng = np.random.default_rng(2)
    syn = {"cbp_luma": rng.integers(0, 16, (6, MB_W)),
           "luma_levels": rng.integers(-9, 9, (6, MB_W, 16, 16)),
           "recon_y": rng.integers(0, 255, (96, 64)), "nr_count": 3}
    qp = rng.integers(20, 30, (6, MB_W))
    for band in (None, (0, 2), (2, 4), (5, 6)):
        got = TC.EncoderCore._band_syn(g, syn, qp, band)
        want = JC.EncoderCore._band_syn(g, syn, qp, band)
        assert got[2:] == want[2:]
        np.testing.assert_array_equal(got[1], want[1])
        assert sorted(got[0]) == sorted(want[0])
        for k in got[0]:
            np.testing.assert_array_equal(got[0][k], want[0][k])


def test_blocks4_grid_matches_jax():
    """The coding-order to block-grid relayout that the assembled P frame's
    strengths read (ops/mcgather.py:307), per stream."""
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 17, (2, 3, MB_W, 16)).astype(np.int32)
    got = TIF.blocks4_grid(torch.from_numpy(vals), 3, MB_W).numpy()
    for s in range(2):
        np.testing.assert_array_equal(
            got[s], np.asarray(JMG.blocks4_grid(jnp.asarray(vals[s]), 3,
                                                MB_W)))
