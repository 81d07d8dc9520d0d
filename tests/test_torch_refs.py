"""The port's Encoder with several references, the JVT scaling lists, noise
reduction, recovery paths (a) and (c) and frame packing 5, against the JAX
Encoder.

On the CPU both Encoders get tools/mainpath.py's multiref_clip (56x40,
padded to 64x48 and cropped back in the SPS: six frames of a moving
texture whose three blocks cycle through three patterns, then
extreme_frame) at encoder_refs_param (param_default() with the JVT
lists and noise reduction 100), with reference marks (mark_reference_
corrupt before the frames named in each case: the list skips the marked
references and the slice headers carry ref_pic_list_modification; before
frame 6, the extreme frame, every reference is marked, so it is forced
to an IDR) and REFS_FORCED (the extreme frame at QP 0, whose CAVLC luma
DC levels overflow: the JAX Encoder re-encodes the flagged MBs at a
raised QP, recovery path (a)):
  (ref3-cavlc) three references under CAVLC, frame 2 marked before
      frame 3;
  (ref4-cabac) four references under CABAC (the PPS default is 4, so
      every P slice header overrides it), frame 2 marked before frame 3
      and frame 1 before frame 4;
  (fp5-ref2) frame packing 5 with two references under CAVLC, where the
      list is sorted by view pair, so that the same-view frame ranks first
      and the headers reorder it; the newest marked before frame 5.
Each must write the same NALs, byte for byte, with equal pic_out planes,
QPs, frame types, per-MB QP grid of the last frame, noise-reduction
state and close() summary, the reference histogram included. The marks
hold every list to at most two active references, and the settings share
their analysis compiles (the entropy mode and the reference order are
host work), so the JAX package compiles one set (the I frame, the P frame
with 1 and 2 references: about 45 s each), ahead of time and side by side
in threads inside light_xla(). Three and four active references (the
ue(v) reference index, the te() bits of the reference choice) are held
without a JAX Encoder: the reference choice to the JAX formula on random
surfaces, the stream to the conformance decoder (tools/h264_decode.py),
and chip_smoke.py phase 3 holds three on the card to the CPU.
"""

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import x264dsp_tpu as xt
import x264dsp_tpu_torch as xtt
from torch_jaxref import light_xla
from x264dsp_tpu import params as P
from x264dsp_tpu.encoder import inter_frame as JIF
from x264dsp_tpu.encoder import intra_frame as JIFR
from x264dsp_tpu.ops import mc as JMC
from x264dsp_tpu.ops.tables import CQM_JVT_LISTS
from x264dsp_tpu_torch.encoder import inter_frame as TIF
from x264dsp_tpu_torch.tools.mainpath import (REFS_FORCED, REFS_MARKS,
                                              MarkingEncoder, encode_clip,
                                              encoder_refs_param,
                                              multiref_clip)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
from h264_decode import Decoder  # noqa: E402

W, H, N = 56, 40, 7
# name: (references, CABAC, frame packing 5, reference marks)
CASES = {"ref3-cavlc": (3, 0, False, {3: 2, 6: None}),
         "ref4-cabac": (4, 1, False, {3: 2, 4: 1, 6: None}),
         "fp5-ref2": (2, 0, True, REFS_MARKS)}


def _param(pkg, name):
    n_ref, cabac, fp5, _ = CASES[name]
    p = encoder_refs_param(W, H, n_ref, cabac, pkg.param_default())
    if fp5:
        p.i_frame_packing = 5
    return p


def _encode(pkg, name):
    """encode_clip with the case's marks; returns its result and the
    core."""
    enc = pkg.Encoder(_param(pkg, name))
    run = encode_clip(MarkingEncoder(enc, CASES[name][3]),
                      multiref_clip(W, H, N), REFS_FORCED, pkg.Picture)
    assert run["tail"] == ([], None) and len(run["pics"]) == N
    run["core"] = enc._core
    return run


def _warm(n_ref):
    """Compile the JAX analysis the runs call, ahead of time (lower and
    compile, no run): the I frame (n_ref 0) or the P frame with n_ref
    references, at the arguments' shapes and types
    (x264dsp_tpu/encoder/core.py:950-995), so that the compiles run side by
    side in threads; the runs then find them in the jit cache."""
    mb_w, mb_h = (W + 15) // 16, (H + 15) // 16
    planes = [np.zeros((16 * mb_h >> (i > 0), 16 * mb_w >> (i > 0)),
                       np.uint8) for i in range(3)]
    grids = [jnp.zeros((mb_h, mb_w), jnp.int32) for _ in range(3)]
    cqm = CQM_JVT_LISTS
    if n_ref == 0:
        JIFR.encode_i_frame.lower(*planes, *grids, mb_w=mb_w, mb_h=mb_h,
                                  use_satd=True, i4x4_enabled=True,
                                  cqm=cqm).compile()
        return
    lead = () if n_ref == 1 else (n_ref,)
    pad = JMC.PAD_MC
    refs = [jnp.zeros(lead + (4, 16 * mb_h + 2 * pad, 16 * mb_w + 2 * pad),
                      jnp.int32)]
    refs += [jnp.zeros(lead + (8 * mb_h + pad, 8 * mb_w + pad), jnp.int32)
             for _ in range(2)]
    p = xt.validate_parameters(_param(xt, "ref3-cavlc"))
    JIF.encode_p_frame.lower(
        *planes, *refs, *grids, mb_w=mb_w, mb_h=mb_h,
        me_range=p.analyse.i_me_range, mv_range=p.analyse.i_mv_range,
        dct_decimate=True, me_method=0, fast_pskip=True, partitions=False,
        n_ref=n_ref, subme=1, cqm=cqm,
        nr_offset=(jnp.zeros(16, jnp.int32),
                   jnp.zeros(16, jnp.int32))).compile()


@pytest.fixture(scope="module")
def jax_runs():
    with light_xla():
        with ThreadPoolExecutor(3) as pool:
            list(pool.map(_warm, range(3)))
        return {name: _encode(xt, name) for name in CASES}


@pytest.fixture(scope="module")
def port_runs():
    """The port's runs on the CPU, with each frame's last_frame record."""
    runs = {}
    for name in CASES:
        enc = MarkingEncoder(xtt.Encoder(_param(xtt, name), device="cpu"),
                             CASES[name][3])
        run = encode_clip(enc, multiref_clip(W, H, N), REFS_FORCED,
                          xtt.Picture)
        run["core"], run["frames"] = enc.enc._core, enc.frames
        runs[name] = run
    return runs


@pytest.mark.parametrize("name", list(CASES))
def test_nals_match_jax_encoder(jax_runs, port_runs, name):
    want, got = jax_runs[name], port_runs[name]
    assert got["headers"] == want["headers"]
    for t in range(N):
        assert got["nals"][t] == want["nals"][t], f"frame {t}"


@pytest.mark.parametrize("name", list(CASES))
def test_pic_out_and_qp_grid_match_jax_encoder(jax_runs, port_runs, name):
    for t, (g, w) in enumerate(zip(port_runs[name]["pics"],
                                   jax_runs[name]["pics"])):
        assert (g.i_frame_qp, g.i_frame_type, g.i_pts) == \
            (w.i_frame_qp, w.i_frame_type, w.i_pts), f"frame {t}"
        for plane in "yuv":
            np.testing.assert_array_equal(getattr(g, plane),
                                          getattr(w, plane),
                                          err_msg=f"{plane} frame {t}")
    np.testing.assert_array_equal(port_runs[name]["core"]._last_qp_mb,
                                  jax_runs[name]["core"]._last_qp_mb)


@pytest.mark.parametrize("name", list(CASES))
def test_close_summary_matches_jax_encoder(jax_runs, port_runs, name):
    got, want = port_runs[name]["summary"], jax_runs[name]["summary"]
    assert got == want
    assert sum(got["ref_histogram"][1:]) > 0


@pytest.mark.parametrize("name", list(CASES))
def test_noise_reduction_offsets_match_jax(jax_runs, port_runs, name):
    """The NR state after the clip (sums, counts, offsets) is the JAX
    Encoder's, and the offsets have moved off zero."""
    got, want = port_runs[name]["core"].nr, jax_runs[name]["core"].nr
    for k in ("sum", "count", "offset"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["offset"].any()


def test_reference_lists(port_runs):
    """The active lists grow 1, 2 after the IDR; each mark drops its
    reference and reorders while a corrupt frame is held; marking every
    reference forces an IDR; frame packing 5 reorders at every second P
    frame."""
    def col(name, key):
        return [f[key] for f in port_runs[name]["frames"]]
    for name in ("ref3-cavlc", "ref4-cabac"):
        assert col(name, "n_ref") == [1, 1, 2, 2, 2, 2, 1]
        assert col(name, "reorder") == [False] * 3 + [True] * 3 + [False]
    assert col("fp5-ref2", "n_ref") == [1, 1, 2, 2, 2, 1, 1]
    assert col("fp5-ref2", "reorder") == [False, False, True, False, True,
                                          True, False]
    for name in CASES:
        types = [po.i_frame_type for po in port_runs[name]["pics"]]
        assert types == [P.TYPE_IDR] + [P.TYPE_P] * 5 + [P.TYPE_IDR]


@pytest.mark.parametrize("name", ["ref3-cavlc", "fp5-ref2"])
def test_overflow_frame_is_reencoded(port_runs, name):
    """Recovery path (a): the extreme frame's first encode overflows, the
    flagged MBs (and only they) go up from QP 0, and the re-encode clears
    it; under CABAC nothing is re-encoded."""
    last = port_runs[name]["frames"][-1]
    grid = port_runs[name]["core"]._last_qp_mb
    assert last["overflow"] >= 1 and last["encodes"] == 1 + last["overflow"]
    assert grid.min() == 0 and grid.max() > 0
    cabac = port_runs["ref4-cabac"]
    assert cabac["frames"][-1]["overflow"] == 0
    assert cabac["core"]._last_qp_mb.max() == 0


@pytest.mark.parametrize("n_ref", [2, 3, 4])
def test_select_ref_matches_jax(n_ref):
    """select_ref against the JAX analysis' reference choice
    (x264dsp_tpu/encoder/inter_frame.py:1845-1853: the least full-pel
    SAD + lambda * zero-MVP mv bits, + lambda * te() bits, jnp.argmin's
    first minimum) on random quadrant surfaces whose narrow range makes
    ties, with per-MB lambdas."""
    R, mb_h, mb_w = 3, 3, 4
    n = 2 * R + 1
    rng = np.random.default_rng(n_ref)
    c8 = rng.integers(0, 6, (n_ref, mb_h, mb_w, 2, 2, n, n)).astype(
        np.int32)
    lam = rng.integers(1, 4, (mb_h, mb_w)).astype(np.int32)

    @jax.jit
    def ref(c8, lam):
        off = JIF._mv_bits(4 * jnp.abs(jnp.arange(-R, R + 1)))
        grid = off[:, None] + off[None, :]
        best = [(c8[r].sum(axis=(2, 3)) + lam[..., None, None] * grid
                 ).reshape(mb_h, mb_w, -1).min(-1)
                + lam * JIF._ref_bits(r, n_ref) for r in range(n_ref)]
        return jnp.argmin(jnp.stack(best), axis=0)
    want = np.asarray(ref(jnp.asarray(c8), jnp.asarray(lam)))
    got = TIF.select_ref(torch.from_numpy(c8)[None],
                         torch.from_numpy(lam)[None], R)[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 1


def _decodes_to_pic_out(run):
    stream = b"".join(b for _, b in run["headers"])
    stream += b"".join(b for nl in run["nals"] for _, b in nl)
    dec = Decoder().decode(stream)
    assert len(dec) == len(run["pics"])
    for t, (planes, po) in enumerate(zip(dec, run["pics"])):
        for d, plane in zip(planes, "yuv"):
            np.testing.assert_array_equal(d, getattr(po, plane),
                                          err_msg=f"{plane} frame {t}")


def test_cavlc_stream_decodes_to_pic_out():
    """Three active references under CAVLC with REFS_MARKS (the newest of
    three held frames marked before frame 5: a reordered list of two, then
    every one before the extreme frame 6) and its overflow re-encode: the
    port's stream decodes (tools/h264_decode.py) to its pic_out."""
    enc = MarkingEncoder(xtt.Encoder(_param(xtt, "ref3-cavlc"),
                                     device="cpu"), REFS_MARKS)
    run = encode_clip(enc, multiref_clip(W, H, N), REFS_FORCED, xtt.Picture)
    assert [f["n_ref"] for f in enc.frames] == [1, 1, 2, 3, 3, 2, 1]
    assert enc.frames[-1]["overflow"] >= 1
    _decodes_to_pic_out(run)


def test_four_active_references_decode_to_pic_out():
    """Four active references (te() as ue(v), reference index 3), under
    CAVLC and (no marks) the slice headers at the PPS default: the port's
    stream decodes to its pic_out, and reference index 3 is coded."""
    p = encoder_refs_param(W, H, 4, 0, xtt.param_default())
    clip = multiref_clip(W, H, N, period=4)[:N - 1]
    enc = xtt.Encoder(p, device="cpu")
    run = encode_clip(enc, clip)
    assert enc._core.last_frame["n_ref"] == 4
    assert run["summary"]["ref_histogram"][3] > 0
    _decodes_to_pic_out(run)
