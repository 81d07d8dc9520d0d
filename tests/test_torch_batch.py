"""The port's BatchEncoder end to end, and the port's guards.

On the CPU, x264dsp_tpu_torch.BatchEncoder and the JAX BatchEncoder get
the same 64x48, 2-stream, keyint-4 clip (I P P P I); the Annex-B bytes
must be identical and each stream must decode (tools/h264_decode.py) to
the port's own reconstruction. Both pack CAVLC in their frame step, so
each slot's payload buffer, bit count, skip count, row positions and
overflow flag are compared too, and the clip is encoded once more with
the wave and region deblock routes.
"""

import inspect
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import x264dsp_tpu as xt
import x264dsp_tpu_torch as xtt
from torch_jaxref import light_xla
from x264dsp_tpu import params as P

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
from h264_decode import Decoder  # noqa: E402

W, H, S, N = 64, 48, 2, 5
ROUTES = ("wave", "region", "wave", "region", None)   # I P P P I


def _clip(seed, sigma=2.0):
    """N frames of a moving texture with luma noise of deviation sigma."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = []
    for t in range(N):
        y = (110 + 60 * np.sin((xx + 2 * t) / 13.0) * np.cos(yy / 17.0)
             + rng.normal(0, sigma, (H, W))).clip(0, 255).astype(np.uint8)
        u = (120 + 30 * np.sin((xx[::2, ::2] + t) / 23.0)).clip(
            0, 255).astype(np.uint8)
        v = (128 + 30 * np.cos((yy[::2, ::2] + t) / 29.0)).clip(
            0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def _params(pkg=xtt):
    """The test settings on pkg's own param_default() (the port's unless
    the JAX package is given)."""
    p = pkg.param_default()
    p.i_width, p.i_height = W, H
    p.b_cabac = 0
    p.rc.i_rc_method = P.RC_CQP
    p.rc.i_qp_constant = 26
    p.i_keyint_max = 4
    p.i_scenecut_threshold = 0
    p.rc.i_lookahead = 0
    return p


PACKED = ("payload", "bits", "ov", "n_skip", "rows")


def _run(be, clips, routes=None, slots=None, qps=None):
    """Encode the clips; `routes` sets the port's deblock route per slot,
    `slots` collects each slot's device-CAVLC outputs and `qps` the port's
    per-stream slice QPs."""
    streams, recons = [b""] * S, []
    for t in range(N + 1):
        pics = ([xt.Picture.from_planes(*clips[s][t]) for s in range(S)]
                if t < N else None)
        if routes is not None and t < N:
            be.deblock_route = routes[t]
        out = be.encode_batch(pics)
        if t < N and qps is not None:
            qps.append(be.last_qps)
        if t < N and slots is not None:
            slots.append({k: np.asarray(be._pending["out"][k])
                          for k in PACKED})
        if t < N and hasattr(be, "device"):
            recons.append([np.asarray(r) for r in be.last_recon])
        if out is not None:
            for s, nl in enumerate(out):
                streams[s] += b"".join(n.payload for n in nl)
    summary = be.close()
    return streams, recons, summary


@pytest.fixture(scope="module")
def encoded():
    clips = [_clip(11 + s) for s in range(S)]
    xtt.reset_kernel_launches()
    port_slots, jax_slots = [], []
    port = _run(xtt.BatchEncoder(_params(), S, device="cpu"), clips,
                slots=port_slots)
    routed = _run(xtt.BatchEncoder(_params(), S, device="cpu"), clips,
                  routes=ROUTES)
    launches = xtt.kernel_launches()
    with light_xla():
        jax_run = _run(xt.BatchEncoder(_params(xt), S), clips,
                       slots=jax_slots)
    return port, jax_run, launches, routed, port_slots, jax_slots


def test_bytes_match_jax_batch_encoder(encoded):
    (port_streams, _, port_sum), (jax_streams, _, jax_sum), *_ = encoded
    for s in range(S):
        assert len(port_streams[s]) > 0
        assert port_streams[s] == jax_streams[s], f"stream {s}"
    assert port_sum == jax_sum


@pytest.mark.parametrize("key", PACKED)
def test_device_cavlc_outputs_match_jax(encoded, key):
    """Every slot's packer output (I and P slices) equals the JAX
    cavlc_i_payload / cavlc_p_payload output inside its frame step."""
    *_, port_slots, jax_slots = encoded
    assert len(port_slots) == len(jax_slots) == N
    for t, (got, want) in enumerate(zip(port_slots, jax_slots)):
        assert not want["ov"].any()
        np.testing.assert_array_equal(got[key], want[key],
                                      err_msg=f"slot {t}")


def test_deblock_routes_write_the_same_bytes(encoded):
    """The wave route on the I slots and a P slot, the region route on two
    P slots: the bytes, the recon and the summary of the default route."""
    (streams, recons, summary), _, _, routed, *_ = encoded
    assert routed[0] == streams
    assert routed[2] == summary
    for got, want in zip(routed[1], recons):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_streams_decode_to_port_recon(encoded):
    (streams, recons, _), *_ = encoded
    for s in range(S):
        dec = Decoder().decode(streams[s])
        assert len(dec) == N
        for t, planes in enumerate(dec):
            for got, want in zip(planes, recons[t]):
                np.testing.assert_array_equal(got, want[s],
                                              err_msg=f"stream {s} frame {t}")


def test_cpu_run_launches_no_kernel(encoded):
    launches = encoded[2]
    assert len(launches) == 9        # the eight TPU kernels and the walk
    assert all(n == 0 for n in launches.values())


def test_package_imports_no_jax():
    code = ("import sys; import x264dsp_tpu_torch as m; "
            "from x264dsp_tpu_torch import BatchEncoder; "
            "from x264dsp_tpu_torch.encoder import core, inter_frame, "
            "intra_frame; from x264dsp_tpu_torch.ops import deblock, mc, "
            "mcgather, me_sad, pixel, residual_plane, transforms, intra; "
            "from x264dsp_tpu_torch.parallel import dryrun, mesh; "
            "from x264dsp_tpu_torch.entropy import cabac_device; "
            "print('jax' in sys.modules)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"


def test_port_imports_nothing_of_the_jax_package():
    """After importing every module of the port and chip_smoke (without
    running it), no x264dsp_tpu module is loaded."""
    code = ("import sys, pkgutil, importlib, x264dsp_tpu_torch as m; "
            "[importlib.import_module(i.name) for i in pkgutil.walk_packages("
            "m.__path__, 'x264dsp_tpu_torch.')]; import chip_smoke; "
            "print([k for k in sys.modules "
            "if k.split('.')[0] == 'x264dsp_tpu'])")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_no_file_of_the_port_imports_the_jax_package():
    """No source of the port and not chip_smoke.py names x264dsp_tpu (as
    opposed to x264dsp_tpu_torch) in an import."""
    pattern = re.compile(r"^\s*(from|import)\s+x264dsp_tpu(\.|\s|$)",
                         re.MULTILINE)
    files = sorted((REPO / "x264dsp_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        xtt.BatchEncoder(_params(), S, device="cuda")


def test_cpu_is_used_only_when_asked(monkeypatch):
    default = inspect.signature(xtt.BatchEncoder).parameters["device"]
    assert default.default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        xtt.BatchEncoder(_params(), S)          # the default is the card
    assert xtt.BatchEncoder(_params(), S, device="cpu").device == \
        torch.device("cpu")
    with pytest.raises(ValueError):
        xtt.BatchEncoder(_params(), S, device="meta")


@pytest.mark.parametrize("change", [
    {"b_cabac": 1}, {"i_frame_reference": 2}, {"i_slice_count": 2},
    {"rc.i_rc_method": P.RC_CRF, "rc.i_aq_mode": P.AQ_VARIANCE},
    {"rc.i_rc_method": P.RC_CRF, "rc.i_vbv_buffer_size": 1000,
     "rc.i_vbv_max_bitrate": 1000},
    {"i_slice_max_mbs": 4},
    {"analyse.i_noise_reduction": 100}, {"i_cqm_preset": 1},
    {"rc.i_rc_method": P.RC_ABR}])
def test_validation_errors(change):
    """Settings that the JAX BatchEncoder refuses: the port's refuses them
    too (AQ and VBV are cleared under CQP, so those cases set CRF; ABR
    needs a bitrate). Constructing either encoder compiles nothing."""
    for pkg in (xtt, xt):
        p = _params(pkg)
        for path, val in change.items():
            obj = p
            *parents, leaf = path.split(".")
            for name in parents:
                obj = getattr(obj, name)
            setattr(obj, leaf, val)
        with pytest.raises(pkg.params.ValidationError):
            if pkg is xtt:
                xtt.BatchEncoder(p, S, device="cpu")
            else:
                xt.BatchEncoder(p, S)


def test_picture_count_checked():
    be = xtt.BatchEncoder(_params(), S, device="cpu")
    with pytest.raises(ValueError):
        be.encode_batch([xt.Picture.from_planes(*_clip(1)[0])])
    be.close()


def test_overflow_screen_matches_jax():
    """The device overflow flag is raised for the streams in which the JAX
    encoder's host screen flags an MB (escape level codes past the
    baseline limit), and for no other."""
    from x264dsp_tpu.encoder import core as JC
    from x264dsp_tpu_torch.entropy import cavlc_device as TCD
    rng = np.random.default_rng(8)
    mb_h, mb_w = 3, 4
    grid = (2, mb_h, mb_w)
    for slice_type in (P.SLICE_TYPE_I, P.SLICE_TYPE_P):
        # stream 0 carries overflowing levels, stream 1 only a large level
        # that the screen suspects and the exact writer clears
        syn = {"luma_levels": rng.integers(-3, 4, grid + (16, 16)),
               "chroma_dc_levels": rng.integers(-3, 4, grid + (2, 4)),
               "chroma_ac_levels": rng.integers(-3, 4, grid + (2, 4, 16)),
               "cbp_luma": np.full(grid, 15),
               "cbp_chroma": np.full(grid, 2)}
        syn["luma_levels"][0, 0, 1, 3, 2] = 5000
        syn["luma_levels"][:, 2, 2, 0, 0] = 300
        syn["chroma_ac_levels"][0, 1, 0, 1, 2, 5] = -4000
        if slice_type == P.SLICE_TYPE_I:
            syn["mb_type"] = np.ones(grid, int)
            syn["mb_type"][:, 2, 3] = 0
            syn["luma_dc_levels"] = rng.integers(-3, 4, grid + (16,))
            syn["luma_dc_levels"][0, 2, 3, 4] = 9000
            syn["nz_luma_dc"] = 1 - syn["mb_type"]
            syn["i16_mode"] = rng.integers(0, 4, grid)
            syn["i4_modes"] = rng.integers(0, 9, grid + (16,))
            syn["chroma_mode"] = rng.integers(0, 4, grid)
        else:
            syn["partition"] = np.zeros(grid, int)
            syn["ref"] = np.zeros(grid, int)
            syn["mv8"] = np.repeat(rng.integers(-20, 20, grid + (1, 1, 2)),
                                   4, 3).reshape(grid + (2, 2, 2))
        fake = type("Enc", (), {"mb_h": mb_h, "mb_w": mb_w})()
        want = [JC.EncoderCore._detect_cavlc_overflow(
            fake, {k: v[s] for k, v in syn.items()}, slice_type).any()
            for s in range(2)]
        assert want == [True, False]
        syn_t = {k: torch.from_numpy(v.astype(np.int32))
                 for k, v in syn.items()}
        qp_mb = torch.full(grid, 26, dtype=torch.int32)
        hv, hl = TCD.header_elements(b"\xa5\x40", 3)
        if slice_type == P.SLICE_TYPE_I:
            out = TCD.cavlc_i_payload(syn_t, qp_mb, 26, mb_h, mb_w, hv, hl,
                                      1 << 16)
        else:
            out = TCD.cavlc_p_payload(syn_t, qp_mb, 26, 1, mb_h, mb_w, hv,
                                      hl, 1 << 16)
        assert out[-1].tolist() == want


def test_overflow_raises():
    """A raised device overflow flag stops the BatchEncoder with the JAX
    encoder's message; here the payload cap is cut below the I slice."""
    be = xtt.BatchEncoder(_params(), S, device="cpu")
    be._cap = 64
    clip = _clip(2)
    pics = [xt.Picture.from_planes(*clip[0]) for _ in range(S)]
    be.encode_batch(pics)
    with pytest.raises(RuntimeError, match="device CAVLC overflow"):
        be.encode_batch(None)


def test_profiled_batch_encoder_writes_the_same_bytes(encoded):
    """profile=True (a device sync and a clock read at each stage) writes
    the unprofiled run's streams and summary, and records each slot's
    stage split."""
    (streams, _, summary), *_ = encoded
    be = xtt.BatchEncoder(_params(), S, device="cpu", profile=True)
    got, _, got_summary = _run(be, [_clip(11 + s) for s in range(S)])
    assert got == streams and got_summary == summary
    assert len(be.slot_times) == N
    assert all(t["encode"] > 0 for _, t in be.slot_times)
