"""The port's BatchEncoder end to end, and the port's guards.

On the CPU, x264dsp_tpu_torch.BatchEncoder and the JAX BatchEncoder get
the same 64x48, 2-stream, keyint-4 clip (I P P P I); the Annex-B bytes
must be identical and each stream must decode (tools/h264_decode.py) to
the port's own reconstruction.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import x264dsp_tpu as xt
import x264dsp_tpu_torch as xtt
from x264dsp_tpu import params as P

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
from h264_decode import Decoder  # noqa: E402

W, H, S, N = 64, 48, 2, 5


def _clip(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = []
    for t in range(N):
        y = (110 + 60 * np.sin((xx + 2 * t) / 13.0) * np.cos(yy / 17.0)
             + rng.normal(0, 2.0, (H, W))).clip(0, 255).astype(np.uint8)
        u = (120 + 30 * np.sin((xx[::2, ::2] + t) / 23.0)).clip(
            0, 255).astype(np.uint8)
        v = (128 + 30 * np.cos((yy[::2, ::2] + t) / 29.0)).clip(
            0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def _params():
    p = xt.param_default()
    p.i_width, p.i_height = W, H
    p.b_cabac = 0
    p.rc.i_rc_method = P.RC_CQP
    p.rc.i_qp_constant = 26
    p.i_keyint_max = 4
    p.i_scenecut_threshold = 0
    p.rc.i_lookahead = 0
    return p


def _run(be, clips):
    streams, recons = [b""] * S, []
    for t in range(N + 1):
        pics = ([xt.Picture.from_planes(*clips[s][t]) for s in range(S)]
                if t < N else None)
        out = be.encode_batch(pics)
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
    port = _run(xtt.BatchEncoder(_params(), S, device="cpu"), clips)
    launches = xtt.kernel_launches()
    jax_run = _run(xt.BatchEncoder(_params(), S), clips)
    return port, jax_run, launches


def test_bytes_match_jax_batch_encoder(encoded):
    (port_streams, _, port_sum), (jax_streams, _, jax_sum), _ = encoded
    for s in range(S):
        assert len(port_streams[s]) > 0
        assert port_streams[s] == jax_streams[s], f"stream {s}"
    assert port_sum == jax_sum


def test_streams_decode_to_port_recon(encoded):
    (streams, recons, _), _, _ = encoded
    for s in range(S):
        dec = Decoder().decode(streams[s])
        assert len(dec) == N
        for t, planes in enumerate(dec):
            for got, want in zip(planes, recons[t]):
                np.testing.assert_array_equal(got, want[s],
                                              err_msg=f"stream {s} frame {t}")


def test_cpu_run_launches_no_kernel(encoded):
    *_, launches = encoded
    assert all(n == 0 for n in launches.values())


def test_package_imports_no_jax():
    code = ("import sys; import x264dsp_tpu_torch as m; "
            "from x264dsp_tpu_torch import BatchEncoder; "
            "from x264dsp_tpu_torch.encoder import core, inter_frame, "
            "intra_frame; from x264dsp_tpu_torch.ops import deblock, mc, "
            "mcgather, me_sad, pixel, residual_plane, transforms, intra; "
            "print('jax' in sys.modules)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        xtt.BatchEncoder(_params(), S, device="cuda")


def test_cpu_is_used_only_when_asked():
    with pytest.raises(TypeError):
        xtt.BatchEncoder(_params(), S)          # no default device
    assert xtt.BatchEncoder(_params(), S, device="cpu").device == \
        torch.device("cpu")
    with pytest.raises(ValueError):
        xtt.BatchEncoder(_params(), S, device="meta")


@pytest.mark.parametrize("change", [
    {"b_cabac": 1}, {"i_frame_reference": 2}, {"i_slice_count": 2},
    {"analyse.i_me_method": P.ME_HEX}, {"analyse.i_subpel_refine": 2},
    {"analyse.i_noise_reduction": 100}, {"i_cqm_preset": 1},
    {"rc.i_rc_method": P.RC_CRF}])
def test_validation_errors(change):
    p = _params()
    (path, val), = change.items()
    obj = p
    *parents, leaf = path.split(".")
    for name in parents:
        obj = getattr(obj, name)
    setattr(obj, leaf, val)
    with pytest.raises(P.ValidationError):
        xtt.BatchEncoder(p, S, device="cpu")


def test_picture_count_checked():
    be = xtt.BatchEncoder(_params(), S, device="cpu")
    with pytest.raises(ValueError):
        be.encode_batch([xt.Picture.from_planes(*_clip(1)[0])])
    be.close()


def test_overflow_screen_matches_jax():
    """The copied CAVLC overflow screen flags the MBs the JAX encoder's
    flags (escape level codes past the baseline limit)."""
    from x264dsp_tpu.encoder import core as JC
    from x264dsp_tpu_torch.encoder import core as TC
    rng = np.random.default_rng(8)
    mb_h, mb_w = 3, 4
    for slice_type in (P.SLICE_TYPE_I, P.SLICE_TYPE_P):
        syn = {"luma_levels": rng.integers(-3, 4, (mb_h, mb_w, 16, 16)),
               "chroma_dc_levels": rng.integers(-3, 4, (mb_h, mb_w, 2, 4)),
               "chroma_ac_levels": rng.integers(-3, 4,
                                                (mb_h, mb_w, 2, 4, 16)),
               "cbp_luma": np.full((mb_h, mb_w), 15),
               "cbp_chroma": np.full((mb_h, mb_w), 2)}
        syn["luma_levels"][0, 1, 3, 2] = 5000
        syn["luma_levels"][2, 2, 0, 0] = 300
        syn["chroma_ac_levels"][1, 0, 1, 2, 5] = -4000
        if slice_type == P.SLICE_TYPE_I:
            syn["mb_type"] = np.ones((mb_h, mb_w), int)
            syn["mb_type"][2, 3] = 0
            syn["luma_dc_levels"] = rng.integers(-3, 4, (mb_h, mb_w, 16))
            syn["luma_dc_levels"][2, 3, 4] = 9000
        fake = type("Enc", (), {"mb_h": mb_h, "mb_w": mb_w})()
        want = JC.EncoderCore._detect_cavlc_overflow(fake, syn, slice_type)
        got = TC.detect_cavlc_overflow(syn, slice_type, mb_h, mb_w)
        assert want.any()
        np.testing.assert_array_equal(got, want)


def test_overflow_raises(monkeypatch):
    """A flagged overflow stops the BatchEncoder, as in the JAX one."""
    from x264dsp_tpu_torch.encoder import core as TC
    monkeypatch.setattr(TC, "detect_cavlc_overflow",
                        lambda syn, st, h, w: np.ones((h, w), bool))
    be = xtt.BatchEncoder(_params(), S, device="cpu")
    clip = _clip(2)
    pics = [xt.Picture.from_planes(*clip[0]) for _ in range(S)]
    be.encode_batch(pics)
    with pytest.raises(RuntimeError, match="overflow"):
        be.encode_batch(None)
