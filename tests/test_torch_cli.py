"""The port's CLI (x264dsp_tpu_torch/cli.py, the x264.c twin) on the CPU.

A 56x40 WxH.yuv of tools/mainpath.py's moving texture (3 frames) goes
through ``cli.main([in, out, --device cpu, flags...])``; the .264 it
writes must be the port's Encoder NALs joined, byte for byte, for the
same settings set by hand: param_default() (CRF 28, CABAC), CQP with
CAVLC and a short keyint, ABR under VBV, CRF with PSNR / SSIM and a
frame limit. The port's Encoder is held to the JAX one elsewhere
(test_torch_encoder.py, test_torch_ratecontrol.py), so nothing here
compiles JAX. Without --device the CLI asks for the GPU.
"""

import numpy as np
import pytest
import torch

import x264dsp_tpu_torch as xtt
from x264dsp_tpu_torch import cli
from x264dsp_tpu_torch import params as P
from x264dsp_tpu_torch.tools.mainpath import encode_clip, scene_cut_clip
from x264dsp_tpu_torch.utils.annexb import split_nals
from x264dsp_tpu_torch.utils.yuv import YUVReader, write_yuv

W, H, N = 56, 40, 3


def _cqp(p):
    p.rc.i_rc_method = P.RC_CQP
    p.rc.i_qp_constant = 22
    p.b_cabac = 0
    p.i_keyint_max = 2


def _vbv(p):
    p.rc.i_rc_method = P.RC_ABR
    p.rc.i_bitrate = 60
    p.rc.i_vbv_max_bitrate = 60
    p.rc.i_vbv_buffer_size = 30


def _crf(p):
    p.rc.f_rf_constant = 30.0
    p.analyse.b_psnr = p.analyse.b_ssim = 1


# name: (CLI flags, the same settings on a Param, frames encoded)
CASES = {
    "default": ([], lambda p: None, N),
    "cqp-cavlc": (["--qp", "22", "--cavlc", "--keyint", "2"], _cqp, N),
    "abr-vbv": (["--bitrate", "60", "--vbv-maxrate", "60", "--vbv-bufsize",
                 "30"], _vbv, N),
    "crf-psnr-ssim": (["--crf", "30", "--psnr", "--ssim", "--frames", "2"],
                      _crf, 2),
}


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    frames = scene_cut_clip(W, H, N)
    path = tmp_path_factory.mktemp("cli") / f"clip_{W}x{H}.yuv"
    write_yuv(str(path), frames)
    return path, frames


@pytest.mark.parametrize("name", list(CASES))
def test_cli_writes_the_encoder_nals(clip, tmp_path, name, capsys):
    path, frames = clip
    flags, setup, n = CASES[name]
    out = tmp_path / "out.264"
    assert cli.main([str(path), str(out), "--device", "cpu"] + flags) == 0
    p = xtt.param_default()
    p.i_width, p.i_height = W, H
    setup(p)
    run = encode_clip(xtt.Encoder(p, device="cpu"), frames[:n])
    want = b"".join(b for nl in run["nals"] for _, b in nl)
    got = out.read_bytes()
    assert got == want
    assert len(split_nals(got)) == sum(len(nl) for nl in run["nals"])
    text = capsys.readouterr().out
    assert f"encoded {n} frames" in text and f"{W}x{H}p" in text


def test_yuv_reader_round_trip(clip):
    path, frames = clip
    with YUVReader(str(path)) as r:
        assert (r.width, r.height, r.num_frames) == (W, H, N)
        for t in (1, 0, N - 1):
            for a, b in zip(r.read_frame(t), frames[t]):
                np.testing.assert_array_equal(a, b)
        assert r.read_frame(N) is None


def test_cli_defaults_to_the_gpu(clip, tmp_path, monkeypatch):
    """No --device: the CLI's Encoder asks for CUDA, which raises here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(clip[0]), str(tmp_path / "out.264")])
