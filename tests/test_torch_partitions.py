"""The port's BatchEncoder end to end with P partition analysis.

On the CPU, x264dsp_tpu_torch.BatchEncoder and the JAX BatchEncoder get
the faster-1ref settings (HEX, subme 4, 16x8/8x16/8x8 partitions, one
reference) and the same 64x64, 2-stream, keyint-4 split-motion clip
(I P P P I). The Annex-B bytes must be identical, each stream must
decode (tools/h264_decode.py) to the port's own reconstruction, and the
summary must count partitioned MBs.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import x264dsp_tpu as xt
from x264dsp_tpu import params as JP
import x264dsp_tpu_torch as xtt
from x264dsp_tpu_torch import params as TP
from x264dsp_tpu_torch.tools.mainpath import (faster_1ref_param,
                                              split_motion_clip)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
from h264_decode import Decoder  # noqa: E402
from test_partitions import _split_motion_clip  # noqa: E402

W = H = 64
S, N, KEYINT, QP = 2, 5, 4, 26
SEEDS = (11, 13)


def _clips():
    out = []
    for seed in SEEDS:
        frame = split_motion_clip(W, H, torch.device("cpu"), seed)
        out.append([tuple(p.numpy() for p in frame(t)) for t in range(N)])
    return out


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
    return streams, recons, be.close()


@pytest.fixture(scope="module")
def encoded():
    clips = _clips()
    xtt.reset_kernel_launches()
    port = _run(xtt.BatchEncoder(
        faster_1ref_param(W, H, QP, KEYINT, TP.param_default()), S,
        device="cpu"), clips)
    launches = xtt.kernel_launches()
    jax_run = _run(xt.BatchEncoder(
        faster_1ref_param(W, H, QP, KEYINT, JP.param_default()), S), clips)
    return port, jax_run, launches


def test_split_motion_twin_matches_clip():
    """tools/mainpath.split_motion_clip makes the frames of
    tests/test_partitions.py's clip."""
    for seed, frames in zip(SEEDS, _clips()):
        for got, want in zip(frames, _split_motion_clip(W, H, N, seed)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_faster_1ref_bytes_match_jax_batch_encoder(encoded):
    (port_streams, _, port_sum), (jax_streams, _, jax_sum), _ = encoded
    for s in range(S):
        assert len(port_streams[s]) > 0
        assert port_streams[s] == jax_streams[s], f"stream {s}"
    assert port_sum == jax_sum


def test_faster_1ref_summary_counts_partitions(encoded):
    (_, _, summary), _, _ = encoded
    used = sum(summary["mb_types"].get(k, 0)
               for k in ("P_16x8", "P_8x16", "P_8x8"))
    assert used > 0, summary["mb_types"]


def test_faster_1ref_streams_decode_to_port_recon(encoded):
    (streams, recons, _), _, _ = encoded
    for s in range(S):
        dec = Decoder().decode(streams[s])
        assert len(dec) == N
        for t, planes in enumerate(dec):
            for got, want in zip(planes, recons[t]):
                np.testing.assert_array_equal(got, want[s],
                                              err_msg=f"stream {s} frame {t}")


def test_faster_1ref_cpu_run_launches_no_kernel(encoded):
    *_, launches = encoded
    assert set(launches) >= {"sad_surface16", "sad_surfaces_8x8"}
    assert all(n == 0 for n in launches.values())
