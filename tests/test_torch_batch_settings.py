"""The port's BatchEncoder under non-default settings, against the JAX one.

The harness of tests/test_torch_batch.py (64x48, 2 streams, keyint 4,
I P P P I, pipelined: each slot is pulled only when the next one has
been launched) on a clip whose two streams differ in detail (luma noise
of deviation 2 and 8), with the settings that frame_cfg and the rate
control carry beyond the defaults:

- "tools-crf-umh-subme0": no fast P-skip, no DCT decimation, I16x16
  only (no I4x4), a chroma QP offset of 2, deblock offsets (-2, 3); CRF
  30, the UMH search, subme 0 (tools/mainpath.crf_umh_param);
- "nodeblock-abr-esa-parts": the deblocking filter off; ABR at 200
  kbit/s, the ESA search, subme 2, the 16x8/8x16/8x8 partitions
  (tools/mainpath.abr_esa_param).

In each case the port's Annex-B bytes on the CPU equal the JAX
BatchEncoder's and differ from the port's bytes at the default settings
(the settings reach the bitstream), and the two streams' rate controls
pick different QPs in some slot. The two JAX encoders compile side by
side in threads, inside light_xla().
"""

from concurrent.futures import ThreadPoolExecutor

import pytest

import x264dsp_tpu as xt
import x264dsp_tpu_torch as xtt
from test_torch_batch import H, S, W, _clip, _params, _run
from torch_jaxref import light_xla
from x264dsp_tpu import params as JP
from x264dsp_tpu_torch.tools import mainpath

SIGMAS = (2.0, 8.0)             # luma noise of stream 0 and stream 1


def _tools_crf_umh_subme0(p):
    mainpath.crf_umh_param(W, H, 4, p)
    p.analyse.b_fast_pskip = 0
    p.analyse.b_dct_decimate = 0
    p.analyse.intra &= ~JP.ANALYSE_I4x4
    p.analyse.i_chroma_qp_offset = 2
    p.i_deblocking_filter_alphac0 = -2
    p.i_deblocking_filter_beta = 3


def _nodeblock_abr_esa_parts(p):
    mainpath.abr_esa_param(W, H, 4, p)
    p.b_deblocking_filter = 0


SETTINGS = {"tools-crf-umh-subme0": _tools_crf_umh_subme0,
            "nodeblock-abr-esa-parts": _nodeblock_abr_esa_parts}


def _settings_params(pkg, name):
    p = _params(pkg)
    SETTINGS[name](p)
    return p


def _clips():
    return [_clip(11 + s, sigma) for s, sigma in enumerate(SIGMAS)]


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX BatchEncoder's streams for every setting."""
    clips = _clips()

    def one(name):
        be = xt.BatchEncoder(_settings_params(xt, name), S)
        return _run(be, clips)[0]
    with light_xla(), ThreadPoolExecutor(len(SETTINGS)) as pool:
        return dict(zip(SETTINGS, pool.map(one, SETTINGS)))


@pytest.mark.parametrize("name", list(SETTINGS))
def test_settings_bytes_match_jax_batch_encoder(jax_streams, name):
    clips = _clips()
    qps = []
    port, _, _ = _run(xtt.BatchEncoder(_settings_params(xtt, name), S,
                                       device="cpu"), clips, qps=qps)
    default, _, _ = _run(xtt.BatchEncoder(_params(), S, device="cpu"),
                         clips)
    for s in range(S):
        assert len(port[s]) > 0
        assert port[s] == jax_streams[name][s], f"{name}: stream {s}"
        assert port[s] != default[s], f"{name}: stream {s}"
    assert len(qps) == 5
    assert any(q[0] != q[1] for q in qps), qps
