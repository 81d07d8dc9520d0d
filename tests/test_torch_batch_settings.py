"""The port's BatchEncoder under non-default settings, against the JAX one.

The clip and harness of tests/test_torch_batch.py (64x48, 2 streams,
keyint 4, I P P P I) with the settings that frame_cfg carries beyond the
defaults:

- "tools": no fast P-skip, no DCT decimation, I16x16 only (no I4x4), a
  chroma QP offset of 2 and deblock offsets (-2, 3);
- "no_deblock": the deblocking filter off.

In each case the port's Annex-B bytes on the CPU equal the JAX
BatchEncoder's and differ from the port's bytes at the default settings
(the settings reach the bitstream). The two JAX encoders compile side by
side in threads, inside light_xla().
"""

from concurrent.futures import ThreadPoolExecutor

import pytest

import x264dsp_tpu as xt
import x264dsp_tpu_torch as xtt
from test_torch_batch import S, _clip, _params, _run
from torch_jaxref import light_xla
from x264dsp_tpu import params as JP


def _tools(p):
    p.analyse.b_fast_pskip = 0
    p.analyse.b_dct_decimate = 0
    p.analyse.intra &= ~JP.ANALYSE_I4x4
    p.analyse.i_chroma_qp_offset = 2
    p.i_deblocking_filter_alphac0 = -2
    p.i_deblocking_filter_beta = 3


def _no_deblock(p):
    p.b_deblocking_filter = 0


SETTINGS = {"tools": _tools, "no_deblock": _no_deblock}


def _settings_params(pkg, name):
    p = _params(pkg)
    SETTINGS[name](p)
    return p


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX BatchEncoder's streams for every setting."""
    clips = [_clip(11 + s) for s in range(S)]

    def one(name):
        be = xt.BatchEncoder(_settings_params(xt, name), S)
        return _run(be, clips)[0]
    with light_xla(), ThreadPoolExecutor(len(SETTINGS)) as pool:
        return dict(zip(SETTINGS, pool.map(one, SETTINGS)))


@pytest.mark.parametrize("name", list(SETTINGS))
def test_settings_bytes_match_jax_batch_encoder(jax_streams, name):
    clips = [_clip(11 + s) for s in range(S)]
    port, _, _ = _run(xtt.BatchEncoder(_settings_params(xtt, name), S,
                                       device="cpu"), clips)
    default, _, _ = _run(xtt.BatchEncoder(_params(), S, device="cpu"),
                         clips)
    for s in range(S):
        assert len(port[s]) > 0
        assert port[s] == jax_streams[name][s], f"{name}: stream {s}"
        assert port[s] != default[s], f"{name}: stream {s}"
