"""The port's frame steps against the JAX package, on the CPU.

encode_p_frame and encode_i_frame of x264dsp_tpu_torch run two streams
at once (a leading stream axis); each stream's syntax and recon must
equal the JAX single-stream function's exactly. The JAX references are
computed once per module.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import make_clip
from torch_jaxref import light_xla
from x264dsp_tpu import params as P
from x264dsp_tpu.encoder import core as JC
from x264dsp_tpu.encoder import inter_frame as JIF
from x264dsp_tpu.encoder import intra_frame as JIN
from x264dsp_tpu.entropy.bitstream import BitWriter
from x264dsp_tpu.ops import mc as JMC
from x264dsp_tpu.ops.tables import CHROMA_QP_TABLE
from x264dsp_tpu_torch.encoder import core as TC
from x264dsp_tpu_torch.encoder import inter_frame as TIF
from x264dsp_tpu_torch.encoder import intra_frame as TIN

MB_W, MB_H = 4, 3
W, H = MB_W * 16, MB_H * 16
ME_RANGE, MV_RANGE = 16, 512
QPS = (26, 34)           # one QP per stream


def _grid(vals):
    return torch.tensor(vals, dtype=torch.int32)[:, None, None].expand(
        len(vals), MB_H, MB_W).contiguous()


@pytest.fixture(scope="module")
def clips():
    return [make_clip(W, H, 2, seed=31 + s) for s in range(2)]


def _stack(clips, t, i):
    return torch.from_numpy(np.stack([c[t][i] for c in clips]))


@pytest.fixture(scope="module")
def i_frames(clips):
    jax_out = []
    for s, qp in enumerate(QPS):
        y, u, v = clips[s][0]
        with light_xla():
            out = JIN.encode_i_frame(
                y, u, v, qp, int(CHROMA_QP_TABLE[qp]),
                int(JC.LAMBDA_TAB[qp]), mb_w=MB_W, mb_h=MB_H, use_satd=True,
                i4x4_enabled=True)
        jax_out.append({k: np.asarray(a) for k, a in out.items()})
    qpc = [int(CHROMA_QP_TABLE[q]) for q in QPS]
    lam = [int(JC.LAMBDA_TAB[q]) for q in QPS]
    port = TIN.encode_i_frame(_stack(clips, 0, 0), _stack(clips, 0, 1),
                              _stack(clips, 0, 2), _grid(QPS), _grid(qpc),
                              _grid(lam), MB_W, MB_H, True, True)
    return jax_out, port


@pytest.mark.parametrize("key", JC._DEV_SYN_I + (
    "recon_y", "recon_u", "recon_v", "luma_nnz", "chroma_nnz_ac",
    "chroma_nz_dc"))
def test_encode_i_frame_matches_jax(i_frames, key):
    jax_out, port = i_frames
    for s in range(2):
        np.testing.assert_array_equal(port[key][s].numpy(), jax_out[s][key],
                                      err_msg=f"stream {s}")


@pytest.fixture(scope="module")
def p_frames(clips, i_frames):
    """P frame on top of each stream's JAX I-frame recon."""
    jax_i, _ = i_frames
    refs = []
    for s in range(2):
        refs.append((np.asarray(JMC.make_ref_planes(
            jnp.asarray(jax_i[s]["recon_y"]))),
            np.asarray(JMC.pad_chroma(jnp.asarray(jax_i[s]["recon_u"]))),
            np.asarray(JMC.pad_chroma(jnp.asarray(jax_i[s]["recon_v"])))))
    jax_out = []
    for s, qp in enumerate(QPS):
        y, u, v = clips[s][1]
        g = lambda x: jnp.full((MB_H, MB_W), x, jnp.int32)  # noqa: E731
        with light_xla():
            out = JIF.encode_p_frame(
                jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                *(jnp.asarray(r) for r in refs[s]), g(qp),
                g(int(CHROMA_QP_TABLE[qp])), g(int(JC.LAMBDA_TAB[qp])),
                mb_w=MB_W, mb_h=MB_H, me_range=ME_RANGE, mv_range=MV_RANGE,
                dct_decimate=True, fast_pskip=True, partitions=False,
                n_ref=1, subme=1, me_method=0)
        jax_out.append({k: np.asarray(a) for k, a in out.items()})
    qpc = [int(CHROMA_QP_TABLE[q]) for q in QPS]
    lam = [int(JC.LAMBDA_TAB[q]) for q in QPS]
    ref_t = [torch.from_numpy(np.stack([r[i] for r in refs]))
             for i in range(3)]
    port = TIF.encode_p_frame(_stack(clips, 1, 0), _stack(clips, 1, 1),
                              _stack(clips, 1, 2), *ref_t, _grid(QPS),
                              _grid(qpc), _grid(lam), MB_W, MB_H, ME_RANGE,
                              MV_RANGE, True)
    return jax_out, port


@pytest.mark.parametrize("key", JC._DEV_SYN_P + (
    "mv", "bs", "feo", "recon_y", "recon_u", "recon_v", "luma_nnz",
    "chroma_nnz_ac", "chroma_nz_dc"))
def test_encode_p_frame_matches_jax(p_frames, key):
    jax_out, port = p_frames
    for s in range(2):
        np.testing.assert_array_equal(port[key][s].numpy(), jax_out[s][key],
                                      err_msg=f"stream {s}")


def test_p_frame_exercises_motion_and_skip(p_frames):
    """The clip moves and holds static areas: both coded MVs and P-skip
    probe hits occur, so the comparison covers the walk and the probe."""
    _, port = p_frames
    assert (port["mv"] != 0).any()
    assert (port["cbp_luma"] == 0).any() and (port["cbp_luma"] != 0).any()


def test_eff_qp_scan_matches_decoded_qp(i_frames):
    """The cummax carry-scan equals the JAX encoder's host raster scan
    (EncoderCore._decoded_qp) on a per-MB QP grid."""
    _, port = i_frames
    rng = np.random.default_rng(3)
    qp = rng.integers(20, 40, (2, MB_H, MB_W)).astype(np.int32)
    got = TC.eff_qp_scan(port, torch.from_numpy(qp), 27, True).numpy()
    for s in range(2):
        syn = {k: port[k][s].numpy() for k in port}
        want = JC.EncoderCore._decoded_qp(None, syn, P.SLICE_TYPE_I, qp[s],
                                          27)
        np.testing.assert_array_equal(got[s], want)


class _HeaderState:
    def __init__(self, p, frame_num):
        from x264dsp_tpu.encoder.sets import PPS, SPS
        self.param = P.validate_parameters(p)
        self.sps = SPS.init(self.param, self.param.i_sps_id)
        self.pps = PPS.init(self.param, self.sps, self.param.i_sps_id)
        self.frame_num = frame_num

    def _deblock_enabled(self, qp):
        return TC.deblock_enabled(self.param, qp)


@pytest.mark.parametrize("slice_type,qp,idr,a0", [
    (P.SLICE_TYPE_I, 23, 0, 0), (P.SLICE_TYPE_I, 12, 7, -2),
    (P.SLICE_TYPE_P, 26, -1, 0), (P.SLICE_TYPE_P, 8, -1, -2),
    (P.SLICE_TYPE_P, 40, -1, 3)])
def test_slice_header_bytes_match_jax(slice_type, qp, idr, a0):
    """The copied slice-header writer emits the JAX writer's bits in the
    BatchEncoder's cases (CAVLC, one reference, deblock on and off)."""
    p = P.param_default()
    p.i_width, p.i_height = W, H
    p.b_cabac = 0
    p.i_deblocking_filter_alphac0 = a0
    st = _HeaderState(p, frame_num=5)
    bw_t, bw_j = BitWriter(), BitWriter()
    TC.write_slice_header_common(st, bw_t, slice_type, qp, idr)
    JC.EncoderCore._write_slice_header_common(st, bw_j, slice_type, qp, idr,
                                              n_ref=1)
    assert bw_t.get_unaligned() == bw_j.get_unaligned()


def test_host_helpers_match_jax():
    np.testing.assert_array_equal(TC.LAMBDA_TAB, JC.LAMBDA_TAB)
    assert TC.DEV_PAYLOAD_BYTES_PER_MB == JC._DEV_PAYLOAD_BYTES_PER_MB
    plane = np.arange(30 * 20, dtype=np.uint8).reshape(30, 20)
    np.testing.assert_array_equal(TC.pad_mod16(plane, 16),
                                  JC.pad_mod16(plane, 16))
    p = P.param_default()
    p.i_width, p.i_height = W, H
    for qp in (10, 15, 16, 26):
        assert TC.deblock_enabled(p, qp) == \
            JC.EncoderCore._deblock_enabled(_HeaderState(p, 0), qp)
