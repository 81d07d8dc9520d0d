"""The port's device CABAC front half (entropy/cabac_device.py) against
the JAX package's, on the CPU, exactly: the per-block op streams of every
residual category (sparse to dense, levels up to 2500 so the escapes
run), a 4x3 frame with I16 and non-I16 MBs, and the overflow flag (a
tiny cap_ops, and a block whose escape chains pass PAD). One JAX program
computes every reference. Then the port's C++ CABAC writer must give the
same bytes and MB counts with the op stream as without it, on random
and on encoded I and P syntax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cabac_device import _syn_frame, random_block
from torch_jaxref import light_xla
from x264dsp_tpu.entropy import cabac_device as JCD
from x264dsp_tpu_torch.entropy import cabac_device as TCD
from x264dsp_tpu_torch.entropy import native
from x264dsp_tpu_torch.ops import mc
from x264dsp_tpu_torch.parallel import dryrun as TD
from x264dsp_tpu_torch.parallel import mesh as TM

MB_H, MB_W = 3, 4
CAP, TINY_CAP = 1 << 16, 64
N_COEF = {0: 16, 1: 15, 2: 16, 3: 4, 4: 15}
FRAME_KEYS = ("luma_levels", "luma_dc_levels", "chroma_dc_levels",
              "chroma_ac_levels")


def _blocks():
    """Random blocks of every category (as tests/test_cabac_device.py
    draws them), single-coefficient edges, a dense escape block and an
    empty one per category."""
    blocks, cats = [], []
    for cat, n in N_COEF.items():
        rng = np.random.default_rng(70 + cat)
        for density in (0.1, 0.4, 0.9, 1.0):
            for big in (False, True):
                for _ in range(6):
                    blocks.append(random_block(rng, cat, density, big))
                    cats.append(cat)
        for pos, val in [(0, 1), (n - 1, -1), (0, 15), (n - 1, 2000),
                         (0, -14), (n - 1, 16)]:
            lv = np.zeros(16, np.int32)
            lv[pos] = val
            blocks.append(lv)
            cats.append(cat)
        blocks.append(np.where(np.arange(16) < n, -2400, 0).astype(np.int32))
        cats.append(cat)
        blocks.append(np.zeros(16, np.int32))
        cats.append(cat)
    return np.stack(blocks), np.array(cats, np.int32)


def _frame_args(syn, is_i16):
    """residual_ops_frame's arguments (a P frame has no luma DC)."""
    dc = np.zeros((MB_H, MB_W, 16), np.int32)
    return [syn.get(k, dc).astype(np.int32) for k in FRAME_KEYS] + [
        is_i16.astype(np.int32)]


@pytest.fixture(scope="module")
def inputs():
    """The blocks; the 4x3 I frame's syntax (I16 and I4 MBs) and the same
    frame with one luma block of 16 escapes (its ops pass PAD)."""
    syn, is_i16 = _syn_frame(np.random.default_rng(23), MB_H, MB_W, False)
    assert is_i16.any() and not is_i16.all()
    big = {k: v.copy() for k, v in syn.items()}
    big["luma_levels"][1, 2, 5, :] = 2000
    return _blocks(), (syn, is_i16), _frame_args(syn, is_i16), _frame_args(
        big, is_i16)


@pytest.fixture(scope="module")
def jax_ref(inputs):
    (blocks, cats), _, frame, big = inputs

    def ref(b, c, f, g):
        return (JCD._block_ops_batched(b, c),
                JCD.residual_ops_frame(*f, MB_H, MB_W, CAP),
                JCD.residual_ops_frame(*f, MB_H, MB_W, TINY_CAP),
                JCD.residual_ops_frame(*g, MB_H, MB_W, CAP))
    with light_xla():
        out = jax.jit(ref)(jnp.asarray(blocks), jnp.asarray(cats),
                           [jnp.asarray(a) for a in frame],
                           [jnp.asarray(a) for a in big])
    return jax.tree_util.tree_map(np.asarray, out)


def _port_frame(args, cap):
    return [t.numpy() for t in TCD.residual_ops_frame(
        *(torch.from_numpy(a) for a in args), MB_H, MB_W, cap)]


FRAME_CASES = ("frame", "tiny cap", "escape block")


@pytest.fixture(scope="module")
def port(inputs):
    """The port's block ops and its three frames, computed once."""
    (blocks, cats), _, frame, big = inputs
    ops, count = TCD.block_ops(torch.from_numpy(blocks),
                               torch.from_numpy(cats))
    frames = dict(zip(FRAME_CASES, (_port_frame(frame, CAP),
                                    _port_frame(frame, TINY_CAP),
                                    _port_frame(big, CAP))))
    return ops, count, frames


@pytest.mark.parametrize("cat", sorted(N_COEF))
def test_block_ops_match_jax(inputs, jax_ref, port, cat):
    blocks, cats = inputs[0]
    ops, count = port[:2]
    assert ops.dtype == torch.int16 and ops.shape == (len(blocks), TCD.PAD)
    sel = cats == cat
    np.testing.assert_array_equal(count.numpy()[sel], jax_ref[0][1][sel])
    np.testing.assert_array_equal(ops.numpy()[sel], jax_ref[0][0][sel])
    # the dense escape block passes PAD (a 2x2 DC block of four cannot);
    # the empty block codes nothing
    assert (count.numpy()[sel][-2] >= TCD.PAD) == (cat != 3)
    assert count.numpy()[sel][-1] == 0


@pytest.mark.parametrize("case,field", [
    (c, f) for c in FRAME_CASES for f in ("ops", "block_off", "overflow")])
def test_residual_ops_frame_matches_jax(jax_ref, port, case, field):
    got = port[2][case]
    ref = jax_ref[1 + FRAME_CASES.index(case)]
    i = ("ops", "block_off", "overflow").index(field)
    assert got[i].dtype == ref[i].dtype and got[i].shape == ref[i].shape
    np.testing.assert_array_equal(got[i], ref[i])
    # only the full frame at the large cap fits
    assert bool(got[2]) == (case != "frame")


def test_chunks_do_not_change_the_frame(inputs, jax_ref, monkeypatch):
    """Blocks go through block_ops CHUNK at a time; chunks of 7 blocks
    (the frame's 324 cut mid-MB) give the JAX frame too."""
    monkeypatch.setattr(TCD, "CHUNK", 7)
    for got, want in zip(_port_frame(inputs[2], CAP), jax_ref[1]):
        np.testing.assert_array_equal(got, want)


def _encoded_syntax(kind):
    """One 64x48 noise stream of the dry run's generator through the
    mesh's I step, or its next frame through the mesh's P pipeline
    against the first's source planes."""
    frames = [TD.synthetic_planes(64, 48, 1, seed) for seed in (3, 4)]
    t0 = [torch.from_numpy(a) for a in frames[0]]
    if kind == "I":
        out = TM.encode_i_frames_batched(*t0, 26, 26, 5, MB_W, MB_H, True,
                                         True)
    else:
        refs = (mc.make_ref_planes(t0[0]), mc.pad_chroma(t0[1]),
                mc.pad_chroma(t0[2]))
        out, _ = TM.encode_p_pipeline_batched(
            *(torch.from_numpy(a) for a in frames[1]), *refs, 26, 26, 5,
            MB_W, MB_H, 16, 512, True)
    syn = {k: v[0].numpy().astype(np.int16) for k, v in out.items()
           if not k.startswith("recon")}
    is_i16 = (syn["mb_type"] == 0) if kind == "I" else np.zeros(
        (MB_H, MB_W), bool)
    return syn, is_i16


@pytest.mark.parametrize("source", ["random I", "random P", "encoded I",
                                    "encoded P"])
def test_writer_consumes_ops_byte_identical(source):
    """write_slice_cabac with res_ops / res_off gives the bytes and MB
    counts of the writer's own binarization."""
    origin, kind = source.split()
    if origin == "random":
        syn, is_i16 = _syn_frame(np.random.default_rng(31 + (kind == "P")),
                                 MB_H, MB_W, kind == "P")
    else:
        syn, is_i16 = _encoded_syntax(kind)
    ops, off, ov = _port_frame(_frame_args(syn, is_i16), CAP)
    assert not ov and off[-1] > 0
    header = bytes([0x40])
    want, want_counts = native.write_slice_cabac(header, MB_W, MB_H, 26, 1,
                                                 kind == "P", syn)
    got, got_counts = native.write_slice_cabac(header, MB_W, MB_H, 26, 1,
                                               kind == "P", syn,
                                               res_ops=ops, res_off=off)
    assert got == want
    np.testing.assert_array_equal(got_counts, want_counts)
    # the writer does read the stream: flipped bins change the bytes
    bad = np.where(np.arange(len(ops)) < off[-1], ops ^ 1, 0)
    assert native.write_slice_cabac(header, MB_W, MB_H, 26, 1, kind == "P",
                                    syn, res_ops=bad, res_off=off)[0] != want
