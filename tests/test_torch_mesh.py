"""The port's stream mesh (x264dsp_tpu_torch/parallel) against the JAX
package's, on the CPU.

Four streams of 64x48 (4x3 MBs) over a two-entry CPU mesh: the port's
encode_i_frames_batched and encode_p_pipeline_batched (ESA, the exact-MVP
wavefront) must equal x264dsp_tpu.parallel.mesh's, sharded over two of
conftest's virtual CPU devices, exactly, for every output key and the
three new reference planes; and the port's sharded results must equal
its single-device ones. The P frame is coded against the reference
planes of the previous source frame, so the two JAX programs compile
side by side (inside light_xla) while the port runs. The dry run's
sections run at this size through the helpers its QCIF run uses; its
sections 1 and 2 give the port's P pipeline that is held to JAX.
"""

import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_clip
from torch_jaxref import light_xla
from x264dsp_tpu.parallel import mesh as JM
from x264dsp_tpu_torch import _build
from x264dsp_tpu_torch.ops import mc as TMC
from x264dsp_tpu_torch.parallel import dryrun as TD
from x264dsp_tpu_torch.parallel import mesh as TM

MB_W, MB_H = 4, 3
W, H, S = MB_W * 16, MB_H * 16, 4
I_KEYS = ("mb_type", "i16_mode", "i4_modes", "chroma_mode", "cbp_luma",
          "cbp_chroma", "nz_luma_dc", "luma_levels", "luma_dc_levels",
          "chroma_dc_levels", "chroma_ac_levels", "luma_nnz",
          "chroma_nnz_ac", "chroma_nz_dc", "recon_y", "recon_u", "recon_v")
P_KEYS = ("partition", "ref", "cbp_luma", "cbp_chroma", "mv8", "mv",
          "luma_levels", "chroma_dc_levels", "chroma_ac_levels", "luma_nnz",
          "chroma_nnz_ac", "chroma_nz_dc", "bs", "feo", "recon_y",
          "recon_u", "recon_v")
REF_PLANES = ("ref4", "refu", "refv")
STEP = dict(qp=TD.QP, qpc=TD.QPC, lam=TD.LAMBDA, mb_w=MB_W, mb_h=MB_H)
P_ARGS = dict(me_range=TD.ME_RANGE, mv_range=TD.MV_RANGE, dct_decimate=True,
              me_parallel=False)


@pytest.fixture(scope="module")
def planes():
    """Frames 0 and 1 of four moving clips, each (y, u, v) stacked on the
    stream axis, and the reference planes of frame 0's source."""
    clips = [make_clip(W, H, 2, seed=51 + s) for s in range(S)]
    frames = [tuple(np.stack([c[t][i] for c in clips]) for i in range(3))
              for t in (0, 1)]
    y, u, v = (torch.from_numpy(a) for a in frames[0])
    refs = tuple(r.numpy() for r in (TMC.make_ref_planes(y),
                                     TMC.pad_chroma(u), TMC.pad_chroma(v)))
    return frames, refs


def _jax_i(frames):
    mesh = JM.make_stream_mesh(jax.devices()[:2])
    fy, fu, fv = JM.shard_streams(mesh, *(jnp.asarray(a) for a in frames[0]))
    out = JM.encode_i_frames_batched(
        fy, fu, fv, TD.QP, TD.QPC, TD.LAMBDA, mb_w=MB_W, mb_h=MB_H,
        use_satd=True, i4x4_enabled=True)
    return {k: np.asarray(a) for k, a in out.items()}


def _jax_p(frames, refs):
    mesh = JM.make_stream_mesh(jax.devices()[:2])
    args = JM.shard_streams(mesh, *(jnp.asarray(a)
                                    for a in frames[1] + refs))
    out, new_refs = JM.encode_p_pipeline_batched(
        *args, TD.QP, TD.QPC, TD.LAMBDA, mb_w=MB_W, mb_h=MB_H, **P_ARGS)
    return ({k: np.asarray(a) for k, a in out.items()},
            dict(zip(REF_PLANES, (np.asarray(r) for r in new_refs))))


@pytest.fixture(scope="module")
def runs(planes):
    """The JAX I and P programs compiled and run in two threads; the
    port meanwhile, sharded and on one device: its I step, and the dry
    run's sections 1 and 2 at 64x48 from the source of frame 0 as the
    recon (their P pipeline is the one held to JAX here), and section
    4's Encoder."""
    frames, refs = planes
    mesh = TM.make_stream_mesh(["cpu"] * 2)
    with light_xla(), ThreadPoolExecutor(2) as pool:
        ji = pool.submit(_jax_i, frames)
        jp = pool.submit(_jax_p, frames, refs)
        port = {}
        for name, shard in (("sharded", True), ("single", False)):
            ts = [torch.from_numpy(a) for a in frames[0]]
            if shard:
                ts = TM.shard_streams(mesh, *ts)
            i_out = TM.encode_i_frames_batched(*ts, use_satd=True,
                                               i4x4_enabled=True, **STEP)
            dry = TD.run_step(mesh, frames[1], shard=shard, recon=frames[0])
            port[name] = (i_out, dry["pout"],
                          dict(zip(REF_PLANES, dry["refs"])), dry)
        slice_nals = TD.encoder_slices("cpu")
        jax_i, (jax_p, jax_refs) = ji.result(), jp.result()
    return {"mesh": mesh, "jax": (jax_i, jax_p, jax_refs),
            "sharded": port["sharded"][:3], "single": port["single"][:3],
            "dryrun": [port["sharded"][3], port["single"][3]],
            "slice_nals": slice_nals}


def _pick(out, part, key):
    i_out, p_out, refs = out
    return {"I": i_out, "P": p_out, "ref": refs}[part][key]


CASES = ([("I", k) for k in I_KEYS] + [("P", k) for k in P_KEYS]
         + [("ref", k) for k in REF_PLANES])


def test_every_output_is_compared(runs):
    jax_i, jax_p, _ = runs["jax"]
    i_out, p_out, _ = runs["sharded"]
    assert set(jax_i) == set(I_KEYS) == set(i_out)
    assert set(jax_p) == set(P_KEYS) == set(p_out)


@pytest.mark.parametrize("part,key", CASES)
def test_sharded_port_matches_sharded_jax(runs, part, key):
    got = TD.host(_pick(runs["sharded"], part, key))
    want = _pick(runs["jax"], part, key)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("part,key", CASES)
def test_sharded_equals_single_device(runs, part, key):
    sharded = _pick(runs["sharded"], part, key)
    single = _pick(runs["single"], part, key)
    assert isinstance(sharded, TM.Sharded) and torch.is_tensor(single)
    assert [s.shape[0] for s in sharded.shards] == [S // 2, S // 2]
    assert tuple(sharded.shape) == tuple(single.shape)
    np.testing.assert_array_equal(TD.host(sharded), single.numpy())


def test_p_frames_batched_is_the_pipelines_p_step(runs, planes):
    """encode_p_frames_batched is encode_p_pipeline_batched without the
    deblock and the reference planes."""
    frames, refs = planes
    args = TM.shard_streams(runs["mesh"], *(torch.from_numpy(a)
                                            for a in frames[1] + refs))
    out = TM.encode_p_frames_batched(*args, **STEP, **P_ARGS)
    assert set(out) == set(P_KEYS)
    for k in P_KEYS:
        np.testing.assert_array_equal(TD.host(out[k]),
                                      TD.host(runs["sharded"][1][k]))


def test_p_frame_codes_motion(runs):
    """The clip moves, so the ESA wavefront finds nonzero vectors."""
    mv = _pick(runs["jax"], "P", "mv")
    assert (mv != 0).any()


def test_uneven_split_raises(runs):
    with pytest.raises(ValueError, match="evenly"):
        TM.shard_streams(runs["mesh"], torch.zeros((3, 16, 16)))


def test_mixed_plain_and_sharded_arguments_raise(runs):
    (a,) = TM.shard_streams(runs["mesh"], torch.zeros((2, 16, 16)))
    with pytest.raises(ValueError, match="mixed"):
        TM.map_shards(lambda x, y: x, a, torch.zeros((2, 16, 16)))


def test_make_stream_mesh_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.make_stream_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.make_stream_mesh(["cuda:0", "cuda:0"])


def test_cpu_mesh_lists_each_entry():
    mesh = TM.make_stream_mesh(["cpu"] * 2)
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.size == 2 and mesh.axis == "stream"


def test_dryrun_sections_1_2_byte_identity(runs):
    sharded, single = runs["dryrun"]
    TD.check_identity(sharded, single)
    assert sharded["off"][-1] == sum(len(b) for b in single["streams"])


def test_dryrun_identity_check_catches_a_changed_byte(runs):
    sharded, single = runs["dryrun"]
    bad = dict(single, streams=list(single["streams"]))
    bad["streams"][3] = bad["streams"][3][:-1] + bytes(
        [bad["streams"][3][-1] ^ 1])
    with pytest.raises(RuntimeError, match="stream 3"):
        TD.check_identity(sharded, bad)


def test_dryrun_section_3_cabac(runs):
    sharded, single = runs["dryrun"]
    sizes = TD.cabac_sizes(sharded["pout"], MB_W, MB_H)
    assert sizes == TD.cabac_sizes(single["pout"], MB_W, MB_H)
    assert len(sizes) == S and min(sizes) > 0


def test_dryrun_section_4_encoder_slices(runs):
    assert runs["slice_nals"] == 6


def test_distinct_devices_run_in_their_own_threads(planes):
    """A mesh of two distinct devices ("cpu" and "cpu:0" compare unequal)
    runs each shard from its own host thread, on every call (a thread
    pool would reuse an idle thread when the first shard ends before the
    second is handed out); the result is the single-device one."""
    frames, _ = planes
    mesh = TM.make_stream_mesh(["cpu", "cpu:0"])
    (y,) = TM.shard_streams(mesh, torch.from_numpy(frames[0][0]))
    want = TMC.make_ref_planes(torch.from_numpy(frames[0][0]))
    for _ in range(20):
        seen = []

        def fn(y):
            seen.append(threading.get_ident())
            return TMC.make_ref_planes(y)
        got = TM.map_streams(fn, y)
        assert len(set(seen)) == 2 and threading.get_ident() not in seen
        np.testing.assert_array_equal(TD.host(got), want.numpy())


def test_launch_counts_lose_no_update_across_threads():
    """count_launch under many threads with a tiny switch interval: every
    increment lands."""
    counts = {"k": 0}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            for f in [pool.submit(lambda: [_build.count_launch(counts, "k")
                                           for _ in range(2000)])
                      for _ in range(16)]:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert counts["k"] == 16 * 2000
