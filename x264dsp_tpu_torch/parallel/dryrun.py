"""The multi-device dry run — port of __graft_entry__.py:41-244
``dryrun_multichip``.

One stream per mesh entry at QCIF (176x144) through the hard paths, in
four sections:
  1. a sharded I step, then a sharded P pipeline on the exact-MVP
     decision wavefront (ESA, me_range 16, mv_range 512, decimation),
     then the device CAVLC packer on every shard;
  2. the same P pipeline and packer on the mesh's first device alone,
     from section 1's recon: its payload offsets and every stream's bytes
     must be the sharded run's;
  3. the host C++ CABAC writer on each stream's pulled syntax;
  4. the public Encoder on the mesh's first device: 64x48, 2 slices, ABR
     80 kbit/s under a VBV of 80 / 40 kbit, 3 frames, 6 slice NALs.
The sections are functions of their own (run_step, check_identity,
cabac_sizes, encoder_slices), so a test can run them at another size.
"""

from __future__ import annotations

import functools
import sys
import time

import numpy as np
import torch

from .. import params as P
from ..api import Encoder, Picture
from ..entropy import cavlc_device as CD
from ..entropy import native
from ..entropy.bitstream import BitWriter
from ..ops import mc as MC
from .mesh import (Sharded, StreamMesh, encode_i_frames_batched,
                   encode_p_pipeline_batched, make_stream_mesh, map_shards,
                   map_streams, shard_streams)

QCIF = (176, 144)
QP, QPC, LAMBDA = 26, 26, 5
ME_RANGE, MV_RANGE = 16, 512
CAP_PER_STREAM = 256 * 1024
_CAVLC_KEYS = ("partition", "ref", "cbp_luma", "cbp_chroma", "mv8",
               "luma_levels", "chroma_dc_levels", "chroma_ac_levels")
_CABAC_KEYS = ("partition", "ref", "cbp_luma", "cbp_chroma", "mv8", "mv",
               "luma_levels", "chroma_dc_levels", "chroma_ac_levels",
               "luma_nnz", "chroma_nnz_ac", "chroma_nz_dc")


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def synthetic_planes(w: int, h: int, s: int, seed: int = 0):
    """Uniform noise planes (s, h, w) and two (s, h/2, w/2), uint8
    (__graft_entry__.py:16-23)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (s, h, w)).astype(np.uint8)
    u = rng.integers(0, 256, (s, h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (s, h // 2, w // 2)).astype(np.uint8)
    return y, u, v


def p_slice_header(cabac: bool) -> BitWriter:
    """The dry run's hand-built P slice header (frame_num 1, no
    reordering or marking, qp delta 0, deblock on); with cabac the
    cabac_init_idc and the alignment ones."""
    hw = BitWriter()
    hw.write_ue(0)            # first_mb
    hw.write_ue(5)            # slice_type P (+5)
    hw.write_ue(0)            # pps id
    hw.write(4, 1)            # frame_num
    hw.write1(0)              # num_ref_idx_override
    hw.write1(0)              # ref_pic_list_modification
    hw.write1(0)              # adaptive_ref_pic_marking
    if cabac:
        hw.write_ue(0)        # cabac_init_idc
    hw.write_se(0)            # qp delta
    hw.write_ue(0)            # deblock idc
    hw.write_se(0)
    hw.write_se(0)
    if cabac:
        hw.align_1()          # cabac_alignment_one_bit
    return hw


def host(x) -> np.ndarray:
    """A plain or Sharded tensor as one numpy array."""
    return (x.gather("cpu") if isinstance(x, Sharded) else x.cpu()).numpy()


def _pack(hv, hl, mb_w, mb_h, *vals):
    """The device CAVLC packer on one shard's streams."""
    syn = dict(zip(_CAVLC_KEYS, vals))
    S, dev = vals[0].shape[0], vals[0].device
    qp_mb = torch.full((S, mb_h, mb_w), QP, dtype=torch.int32, device=dev)
    return CD.cavlc_p_payload_batched(
        syn, qp_mb, QP, 1, mb_h, mb_w, torch.as_tensor(hv, device=dev),
        torch.as_tensor(hl, device=dev), cap_bytes=CAP_PER_STREAM * S)


def cavlc_payloads(pout, mb_w: int, mb_h: int):
    """Every stream's CAVLC slice payload, packed on its shard's device.
    Returns (per-stream bytes, byte offsets (S + 1,) of the streams back
    to back, overflow): a single device's offsets are the packer's own, a
    sharded run's are each shard's, shifted past the shards before."""
    hv, hl = CD.header_elements(*p_slice_header(False).get_unaligned())
    vals = [pout[k] for k in _CAVLC_KEYS]
    fn = functools.partial(_pack, hv, hl, mb_w, mb_h)
    parts = (map_shards(fn, *vals) if isinstance(vals[0], Sharded)
             else [fn(*vals)])
    streams, offs, overflow = [], [0], False
    for payload, off, _, ov in parts:
        payload, off = payload.cpu().numpy(), off.cpu().numpy()
        streams += [payload[off[s]:off[s + 1]].tobytes()
                    for s in range(len(off) - 1)]
        offs += [offs[-1] + int(o) for o in off[1:]]
        overflow |= bool(ov.any())
    return streams, np.asarray(offs, np.int64), overflow


def run_step(mesh: StreamMesh, planes_p, shard: bool, planes_i=None,
             recon=None) -> dict:
    """I step + the steady-state P pipeline + the device CAVLC payload of
    the same streams, sharded over the mesh or on its first device.
    planes_i / planes_p: numpy (y, u, v), each with a leading stream
    axis; recon: a numpy recon triple that replaces the I step (the
    single-device twin starts from the sharded run's). Returns the I and
    P outputs, the new reference planes, the per-stream payloads and
    their offsets; raises on an overflow."""
    dev0 = mesh.devices[0]

    def put(arrs):
        ts = [torch.from_numpy(np.ascontiguousarray(a)).to(dev0)
              for a in arrs]
        return shard_streams(mesh, *ts) if shard else ts
    S, h, w = planes_p[0].shape
    mb_w, mb_h = w // 16, h // 16
    if recon is None:
        fy, fu, fv = put(planes_i)
        iout = encode_i_frames_batched(fy, fu, fv, QP, QPC, LAMBDA, mb_w,
                                       mb_h, use_satd=True,
                                       i4x4_enabled=True)
        _check(tuple(iout["recon_y"].shape) == (S, h, w),
               f"I recon shape {tuple(iout['recon_y'].shape)}")
        ry, ru, rv = iout["recon_y"], iout["recon_u"], iout["recon_v"]
    else:
        iout = None
        ry, ru, rv = put(recon)
    ref4 = map_streams(MC.make_ref_planes, ry)
    refu = map_streams(MC.pad_chroma, ru)
    refv = map_streams(MC.pad_chroma, rv)
    fy2, fu2, fv2 = put(planes_p)
    pout, refs = encode_p_pipeline_batched(
        fy2, fu2, fv2, ref4, refu, refv, QP, QPC, LAMBDA, mb_w, mb_h,
        ME_RANGE, MV_RANGE, dct_decimate=True, me_parallel=False)
    _check(tuple(pout["mv"].shape) == (S, mb_h, mb_w, 2),
           f"mv shape {tuple(pout['mv'].shape)}")
    _check(tuple(pout["bs"].shape) == (S, mb_h, mb_w, 2, 4, 4),
           f"bs shape {tuple(pout['bs'].shape)}")
    streams, off, overflow = cavlc_payloads(pout, mb_w, mb_h)
    _check(not overflow, "device CAVLC overflow")
    _check(off.shape == (S + 1,) and off[-1] > 0,
           f"payload offsets {off.tolist()}")
    return {"iout": iout, "pout": pout, "refs": refs, "streams": streams,
            "off": off}


def check_identity(sharded: dict, single: dict) -> None:
    """The sharded run's payload offsets and every stream's bytes equal
    the single-device run's (sharding is a throughput axis, never an
    output axis)."""
    _check(np.array_equal(sharded["off"], single["off"]),
           "payload offsets diverge")
    for s, (a, b) in enumerate(zip(sharded["streams"], single["streams"])):
        _check(a == b, f"stream {s}: sharded payload != single-device "
               "payload")


def cabac_sizes(pout, mb_w: int, mb_h: int) -> list:
    """The host C++ CABAC writer on every stream's pulled P syntax;
    returns each slice's bytes."""
    header = p_slice_header(True).get_bytes()
    syn = {k: host(pout[k]) for k in _CABAC_KEYS if k in pout}
    sizes = []
    for s in range(len(syn["cbp_luma"])):
        body, _ = native.write_slice_cabac(
            header, mb_w, mb_h, QP, 1, True,
            {k: v[s] for k, v in syn.items()})
        _check(len(body) > len(header), f"stream {s}: empty CABAC slice")
        sizes.append(len(body))
    return sizes


def encoder_slices(device, n_frames: int = 3, seed: int = 7) -> int:
    """Multi-slice + row VBV through the public Encoder (x264.h:660-662,
    ratecontrol.c:651-780): 64x48, 2 slices, ABR 80 with VBV 80 / 40
    (a tight bucket: the row walk is on). Returns the slice NALs, which
    must be 2 per frame."""
    p = P.param_default()
    p.i_width, p.i_height = 64, 48
    p.i_slice_count = 2
    p.rc.i_rc_method = P.RC_ABR
    p.rc.i_bitrate = 80
    p.rc.i_vbv_max_bitrate = 80
    p.rc.i_vbv_buffer_size = 40
    enc = Encoder(p, device=device)
    rng = np.random.default_rng(seed)
    n_slice_nals = 0
    for _ in range(n_frames):
        yy = rng.integers(0, 256, (48, 64)).astype(np.uint8)
        uu = rng.integers(0, 256, (24, 32)).astype(np.uint8)
        vv = rng.integers(0, 256, (24, 32)).astype(np.uint8)
        nals, _ = enc.encode(Picture.from_planes(yy, uu, vv))
        n_slice_nals += sum(1 for n in nals if n.i_type in (1, 5))
    enc.close()
    _check(n_slice_nals == n_frames * p.i_slice_count,
           f"expected {n_frames * p.i_slice_count} slice NALs, got "
           f"{n_slice_nals}")
    return n_slice_nals


def dryrun_multichip(n_devices: int | None = None, devices=None) -> dict:
    """The four sections at QCIF, one stream per mesh entry, on the mesh
    of `devices` (make_stream_mesh: None is every CUDA device), cut to
    its first n_devices entries when given. Raises RuntimeError on a
    failed check; prints the OK line and returns its numbers."""
    mesh = make_stream_mesh(devices)
    if n_devices is not None:
        _check(mesh.size >= n_devices,
               f"need {n_devices} devices, have {mesh.size}")
        mesh = StreamMesh(mesh.devices[:n_devices], mesh.axis)
    n = mesh.size
    t0 = time.monotonic()

    def progress(msg):
        print(f"dryrun [{time.monotonic() - t0:6.1f}s] {msg}",
              file=sys.stderr, flush=True)
    w, h = QCIF
    planes_i = synthetic_planes(w, h, n, seed=0)
    planes_p = synthetic_planes(w, h, n, seed=1)
    progress("section 1/4: sharded I+P steps + device CAVLC")
    run = run_step(mesh, planes_p, shard=True, planes_i=planes_i)
    progress("section 2/4: single-device twin for byte-identity")
    recon = tuple(host(run["iout"][k])
                  for k in ("recon_y", "recon_u", "recon_v"))
    check_identity(run, run_step(mesh, planes_p, shard=False, recon=recon))
    progress("section 3/4: host CABAC stage over sharded syntax")
    sizes = cabac_sizes(run["pout"], w // 16, h // 16)
    progress("section 4/4: multi-slice + row-VBV public Encoder")
    n_slice_nals = encoder_slices(mesh.devices[0])
    print(f"dryrun_multichip OK: {n} devices, QCIF I+P steps on "
          f"the exact-MVP wavefront, sharded device CAVLC byte-identical "
          f"to single-device ({int(run['off'][-1])} B), host CABAC stage "
          f"packed {sum(sizes)} B over {n} shards, "
          f"multi-slice+row-VBV Encoder emitted {n_slice_nals} slices")
    return {"devices": n, "payload_bytes": int(run["off"][-1]),
            "cabac_bytes": sum(sizes), "slice_nals": n_slice_nals}
