"""Multi-stream batching over a list of devices — port of
x264dsp_tpu/parallel/mesh.py.

N independent video streams are encoded as one batched program whose
leading stream axis is split over a 1-D mesh of devices (data parallel,
the reference's frame-threading slot, encoder/encoder.c:57). Streams are
independent, so no collective is needed.

The JAX module shards with a ``jax.sharding.Mesh`` and lets XLA place
the work. Here a :class:`StreamMesh` is an ordered tuple of devices, one
shard per entry, and :class:`Sharded` holds a stream-batched tensor as
its per-entry chunks. The batched steps run each shard's chunk on that
shard's device: every distinct device gets one host thread, which runs
its shards in mesh order (the P walks sync the host once per step, so a
single thread for all devices would serialize the cards). Results do not
depend on the split.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass

import torch

from .. import params as P
from ..encoder import inter_frame, intra_frame
from ..encoder.core import resolve_device
from ..ops import deblock as DB
from ..ops import mc as MC


@dataclass(frozen=True)
class StreamMesh:
    """An ordered 1-D device mesh: entry i holds the i-th equal chunk of
    the stream axis. A device may appear more than once, each entry one
    shard: the JAX tests' virtual CPU devices are shards of one host in
    the same way, and so is a mesh that names the one card of a
    one-GPU machine twice."""
    devices: tuple
    axis: str = "stream"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_stream_mesh(devices=None, name: str = "stream") -> StreamMesh:
    """The mesh over `devices` (torch devices or their names), in order;
    None means every CUDA device torch sees, and raises without one (the
    CPU runs only when the caller lists CPU devices)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_stream_mesh() needs a CUDA device; "
                               "torch finds none (list CPU devices to "
                               "run on the CPU)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs.append(dev)
    if not devs:
        raise ValueError("a stream mesh needs at least one device")
    return StreamMesh(tuple(devs), name)


class Sharded:
    """A stream-batched tensor split over a mesh: ``shards[i]`` holds the
    i-th chunk of the stream axis on ``mesh.devices[i]``."""

    def __init__(self, mesh: StreamMesh, shards):
        self.mesh, self.shards = mesh, tuple(shards)

    @property
    def shape(self) -> tuple:
        first = self.shards[0].shape
        return (sum(s.shape[0] for s in self.shards),) + tuple(first[1:])

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on one device (the mesh's first by default)."""
        dev = self.mesh.devices[0] if device is None else device
        return torch.cat([s.to(dev) for s in self.shards])


def shard_streams(mesh: StreamMesh, *tensors):
    """Split each tensor's leading stream axis into mesh.size equal
    contiguous chunks, chunk i on mesh.devices[i] (PSpec("stream", None,
    ...)). A stream count that the mesh size does not divide raises
    ValueError, as JAX's device_put does."""
    out = []
    for t in tensors:
        S = t.shape[0]
        if S % mesh.size:
            raise ValueError(f"{S} streams do not split evenly over a "
                             f"mesh of {mesh.size}")
        k = S // mesh.size
        out.append(Sharded(mesh, [t[i * k:(i + 1) * k].to(dev)
                                  for i, dev in enumerate(mesh.devices)]))
    return tuple(out)


def map_shards(fn, *args) -> list:
    """fn on every shard: the Sharded arguments give their shard, the
    others pass as they are. One host thread per distinct device (the
    calling thread when there is one), each running its shards in mesh
    order under that device. Returns the results in mesh order."""
    sharded = [a for a in args if isinstance(a, Sharded)]
    mesh = sharded[0].mesh
    if any(a.mesh != mesh for a in sharded):
        raise ValueError("the sharded arguments lie on different meshes")
    if any(torch.is_tensor(a) for a in args):
        raise ValueError("mixed sharded and plain tensor arguments")
    by_device: dict = {}
    for i, dev in enumerate(mesh.devices):
        by_device.setdefault(dev, []).append(i)
    out = [None] * mesh.size
    errors = [None] * mesh.size

    def run(dev, shards, ready=None):
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        i = shards[0]
        try:
            if ready is not None:
                ready.wait()
            with ctx:
                for i in shards:
                    out[i] = fn(*(a.shards[i] if isinstance(a, Sharded)
                                  else a for a in args))
        except BaseException as e:  # raised again by the calling thread
            errors[i] = e
    if len(by_device) == 1:
        run(*next(iter(by_device.items())))
    else:
        # Each device's thread runs its shards only once every device has
        # its thread: all devices are driven at once, and no thread ends
        # before the others start (an ended thread's ident can be reused).
        ready = threading.Barrier(len(by_device))
        threads = [threading.Thread(target=run, args=(d, s, ready))
                   for d, s in by_device.items()]
        try:
            for t in threads:
                t.start()
        except BaseException:
            ready.abort()
            raise
        for t in threads:
            t.join()
    for e in errors:
        if e is not None:
            raise e
    return out


def _assemble(mesh, parts):
    """Per-shard results (tensors with a leading stream axis, in dicts
    and tuples) -> the same structure of Sharded tensors."""
    first = parts[0]
    if torch.is_tensor(first):
        return Sharded(mesh, parts)
    if isinstance(first, dict):
        return {k: _assemble(mesh, [p[k] for p in parts]) for k in first}
    if isinstance(first, tuple):
        return tuple(_assemble(mesh, [p[i] for p in parts])
                     for i in range(len(first)))
    raise TypeError(f"cannot assemble shard results of type {type(first)}")


def map_streams(fn, *args):
    """fn over the stream axis: on plain tensors a single call; with
    Sharded arguments one call per shard (map_shards), its outputs
    (leading stream axis) assembled as Sharded tensors."""
    mesh = next((a.mesh for a in args if isinstance(a, Sharded)), None)
    if mesh is None:
        return fn(*args)
    return _assemble(mesh, map_shards(fn, *args))


def _grid(x, fy, mb_w: int, mb_h: int):
    """A scalar QP / lambda as the (S, mb_h, mb_w) int32 grid of fy's
    streams, on fy's device."""
    return torch.full((fy.shape[0], mb_h, mb_w), int(x), dtype=torch.int32,
                      device=fy.device)


def _i_step(fy, fu, fv, qp, qpc, lam, mb_w, mb_h, use_satd, i4x4_enabled):
    return intra_frame.encode_i_frame(
        fy, fu, fv, _grid(qp, fy, mb_w, mb_h), _grid(qpc, fy, mb_w, mb_h),
        _grid(lam, fy, mb_w, mb_h), mb_w, mb_h, use_satd, i4x4_enabled)


def _p_step(fy, fu, fv, ref4, refu, refv, qp, qpc, lam, mb_w, mb_h,
            me_range, mv_range, dct_decimate, me_parallel):
    # the JAX encode_p_frame's defaults: fast P-skip, subme 1, no
    # partitions, one reference; me_parallel picks UMH (True) or the ESA
    # wavefront (False), inter_frame.py:1875
    return inter_frame.encode_p_frame(
        fy, fu, fv, ref4, refu, refv, _grid(qp, fy, mb_w, mb_h),
        _grid(qpc, fy, mb_w, mb_h), _grid(lam, fy, mb_w, mb_h), mb_w, mb_h,
        me_range, mv_range, dct_decimate, fast_pskip=True,
        me_method=P.ME_UMH if me_parallel else P.ME_ESA, subme=1,
        partitions=False, n_ref=1)


def _p_pipeline(fy, fu, fv, ref4, refu, refv, qp, qpc, lam, mb_w, mb_h,
                me_range, mv_range, dct_decimate, me_parallel):
    out = _p_step(fy, fu, fv, ref4, refu, refv, qp, qpc, lam, mb_w, mb_h,
                  me_range, mv_range, dct_decimate, me_parallel)
    zero = torch.zeros((fy.shape[0], mb_h, mb_w), dtype=torch.int32,
                       device=fy.device)
    dy, du, dv = DB.deblock_frame(
        out["recon_y"].contiguous(), out["recon_u"].contiguous(),
        out["recon_v"].contiguous(), out["bs"].contiguous(), zero,
        out["feo"].contiguous(), _grid(qp, fy, mb_w, mb_h),
        _grid(qpc, fy, mb_w, mb_h), 0, 0, mb_w, mb_h)
    return out, (MC.make_ref_planes(dy), MC.pad_chroma(du),
                 MC.pad_chroma(dv))


def encode_i_frames_batched(fy, fu, fv, qp, qpc, lam, mb_w: int, mb_h: int,
                            use_satd: bool, i4x4_enabled: bool):
    """Batched I-frame encode: fy (S, H, W), fu / fv (S, H/2, W/2), plain
    or Sharded; qp / qpc / lam scalars for every MB. Returns the syntax
    and recon dict of intra_frame.encode_i_frame, in the inputs' form."""
    return map_streams(functools.partial(
        _i_step, qp=qp, qpc=qpc, lam=lam, mb_w=mb_w, mb_h=mb_h,
        use_satd=use_satd, i4x4_enabled=i4x4_enabled), fy, fu, fv)


def encode_p_frames_batched(fy, fu, fv, ref4, refu, refv, qp, qpc, lam,
                            mb_w: int, mb_h: int, me_range: int,
                            mv_range: int, dct_decimate: bool,
                            me_parallel: bool = False):
    """Batched P-frame encode over the stream axis (inter_frame.
    encode_p_frame; the references from mc.make_ref_planes / pad_chroma).
    The wavefront steps are shared across a shard's streams."""
    return map_streams(functools.partial(
        _p_step, qp=qp, qpc=qpc, lam=lam, mb_w=mb_w, mb_h=mb_h,
        me_range=me_range, mv_range=mv_range, dct_decimate=dct_decimate,
        me_parallel=me_parallel), fy, fu, fv, ref4, refu, refv)


def encode_p_pipeline_batched(fy, fu, fv, ref4, refu, refv, qp, qpc, lam,
                              mb_w: int, mb_h: int, me_range: int,
                              mv_range: int, dct_decimate: bool,
                              me_parallel: bool = False):
    """The steady-state P step over a stream batch: encode, the in-loop
    deblock (all MBs inter, the frame's QP, offsets 0; kernel K3 on the
    card) and the half-pel reference. Returns (out, (ref4, refu, refv)),
    in the inputs' form."""
    return map_streams(functools.partial(
        _p_pipeline, qp=qp, qpc=qpc, lam=lam, mb_w=mb_w, mb_h=mb_h,
        me_range=me_range, mv_range=mv_range, dct_decimate=dct_decimate,
        me_parallel=me_parallel), fy, fu, fv, ref4, refu, refv)
