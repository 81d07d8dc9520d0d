"""Frame step, host helpers and the single-stream encoder — port of
x264dsp_tpu/encoder/core.py.

The frame step works on S streams with an explicit leading stream axis
on every tensor, in three halves: ``encode_frame`` (the I or P frame
encode), ``pack_cavlc`` (the device CAVLC slice payload,
entropy/cavlc_device.py, and the stats vector) and ``reference`` (the
decoded-QP scan, the in-loop deblock on the chosen route, the half-pel
reference planes). ``frame_step`` runs all three, as
``_fused_frame_fn(batched=True)`` (core.py:133) does; BatchEncoder calls
it and pulls the payload bytes, never the syntax. The TPU worker-fault
split of the reference pyramid (core.py:258-265) has no counterpart.

``EncoderCore`` (core.py:350) is the x264.h API's encoder: one stream
(S = 1), the scenecut slice-type decision (slicetype.SlicetypeDecider)
and the lookahead queue, one host RateControl with variance AQ
(ratecontrol.aq_offsets, per-MB QP grids through both halves of the
frame step) and VBV (the row-VBV walk, the VBV re-encode, the HRD SEIs
and the CBR filler NAL), CAVLC packed on the device or CABAC written by
the host C++ writer from one pull of the frame's syntax; up to REF_MAX
references in a DPB that skips corrupt frames (recovery path (c)) and
orders frame packing 5's views, the scaling lists, noise reduction, the
CAVLC overflow re-encode (recovery path (a)) whose frames the host C++
CAVLC writers write, and multi-slice frames (i_slice_count,
i_slice_max_mbs, i_slice_max_size): MB-row bands encoded as independent
frames, the bands of one height as the streams of one frame-step call,
deblocked as one frame and written one NAL each by the host writers.

The host helpers below are JAX-free copies of their namesakes in
x264dsp_tpu/encoder/core.py (which imports JAX), each marked with its
origin.
"""

from __future__ import annotations

import math
import time
from collections import defaultdict

import numpy as np
import torch

from .. import params as P
from ..api import NAL, Picture
from ..entropy import cavlc
from ..entropy import cavlc_device as CD
from ..entropy import native
from ..entropy.bitstream import BitWriter, nal_unit
from ..ops import deblock as DB
from ..ops import mc as MC
from ..ops.tables import CHROMA_QP_TABLE, CQM_JVT_LISTS
from . import inter_frame, intra_frame
from .ratecontrol import RateControl, aq_offsets
from .sets import (PPS, SPS, filler_rbsp, sei_buffering_period_rbsp,
                   sei_pic_timing_rbsp)
from .slicetype import SlicetypeDecider

_I32 = torch.int32

# copy of core.py:41 LAMBDA_TAB (encoder/analyse.c:98-110):
# lambda = pow(2, qp/6 - 2)
LAMBDA_TAB = np.array([
    1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1,
    2, 2, 2, 2, 3, 3, 3, 4,
    4, 4, 5, 6, 6, 7, 8, 9,
    10, 11, 13, 14, 16, 18, 20, 23,
    25, 29, 32, 36, 40, 45, 51, 57,
    64, 72, 81, 91, 102, 114, 128, 144,
    161, 181, 203, 228, 256, 287, 323, 362,
    406, 456, 512, 575, 645, 724, 813, 912,
    1024, 1149, 1290, 1448, 1625, 1825, 2048, 2299,
    2048, 2299], np.int32)

# copy of core.py:58 _DEV_PAYLOAD_BYTES_PER_MB: the per-MB payload
# budget of the JAX BatchEncoder, whose overshoot it reports as an error
DEV_PAYLOAD_BYTES_PER_MB = 512

# syntax keys the C++ CAVLC writers read (native.write_slice_p/_i); the
# device packer reads the same tensors on the device
SYN_P = ("mv", "cbp_luma", "cbp_chroma", "luma_levels", "chroma_dc_levels",
         "chroma_ac_levels", "partition", "mv8", "ref")
SYN_I = ("mb_type", "i16_mode", "i4_modes", "chroma_mode", "cbp_luma",
         "cbp_chroma", "nz_luma_dc", "luma_levels", "luma_dc_levels",
         "chroma_dc_levels", "chroma_ac_levels")
# syntax keys the C++ CABAC writer reads (native.write_slice_cabac)
SYN_CABAC_P = SYN_P + ("luma_nnz", "chroma_nnz_ac", "chroma_nz_dc")
SYN_CABAC_I = SYN_I + ("luma_nnz", "chroma_nnz_ac", "chroma_nz_dc")


def resolve_device(device) -> torch.device:
    """The device a caller asked for; CUDA without a usable GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch finds no "
                           "CUDA device")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def pad_mod16_tensor(plane, mb: int):
    """pad_mod16 of an (h, w) tensor, on its device: the edge row and
    column replicated to the MB-aligned size (core.py:776-788)."""
    h, w = plane.shape
    H, W = ((h + mb - 1) // mb) * mb, ((w + mb - 1) // mb) * mb
    if (H, W) == (h, w):
        return plane
    ri = torch.arange(H, device=plane.device).clamp(max=h - 1)
    ci = torch.arange(W, device=plane.device).clamp(max=w - 1)
    return plane[ri[:, None], ci[None, :]]


def pad_mod16(plane: np.ndarray, mb: int) -> np.ndarray:
    """Copy of core.py:296 pad_mod16 (x264_frame_expand_border_mod16,
    common/frame.c:423): replicate edge pixels to the MB-aligned size."""
    h, w = plane.shape
    H, W = ((h + mb - 1) // mb) * mb, ((w + mb - 1) // mb) * mb
    if (H, W) == (h, w):
        return plane
    return np.pad(plane, ((0, H - h), (0, W - w)), mode="edge")


def deblock_enabled(param, qp: int) -> bool:
    """Copy of core.py:547 EncoderCore._deblock_enabled: the alpha/beta
    tables are zero below qp + 2*min(a0, b0) <= 15."""
    thresh = qp + 2 * min(param.i_deblocking_filter_alphac0,
                          param.i_deblocking_filter_beta)
    return bool(param.b_deblocking_filter and thresh > 15)


def write_slice_header_common(enc, bw, slice_type, qp, idr_pic_id,
                              n_ref: int = 1, first_mb: int = 0):
    """Copy of core.py:1857-1902 EncoderCore._write_slice_header_common
    (x264_slice_header_write, encoder.c:1047-1196), duck-typed on `enc`
    (param, sps, pps, frame_num; an Encoder's _ref_reorder and
    _active_refs): a slice from MB first_mb, n_ref active references (the
    num_ref_idx override where the PPS default differs), the
    ref_pic_list_modification of the active references' frame_nums where
    a corrupt reference was skipped or the order is not the default, and
    cabac_init_idc on a CABAC P slice."""
    p = enc.param
    bw.write_ue(first_mb)               # first_mb_in_slice
    bw.write_ue(slice_type + 5)
    bw.write_ue(enc.pps.i_id)
    bw.write(enc.sps.i_log2_max_frame_num,
             enc.frame_num & ((1 << enc.sps.i_log2_max_frame_num) - 1))
    if idr_pic_id >= 0:
        bw.write_ue(idr_pic_id)
    if slice_type == P.SLICE_TYPE_P:
        # num_ref_idx_override (slice_header_write, encoder.c:1127): the
        # DPB holds fewer frames than the PPS default early on
        if n_ref != enc.pps.i_num_ref_idx_l0_default_active:
            bw.write1(1)
            bw.write_ue(n_ref - 1)
        else:
            bw.write1(0)
        # ref_pic_list_modification (slice_header_init :1013-1027 +
        # slice_header_write :1098-1111)
        if getattr(enc, "_ref_reorder", False):
            bw.write1(1)
            pred = enc.frame_num
            wrap = 1 << enc.sps.i_log2_max_frame_num
            for fn in enc._active_refs[:n_ref]:
                diff = fn - pred
                bw.write_ue(1 if diff > 0 else 0)
                bw.write_ue((abs(diff) - 1) % wrap)
                pred = fn
            bw.write_ue(3)
        else:
            bw.write1(0)
    if idr_pic_id >= 0:
        bw.write1(0)                    # no_output_of_prior_pics_flag
        bw.write1(0)                    # long_term_reference_flag
    else:
        bw.write1(0)                    # adaptive_ref_pic_marking_mode_flag
    if p.b_cabac and slice_type != P.SLICE_TYPE_I:
        bw.write_ue(p.i_cabac_init_idc)
    bw.write_se(qp - enc.pps.i_pic_init_qp)
    deblock_on = deblock_enabled(p, qp)
    bw.write_ue(0 if deblock_on else 1)
    if deblock_on:
        bw.write_se(p.i_deblocking_filter_alphac0)
        bw.write_se(p.i_deblocking_filter_beta)


def payload_cap(mb_w: int, mb_h: int) -> int:
    """The device CAVLC payload buffer in bytes (core.py:58, a multiple
    of 4)."""
    cap = DEV_PAYLOAD_BYTES_PER_MB * mb_w * mb_h + 4096
    return -(-cap // 4) * 4


def cqm_lists(p):
    """The scaling lists of the frame step (core.py:383-393): None for the
    flat CQM (the module tables), else a tuple of the 4 lists
    4IY/4PY/4IC/4PC."""
    if p.i_cqm_preset == P.CQM_JVT:
        return CQM_JVT_LISTS
    if p.i_cqm_preset == P.CQM_CUSTOM:
        return tuple(tuple(int(v) for v in lst)
                     for lst in (p.cqm_4iy, p.cqm_4py, p.cqm_4ic, p.cqm_4pc))
    return None


def frame_cfg(p, mb_w: int, mb_h: int, qp: int, cap_bytes: int,
              deblock_route=None) -> dict:
    """The static settings of the frame step (encode_frame, pack_cavlc,
    reference) for a frame at `qp` under the parameters `p`."""
    return dict(mb_w=mb_w, mb_h=mb_h, cqm=cqm_lists(p),
                me_range=p.analyse.i_me_range,
                mv_range=p.analyse.i_mv_range,
                me_method=min(max(p.analyse.i_me_method, 0), 3),
                subme=p.analyse.i_subpel_refine,
                partitions=bool(p.analyse.inter & P.ANALYSE_PSUB16x16),
                dct_decimate=bool(p.analyse.b_dct_decimate),
                fast_pskip=bool(p.analyse.b_fast_pskip),
                use_satd=p.analyse.i_subpel_refine > 0,
                i4x4=bool(p.analyse.intra & P.ANALYSE_I4x4),
                deblock_on=deblock_enabled(p, qp),
                deblock_route=deblock_route,
                cap_bytes=cap_bytes,
                alpha_off=p.i_deblocking_filter_alphac0 * 2,
                beta_off=p.i_deblocking_filter_beta * 2,
                cqpo=p.analyse.i_chroma_qp_offset)


def slot_inputs(enc, slice_type: int, qps: list, idr_pic_id: int,
                qp_mb=None, n_ref: int = 1):
    """The per-stream inputs of the frame step at the streams' QPs `qps`,
    duck-typed on `enc` (param, sps, pps, frame_num, device, mb_w, mb_h):
    each stream's slice header (BitWriter.get_unaligned) with n_ref
    active references, and a dict of
    its packer slots hv / hl (S, n), qp_mb / lam (S, mb_h, mb_w) and the
    (S,) slice_qp (batch.py:247-265). qp_mb: an optional host (S, mb_h,
    mb_w) grid of per-MB QPs (AQ, row VBV), each stream's QP flat when
    None; lam is LAMBDA_TAB per MB (core.py:944). Returns (headers,
    inputs)."""
    headers = []
    for qp in qps:
        bw = BitWriter()
        write_slice_header_common(enc, bw, slice_type, qp, idr_pic_id,
                                  n_ref)
        headers.append(bw.get_unaligned())
    elems = [CD.header_elements(*h, max_slots=32) for h in headers]
    dev = enc.device
    hv, hl = (torch.as_tensor(np.stack([e[i] for e in elems]), device=dev)
              for i in range(2))
    qps_np = np.array(qps, np.int32)
    if qp_mb is None:
        qp_mb = np.broadcast_to(qps_np[:, None, None],
                                (len(qps), enc.mb_h, enc.mb_w))
    qp_mb = np.asarray(qp_mb, np.int32)
    ql = torch.as_tensor(np.stack([qp_mb, LAMBDA_TAB[qp_mb]]), device=dev)
    return headers, dict(hv=hv, hl=hl, qp_mb=ql[0], lam=ql[1],
                         slice_qp=torch.as_tensor(qps_np, device=dev))


class StageClock:
    """Wall-clock split of a frame step into named stages. When enabled
    it synchronizes the device at each mark, so a stage's time includes
    its device work; disabled, mark() does nothing."""

    def __init__(self, device, enabled: bool):
        self.device = torch.device(device)
        self.enabled = enabled
        self.times = defaultdict(float)
        self.t = time.perf_counter()

    def start(self):
        if self.enabled:
            self._sync()
            self.t = time.perf_counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, name: str):
        if self.enabled:
            self._sync()
            now = time.perf_counter()
            self.times[name] += now - self.t
            self.t = now


def _hist(x, n: int):
    """(S, ...) ints -> (S, n) int32 counts of 0..n-1."""
    flat = x.reshape(x.shape[0], -1)
    ar = torch.arange(n, device=x.device)
    return (flat[..., None] == ar).sum(1, dtype=_I32)


def eff_qp_scan(syn, qp_mb, slice_qp, is_i: bool):
    """Decoded per-MB QP (core.py:162-176): MBs that code no residual
    inherit the running QP in raster order (torch.cummax carry-scan), and
    those before a stream's first coded MB its slice QP (slice_qp an int
    or one per stream, (S,))."""
    S = qp_mb.shape[0]
    cbp_any = (syn["cbp_luma"] | syn["cbp_chroma"]) != 0
    if is_i:
        ext = (syn["nz_luma_dc"] != 0) | (syn["chroma_nz_dc"] != 0).any(-1)
        coded = torch.where(syn["mb_type"] == 0, cbp_any | ext, cbp_any)
    else:
        coded = cbp_any
    m = coded.reshape(S, -1)
    ar = torch.arange(m.shape[1], device=m.device, dtype=torch.long)
    idx = torch.where(m, ar, -1)
    run = torch.cummax(idx, dim=1).values
    flat = qp_mb.reshape(S, -1)
    sqp = torch.as_tensor(slice_qp, dtype=flat.dtype,
                          device=flat.device).reshape(-1, 1)
    eff = torch.where(run >= 0, flat.gather(1, run.clamp(min=0)), sqp)
    return eff.reshape(qp_mb.shape).to(_I32)


def encode_frame(cfg: dict, is_p: bool, fy, fu, fv, refs, qp_mb, lam_mb,
                 clock: StageClock, n_ref: int = 1, nr_offset=None):
    """The encode half of the frame step: the I or P frame encode of S
    streams. cfg: frame_cfg's settings; fy/fu/fv (S, H, W) frames on the
    device, refs (ref4, refu, refv) for a P frame (with n_ref > 1 a
    reference axis after the stream axis), qp_mb / lam_mb (S, mb_h, mb_w)
    int32; nr_offset the P frame's (luma, chroma) noise-reduction
    offsets or None. Returns the device syntax dict (recon planes
    unfiltered)."""
    cqp = torch.as_tensor(CHROMA_QP_TABLE, device=fy.device)
    qpc_mb = cqp[(qp_mb + cfg["cqpo"]).clamp(0, 51).long()].to(_I32)
    clock.start()
    if is_p:
        ref4, refu, refv = refs
        syn = inter_frame.encode_p_frame(
            fy, fu, fv, ref4, refu, refv, qp_mb, qpc_mb, lam_mb,
            cfg["mb_w"], cfg["mb_h"], cfg["me_range"], cfg["mv_range"],
            cfg["dct_decimate"], fast_pskip=cfg["fast_pskip"],
            me_method=cfg["me_method"], subme=cfg["subme"],
            partitions=cfg["partitions"], n_ref=n_ref, cqm=cfg["cqm"],
            nr_offset=nr_offset)
    else:
        syn = intra_frame.encode_i_frame(fy, fu, fv, qp_mb, qpc_mb, lam_mb,
                                         cfg["mb_w"], cfg["mb_h"],
                                         cfg["use_satd"], cfg["i4x4"],
                                         cfg["cqm"])
    clock.mark("encode")
    return syn


def frame_stats(syn, is_p: bool, n_skip):
    """(S, n) int32 per-stream counts: P [skips, partition histogram (4),
    reference histogram (REF_MAX)], with n_skip (S,) the P_SKIP MBs; I
    [I4x4 MBs, I16x16 mode histogram (7), I4x4 mode histogram (12),
    chroma mode histogram (7), MBs with luma / chroma DC / chroma AC
    coded]."""
    S = syn["cbp_luma"].shape[0]
    if is_p:
        return torch.cat([n_skip.to(_I32)[:, None],
                          _hist(syn["partition"], 4),
                          _hist(syn["ref"], P.REF_MAX)], 1)
    is_i4 = syn["mb_type"] == 1
    return torch.cat([
        is_i4.reshape(S, -1).sum(1, dtype=_I32)[:, None],
        _hist(torch.where(is_i4, 7, syn["i16_mode"]), 7),
        _hist(torch.where(is_i4[..., None], syn["i4_modes"], 12), 12),
        _hist(syn["chroma_mode"], 7),
        torch.stack([(syn["cbp_luma"] != 0).reshape(S, -1).sum(1),
                     (syn["cbp_chroma"] >= 1).reshape(S, -1).sum(1),
                     (syn["cbp_chroma"] == 2).reshape(S, -1).sum(1)],
                    1).to(_I32)], 1)


def pack_cavlc(cfg: dict, is_p: bool, syn, qp_mb, slice_qp, hv, hl,
               n_ref: int = 1):
    """The device CAVLC slice payloads of S streams (slice_qp (S,), hv /
    hl (S, n) the slice headers as packer slots, n_ref active
    references). Returns a dict: payload (S, cap_bytes) uint8, bits, ov,
    n_skip (S,), rows (S, mb_h) and the frame_stats vector."""
    mb_w, mb_h = cfg["mb_w"], cfg["mb_h"]
    if is_p:
        payload, bits, n_skip, ov, rows = CD.cavlc_p_payload(
            {k: syn[k] for k in SYN_P if k != "mv"}, qp_mb, slice_qp, n_ref,
            mb_h, mb_w, hv, hl, cfg["cap_bytes"], with_rows=True)
    else:
        payload, bits, ov, rows = CD.cavlc_i_payload(
            {k: syn[k] for k in SYN_I}, qp_mb, slice_qp, mb_h, mb_w, hv, hl,
            cfg["cap_bytes"], with_rows=True)
        n_skip = torch.zeros(bits.shape[0], dtype=_I32, device=bits.device)
    return dict(payload=payload, bits=bits, ov=ov, n_skip=n_skip, rows=rows,
                stats=frame_stats(syn, is_p, n_skip))


def reference(cfg: dict, is_p: bool, syn, qp_mb, slice_qp,
              clock: StageClock):
    """The reference half of the frame step (core.py:665-712
    _compute_reference): the in-loop deblock at the decoded per-MB QP on
    the chosen route when cfg's deblock_on (the slice headers say so),
    else the unfiltered recon, then the half-pel reference planes.
    Returns (planes (ref4, refu, refv), recon: the deblocked planes as
    uint8)."""
    mb_w, mb_h = cfg["mb_w"], cfg["mb_h"]
    dy, du, dv = syn["recon_y"], syn["recon_u"], syn["recon_v"]
    if cfg["deblock_on"]:
        dev = dy.device
        S = dy.shape[0]
        if is_p:
            bs, feo = syn["bs"], syn["feo"]
            intra_mb = torch.zeros((S, mb_h, mb_w), dtype=_I32, device=dev)
        else:
            bs = torch.full((S, mb_h, mb_w, 2, 4, 4), 3, dtype=_I32,
                            device=dev)
            feo = torch.zeros((S, mb_h, mb_w), dtype=_I32, device=dev)
            intra_mb = torch.ones((S, mb_h, mb_w), dtype=_I32, device=dev)
        cqp = torch.as_tensor(CHROMA_QP_TABLE, device=dev)
        eff = eff_qp_scan(syn, qp_mb, slice_qp, not is_p)
        eff_c = cqp[(eff + cfg["cqpo"]).clamp(0, 51).long()].to(_I32)
        dy, du, dv = DB.deblock_frame(
            dy.contiguous(), du.contiguous(), dv.contiguous(),
            bs.contiguous(), intra_mb, feo.contiguous(), eff, eff_c,
            cfg["alpha_off"], cfg["beta_off"], mb_w, mb_h,
            route=cfg.get("deblock_route"))
    clock.mark("deblock")
    planes = (MC.make_ref_planes(dy).contiguous(),
              MC.pad_chroma(du).contiguous(), MC.pad_chroma(dv).contiguous())
    clock.mark("ref_planes")
    return planes, (dy.to(torch.uint8), du.to(torch.uint8),
                    dv.to(torch.uint8))


def frame_step(cfg: dict, is_p: bool, fy, fu, fv, refs, qp_mb, lam_mb,
               slice_qp, hv, hl, clock: StageClock):
    """One batched frame slot: encode_frame, pack_cavlc and reference in
    turn (the per_stream_qp variant of core.py:133 _fused_frame_fn).
    Returns pack_cavlc's dict with planes (the next reference planes),
    recon (the deblocked uint8 planes) and syn (the device syntax)."""
    syn = encode_frame(cfg, is_p, fy, fu, fv, refs, qp_mb, lam_mb, clock)
    out = pack_cavlc(cfg, is_p, syn, qp_mb, slice_qp, hv, hl)
    clock.mark("cavlc")
    planes, recon = reference(cfg, is_p, syn, qp_mb, slice_qp, clock)
    return dict(out, planes=planes, recon=recon, syn=syn)


def pull_payload(out, cap: int, overflow_msg: str | None):
    """pack_cavlc's payloads on the host: one small pull of the streams'
    bit counts, overflow flags, summed stats vector and end-of-row bit
    positions, the overflow check against the cap
    (RuntimeError(overflow_msg); with overflow_msg None an overflowed
    payload returns None), then a power-of-two bucket of payload bytes.
    Returns (nbytes (S,), vec, raw (S, bucket) uint8, rows (S, mb_h)
    int64)."""
    S = out["bits"].shape[0]
    n_vec = out["stats"].shape[1]
    meta = torch.cat([out["bits"].long(), out["ov"].long(),
                      out["stats"].sum(0).long(),
                      out["rows"].reshape(-1).long()]).cpu().numpy()
    bits, ov = meta[:S], meta[S:2 * S]
    vec = meta[2 * S:2 * S + n_vec]
    if ov.any() or (bits > cap * 8).any():
        if overflow_msg is None:
            return None
        raise RuntimeError(overflow_msg)
    nbytes = (bits + 7) >> 3
    bucket = min(1 << max(12, int(nbytes.max() - 1).bit_length()), cap)
    return (nbytes, vec, out["payload"][:, :bucket].cpu().numpy(),
            meta[2 * S + n_vec:].reshape(S, -1))


def pull_syntax(syn, keys, S: int):
    """Device syntax -> per-stream host dicts of int16 arrays, in ONE
    device-to-host copy (the C++ writers read int16): the Encoder's CABAC
    frames, and the checks that hold the device packer to the C++
    writers."""
    parts = [syn[k].to(torch.int16).reshape(S, -1) for k in keys]
    flat = torch.cat(parts, 1).cpu().numpy()
    out = [{} for _ in range(S)]
    off = 0
    for k, part in zip(keys, parts):
        n = part.shape[1]
        shape = tuple(syn[k].shape[1:])
        for s in range(S):
            out[s][k] = flat[s, off:off + n].reshape(shape)
        off += n
    return out


def _max_level(syn) -> np.ndarray:
    """Per-MB largest |level| over the luma, chroma DC / AC and (I16)
    luma DC levels of a host syntax dict (core.py:1131-1141)."""
    m = np.abs(syn["luma_levels"]).max(axis=(-1, -2))
    m = np.maximum(m, np.abs(syn["chroma_dc_levels"]).max(axis=(-1, -2)))
    m = np.maximum(m, np.abs(syn["chroma_ac_levels"]).max(axis=(-1, -2, -3)))
    if "luma_dc_levels" in syn:
        m = np.maximum(m, np.abs(syn["luma_dc_levels"]).max(axis=-1))
    return m.astype(np.int64)


class Stats:
    """Copy of core.py:306 Stats (the h->stat twin)."""

    def __init__(self):
        self.i_frame_count = {P.SLICE_TYPE_I: 0, P.SLICE_TYPE_P: 0}
        self.i_frame_size = {P.SLICE_TYPE_I: 0, P.SLICE_TYPE_P: 0}
        self.f_frame_qp = {P.SLICE_TYPE_I: 0.0, P.SLICE_TYPE_P: 0.0}
        self.i_mb_count = {}       # mb type histogram
        self.ssd = np.zeros(3, np.int64)
        self.pixels = np.zeros(3, np.int64)
        # per-type PSNR accumulators (h->stat.f_psnr_mean_*, encoder.c
        # :2198-2209) and ref/pred-mode histograms (:2262-2367)
        self.ssd_type = {P.SLICE_TYPE_I: np.zeros(3, np.int64),
                         P.SLICE_TYPE_P: np.zeros(3, np.int64)}
        self.pixels_type = {P.SLICE_TYPE_I: np.zeros(3, np.int64),
                            P.SLICE_TYPE_P: np.zeros(3, np.int64)}
        self.i_mb_count_ref = np.zeros(P.REF_MAX, np.int64)
        self.i16_modes = np.zeros(7, np.int64)
        self.i4_modes = np.zeros(12, np.int64)
        self.chroma_modes = np.zeros(7, np.int64)
        self.cbp_coded = np.zeros(3, np.int64)  # y, uvDC, uvAC (intra)
        self.cbp_mbs = 0
        self.f_ssim = 0.0
        self.i_ssim_cnt = 0

    def summary(self) -> dict:
        out = {"frames": dict(self.i_frame_count),
               "bytes": dict(self.i_frame_size),
               "mb_types": dict(self.i_mb_count)}
        with np.errstate(divide="ignore"):
            psnr = [float(10 * np.log10(255.0 ** 2 * p / s)) if s else float("inf")
                    for s, p in zip(self.ssd, self.pixels)]
        if self.pixels[0]:
            out["psnr_yuv"] = psnr
        if self.i_mb_count_ref.sum():
            out["ref_histogram"] = self.i_mb_count_ref.tolist()
        out["psnr_yuv_by_type"] = {
            t: [float(10 * np.log10(255.0 ** 2 * px / s)) if s else
                float("inf")
                for s, px in zip(self.ssd_type[t], self.pixels_type[t])]
            for t in self.ssd_type if self.pixels_type[t][0]}
        if self.i_ssim_cnt:
            out["ssim_y"] = self.f_ssim / self.i_ssim_cnt
        return out


def _host(a) -> np.ndarray:
    """A picture plane (tensor or array) as a host uint8 array."""
    if torch.is_tensor(a):
        return a.cpu().numpy()
    return np.asarray(a, np.uint8)


class EncoderCore:
    """x264_t twin (core.py:350): one stream encoded frame by frame on
    `device` (the GPU unless the caller asks for "cpu"). profile=True
    synchronizes the device at each stage and records frame_times."""

    def __init__(self, param: P.Param, device="cuda", profile: bool = False):
        self.param = p = P.validate_parameters(param)
        self.sps = SPS.init(p, p.i_sps_id)
        self.pps = PPS.init(p, self.sps, p.i_sps_id)
        self.mb_w = self.sps.i_mb_width
        self.mb_h = self.sps.i_mb_height
        self.rc = RateControl(p, self.mb_w * self.mb_h)
        self.device = resolve_device(device)
        self.slicetype = SlicetypeDecider(p)
        # lookahead queue (core.py:363-371, lookahead.c:59-115): under VBV
        # a frame waits i_lookahead inputs, so that rate control plans
        # over the queued frames' types and costs
        self.la_next: list[dict] = []
        self.frames_input = 0
        self.frames_delay = (p.rc.i_lookahead
                             if p.rc.i_vbv_buffer_size > 0 else 0)
        self.aq = p.rc.i_aq_mode != P.AQ_NONE and p.rc.f_aq_strength > 0
        self.i_frame = 0          # input frame counter
        self.frame_num = 0        # frame_num syntax element
        self.idr_pic_id = 0
        self._cpb_delay = 0       # pic-timing SEI ticks since IDR
        profile_name = "Main" if p.b_cabac else "Constrained Baseline"
        P.x264_log(p, P.LOG_INFO,
                   f"profile {profile_name}, level "
                   f"{p.i_level_idc // 10}.{p.i_level_idc % 10}")
        P.x264_log(p, P.LOG_DEBUG, "options: " + P.param2string(p, True))
        self.stats = Stats()
        self.last_recon = None    # (y, u, v) host uint8, deblocked, padded
        # the newest frame's per-MB QPs (host int32 (mb_h, mb_w)) and its
        # per-row bits under VBV, as the JAX core keeps them
        self._last_qp_mb = None
        self._row_bits = None
        # the newest frame's device encodes (1 + overflow re-encodes +
        # row-VBV passes + VBV re-encodes), per-MB QP range, filler bytes,
        # buffering-period SEI (delay, offset) or None, active references
        # and whether its header reorders them
        self.last_frame = None
        # DPB, nearest first (x264_reference_build, encoder.c:813): dicts
        # {planes: (ref4, refu, refv), frame_idx, frame_num, corrupt}
        # (core.py:403-410); corrupt entries are skipped when the active
        # list is built, and an IDR is forced when none is left
        self.dpb: list = []
        # noise reduction (core.py:417-428): per-position |level| sums
        # [luma, chroma], sample counts and the offsets the next P frame
        # subtracts, updated after each P frame's final encode
        self.nr = None
        if p.analyse.i_noise_reduction:
            self.nr = {"sum": np.zeros((2, 16), np.int64),
                       "count": np.zeros(2, np.int64),
                       "offset": np.zeros((2, 16), np.int32)}
        self._cap = payload_cap(self.mb_w, self.mb_h)
        self.clock = StageClock(self.device, profile)
        # keep_syntax (CAVLC): hold the newest frame's device syntax,
        # packer outputs, slice header and QP in last_slot, as the
        # BatchEncoder does (tools/mainpath.payload_vs_writers reads it)
        self.keep_syntax = False
        self.last_slot = None
        # profile: per-frame (slice type, {stage: seconds}) for the stages
        # slicetype (pad, upload, the decision of the frame put in the
        # same call), aq (the QP grid), encode, then CABAC: syntax_pull,
        # cabac (the C++ writer); or CAVLC: cavlc (device packer), pull
        # (payload); deblock, ref_planes; and vbv (the row-VBV walk and
        # the re-encode decisions). A frame encoded more than once sums
        # its encodes' stages
        self.frame_times = []

    # ------------------------------------------------------------------
    def headers(self) -> list[NAL]:
        nals = []
        for cls, t in ((self.sps, P.NAL_SPS), (self.pps, P.NAL_PPS)):
            bw = BitWriter()
            cls.write(bw)
            nals.append(NAL(t, P.NAL_PRIORITY_HIGHEST,
                            nal_unit(t, P.NAL_PRIORITY_HIGHEST,
                                     bw.get_bytes())))
        nals.append(self._sei_version())
        return nals

    def _sei_version(self) -> NAL:
        """Copy of core.py:492 _sei_version: the JAX package's version
        text, byte for byte, so that both encoders' headers agree."""
        bw = BitWriter()
        opts = P.param2string(self.param)
        payload = bytes(16) + (
            "x264dsp_tpu 0.1 - TPU-native H.264 encoder - options: "
            + opts).encode() + b"\x00"
        # sei payload type 5 = user_data_unregistered (set.c:52-70)
        t, size = 5, len(payload)
        bw.write(8, t)
        n = size
        while n >= 255:
            bw.write(8, 255)
            n -= 255
        bw.write(8, n)
        for b in payload:
            bw.write(8, b)
        bw.rbsp_trailing()
        return NAL(P.NAL_SEI, P.NAL_PRIORITY_DISPOSABLE,
                   nal_unit(P.NAL_SEI, P.NAL_PRIORITY_DISPOSABLE,
                            bw.get_bytes()))

    @staticmethod
    def _sei(rbsp: bytes) -> NAL:
        return NAL(P.NAL_SEI, P.NAL_PRIORITY_DISPOSABLE,
                   nal_unit(P.NAL_SEI, P.NAL_PRIORITY_DISPOSABLE, rbsp))

    # ------------------------------------------------------------------
    def encode(self, pic: Picture | None):
        """x264_encoder_encode (core.py:767): the slice-type decision at
        put time into the lookahead queue, then the oldest queued frame's
        encode. Under VBV with i_lookahead > 0 the queue holds that many
        frames, so the first calls return ([], None) (encoder.c:1775-1781)
        and encode(None) returns one queued frame per call until the queue
        is empty, then ([], None). A torch picture is padded on its device
        and stays there while it waits; anything else through pad_mod16."""
        self.clock.start()
        if pic is not None:
            planes = []
            for a, mb in ((pic.y, 16), (pic.u, 8), (pic.v, 8)):
                if torch.is_tensor(a):
                    t = pad_mod16_tensor(a.to(self.device, torch.uint8), mb)
                else:
                    t = torch.from_numpy(np.ascontiguousarray(
                        pad_mod16(np.asarray(a, np.uint8), mb))).to(
                            self.device)
                planes.append(t)
            slice_type, is_keyframe, frame_cost = self.slicetype.decide(
                planes[0])
            # put-time snapshots: the decider has moved past this frame by
            # the time it is popped
            self.la_next.append(dict(
                pic=pic, planes=planes, slice_type=slice_type,
                is_keyframe=is_keyframe, frame_cost=frame_cost,
                row_costs=self.slicetype.row_costs,
                st_idx=self.slicetype.frame_idx - 1))
            self.clock.mark("slicetype")
            self.frames_input += 1
            if self.frames_input <= self.frames_delay:
                return [], None
        if not self.la_next:
            return [], None
        rec = self.la_next.pop(0)
        planned = [(r["slice_type"], r["frame_cost"]) for r in self.la_next]
        return self._encode_frame(rec, planned)

    def _qp_grid(self, planes, qp: int) -> np.ndarray:
        """The frame's per-MB QPs (host int32 (mb_h, mb_w)): variance AQ
        on the padded planes on their device, floor(qp + offset + 0.5) in
        float32 and clipped as core.py:864-872 does; else qp flat."""
        p = self.param
        if not self.aq:
            return np.full((self.mb_h, self.mb_w), qp, np.int32)
        off = aq_offsets(*planes, p.rc.f_aq_strength, self.mb_w, self.mb_h)
        return torch.floor(qp + off + 0.5).clamp(
            p.rc.i_qp_min, min(p.rc.i_qp_max, P.QP_MAX_SPEC)).to(
                _I32).cpu().numpy()

    def _slice_ranges(self) -> list:
        """Copy of core.py:533-545 EncoderCore._slice_ranges: the frame's
        slices as MB-row bands [(y0, y1)], i_slice_count of them, or more
        where i_slice_max_mbs asks for it, at bounds round(i * mb_h / n)
        (Python's round: halves to even)."""
        p = self.param
        n = max(1, p.i_slice_count)
        if p.i_slice_max_mbs:
            rows = max(1, p.i_slice_max_mbs // self.mb_w)
            n = max(n, -(-self.mb_h // rows))
        n = min(n, self.mb_h)
        bounds = [round(i * self.mb_h / n) for i in range(n + 1)]
        return [(bounds[i], bounds[i + 1]) for i in range(n)
                if bounds[i + 1] > bounds[i]]

    def _band_syn(self, syn, qp_mb, band):
        """Copy of core.py:521-531 EncoderCore._band_syn: a host syntax
        dict and QP grid cut to the MB rows of band (y0, y1), or the whole
        frame when band is None. Returns (syntax, qp_mb, mb_h, first_mb)."""
        if band is None:
            return syn, qp_mb, self.mb_h, 0
        y0, y1 = band
        out = {k: v[y0:y1] for k, v in syn.items()
               if hasattr(v, "shape") and len(v.shape) >= 2
               and v.shape[0] == self.mb_h and v.shape[1] == self.mb_w}
        qpb = None if qp_mb is None else qp_mb[y0:y1]
        return out, qpb, y1 - y0, y0 * self.mb_w

    def _encode_bands(self, slices, is_p, qp, planes, ref_planes, x, n_ref,
                      nr_offset):
        """The device encode of a frame of several slices (core.py
        :937-1010, 1062-1098): each MB-row band is an independent frame of
        its rows, so the frame step's row-0 unavailability is the
        slice-boundary rule; the bands of one height run as the streams of
        one encode_frame call. A P band reads its rows of the active
        references' padded planes (ref_planes, each (ref4, refu, refv) with
        a stream axis of 1, nearest first) with the real rows of its
        neighbours, not an edge copy (:960-966). The bands' syntax and
        recon are concatenated on the row axis and their noise-reduction
        sums added; a P frame's deblock strengths are computed again on the
        whole frame (deblocking crosses slice edges at idc 0,
        common/deblock.c:341), an I frame's are the constant of
        reference(). Returns the frame's device syntax dict (S = 1)."""
        pad = MC.PAD_MC
        fy, fu, fv = planes
        by_height = defaultdict(list)
        for i, (y0, y1) in enumerate(slices):
            by_height[y1 - y0].append(i)

        def crop(r, y0, y1):
            return (r[0][:, :, y0 * 16:y1 * 16 + 2 * pad],
                    r[1][:, y0 * 8:y1 * 8 + pad], r[2][:, y0 * 8:y1 * 8 + pad])

        groups, where = [], [None] * len(slices)
        for hb, idx in by_height.items():
            rows = [slices[i] for i in idx]

            def cat(f):
                return torch.cat([f(y0, y1) for y0, y1 in rows])
            refs = None
            if is_p and n_ref == 1:
                refs = tuple(cat(lambda y0, y1: crop(ref_planes[0], y0, y1)[i])
                             for i in range(3))
            elif is_p:
                # (bands, n_ref, ...): the references after the stream axis
                refs = tuple(torch.stack([
                    torch.cat([crop(r, y0, y1)[i] for r in ref_planes])
                    for y0, y1 in rows]) for i in range(3))
            cfg = frame_cfg(self.param, self.mb_w, hb, qp, self._cap)
            syn = encode_frame(
                cfg, is_p, cat(lambda y0, y1: fy[None, y0 * 16:y1 * 16]),
                cat(lambda y0, y1: fu[None, y0 * 8:y1 * 8]),
                cat(lambda y0, y1: fv[None, y0 * 8:y1 * 8]), refs,
                cat(lambda y0, y1: x["qp_mb"][:, y0:y1]),
                cat(lambda y0, y1: x["lam"][:, y0:y1]), self.clock, n_ref,
                nr_offset)
            for j, i in enumerate(idx):
                where[i] = (syn, j)
            groups.append(syn)
        out = {}
        for k in groups[0]:
            if k.startswith("nr_"):
                out[k] = sum(g[k].sum(0, keepdim=True) for g in groups)
            else:
                out[k] = torch.cat([g[k][j:j + 1] for g, j in where], 1)
        if is_p:
            out["bs"], out["feo"] = inter_frame.compute_strengths_p(
                inter_frame.blocks4_grid(out["luma_nnz"], self.mb_h,
                                         self.mb_w),
                out["cbp_luma"], out["cbp_chroma"], out["mv8"], self.mb_w,
                self.mb_h, out["ref"])
        return out

    def _valid_refs(self, st_idx: int) -> list:
        """The reference list of frame st_idx (core.py:821-833): the DPB
        less its corrupt entries (x264_reference_build, encoder.c:825-826),
        sorted by view pair under frame packing 5."""
        valid = [e for e in self.dpb if not e["corrupt"]]
        if self.param.i_frame_packing == 5 and len(valid) > 1:
            # 3D one-view-per-frame: L0 orders by the view-pair distance
            # (x264_reference_distance, encoder.c:804-810; sort at
            # :833-853) so that the same-view frame of each pair ranks
            # first; a stable sort over the nearest-first list
            valid.sort(key=lambda e: abs((st_idx & ~1) - (e["frame_idx"] & ~1))
                       + ((st_idx & 1) != (e["frame_idx"] & 1)))
        return valid

    def _encode_frame(self, rec: dict, planned: list):
        """core.py:816-1373 in the JAX CPU path's order (its
        multi-dispatch flow, core.py:1100-1320): the active reference list
        and the forced IDR when none is valid, the SEIs, the first encode
        (of each slice band, _encode_bands), the CAVLC overflow re-encode
        (recovery path (a), core.py:1102-1147), the first write, up to 3
        row-VBV passes (one slice only), up to 16 i_slice_max_size passes
        that split the bands over budget, up to 8 VBV re-encodes while the
        frame's slices exceed rc.frame_size_limit(), the row predictors'
        update from the final encode where its row bits cover the frame,
        the noise-reduction update, rc.end over every NAL and the CBR
        filler NAL."""
        p = self.param
        clock = self.clock
        pic, planes, st_idx = rec["pic"], rec["planes"], rec["st_idx"]
        slice_type, is_keyframe = rec["slice_type"], rec["is_keyframe"]
        valid_dpb = self._valid_refs(st_idx)
        is_idr = is_keyframe
        if not is_keyframe and (pic.i_type == P.TYPE_IDR or pic.b_keyframe
                                or not valid_dpb):
            # user-forced IDR, or no valid reference left (encoder.c
            # :1808-1820)
            slice_type, is_keyframe, is_idr = P.SLICE_TYPE_I, True, True
            self.slicetype.last_keyframe = st_idx
        elif not is_keyframe and pic.i_type == P.TYPE_I:
            # user-forced I: an IDR once keyint_min has elapsed
            # (slicetype.c:521-529); inside keyint_min a non-IDR I slice
            # that continues frame_num and the DPB
            if st_idx - self.slicetype.last_keyframe >= max(p.i_keyint_min,
                                                             1):
                slice_type, is_keyframe, is_idr = (P.SLICE_TYPE_I, True,
                                                   True)
                self.slicetype.last_keyframe = st_idx
            else:
                slice_type = P.SLICE_TYPE_I
        qp = self.rc.start(slice_type, rec["frame_cost"], planned=planned)
        if pic.i_qpplus1:
            qp = pic.i_qpplus1 - 1  # i_force_qp (ratecontrol.c:579-580)
        qp = min(int(np.clip(qp, p.rc.i_qp_min, p.rc.i_qp_max)),
                 P.QP_MAX_SPEC)
        qp_mb = self._qp_grid(planes, qp)
        clock.mark("aq")
        is_p = slice_type == P.SLICE_TYPE_P
        n_ref = min(len(valid_dpb), p.i_frame_reference) if is_p else 1
        # when a corrupt entry was skipped, the encoder's list diverges
        # from the decoder's default order: an explicit
        # ref_pic_list_modification (x264_reference_check_reorder,
        # encoder.c:777-799; core.py:880-890)
        active = valid_dpb[:n_ref]
        self._ref_reorder = is_p and (
            any(e["corrupt"] for e in self.dpb)
            or any(active[i + 1]["frame_idx"] > active[i]["frame_idx"]
                   for i in range(len(active) - 1)))
        self._active_refs = [e["frame_num"] for e in active]
        # IDR resets frame_num before the slice header is written
        if is_idr:
            self.frame_num = 0
        idr_id = self.idr_pic_id if is_idr else -1
        cfg = frame_cfg(p, self.mb_w, self.mb_h, qp, self._cap)
        slices = self._slice_ranges()
        # the device packer writes a CAVLC frame of one slice and no size
        # budget; the other frames are written by the host C++ writers, one
        # slice per band (core.py:929, :1178-1205)
        dev_pack = (not p.b_cabac and len(slices) == 1
                    and not p.i_slice_max_size)
        refs = None
        if is_p and n_ref == 1:
            refs = active[0]["planes"]
        elif is_p:
            # the active references on an axis after the stream axis
            refs = tuple(torch.stack([e["planes"][i][0] for e in active])[None]
                         for i in range(3))
        nr_offset = None
        if self.nr is not None and is_p:
            nr_offset = tuple(torch.as_tensor(o, device=self.device)
                              for o in self.nr["offset"])
        n_skip = 0      # P_SKIP MBs counted by every write of the frame

        def encode_once(qp_mb):
            """One device encode of the frame, cut into the current slice
            bands, at the grid qp_mb; a CAVLC frame of the device packer
            also packs its payload (dev: (payload, stats vector, row bits),
            or None when the packer's overflow flag is set or the bits pass
            the cap, and for the host writers' frames)."""
            headers, x = slot_inputs(self, slice_type, [qp], idr_id,
                                     qp_mb[None], n_ref)
            if len(slices) == 1:
                syn = encode_frame(cfg, is_p, *(a[None] for a in planes),
                                   refs, x["qp_mb"], x["lam"], clock, n_ref,
                                   nr_offset)
            else:
                syn = self._encode_bands(slices, is_p, qp, planes,
                                         [e["planes"] for e in active], x,
                                         n_ref, nr_offset)
            res = dict(syn=syn, x=x, headers=headers, slices=list(slices))
            if not p.b_cabac:
                res["dev"] = (self._pack_cavlc(cfg, slice_type, qp, syn, x,
                                               headers, n_ref)
                              if dev_pack else None)
            return res

        def write(res, qp_mb):
            """The slice payloads of an encode, one per band, its MB-type
            counts added as the JAX host writers add them at every write;
            the bits of each MB row only for a frame of one slice (the
            band writers keep none, core.py:1712, :1920). A CABAC frame
            launches its reference half before the host writer runs, so
            the card filters while the host writes (a re-encode drops it
            and launches its own); a CAVLC frame's comes from the final
            encode, its payload from the device packer or from the host
            C++ CAVLC writers (core.py:1180-1203)."""
            nonlocal n_skip
            syn, x = res["syn"], res["x"]
            bands = [None] if len(res["slices"]) == 1 else res["slices"]
            if p.b_cabac:
                host = pull_syntax(syn, SYN_CABAC_P if is_p else SYN_CABAC_I,
                                   1)[0]
                clock.mark("syntax_pull")
                res["stats"] = frame_stats(syn, is_p, torch.zeros(
                    1, dtype=_I32, device=self.device))
                res["ref"] = reference(cfg, is_p, syn, x["qp_mb"],
                                       x["slice_qp"], clock)
                out = [self._write_slice_cabac(host, slice_type, qp, idr_id,
                                               qp_mb, n_ref, band)
                       for band in bands]
                res["payloads"] = [o[0] for o in out]
                res["row_bits"] = out[0][2]
                clock.mark("cabac")
                n_skip += self._count_mb_types(
                    slice_type, counts=np.sum([o[1] for o in out], 0))
            elif res["dev"] is not None:
                payload, res["vec"], res["row_bits"] = res["dev"]
                res["payloads"] = [payload]
                n_skip += self._count_mb_types(slice_type, vec=res["vec"])
            else:
                res["payloads"], res["vec"], res["row_bits"] = \
                    self._write_slice_cavlc_host(res, slice_type, qp, idr_id,
                                                 qp_mb, n_ref, bands)
                n_skip += self._count_mb_types(slice_type, vec=res["vec"])

        nals, bp = [], None
        if p.b_repeat_headers and self.i_frame == 0:
            # in-band SPS/PPS on the first frame only (encoder.c:1916-1944)
            nals.extend(self.headers()[:2])
        if self.sps.vui_nal_hrd_present and is_idr:
            # buffering-period SEI on every IDR (set.c:577-597), from the
            # CPB fill before this frame
            bp = self.rc.hrd_fullness(self.sps)
            nals.append(self._sei(sei_buffering_period_rbsp(self.sps, *bp)))
            if not p.b_intra_refresh:
                self._cpb_delay = 0
        if self.sps.vui_nal_hrd_present or self.sps.vui_pic_struct_present:
            # pic-timing SEI per frame (set.c:599-630)
            nals.append(self._sei(sei_pic_timing_rbsp(self.sps,
                                                      self._cpb_delay, 0)))
            self._cpb_delay += 2

        res = encode_once(qp_mb)
        n_ov = 0
        if not p.b_cabac:
            # recovery path (a): the packer flagged a CAVLC level-code
            # overflow (cavlc.c:56-60) or a payload past the cap; the host
            # detector flags the MBs, which go up by the analytic estimate
            # ceil(6 log2(maxlev / 1024)) (levels scale ~2^(-dqp/6)), up to
            # 8 times, then to QP_MAX_SPEC (core.py:1102-1147)
            for it in range(9):
                if res["dev"] is not None:
                    break
                res["host"] = pull_syntax(res["syn"],
                                          SYN_P if is_p else SYN_I, 1)[0]
                flagged = self._detect_cavlc_overflow(res["host"],
                                                      slice_type)
                if not flagged.any():
                    break
                if it == 8:
                    bump = np.where(flagged, P.QP_MAX_SPEC, 0)
                else:
                    est = np.ceil(6.0 * np.log2(np.maximum(
                        _max_level(res["host"]), 1) / 1024.0)).astype(
                            np.int64)
                    bump = np.where(flagged, np.maximum(est, 1), 0)
                qp_mb = np.minimum(qp_mb + bump, P.QP_MAX_SPEC).astype(
                    np.int32)
                res = encode_once(qp_mb)
                n_ov += 1
        write(res, qp_mb)
        n_row, n_split, n_frame = 0, 0, 0
        row_satd = rec["row_costs"]
        if self.rc.b_vbv and len(slices) == 1:
            qp_hi = min(p.rc.i_qp_max, P.QP_MAX_SPEC)
            # per-row VBV (x264_ratecontrol_mb, ratecontrol.c:599-780): the
            # end-of-row QP-step walk over the measured row bits, a
            # re-encode with the new ramp, to a fixed point (core.py
            # :1217-1234); a frame of one slice only
            ramp = np.full(self.mb_h, qp, np.int32)
            for _ in range(3):
                new_ramp = self.rc.row_vbv_adjust(slice_type, ramp,
                                                  res["row_bits"], row_satd)
                clock.mark("vbv")
                if new_ramp is None:
                    break
                qp_mb = np.clip(qp_mb + (new_ramp - ramp)[:, None],
                                p.rc.i_qp_min, qp_hi).astype(np.int32)
                ramp = new_ramp
                res = encode_once(qp_mb)
                write(res, qp_mb)
                n_row += 1
        nal_type = P.NAL_SLICE_IDR if is_idr else P.NAL_SLICE
        if p.i_slice_max_size > 0:
            # i_slice_max_size (x264.h:660): a band whose NAL (start code,
            # header and escapes included) passes the budget is split in
            # proportion, rows at a time, and the frame encoded and written
            # again; a single row over budget stays as it is (core.py
            # :1236-1264)
            limit = p.i_slice_max_size
            for _ in range(16):
                new, split = [], False
                for (y0, y1), pl in zip(slices, res["payloads"]):
                    rows = y1 - y0
                    size = len(nal_unit(nal_type, P.NAL_PRIORITY_HIGHEST, pl))
                    if size <= limit or rows == 1:
                        new.append((y0, y1))
                        continue
                    parts = min(rows, -(-size // limit) + 1)
                    bounds = [y0 + (rows * i) // parts
                              for i in range(parts)] + [y1]
                    new.extend((a, b) for a, b in zip(bounds, bounds[1:])
                               if a < b)
                    split = True
                if not split:
                    break
                slices[:] = new
                res = encode_once(qp_mb)
                write(res, qp_mb)
                n_split += 1
        if self.rc.b_vbv:
            # recovery path (b): a frame past the MinCR / VBV ceiling is
            # encoded again at a QP raised by the overshoot, measured on
            # all its slices (core.py:1270-1286)
            for _ in range(8):
                bits = sum(len(pl) for pl in res["payloads"]) * 8
                limit = self.rc.frame_size_limit()
                clock.mark("vbv")
                if bits <= limit or qp_mb.min() >= P.QP_MAX_SPEC:
                    break
                step = max(1, int(round(6 * math.log2(bits / limit))))
                qp_mb = np.minimum(qp_mb + step, P.QP_MAX_SPEC)
                res = encode_once(qp_mb)
                write(res, qp_mb)
                n_frame += 1
            # the row predictors learn from the final encode (:675-681)
            # where its row bits cover the frame (one slice)
            if res["row_bits"] is not None:
                self.rc.row_vbv_commit(slice_type, qp_mb.mean(axis=1),
                                       res["row_bits"], row_satd)
            self._row_bits = res["row_bits"]
            clock.mark("vbv")
        self._last_qp_mb = qp_mb
        ref_planes, recon = res.get("ref") or reference(
            cfg, is_p, res["syn"], res["x"]["qp_mb"], res["x"]["slice_qp"],
            clock)
        vec = res["vec"] if "vec" in res else res["stats"][0].cpu().numpy()

        for pl in res["payloads"]:
            nals.append(NAL(nal_type, P.NAL_PRIORITY_HIGHEST,
                            nal_unit(nal_type, P.NAL_PRIORITY_HIGHEST, pl)))

        if is_idr:
            self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        self.frame_num = (self.frame_num + 1) % (
            1 << self.sps.i_log2_max_frame_num)
        self.i_frame += 1
        self.last_recon = self._update_reference(ref_planes, recon, is_idr)
        if nr_offset is not None:
            self._nr_update(res["syn"])
        filler = self._add_stats(pic, slice_type, qp_mb, nals, vec, n_skip)
        self.last_frame = dict(encodes=1 + n_ov + n_row + n_split + n_frame,
                               overflow=n_ov, row_vbv=n_row,
                               slices=list(res["slices"]),
                               max_size_passes=n_split,
                               reencodes=n_frame, qp_min=int(qp_mb.min()),
                               qp_max=int(qp_mb.max()), filler=filler,
                               bp=bp, n_ref=n_ref,
                               reorder=bool(self._ref_reorder))
        if clock.enabled:
            self.frame_times.append((slice_type, dict(clock.times)))
            clock.times.clear()

        ftype = (P.TYPE_IDR if is_idr
                 else P.TYPE_I if slice_type == P.SLICE_TYPE_I
                 else P.TYPE_P)
        # the recon cropped to the visible frame (the SPS crop window)
        h, w = pic.y.shape
        ch, cw = pic.u.shape
        y, u, v = self.last_recon
        return nals, Picture(y=y[:h, :w], u=u[:ch, :cw], v=v[:ch, :cw],
                             i_frame_qp=qp, i_frame_type=ftype,
                             i_pts=pic.i_pts)

    def _pack_cavlc(self, cfg, slice_type, qp, syn, x, headers, n_ref=1):
        """The device CAVLC payload of the frame, packed and pulled as the
        BatchEncoder does (its bytes equal the host C++ writers'). Returns
        (payload, stats vector, the bits of each MB row, the first without
        the slice header: core.py:1715-1720), or None when the packer
        raised its overflow flag or the bits pass the cap."""
        out = pack_cavlc(cfg, slice_type == P.SLICE_TYPE_P, syn, x["qp_mb"],
                         x["slice_qp"], x["hv"], x["hl"], n_ref)
        if self.keep_syntax:
            self.last_slot = dict(out, syn=syn, slice_type=slice_type,
                                  qps=[qp], headers=headers)
        self.clock.mark("cavlc")
        got = pull_payload(out, self._cap, None)
        self.clock.mark("pull")
        if got is None:
            return None
        nbytes, vec, raw, rows = got
        hb, hn = headers[0]
        row_bits = np.diff(rows[0], prepend=(len(hb) - 1) * 8 + hn)
        return raw[0, :nbytes[0]].tobytes(), vec, row_bits

    def _write_slice_cavlc_host(self, res, slice_type, qp, idr_pic_id,
                                qp_mb, n_ref, bands):
        """A CAVLC frame that the device packer does not write (a packer
        overflow, several slices, a slice size budget), written by the
        host C++ CAVLC writers (core.py:1697-1727, 2246-2278) on its pulled
        syntax (res["host"], pulled here if the overflow loop has not), one
        slice per band (None: the whole frame). Returns (payloads, stats
        vector with the writers' P_SKIP count, the bits of each MB row of a
        whole-frame slice, the first without the slice header, or None)."""
        syn = res["syn"]
        is_p = slice_type == P.SLICE_TYPE_P
        if "host" not in res:
            res["host"] = pull_syntax(syn, SYN_P if is_p else SYN_I, 1)[0]
        vec = frame_stats(syn, is_p, torch.zeros(
            1, dtype=_I32, device=self.device))[0].cpu().numpy()
        payloads, n_skip, row_bits = [], 0, None
        for band in bands:
            host, qpb, mb_h, first_mb = self._band_syn(res["host"], qp_mb,
                                                       band)
            bw = BitWriter()
            write_slice_header_common(self, bw, slice_type, qp, idr_pic_id,
                                      n_ref, first_mb)
            header = bw.get_unaligned()
            rb = np.zeros(mb_h, np.int64) if band is None else None
            if is_p:
                payload, skips = native.write_slice_p(
                    header, self.mb_w, mb_h, qp, host, qp_mb=qpb,
                    n_ref=n_ref, row_bits=rb)
                n_skip += skips
            else:
                payload = native.write_slice_i(header, self.mb_w, mb_h, qp,
                                               host, qp_mb=qpb, row_bits=rb)
            payloads.append(payload)
            if rb is not None:
                hb, hn = header
                row_bits = np.diff(rb, prepend=(len(hb) - 1) * 8 + hn)
        if is_p:
            vec[0] = n_skip
        self.clock.mark("cavlc_host")
        return payloads, vec, row_bits

    def _detect_cavlc_overflow(self, syn, slice_type) -> np.ndarray:
        """Copy of core.py:553-602 EncoderCore._detect_cavlc_overflow:
        per-MB CAVLC level-code overflow detection (cavlc.c:56-60: escape
        level_code >= 1<<12 below High profile). Cheap magnitude screen,
        then the exact writer state machine on suspect MBs only.
        Returns a (mb_h, mb_w) bool grid."""
        mb_h, mb_w = self.mb_h, self.mb_w
        flagged = np.zeros((mb_h, mb_w), bool)
        # minimum |level| that can escape with level_code >= 1<<12 is
        # > 2^11; screen generously at 256
        suspects = np.abs(syn["luma_levels"]).max(axis=(-1, -2)) >= 256
        suspects |= np.abs(syn["chroma_dc_levels"]).max(axis=(-1, -2)) >= 256
        suspects |= np.abs(syn["chroma_ac_levels"]).max(
            axis=(-1, -2, -3)) >= 256
        if "luma_dc_levels" in syn:
            suspects |= np.abs(syn["luma_dc_levels"]).max(axis=-1) >= 256
        if not suspects.any():
            return flagged

        def block_ov(levels, chroma_dc=False):
            bw = BitWriter()
            _, ov = cavlc.write_block_residual(bw, levels, 0,
                                               chroma_dc=chroma_dc)
            return ov

        is_i = slice_type == P.SLICE_TYPE_I
        for mby, mbx in zip(*np.nonzero(suspects)):
            ov = False
            cbp_luma = int(syn["cbp_luma"][mby, mbx])
            is_i16 = is_i and syn["mb_type"][mby, mbx] == 0
            for i in range(16):
                lv = syn["luma_levels"][mby, mbx, i]
                if is_i16:
                    if cbp_luma:
                        ov |= block_ov(lv[1:])
                elif cbp_luma & (1 << (i >> 2)):
                    ov |= block_ov(lv)
            if is_i16:
                ov |= block_ov(syn["luma_dc_levels"][mby, mbx])
            cbp_chroma = int(syn["cbp_chroma"][mby, mbx])
            if cbp_chroma:
                for ch in range(2):
                    ov |= block_ov(syn["chroma_dc_levels"][mby, mbx, ch],
                                   chroma_dc=True)
                if cbp_chroma == 2:
                    for ch in range(2):
                        for i in range(4):
                            ov |= block_ov(
                                syn["chroma_ac_levels"][mby, mbx, ch, i, 1:])
            flagged[mby, mbx] = ov
        return flagged

    def _nr_update(self, syn):
        """Copy of core.py:622-642 EncoderCore._nr_update on the final
        encode's device sums (one small pull): the between-frame
        noise-reduction offset update (upstream x264's
        x264_noise_reduction_update), offset = (nr·count + sum/2) /
        (sum+1), with the sliding-window halving at 2^18 samples."""
        flat = torch.cat([syn["nr_sum_y"][0], syn["nr_sum_c"][0],
                          syn["nr_count"][0]]).cpu().numpy()
        nr = self.nr
        nr["sum"][0] += flat[:16]
        nr["sum"][1] += flat[16:32]
        nr["count"] += flat[32:34]
        strength = self.param.analyse.i_noise_reduction
        for cat in range(2):
            if nr["count"][cat] > (1 << 18):
                nr["sum"][cat] >>= 1
                nr["count"][cat] >>= 1
            nr["offset"][cat] = ((strength * nr["count"][cat]
                                  + nr["sum"][cat] // 2)
                                 // (nr["sum"][cat] + 1)).astype(np.int32)
        # the DC position is never denoised in the reference layout
        # (offset[0] applies to coef 0 pre-extraction; x264 zeroes it)
        nr["offset"][:, 0] = 0

    def _write_slice_cabac(self, syn, slice_type, qp, idr_pic_id, qp_mb,
                           n_ref=1, band=None):
        """core.py:1904-1941 on the native writer: the slice of band (y0,
        y1) of the host syntax syn (None: the whole frame), its header, the
        cabac_alignment_one_bits, then the C++ CABAC body with frame_idx
        the input frame counter, at the per-MB QPs qp_mb (host (mb_h,
        mb_w)) with n_ref active references. Returns (payload, MB-type
        counts, the bits of each MB row of a whole-frame slice, or None:
        x264_cabac_pos starts at 1 bit, so the first row's count holds the
        slice's opening bit, core.py:1926-1928)."""
        syn, qp_mb, mb_h, first_mb = self._band_syn(syn, qp_mb, band)
        bw = BitWriter()
        write_slice_header_common(self, bw, slice_type, qp, idr_pic_id,
                                  n_ref, first_mb)
        bw.align_1()
        rb = np.zeros(mb_h, np.int64) if band is None else None
        payload, counts = native.write_slice_cabac(
            bw.get_bytes(), self.mb_w, mb_h, qp, self.i_frame,
            slice_type == P.SLICE_TYPE_P, syn, qp_mb=qp_mb, n_ref=n_ref,
            row_bits=rb)
        return payload, counts, None if rb is None else np.diff(rb,
                                                                prepend=1)

    def _update_reference(self, planes, recon, is_idr):
        """Commit the frame's reference planes to the DPB (core.py:730-766;
        only an IDR empties it, encoder.c:909-916) and pull its deblocked
        recon, cast to uint8 on the device, in one copy."""
        if is_idr:
            self.dpb = []
        self.dpb.insert(0, {"planes": planes, "frame_idx": self.i_frame - 1,
                            "frame_num": (self.frame_num - 1)
                            % (1 << self.sps.i_log2_max_frame_num),
                            "corrupt": False})
        del self.dpb[max(self.param.i_frame_reference, 1):]
        flat = torch.cat([r.reshape(-1) for r in recon]).cpu().numpy()
        out, off = [], 0
        for r in recon:
            n = r.numel()
            out.append(flat[off:off + n].reshape(r.shape[1:]))
            off += n
        return tuple(out)

    def _count_mb_types(self, slice_type, counts=None, vec=None) -> int:
        """The MB-type histogram update of one slice write (core.py
        :1672-1694, 1721-1726, 1929-1933, 2268-2277): from the CABAC
        writer's counts, or a CAVLC frame's device stats vector. A frame
        written more than once (VBV) counts every write, as the JAX
        Encoder does. Returns the write's P_SKIP MBs."""
        mbc = self.stats.i_mb_count
        if counts is not None:
            for name, n in zip(("I_16x16", "I_4x4", "P_L0", "P_SKIP",
                                "P_16x8", "P_8x16", "P_8x8"), counts):
                if n:
                    mbc[name] = mbc.get(name, 0) + int(n)
            return int(counts[3])
        if slice_type == P.SLICE_TYPE_P:
            n_skip = int(vec[0])
            mbc["P_SKIP"] = mbc.get("P_SKIP", 0) + n_skip
            part = vec[1:5].copy()
            part[0] -= n_skip   # skips are partition-0 MBs
            for name, n in zip(("P_L0", "P_16x8", "P_8x16", "P_8x8"), part):
                if n:
                    mbc[name] = mbc.get(name, 0) + int(n)
            return n_skip
        n_i4 = int(vec[0])
        mbc["I_4x4"] = mbc.get("I_4x4", 0) + n_i4
        mbc["I_16x16"] = mbc.get("I_16x16", 0) + self.mb_w * self.mb_h - n_i4
        return 0

    def _add_stats(self, pic, slice_type, qp_mb, nals, vec, n_skip) -> int:
        """The h->stat update of core.py:1306-1360: frame count and size,
        rate control's end on every NAL of the frame, the CBR filler NAL
        it asks for (appended to nals and to the frame's size), the mean
        per-MB QP, PSNR on the cropped planes, the reference histogram
        (less the frame's n_skip P_SKIP MBs over all its writes) and the
        intra-mode histograms from the final encode's stats vector, SSIM
        offset by (2, 2). Returns the filler payload bytes."""
        p = self.param
        st = self.stats
        n_mbs = self.mb_w * self.mb_h
        st.i_frame_count[slice_type] += 1
        total = sum(len(n.payload) for n in nals)
        st.i_frame_size[slice_type] += total
        filler = self.rc.end(slice_type, total * 8)
        if filler > 0:
            # CBR-HRD filler NAL (update_vbv :945-952, x264_filler_write)
            nals.append(NAL(P.NAL_FILLER, P.NAL_PRIORITY_DISPOSABLE,
                            nal_unit(P.NAL_FILLER, P.NAL_PRIORITY_DISPOSABLE,
                                     filler_rbsp(filler))))
            st.i_frame_size[slice_type] += len(nals[-1].payload)
        st.f_frame_qp[slice_type] += float(qp_mb.mean())
        h, w = pic.y.shape
        src = None
        if p.analyse.b_psnr or p.analyse.b_ssim:
            src = [_host(a) for a in (pic.y, pic.u, pic.v)]
        if p.analyse.b_psnr:
            for plane, (rec, s) in enumerate(zip(self.last_recon, src)):
                ph, pw = s.shape
                d = rec[:ph, :pw].astype(np.int64) - s.astype(np.int64)
                ssd_p = int((d * d).sum())
                st.ssd[plane] += ssd_p
                st.pixels[plane] += ph * pw
                st.ssd_type[slice_type][plane] += ssd_p
                st.pixels_type[slice_type][plane] += ph * pw
        if slice_type == P.SLICE_TYPE_P:
            # reference histogram without the P_SKIP MBs (encoder.c:1612)
            rh = vec[5:5 + P.REF_MAX].astype(np.int64)
            rh[0] -= n_skip
            st.i_mb_count_ref += np.maximum(rh, 0)
        else:
            # intra prediction-mode histograms (encoder.c:2262-2341)
            st.i16_modes += vec[1:8]
            st.i4_modes += vec[8:20]
            st.chroma_modes += vec[20:27]
            st.cbp_coded += vec[27:30]
            st.cbp_mbs += n_mbs
        if p.analyse.b_ssim:
            # offset (2, 2) so that SSIM blocks don't align with the DCT
            # blocks (encoder.c:1416-1427)
            from ..ops.pixel import ssim_wxh
            s, cnt = ssim_wxh(torch.from_numpy(self.last_recon[0][2:h, 2:w]),
                              torch.from_numpy(src[0][2:, 2:]))
            st.f_ssim += float(s)
            st.i_ssim_cnt += cnt
        return max(filler, 0)

    # ------------------------------------------------------------------
    def close(self) -> dict:
        """Copy of core.py:2410 close: the x264_encoder_close stats
        summary (encoder.c:2189-2388) through x264_log."""
        p = self.param
        st = self.stats
        out = st.summary()
        fps = (p.i_fps_num / p.i_fps_den
               if p.i_fps_num > 0 and p.i_fps_den > 0 else 25.0)
        total_frames = sum(st.i_frame_count.values())
        for stype, ch in ((P.SLICE_TYPE_I, "I"), (P.SLICE_TYPE_P, "P")):
            n = st.i_frame_count.get(stype, 0)
            if not n:
                continue
            P.x264_log(p, P.LOG_INFO,
                       f"frame {ch}:{n:<5d} Avg QP:"
                       f"{st.f_frame_qp[stype] / n:5.2f}  size:"
                       f"{st.i_frame_size[stype] / n:6.0f}")
        mbs = st.i_mb_count
        tot_mb = max(sum(mbs.values()), 1)
        if mbs:
            P.x264_log(p, P.LOG_INFO, "mb " + "  ".join(
                f"{k}:{100.0 * v / tot_mb:.1f}%"
                for k, v in sorted(mbs.items())))
        if st.cbp_mbs:
            cy, cdc, cac = (100.0 * st.cbp_coded / st.cbp_mbs)
            P.x264_log(p, P.LOG_INFO,
                       f"coded y,uvDC,uvAC intra: {cy:.1f}% {cdc:.1f}% "
                       f"{cac:.1f}%")
            tot16 = max(int(st.i16_modes.sum()), 1)
            v, h_, dc, pl = (100.0 * st.i16_modes[[0, 1, 2, 3]] / tot16)
            P.x264_log(p, P.LOG_INFO,
                       f"i16 v,h,dc,p: {v:2.0f}% {h_:2.0f}% {dc:2.0f}% "
                       f"{pl:2.0f}%")
            if st.i4_modes.sum():
                m = 100.0 * st.i4_modes[:9] / st.i4_modes.sum()
                P.x264_log(p, P.LOG_INFO,
                           "i4 v,h,dc,ddl,ddr,vr,hd,vl,hu: "
                           + " ".join(f"{x:2.0f}%" for x in m))
            totc = max(int(st.chroma_modes.sum()), 1)
            dc, h_, v, pl = (100.0 * st.chroma_modes[[0, 1, 2, 3]] / totc)
            P.x264_log(p, P.LOG_INFO,
                       f"i8c dc,h,v,p: {dc:2.0f}% {h_:2.0f}% {v:2.0f}% "
                       f"{pl:2.0f}%")
        if st.i_mb_count_ref.sum():
            den = st.i_mb_count_ref.sum()
            P.x264_log(p, P.LOG_INFO, "ref P L0:" + "".join(
                f" {100.0 * n / den:4.1f}%"
                for n in st.i_mb_count_ref if n))
        if p.analyse.b_psnr and st.pixels[0]:
            psnr = out["psnr_yuv"]
            for stype, ch in ((P.SLICE_TYPE_I, "I"), (P.SLICE_TYPE_P, "P")):
                if st.pixels_type[stype][0]:
                    py = out["psnr_yuv_by_type"][stype]
                    P.x264_log(p, P.LOG_INFO,
                               f"frame {ch} PSNR Mean Y:{py[0]:.3f} "
                               f"U:{py[1]:.3f} V:{py[2]:.3f}")
            P.x264_log(p, P.LOG_INFO,
                       f"PSNR Mean Y:{psnr[0]:.3f} U:{psnr[1]:.3f} "
                       f"V:{psnr[2]:.3f}")
        if p.analyse.b_ssim and st.i_ssim_cnt:
            P.x264_log(p, P.LOG_INFO,
                       f"SSIM Mean Y:{out['ssim_y']:.7f}")
        if total_frames:
            total_bytes = sum(st.i_frame_size.values())
            P.x264_log(p, P.LOG_INFO,
                       f"kb/s:{total_bytes * 8 * fps / total_frames / 1000:.2f}")
        return out
