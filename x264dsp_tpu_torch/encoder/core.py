"""Batched frame step and host helpers — port of the BatchEncoder slice of
x264dsp_tpu/encoder/core.py.

``frame_step`` does what ``_fused_frame_fn(batched=True)`` (core.py:133)
does for S lockstep streams, with an explicit leading stream axis on
every tensor: the I or P frame encode, the device CAVLC slice payload
(entropy/cavlc_device.py), the decoded-QP scan, the in-loop deblock on
the chosen route, the half-pel reference planes and the stats vector.
BatchEncoder pulls the payload bytes, never the syntax. The TPU
worker-fault split of the reference pyramid (core.py:258-265) has no
counterpart.

The host helpers below are JAX-free copies of their namesakes in
x264dsp_tpu/encoder/core.py (which imports JAX), each marked with its
origin.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

from .. import params as P
from ..entropy import cavlc_device as CD
from ..ops import deblock as DB
from ..ops import mc as MC
from ..ops.tables import CHROMA_QP_TABLE
from . import inter_frame, intra_frame

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


def write_slice_header_common(enc, bw, slice_type, qp, idr_pic_id):
    """Copy of core.py:1857-1902 EncoderCore._write_slice_header_common
    (x264_slice_header_write, encoder.c:1047-1196), duck-typed on `enc`
    (param, sps, pps, frame_num), cut to the BatchEncoder's case: one
    slice from MB 0, CAVLC, one reference (the PPS default), no
    reference reordering."""
    p = enc.param
    bw.write_ue(0)                      # first_mb_in_slice
    bw.write_ue(slice_type + 5)
    bw.write_ue(enc.pps.i_id)
    bw.write(enc.sps.i_log2_max_frame_num,
             enc.frame_num & ((1 << enc.sps.i_log2_max_frame_num) - 1))
    if idr_pic_id >= 0:
        bw.write_ue(idr_pic_id)
    if slice_type == P.SLICE_TYPE_P:
        bw.write1(0)                    # num_ref_idx_active_override_flag
        bw.write1(0)                    # ref_pic_list_reordering_flag_l0
    if idr_pic_id >= 0:
        bw.write1(0)                    # no_output_of_prior_pics_flag
        bw.write1(0)                    # long_term_reference_flag
    else:
        bw.write1(0)                    # adaptive_ref_pic_marking_mode_flag
    bw.write_se(qp - enc.pps.i_pic_init_qp)
    deblock_on = deblock_enabled(p, qp)
    bw.write_ue(0 if deblock_on else 1)
    if deblock_on:
        bw.write_se(p.i_deblocking_filter_alphac0)
        bw.write_se(p.i_deblocking_filter_beta)


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


def frame_step(cfg: dict, is_p: bool, fy, fu, fv, refs, qp_mb, lam_mb,
               slice_qp, hv, hl, clock: StageClock):
    """One batched frame slot. cfg: the static settings (mb_w, mb_h,
    me_range, mv_range, me_method, subme, partitions, dct_decimate,
    fast_pskip, use_satd, i4x4, deblock_on, deblock_route, alpha_off,
    beta_off, cqpo, cap_bytes). fy/fu/fv (S, H, W) frames on the device,
    refs (ref4, refu, refv) for a P slot, qp_mb / lam_mb (S, mb_h, mb_w)
    int32, slice_qp the (S,) slice QPs (the per_stream_qp variant of
    core.py:133 _fused_frame_fn), hv / hl (S, n) each stream's slice
    header as packer slots (cavlc_device.header_elements). Returns a dict
    like the JAX fused frame function's: payload (S, cap_bytes) uint8,
    bits, ov, n_skip (S,), rows (S, mb_h), stats (S, n) int32, planes
    (next reference planes), recon (deblocked uint8 planes), and syn (the
    device syntax)."""
    mb_w, mb_h = cfg["mb_w"], cfg["mb_h"]
    dev = fy.device
    S = fy.shape[0]
    cqp = torch.as_tensor(CHROMA_QP_TABLE, device=dev)
    qpc_mb = cqp[(qp_mb + cfg["cqpo"]).clamp(0, 51).long()].to(_I32)
    clock.start()
    if is_p:
        ref4, refu, refv = refs
        syn = inter_frame.encode_p_frame(
            fy, fu, fv, ref4, refu, refv, qp_mb, qpc_mb, lam_mb, mb_w, mb_h,
            cfg["me_range"], cfg["mv_range"], cfg["dct_decimate"],
            fast_pskip=cfg["fast_pskip"], me_method=cfg["me_method"],
            subme=cfg["subme"], partitions=cfg["partitions"])
        clock.mark("encode")
        payload, bits, n_skip, ov, rows = CD.cavlc_p_payload(
            {k: syn[k] for k in SYN_P if k != "mv"}, qp_mb, slice_qp, 1,
            mb_h, mb_w, hv, hl, cfg["cap_bytes"], with_rows=True)
        stats = torch.cat([n_skip[:, None], _hist(syn["partition"], 4),
                           _hist(syn["ref"], P.REF_MAX)], 1)
    else:
        syn = intra_frame.encode_i_frame(fy, fu, fv, qp_mb, qpc_mb, lam_mb,
                                         mb_w, mb_h, cfg["use_satd"],
                                         cfg["i4x4"])
        clock.mark("encode")
        payload, bits, ov, rows = CD.cavlc_i_payload(
            {k: syn[k] for k in SYN_I}, qp_mb, slice_qp, mb_h, mb_w, hv, hl,
            cfg["cap_bytes"], with_rows=True)
        n_skip = torch.zeros(S, dtype=_I32, device=dev)
        is_i4 = syn["mb_type"] == 1
        stats = torch.cat([
            is_i4.reshape(S, -1).sum(1, dtype=_I32)[:, None],
            _hist(torch.where(is_i4, 7, syn["i16_mode"]), 7),
            _hist(torch.where(is_i4[..., None], syn["i4_modes"], 12), 12),
            _hist(syn["chroma_mode"], 7),
            torch.stack([(syn["cbp_luma"] != 0).reshape(S, -1).sum(1),
                         (syn["cbp_chroma"] >= 1).reshape(S, -1).sum(1),
                         (syn["cbp_chroma"] == 2).reshape(S, -1).sum(1)],
                        1).to(_I32)], 1)
    clock.mark("cavlc")
    dy, du, dv = syn["recon_y"], syn["recon_u"], syn["recon_v"]
    if cfg["deblock_on"]:
        if is_p:
            bs, feo = syn["bs"], syn["feo"]
            intra_mb = torch.zeros((S, mb_h, mb_w), dtype=_I32, device=dev)
        else:
            bs = torch.full((S, mb_h, mb_w, 2, 4, 4), 3, dtype=_I32,
                            device=dev)
            feo = torch.zeros((S, mb_h, mb_w), dtype=_I32, device=dev)
            intra_mb = torch.ones((S, mb_h, mb_w), dtype=_I32, device=dev)
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
    return dict(payload=payload, bits=bits, ov=ov, n_skip=n_skip, rows=rows,
                stats=stats, planes=planes, syn=syn,
                recon=(dy.to(torch.uint8), du.to(torch.uint8),
                       dv.to(torch.uint8)))


def pull_syntax(syn, keys, S: int):
    """Device syntax -> per-stream host dicts of int16 arrays, in ONE
    device-to-host copy (the C++ writers read int16). Not on the
    BatchEncoder's path: the checks that hold the device packer to the
    C++ writers use it."""
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
