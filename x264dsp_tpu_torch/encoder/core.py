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
(S = 1), the scenecut slice-type decision (slicetype.SlicetypeDecider),
one host RateControl, CAVLC packed on the device or CABAC written by
the host C++ writer from one pull of the frame's syntax.

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
from ..api import NAL, Picture
from ..entropy import cavlc_device as CD
from ..entropy import native
from ..entropy.bitstream import BitWriter, nal_unit
from ..ops import deblock as DB
from ..ops import mc as MC
from ..ops.tables import CHROMA_QP_TABLE
from . import inter_frame, intra_frame
from .ratecontrol import RateControl
from .sets import PPS, SPS, sei_pic_timing_rbsp
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


def write_slice_header_common(enc, bw, slice_type, qp, idr_pic_id):
    """Copy of core.py:1857-1902 EncoderCore._write_slice_header_common
    (x264_slice_header_write, encoder.c:1047-1196), duck-typed on `enc`
    (param, sps, pps, frame_num): one slice from MB 0, one active
    reference (the PPS default, so no num_ref_idx override), no reference
    reordering (no corrupt reference is ever skipped), and
    cabac_init_idc on a CABAC P slice."""
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


def frame_cfg(p, mb_w: int, mb_h: int, qp: int, cap_bytes: int,
              deblock_route=None) -> dict:
    """The static settings of the frame step (encode_frame, pack_cavlc,
    reference) for a frame at `qp` under the parameters `p`."""
    return dict(mb_w=mb_w, mb_h=mb_h,
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


def slot_inputs(enc, slice_type: int, qps: list, idr_pic_id: int):
    """The per-stream inputs of the frame step at the streams' QPs `qps`,
    duck-typed on `enc` (param, sps, pps, frame_num, device, mb_w, mb_h):
    each stream's slice header (BitWriter.get_unaligned), and a dict of
    its packer slots hv / hl (S, n), qp_mb / lam (S, mb_h, mb_w) and the
    (S,) slice_qp (batch.py:247-265). Returns (headers, inputs)."""
    headers = []
    for qp in qps:
        bw = BitWriter()
        write_slice_header_common(enc, bw, slice_type, qp, idr_pic_id)
        headers.append(bw.get_unaligned())
    elems = [CD.header_elements(*h, max_slots=32) for h in headers]
    dev = enc.device
    hv, hl = (torch.as_tensor(np.stack([e[i] for e in elems]), device=dev)
              for i in range(2))
    qps_np = np.array(qps, np.int32)
    ql = torch.as_tensor(np.stack([qps_np, LAMBDA_TAB[qps_np]]), device=dev)
    grid = (len(qps), enc.mb_h, enc.mb_w)
    qp_mb, lam = (ql[i][:, None, None].expand(grid).contiguous()
                  for i in range(2))
    return headers, dict(hv=hv, hl=hl, qp_mb=qp_mb, lam=lam, slice_qp=ql[0])


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
                 clock: StageClock):
    """The encode half of the frame step: the I or P frame encode of S
    streams. cfg: frame_cfg's settings; fy/fu/fv (S, H, W) frames on the
    device, refs (ref4, refu, refv) for a P frame, qp_mb / lam_mb
    (S, mb_h, mb_w) int32. Returns the device syntax dict (recon planes
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
            partitions=cfg["partitions"])
    else:
        syn = intra_frame.encode_i_frame(fy, fu, fv, qp_mb, qpc_mb, lam_mb,
                                         cfg["mb_w"], cfg["mb_h"],
                                         cfg["use_satd"], cfg["i4x4"])
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


def pack_cavlc(cfg: dict, is_p: bool, syn, qp_mb, slice_qp, hv, hl):
    """The device CAVLC slice payloads of S streams (slice_qp (S,), hv /
    hl (S, n) the slice headers as packer slots). Returns a dict: payload
    (S, cap_bytes) uint8, bits, ov, n_skip (S,), rows (S, mb_h) and the
    frame_stats vector."""
    mb_w, mb_h = cfg["mb_w"], cfg["mb_h"]
    if is_p:
        payload, bits, n_skip, ov, rows = CD.cavlc_p_payload(
            {k: syn[k] for k in SYN_P if k != "mv"}, qp_mb, slice_qp, 1,
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


def pull_payload(out, cap: int, overflow_msg: str):
    """pack_cavlc's payloads on the host: one small pull of the streams'
    bit counts, overflow flags and summed stats vector, the overflow check
    against the cap (RuntimeError(overflow_msg)), then a power-of-two
    bucket of payload bytes. Returns (nbytes (S,), vec, raw (S, bucket)
    uint8)."""
    S = out["bits"].shape[0]
    meta = torch.cat([out["bits"].long(), out["ov"].long(),
                      out["stats"].sum(0).long()]).cpu().numpy()
    bits, ov, vec = meta[:S], meta[S:2 * S], meta[2 * S:]
    if ov.any() or (bits > cap * 8).any():
        raise RuntimeError(overflow_msg)
    nbytes = (bits + 7) >> 3
    bucket = min(1 << max(12, int(nbytes.max() - 1).bit_length()), cap)
    return nbytes, vec, out["payload"][:, :bucket].cpu().numpy()


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
        self._refuse_unported()
        self.device = resolve_device(device)
        self.slicetype = SlicetypeDecider(p)
        self.i_frame = 0          # input frame counter
        self.frame_num = 0        # frame_num syntax element
        self.idr_pic_id = 0
        self._cpb_delay = 0       # pic-timing SEI ticks
        profile_name = "Main" if p.b_cabac else "Constrained Baseline"
        P.x264_log(p, P.LOG_INFO,
                   f"profile {profile_name}, level "
                   f"{p.i_level_idc // 10}.{p.i_level_idc % 10}")
        P.x264_log(p, P.LOG_DEBUG, "options: " + P.param2string(p, True))
        self.stats = Stats()
        self.last_recon = None    # (y, u, v) host uint8, deblocked, padded
        # DPB, nearest first (x264_reference_build, encoder.c:813): each
        # frame's reference planes (ref4, refu, refv)
        self.dpb: list = []
        self._cap = payload_cap(self.mb_w, self.mb_h)
        self.clock = StageClock(self.device, profile)
        # keep_syntax (CAVLC): hold the newest frame's device syntax,
        # packer outputs, slice header and QP in last_slot, as the
        # BatchEncoder does (tools/mainpath.payload_vs_writers reads it)
        self.keep_syntax = False
        self.last_slot = None
        # profile: per-frame (slice type, {stage: seconds}) for the stages
        # slicetype (pad, upload, the decision), encode, then CABAC:
        # syntax_pull, cabac (the C++ writer); or CAVLC: cavlc (device
        # packer), pull (payload); and deblock, ref_planes
        self.frame_times = []

    def _refuse_unported(self):
        """The JAX Encoder's settings that the port does not take yet:
        each raises ValidationError naming the missing feature."""
        p = self.param
        refused = (
            (p.rc.i_aq_mode != P.AQ_NONE and p.rc.f_aq_strength > 0,
             "adaptive quantization (AQ, ratecontrol.aq_offsets)"),
            (self.rc.b_vbv, "VBV (row VBV, the lookahead queue, HRD SEI "
             "and filler)"),
            (p.i_frame_reference > 1, "more than one reference frame"),
            (p.i_cqm_preset != P.CQM_FLAT, "non-flat CQM"),
            (p.analyse.i_noise_reduction, "noise reduction"),
            (max(1, p.i_slice_count) > 1 or p.i_slice_max_mbs
             or p.i_slice_max_size, "more than one slice per frame "
             "(i_slice_count, i_slice_max_mbs, i_slice_max_size)"),
            (p.b_intra_refresh, "periodic intra refresh"),
            (p.i_frame_packing == 5, "frame packing 5 (one view per "
             "frame)"))
        for hit, feature in refused:
            if hit:
                raise P.ValidationError(
                    f"{feature} is not ported to the PyTorch Encoder yet")

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

    # ------------------------------------------------------------------
    def encode(self, pic: Picture | None):
        """x264_encoder_encode (core.py:767): the slice-type decision at
        put time, then the frame's encode. Without VBV the lookahead
        delays no frame (frames_delay 0), so a picture comes back encoded
        at once and encode(None) returns ([], None). A torch picture is
        padded on its device; anything else through pad_mod16."""
        if pic is None:
            return [], None
        self.clock.start()
        planes = []
        for a, mb in ((pic.y, 16), (pic.u, 8), (pic.v, 8)):
            if torch.is_tensor(a):
                t = pad_mod16_tensor(a.to(self.device, torch.uint8), mb)
            else:
                t = torch.from_numpy(np.ascontiguousarray(
                    pad_mod16(np.asarray(a, np.uint8), mb))).to(self.device)
            planes.append(t)
        slice_type, is_keyframe, frame_cost = self.slicetype.decide(planes[0])
        self.clock.mark("slicetype")
        return self._encode_frame(pic, planes, slice_type, is_keyframe,
                                  frame_cost, self.slicetype.frame_idx - 1)

    def _encode_frame(self, pic, planes, slice_type, is_keyframe,
                      frame_cost, st_idx):
        """core.py:816-1373 for one slice, one reference, no AQ or VBV."""
        p = self.param
        clock = self.clock
        is_idr = is_keyframe
        if not is_keyframe and (pic.i_type == P.TYPE_IDR or pic.b_keyframe
                                or not self.dpb):
            # user-forced IDR, or no reference left (encoder.c:1808-1820)
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
        qp = self.rc.start(slice_type, frame_cost, planned=[])
        if pic.i_qpplus1:
            qp = pic.i_qpplus1 - 1  # i_force_qp (ratecontrol.c:579-580)
        qp = min(int(np.clip(qp, p.rc.i_qp_min, p.rc.i_qp_max)),
                 P.QP_MAX_SPEC)
        is_p = slice_type == P.SLICE_TYPE_P
        # IDR resets frame_num before the slice header is written
        if is_idr:
            self.frame_num = 0
        idr_id = self.idr_pic_id if is_idr else -1
        headers, x = slot_inputs(self, slice_type, [qp], idr_id)
        cfg = frame_cfg(p, self.mb_w, self.mb_h, qp, self._cap)
        refs = self.dpb[0] if is_p else None
        syn = encode_frame(cfg, is_p, *(a[None] for a in planes), refs,
                           x["qp_mb"], x["lam"], clock)
        if p.b_cabac:
            # the frame's syntax crosses once; the device filters the
            # reference while the host writes the slice, and the stats
            # vector is pulled after the writer
            host = pull_syntax(syn, SYN_CABAC_P if is_p else SYN_CABAC_I,
                               1)[0]
            clock.mark("syntax_pull")
            stats = frame_stats(syn, is_p, torch.zeros(
                1, dtype=_I32, device=self.device))
            ref_planes, recon = reference(cfg, is_p, syn, x["qp_mb"],
                                          x["slice_qp"], clock)
            payload, counts = self._write_slice_cabac(host, slice_type, qp,
                                                      idr_id)
            clock.mark("cabac")
            vec = stats[0].cpu().numpy()
        else:
            payload, vec, counts = self._pack_cavlc(cfg, slice_type, qp, syn,
                                                    x, headers)
            ref_planes, recon = reference(cfg, is_p, syn, x["qp_mb"],
                                          x["slice_qp"], clock)

        nals = []
        if p.b_repeat_headers and self.i_frame == 0:
            # in-band SPS/PPS on the first frame only (encoder.c:1916-1944)
            nals.extend(self.headers()[:2])
        if self.sps.vui_pic_struct_present:
            # pic-timing SEI per frame (set.c:599-630)
            nals.append(NAL(P.NAL_SEI, P.NAL_PRIORITY_DISPOSABLE,
                            nal_unit(P.NAL_SEI, P.NAL_PRIORITY_DISPOSABLE,
                                     sei_pic_timing_rbsp(
                                         self.sps, self._cpb_delay, 0))))
            self._cpb_delay += 2
        nal_type = P.NAL_SLICE_IDR if is_idr else P.NAL_SLICE
        nals.append(NAL(nal_type, P.NAL_PRIORITY_HIGHEST,
                        nal_unit(nal_type, P.NAL_PRIORITY_HIGHEST, payload)))

        if is_idr:
            self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        self.frame_num = (self.frame_num + 1) % (
            1 << self.sps.i_log2_max_frame_num)
        self.i_frame += 1
        self.last_recon = self._update_reference(ref_planes, recon, is_idr)
        self._add_stats(pic, slice_type, qp, nals, vec, counts)
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

    def _pack_cavlc(self, cfg, slice_type, qp, syn, x, headers):
        """The device CAVLC payload of the frame, packed and pulled as the
        BatchEncoder does (its bytes equal the host C++ writers'). Returns
        (payload, stats vector, None)."""
        out = pack_cavlc(cfg, slice_type == P.SLICE_TYPE_P, syn, x["qp_mb"],
                         x["slice_qp"], x["hv"], x["hl"])
        if self.keep_syntax:
            self.last_slot = dict(out, syn=syn, slice_type=slice_type,
                                  qps=[qp], headers=headers)
        self.clock.mark("cavlc")
        nbytes, vec, raw = pull_payload(
            out, self._cap, "device CAVLC overflow (pathological content "
            "for the payload cap); the re-encode at a raised QP is not "
            "ported")
        self.clock.mark("pull")
        return raw[0, :nbytes[0]].tobytes(), vec, None

    def _write_slice_cabac(self, syn, slice_type, qp, idr_pic_id):
        """core.py:1904-1941 on the native writer: the slice header, the
        cabac_alignment_one_bits, then the C++ CABAC body with frame_idx
        the input frame counter. Returns (payload, MB-type counts)."""
        bw = BitWriter()
        write_slice_header_common(self, bw, slice_type, qp, idr_pic_id)
        bw.align_1()
        qp_mb = np.full((self.mb_h, self.mb_w), qp, np.int16)
        return native.write_slice_cabac(
            bw.get_bytes(), self.mb_w, self.mb_h, qp, self.i_frame,
            slice_type == P.SLICE_TYPE_P, syn, qp_mb=qp_mb)

    def _update_reference(self, planes, recon, is_idr):
        """Commit the frame's reference planes to the DPB (core.py:730-766;
        only an IDR empties it, encoder.c:909-916) and pull its deblocked
        recon, cast to uint8 on the device, in one copy."""
        if is_idr:
            self.dpb = []
        self.dpb.insert(0, planes)
        del self.dpb[max(self.param.i_frame_reference, 1):]
        flat = torch.cat([r.reshape(-1) for r in recon]).cpu().numpy()
        out, off = [], 0
        for r in recon:
            n = r.numel()
            out.append(flat[off:off + n].reshape(r.shape[1:]))
            off += n
        return tuple(out)

    def _add_stats(self, pic, slice_type, qp, nals, vec, counts):
        """The h->stat update of core.py:1302-1359: frame count, size and
        QP, rate control's end on every NAL of the frame, the MB-type
        histogram (from the CABAC writer's counts, or the device stats
        vector), PSNR on the cropped planes, the reference and intra-mode
        histograms, SSIM offset by (2, 2)."""
        p = self.param
        st = self.stats
        n_mbs = self.mb_w * self.mb_h
        st.i_frame_count[slice_type] += 1
        total = sum(len(n.payload) for n in nals)
        st.i_frame_size[slice_type] += total
        self.rc.end(slice_type, total * 8)
        st.f_frame_qp[slice_type] += float(qp)
        mbc = st.i_mb_count
        if counts is not None:
            for name, n in zip(("I_16x16", "I_4x4", "P_L0", "P_SKIP",
                                "P_16x8", "P_8x16", "P_8x8"), counts):
                if n:
                    mbc[name] = mbc.get(name, 0) + int(n)
            n_skip = int(counts[3])
        elif slice_type == P.SLICE_TYPE_P:
            n_skip = int(vec[0])
            mbc["P_SKIP"] = mbc.get("P_SKIP", 0) + n_skip
            part = vec[1:5].copy()
            part[0] -= n_skip   # skips are partition-0 MBs
            for name, n in zip(("P_L0", "P_16x8", "P_8x16", "P_8x8"), part):
                if n:
                    mbc[name] = mbc.get(name, 0) + int(n)
        else:
            n_i4 = int(vec[0])
            mbc["I_4x4"] = mbc.get("I_4x4", 0) + n_i4
            mbc["I_16x16"] = mbc.get("I_16x16", 0) + n_mbs - n_i4
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
