"""Batched multi-stream encoder — port of x264dsp_tpu/encoder/batch.py
(CQP; the per-stream CRF/ABR of its v2 is not ported yet).

S independent streams encode in lockstep, one batched frame step per
slot on the chosen device (every tensor has a leading stream axis).
Output is pipelined one slot behind input, like the JAX BatchEncoder:
encode_batch(pics) returns the PREVIOUS slot's NALs (None on the first
call) and encode_batch(None) drains. The previous slot's syntax is
pulled to the host and its slices are written by the C++ CAVLC writers
in a thread pool (ctypes releases the GIL) while the device runs the
current slot. The reference planes are not updated in place: each slot
allocates new planes and the old ones are freed when replaced.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from x264dsp_tpu import params as P
from x264dsp_tpu.api import NAL
from x264dsp_tpu.encoder.ratecontrol import RateControl
from x264dsp_tpu.encoder.sets import PPS, SPS
from x264dsp_tpu.entropy import native
from x264dsp_tpu.entropy.bitstream import BitWriter, nal_unit

from . import core as C


def resolve_device(device) -> torch.device:
    """The device a caller asked for; CUDA without a usable GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch finds no "
                           "CUDA device")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class BatchEncoder:
    def __init__(self, param: P.Param, n_streams: int, *, device,
                 profile: bool = False):
        """S = n_streams lockstep streams on `device` ("cuda" or "cpu";
        no default, so the CPU runs only when asked for). profile=True
        synchronizes at each stage and records slot_times."""
        self.param = p = P.validate_parameters(param)
        if p.b_cabac:
            raise P.ValidationError("BatchEncoder is CAVLC-only "
                                    "(use Encoder for CABAC streams)")
        if p.rc.i_rc_method != P.RC_CQP:
            raise P.ValidationError("the PyTorch BatchEncoder is CQP-only "
                                    "(per-stream CRF/ABR is not ported)")
        if p.rc.i_vbv_buffer_size:
            raise P.ValidationError("BatchEncoder has no VBV")
        if p.rc.i_aq_mode != P.AQ_NONE and p.rc.f_aq_strength > 0:
            raise P.ValidationError("BatchEncoder has no AQ")
        if max(1, p.i_slice_count) != 1 or p.i_slice_max_mbs \
                or p.i_slice_max_size:
            raise P.ValidationError("BatchEncoder is single-slice")
        if p.i_frame_reference != 1:
            raise P.ValidationError("BatchEncoder uses 1 reference")
        if p.analyse.i_noise_reduction:
            raise P.ValidationError("BatchEncoder has no NR")
        if p.i_cqm_preset != P.CQM_FLAT:
            raise P.ValidationError("BatchEncoder v1 is flat-CQM")
        if min(max(p.analyse.i_me_method, 0), 3) != P.ME_DIA \
                or p.analyse.inter & P.ANALYSE_PSUB16x16 \
                or min(max(p.analyse.i_subpel_refine, 0), 11) != 1:
            raise P.ValidationError("the PyTorch BatchEncoder runs DIA, "
                                    "subme 1, no sub-16x16 partitions")
        if native.get_lib() is None:
            raise RuntimeError("the C++ CAVLC writers did not build "
                               "(x264dsp_tpu/entropy/native.py)")
        self.device = resolve_device(device)
        self.S = int(n_streams)
        self.sps = SPS.init(p, p.i_sps_id)
        self.pps = PPS.init(p, self.sps, p.i_sps_id)
        self.mb_w = self.sps.i_mb_width
        self.mb_h = self.sps.i_mb_height
        # CQP: the I/P QPs (qp_constant with the ip offset) come from the
        # shared host RateControl, as in the JAX BatchEncoder
        self.rc = RateControl(p, self.mb_w * self.mb_h)
        self.i_frame = 0
        self.frame_num = 0
        self.idr_pic_id = 0
        self.refs = None
        self.last_recon = None
        self._pending = None
        self._pool = ThreadPoolExecutor(max_workers=min(max(self.S, 2), 8))
        self.frames = {P.SLICE_TYPE_I: 0, P.SLICE_TYPE_P: 0}
        self.bytes = {P.SLICE_TYPE_I: 0, P.SLICE_TYPE_P: 0}
        self.mb_hist = {}
        cap = C.DEV_PAYLOAD_BYTES_PER_MB * self.mb_w * self.mb_h + 4096
        self._cap = -(-cap // 4) * 4
        self.clock = C.StageClock(self.device, profile)
        # profile: per-slot (slice type, {stage: seconds}) for the stages
        # encode, deblock, ref_planes, pull, cavlc
        self.slot_times = []

    # ------------------------------------------------------------------
    def headers(self) -> list[NAL]:
        nals = []
        for cls, t in ((self.sps, P.NAL_SPS), (self.pps, P.NAL_PPS)):
            bw = BitWriter()
            cls.write(bw)
            nals.append(NAL(t, P.NAL_PRIORITY_HIGHEST,
                            nal_unit(t, P.NAL_PRIORITY_HIGHEST,
                                     bw.get_bytes())))
        return nals

    def slot_qp(self, slice_type: int) -> int:
        """The slot's QP from the host RateControl, clipped to the
        parameters' range."""
        p = self.param
        return int(np.clip(self.rc.start(slice_type, 0), p.rc.i_qp_min,
                           min(p.rc.i_qp_max, P.QP_MAX_SPEC)))

    def frame_cfg(self, qp: int) -> dict:
        """The static settings of core.frame_step for a slot at `qp`."""
        p = self.param
        return dict(mb_w=self.mb_w, mb_h=self.mb_h,
                    me_range=p.analyse.i_me_range,
                    mv_range=p.analyse.i_mv_range,
                    dct_decimate=bool(p.analyse.b_dct_decimate),
                    fast_pskip=bool(p.analyse.b_fast_pskip),
                    use_satd=p.analyse.i_subpel_refine > 0,
                    i4x4=bool(p.analyse.intra & P.ANALYSE_I4x4),
                    deblock_on=C.deblock_enabled(p, qp),
                    alpha_off=p.i_deblocking_filter_alphac0 * 2,
                    beta_off=p.i_deblocking_filter_beta * 2,
                    cqpo=p.analyse.i_chroma_qp_offset)

    # ------------------------------------------------------------------
    def _start_entropy(self, rec):
        """Pull the slot's syntax and submit one slice writer per stream
        to the pool. Returns the futures."""
        is_p = rec["slice_type"] == P.SLICE_TYPE_P
        self.clock.start()
        syns = C.pull_syntax(rec["syn"], C.SYN_P if is_p else C.SYN_I,
                             self.S)
        self.clock.mark("pull")
        for s, syn in enumerate(syns):
            if C.detect_cavlc_overflow(syn, rec["slice_type"], self.mb_h,
                                       self.mb_w).any():
                raise RuntimeError(
                    f"CAVLC level overflow in stream {s} (pathological "
                    "content for baseline CAVLC); use Encoder for this "
                    "stream")
        qp = rec["qp"]
        qp_grid = np.full((self.mb_h, self.mb_w), qp, np.int16)
        hdr = rec["header"]

        def one(syn):
            if is_p:
                payload, n_skip = native.write_slice_p(
                    hdr, self.mb_w, self.mb_h, qp, syn, qp_mb=qp_grid)
            else:
                payload, n_skip = native.write_slice_i(
                    hdr, self.mb_w, self.mb_h, qp, syn, qp_mb=qp_grid), 0
            return payload, n_skip
        futures = [self._pool.submit(one, syn) for syn in syns]
        if self.clock.enabled:
            # profiling serializes the pipeline so the writers' time is seen
            for f in futures:
                f.result()
            self.clock.mark("cavlc")
            rec["times"].update({k: self.clock.times.pop(k, 0.0)
                                 for k in ("pull", "cavlc")})
        return futures

    def _finish(self, rec, futures):
        """Collect the slot's slices and frame its NALs."""
        results = [f.result() for f in futures]
        nal_type = P.NAL_SLICE_IDR if rec["is_idr"] else P.NAL_SLICE
        out_nals = []
        for payload, _ in results:
            if len(payload) > self._cap:
                raise RuntimeError("CAVLC slice exceeds the BatchEncoder "
                                   "payload cap; use Encoder for this stream")
            nals = []
            if rec["first"] and self.param.b_repeat_headers:
                nals.extend(self.headers())
            nals.append(NAL(nal_type, P.NAL_PRIORITY_HIGHEST,
                            nal_unit(nal_type, P.NAL_PRIORITY_HIGHEST,
                                     payload)))
            out_nals.append(nals)
        slice_type = rec["slice_type"]
        vec = rec["stats"].sum(0).cpu().numpy()
        self.frames[slice_type] += self.S
        self.bytes[slice_type] += sum(len(n.payload) for nl in out_nals
                                      for n in nl)
        h = self.mb_hist
        if slice_type == P.SLICE_TYPE_P:
            n_skip = sum(n for _, n in results)
            part = vec[0:4].copy()
            part[0] -= n_skip
            h["P_SKIP"] = h.get("P_SKIP", 0) + n_skip
            for name, n in zip(("P_L0", "P_16x8", "P_8x16", "P_8x8"), part):
                if n:
                    h[name] = h.get(name, 0) + int(n)
        else:
            n_i4 = int(vec[0])
            h["I_4x4"] = h.get("I_4x4", 0) + n_i4
            h["I_16x16"] = (h.get("I_16x16", 0)
                            + self.S * self.mb_w * self.mb_h - n_i4)
        if self.clock.enabled:
            self.slot_times.append((slice_type, rec["times"]))
        return out_nals

    def _stack(self, pics):
        if isinstance(pics, tuple) and len(pics) == 3:
            planes = [torch.as_tensor(a).to(self.device) for a in pics]
            if planes[0].shape[0] != self.S:
                raise ValueError(f"expected {self.S} stacked streams")
            return planes
        if len(pics) != self.S:
            raise ValueError(f"expected {self.S} pictures")
        out = []
        for attr, mb in (("y", 16), ("u", 8), ("v", 8)):
            arr = np.stack([C.pad_mod16(np.asarray(getattr(q, attr),
                                                   np.uint8), mb)
                            for q in pics])
            out.append(torch.from_numpy(arr).to(self.device))
        return out

    # ------------------------------------------------------------------
    def encode_batch(self, pics):
        """pics: S Pictures, a stacked ((S,H,W) y, (S,H/2,W/2) u, v)
        triple of tensors or arrays, or None to drain. Returns the
        PREVIOUS slot's per-stream NAL lists (None while the pipeline
        fills)."""
        pending, self._pending = self._pending, None
        futures = self._start_entropy(pending) if pending else None
        if pics is None:
            return self._finish(pending, futures) if pending else None
        fy, fu, fv = self._stack(pics)
        p = self.param
        is_idr = self.i_frame % max(p.i_keyint_max, 1) == 0
        slice_type = P.SLICE_TYPE_I if is_idr else P.SLICE_TYPE_P
        if is_idr:
            self.frame_num = 0
        qp = self.slot_qp(slice_type)
        bw = BitWriter()
        C.write_slice_header_common(self, bw, slice_type, qp,
                                    self.idr_pic_id if is_idr else -1)
        qp_mb = torch.full((self.S, self.mb_h, self.mb_w), qp,
                           dtype=torch.int32, device=self.device)
        lam = torch.full_like(qp_mb, int(C.LAMBDA_TAB[qp]))
        out = C.frame_step(self.frame_cfg(qp), slice_type == P.SLICE_TYPE_P,
                           fy, fu, fv, self.refs, qp_mb, lam, qp, self.clock)
        self.refs = out["planes"]
        self.last_recon = out["recon"]
        prev = self._finish(pending, futures) if pending else None
        self._pending = {"syn": out["syn"], "stats": out["stats"],
                         "slice_type": slice_type, "is_idr": is_idr,
                         "first": self.i_frame == 0, "qp": qp,
                         "header": bw.get_unaligned(),
                         "times": {k: self.clock.times.pop(k, 0.0)
                                   for k in ("encode", "deblock",
                                             "ref_planes")}}
        if is_idr:
            self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        self.frame_num = (self.frame_num + 1) % (
            1 << self.sps.i_log2_max_frame_num)
        self.i_frame += 1
        return prev

    # ------------------------------------------------------------------
    def close(self) -> dict:
        tail = self.encode_batch(None)
        self._pool.shutdown(wait=True)
        summary = {"frames": dict(self.frames), "bytes": dict(self.bytes),
                   "mb_types": dict(self.mb_hist)}
        if tail is not None:
            summary["drained"] = True
        P.x264_log(self.param, P.LOG_INFO, f"batch summary {summary}")
        return summary
