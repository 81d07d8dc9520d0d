"""Batched multi-stream encoder — port of x264dsp_tpu/encoder/batch.py:
CQP, or its v2 per-stream CRF/ABR. P analysis: DIA, HEX, UMH or ESA
full-pel search, subme 0-11, with or without the 16x8/8x16/8x8
partitions (X264_ANALYSE_PSUB16x16), one reference. The BatchEncoder
takes the parameter sets that the JAX one takes and refuses the others.

S independent streams encode in lockstep, one batched frame step per
slot on the chosen device (every tensor has a leading stream axis).
Output is pipelined one slot behind input, like the JAX BatchEncoder:
encode_batch(pics) returns the PREVIOUS slot's NALs (None on the first
call) and encode_batch(None) drains. As there, a slot's QP is decided
before the previous slot is pulled, so the rate control of CRF/ABR sees
each slot's size one slot late. The frame step packs each slot's
CAVLC slice payloads on the device (entropy/cavlc_device.py); the host
pulls the bit counts, the overflow flags and the stats vector, then a
power-of-two bucket of payload bytes, and frames the NALs. The
reference planes are not updated in place: each slot allocates new
planes and the old ones are freed when replaced.

``deblock_route`` (None, "wave" or "region"; see ops/deblock.py) is a
plain attribute read at each slot, so it may change between slots; all
three routes write the same bytes.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import params as P
from ..api import NAL
from ..entropy.bitstream import BitWriter, nal_unit
from ..ops import mc as MC
from . import core as C
from . import slicetype as ST
from .ratecontrol import RateControl
from .sets import PPS, SPS


class BatchEncoder:
    def __init__(self, param: P.Param, n_streams: int, *,
                 device="cuda", profile: bool = False):
        """S = n_streams lockstep streams on `device`: the GPU unless the
        caller asks for "cpu"; "cuda" without a GPU raises. profile=True
        synchronizes at each stage and records slot_times."""
        self.param = p = P.validate_parameters(param)
        if p.b_cabac:
            raise P.ValidationError("BatchEncoder is CAVLC-only "
                                    "(use Encoder for CABAC streams)")
        if p.rc.i_rc_method not in (P.RC_CQP, P.RC_CRF, P.RC_ABR):
            raise P.ValidationError("unknown rc method")
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
        self.device = C.resolve_device(device)
        self.deblock_route = None
        # keep_syntax: hold the newest slot's device syntax and each
        # stream's slice header and QP in last_slot
        # (tools/mainpath.payload_vs_writers reads them)
        self.keep_syntax = False
        self.last_slot = None
        self.S = int(n_streams)
        self.sps = SPS.init(p, p.i_sps_id)
        self.pps = PPS.init(p, self.sps, p.i_sps_id)
        self.mb_w = self.sps.i_mb_width
        self.mb_h = self.sps.i_mb_height
        # CQP: the I/P QPs (qp_constant with the ip offset) come from the
        # shared host RateControl, as in the JAX BatchEncoder. CRF/ABR
        # (its v2, batch.py:70-80): one RateControl per stream, started
        # with the stream's frame SATD from the lowres cost pass and ended
        # with the stream's bits when the slot is pulled
        self.rc = RateControl(p, self.mb_w * self.mb_h)
        self.per_stream_rc = p.rc.i_rc_method != P.RC_CQP
        self.rcs = [RateControl(p, self.mb_w * self.mb_h)
                    for _ in range(self.S if self.per_stream_rc else 0)]
        self.prev_low4 = None
        # the lowres frame cost counts the edge-block ring only where the
        # spatial distribution matters or there is no interior
        self.lowres_edges = bool(p.rc.b_mb_tree or p.rc.i_vbv_buffer_size
                                 or self.mb_w <= 2 or self.mb_h <= 2)
        # the streams' slice QPs of the newest slot
        self.last_qps = None
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
        self._cap = C.payload_cap(self.mb_w, self.mb_h)
        self.clock = C.StageClock(self.device, profile)
        # profile: per-slot (slice type, {stage: seconds}) for the stages
        # lowres (the slice QPs, with CRF/ABR's lowres cost pass, and the
        # slice headers), encode, cavlc (device packer), deblock,
        # ref_planes, pull (payload)
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
        """The static settings of core.frame_step for a slot at `qp` (with
        per-stream QPs, the largest: a stream below the deblock threshold
        then filters with zero alpha/beta, a no-op, batch.py:266-270)."""
        return C.frame_cfg(self.param, self.mb_w, self.mb_h, qp, self._cap,
                           self.deblock_route)

    # ------------------------------------------------------------------
    def _finish_pending(self):
        """Pull the previous slot's payload and frame its NALs (the JAX
        BatchEncoder._finish_pending)."""
        if self._pending is None:
            return None
        rec, self._pending = self._pending, None
        out = rec["out"]
        S = self.S
        self.clock.start()
        nbytes, vec, raw = C.pull_payload(
            out, self._cap, "device CAVLC overflow in BatchEncoder "
            "(pathological content for the payload cap); use Encoder for "
            "this stream")
        self.clock.mark("pull")
        nal_type = P.NAL_SLICE_IDR if rec["is_idr"] else P.NAL_SLICE

        def one(s):
            nals = []
            if rec["first"] and self.param.b_repeat_headers:
                nals.extend(self.headers())
            nals.append(NAL(nal_type, P.NAL_PRIORITY_HIGHEST,
                            nal_unit(nal_type, P.NAL_PRIORITY_HIGHEST,
                                     raw[s, :nbytes[s]].tobytes())))
            return nals
        out_nals = list(self._pool.map(one, range(S)))
        slice_type = rec["slice_type"]
        if self.per_stream_rc:
            # the stream's bits of the slot, SPS/PPS included (batch.py:162)
            for s, nl in enumerate(out_nals):
                self.rcs[s].end(slice_type,
                                8 * sum(len(n.payload) for n in nl))
        self.frames[slice_type] += self.S
        self.bytes[slice_type] += sum(len(n.payload) for nl in out_nals
                                      for n in nl)
        h = self.mb_hist
        if slice_type == P.SLICE_TYPE_P:
            n_skip = int(vec[0])
            part = vec[1:5].copy()
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
            rec["times"]["pull"] = self.clock.times.pop("pull", 0.0)
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
    def slot_qps(self, fy, slice_type: int, is_idr: bool) -> list:
        """The S streams' slice QPs of a slot. CQP: slot_qp for every
        stream. CRF/ABR (batch.py:226-246): each stream's frame SATD from
        one lowres cost pass over the batch (the I cost on an IDR, else
        the P cost against the previous slot's source,
        x264_rc_analyse_slice, slicetype.c:605), its RateControl's QP
        clipped to the range."""
        if not self.per_stream_rc:
            return [self.slot_qp(slice_type)] * self.S
        p = self.param
        low4 = MC.lowres_planes(fy)
        prev = low4 if is_idr or self.prev_low4 is None else self.prev_low4
        vec = ST.frame_summary(low4[:, 0], prev, self.mb_w, self.mb_h,
                               self.lowres_edges)[:, :2].cpu().numpy()
        self.prev_low4 = low4
        satd = vec[:, 0] if is_idr else vec[:, 1]
        return [int(np.clip(rc.start(slice_type, int(satd[s])),
                            p.rc.i_qp_min, min(p.rc.i_qp_max, P.QP_MAX_SPEC)))
                for s, rc in enumerate(self.rcs)]

    def slot_inputs(self, slice_type: int, qps: list, idr_pic_id: int):
        """core.slot_inputs for this encoder's S streams at the QPs
        `qps`. Returns (headers, inputs)."""
        return C.slot_inputs(self, slice_type, qps, idr_pic_id)

    # ------------------------------------------------------------------
    def encode_batch(self, pics):
        """pics: S Pictures, a stacked ((S,H,W) y, (S,H/2,W/2) u, v)
        triple of tensors or arrays, or None to drain. Returns the
        PREVIOUS slot's per-stream NAL lists (None while the pipeline
        fills)."""
        if pics is None:
            return self._finish_pending()
        fy, fu, fv = self._stack(pics)
        p = self.param
        is_idr = self.i_frame % max(p.i_keyint_max, 1) == 0
        slice_type = P.SLICE_TYPE_I if is_idr else P.SLICE_TYPE_P
        if is_idr:
            self.frame_num = 0
        self.clock.start()
        qps = self.slot_qps(fy, slice_type, is_idr)
        headers, x = self.slot_inputs(slice_type, qps,
                                      self.idr_pic_id if is_idr else -1)
        self.clock.mark("lowres")
        out = C.frame_step(self.frame_cfg(max(qps)),
                           slice_type == P.SLICE_TYPE_P, fy, fu, fv,
                           self.refs, x["qp_mb"], x["lam"], x["slice_qp"],
                           x["hv"], x["hl"], self.clock)
        times = {k: self.clock.times.pop(k, 0.0)
                 for k in ("lowres", "encode", "cavlc", "deblock",
                           "ref_planes")}
        self.refs = out["planes"]
        self.last_recon = out["recon"]
        self.last_qps = list(qps)
        if self.keep_syntax:
            self.last_slot = dict(out, slice_type=slice_type, qps=list(qps),
                                  headers=headers)
        # the previous slot is pulled after this one is launched (the JAX
        # order, batch.py:305): its rate-control feedback comes after this
        # slot's QPs
        prev = self._finish_pending()
        self._pending = {"out": {k: out[k] for k in ("payload", "bits", "ov",
                                                     "n_skip", "rows",
                                                     "stats")},
                         "slice_type": slice_type, "is_idr": is_idr,
                         "first": self.i_frame == 0, "times": times}
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
