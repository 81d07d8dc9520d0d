"""Rate control — twin of encoder/ratecontrol.c (frame-level scope).

Implements the reference's CQP / CRF / ABR math exactly:
- qp2qscale/qscale2qp (:183-190)
- ratecontrol_new state (:370-480): cplxr_sum, wanted_bits_window,
  accum_p_qp/norm, lstep, qp_constant[]
- rate_estimate_qscale (:1108-1230): blurred complexity, get_qscale
  (qscale = complexity^(1-qcomp) / rate_factor, :868-905), ABR overflow
  control, I-frame accum_p_qp path, asymmetric lstep clipping
- accum_p_qp_update (:505-516), ratecontrol_end cplxr/wanted-bits windows
  (:813-860)
- AQ variance offsets (x264_adaptive_quant_frame :241-300) are computed
  by aq_offsets() (device kernel in ops/pixel.py); per-MB application
  lands together with VBV row control (both default-off in the fork:
  common/common.c:82,69-71).
- Frame-level VBV: init_reconfigurable (:319-369), size predictors
  (predict_size/update_predictor :444-456,897-921), clip_qscale's
  reactive no-lookahead path (:1040-1060 — the fork defaults
  rc_lookahead=0, common/common.c:84) AND the lookahead VBV planner
  over queued frames (:979-1038, rc_lookahead > 0), MinCR
  frame_size_maximum (:536-562), update_vbv (:924-957),
  update_vbv_plan (:959-966).
- Per-row VBV (x264_ratecontrol_mb :651-780): row size predictors
  (:599-645), intra-frame QP steps and the row re-encode signal,
  driven per slice-band row from device row SATD/bits tensors
  (row_vbv_adjust / row_vbv_commit below).

Copied from x264dsp_tpu/encoder/ratecontrol.py
so that the port imports nothing of the JAX package; only the import
lines differ, and the device function aq_offsets (ratecontrol.py:619-645)
is ported to PyTorch below, with the reference's float32 log2
(log2_f32) so that the per-MB QPs come out the same.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import params as P


def qp2qscale(qp: float) -> float:
    return 0.85 * 2.0 ** ((qp - 12.0) / 6.0)


def qscale2qp(qscale: float) -> float:
    return 12.0 + 6.0 * math.log2(qscale / 0.85)


class _Predictor:
    """Frame-size predictor: bits ≈ (coeff·satd + offset)/(q·count)
    (ratecontrol.c:444-448 init, :897-921 update)."""

    def __init__(self, coeff=2.0, coeff_min=0.5):
        self.coeff = coeff
        self.coeff_min = coeff_min
        self.count = 1.0
        self.decay = 0.5
        self.offset = 0.0

    def predict(self, q: float, var: float) -> float:
        return (self.coeff * var + self.offset) / (q * self.count)

    def update(self, q: float, var: float, bits: float):
        if var < 10:
            return
        rng = 1.5
        old_coeff = self.coeff / self.count
        new_coeff = max(bits * q / var, self.coeff_min)
        new_coeff_clipped = float(np.clip(new_coeff, old_coeff / rng,
                                          old_coeff * rng))
        new_offset = bits * q - new_coeff_clipped * var
        if new_offset >= 0:
            new_coeff = new_coeff_clipped
        else:
            new_offset = 0.0
        self.count *= self.decay
        self.coeff *= self.decay
        self.offset *= self.decay
        self.count += 1
        self.coeff += new_coeff
        self.offset += new_offset


class RateControl:
    def __init__(self, param: P.Param, mb_count: int):
        p = param
        self.param = p
        self.b_abr = p.rc.i_rc_method != P.RC_CQP
        self.fps = (p.i_fps_num / p.i_fps_den
                    if p.i_fps_num > 0 and p.i_fps_den > 0 else 25.0)
        self.qcompress = p.rc.f_qcompress
        self.bitrate = p.rc.i_bitrate * 1000.0
        self.rate_tolerance = max(p.rc.f_rate_tolerance, 0.01)
        self.nmb = mb_count
        self.cbr_decay = 1.0

        # CRF-max: don't allow the effective rate factor above
        # f_rf_constant_max (ratecontrol.c:347-354; caps row/frame QP at
        # qp_novbv + increment, :692-693 and :974-975)
        self.rate_factor_max_increment = 0.0
        if p.rc.i_rc_method == P.RC_CRF:
            base_cplx = mb_count * 80  # no B-frames in the fork
            self.rate_factor_constant = (
                base_cplx ** (1 - self.qcompress)
                / qp2qscale(p.rc.f_rf_constant))
            if p.rc.f_rf_constant_max:
                inc = p.rc.f_rf_constant_max - p.rc.f_rf_constant
                if inc <= 0:
                    P.x264_log(p, P.LOG_WARNING,
                               "CRF max must be greater than CRF\n")
                    inc = 0.0
                self.rate_factor_max_increment = inc

        self.abr_init_qp = (p.rc.f_rf_constant
                            if p.rc.i_rc_method == P.RC_CRF else 24)
        if self.b_abr:
            self.accum_p_norm = 0.01
            self.accum_p_qp = self.abr_init_qp * self.accum_p_norm
            self.cplxr_sum = (0.01 * (7.0e5 ** self.qcompress)
                              * (mb_count ** 0.5))
            self.wanted_bits_window = self.bitrate / self.fps
        else:
            self.accum_p_norm = 0.0
            self.accum_p_qp = 0.0
            self.cplxr_sum = 0.0
            self.wanted_bits_window = 0.0

        self.ip_offset = 6.0 * math.log2(p.rc.f_ip_factor)
        self.pb_offset = 6.0 * math.log2(p.rc.f_pb_factor)
        self.qp_constant = {
            P.SLICE_TYPE_P: p.rc.i_qp_constant,
            P.SLICE_TYPE_I: int(np.clip(
                p.rc.i_qp_constant - self.ip_offset + 0.5, 0, P.QP_MAX)),
        }
        self.lstep = 2.0 ** (p.rc.i_qp_step / 6.0)
        self.last_qscale = qp2qscale(26)
        self.last_qscale_for = {t: qp2qscale(self.abr_init_qp)
                                for t in (P.SLICE_TYPE_I, P.SLICE_TYPE_P)}
        self.lmin = {t: qp2qscale(p.rc.i_qp_min)
                     for t in (P.SLICE_TYPE_I, P.SLICE_TYPE_P)}
        self.lmax = {t: qp2qscale(p.rc.i_qp_max)
                     for t in (P.SLICE_TYPE_I, P.SLICE_TYPE_P)}

        # ---- VBV (init_reconfigurable, ratecontrol.c:319-369) ----
        self.b_vbv = False
        self.b_vbv_min_rate = False
        self.single_frame_vbv = False
        self.buffer_size = 0.0
        self.buffer_rate = 0.0
        self.vbv_max_rate = 0.0
        # (type, satd) of the frames buffered behind the current one —
        # i_planned_type/i_planned_satd (frame.h:148-150) for the
        # lookahead VBV planner in _clip_qscale
        self.planned: list[tuple[int, int]] = []
        self.buffer_fill_final = 0.0   # bits (the C stores ×time_scale)
        self.buffer_fill = 0.0
        self.qp_novbv = 0.0
        self.frame_size_maximum = 1e9
        self.frame_size_planned = 0.0
        self.pred = {t: _Predictor()
                     for t in (P.SLICE_TYPE_I, P.SLICE_TYPE_P)}
        # per-row VBV (x264_ratecontrol_mb): [0] main row predictor,
        # [1] intra fallback (row_preds init, ratecontrol.c:454-461)
        self.row_pred = {t: [_Predictor(coeff=0.25, coeff_min=0.25 / 4),
                             _Predictor(coeff=0.25, coeff_min=0.25 / 4)]
                         for t in (P.SLICE_TYPE_I, P.SLICE_TYPE_P)}
        # previous frame's row data (f_row_qp/qscale, i_row_satd/bits)
        self.prev_row = None
        if p.rc.i_vbv_max_bitrate > 0 and p.rc.i_vbv_buffer_size > 0:
            vbv_buffer_size = p.rc.i_vbv_buffer_size
            if vbv_buffer_size < int(p.rc.i_vbv_max_bitrate / self.fps):
                vbv_buffer_size = int(p.rc.i_vbv_max_bitrate / self.fps)
            self.buffer_size = vbv_buffer_size * 1000.0
            self.vbv_max_rate = p.rc.i_vbv_max_bitrate * 1000.0
            self.buffer_rate = self.vbv_max_rate / self.fps
            self.single_frame_vbv = self.buffer_rate * 1.1 > self.buffer_size
            self.cbr_decay = (1.0 - self.buffer_rate / self.buffer_size
                              * 0.5 * max(0.0, 1.5 - self.buffer_rate
                                          * self.fps / max(self.bitrate, 1.0)))
            binit = p.rc.f_vbv_buffer_init
            if binit > 1.0:
                binit = float(np.clip(binit / p.rc.i_vbv_buffer_size, 0, 1))
            binit = float(np.clip(max(binit,
                                      self.buffer_rate / self.buffer_size),
                                  0, 1))
            self.buffer_fill_final = self.buffer_size * binit
            self.b_vbv = True
            self.b_vbv_min_rate = (
                p.rc.i_rc_method == P.RC_ABR
                and p.rc.i_vbv_max_bitrate <= p.rc.i_bitrate)
        # CBR-HRD filler mode (set.h:161, update_vbv :945-952)
        self.b_cbr_hrd = p.i_nal_hrd == P.NAL_HRD_CBR
        self._mincr_level = next(
            (l for l in P.LEVELS if l.level_idc == p.i_level_idc), None)

        self.short_term_cplxsum = 0.0
        self.short_term_cplxcount = 0.0
        self.last_non_b_pict_type = P.SLICE_TYPE_I if self.b_abr else -1
        self.total_bits = 0
        self.i_frame = 0
        self.last_satd = 0
        self.last_rceq = 1.0
        self.qpa_rc = 0.0
        self.qpm = 0.0

    # ------------------------------------------------------------------
    def _get_qscale(self, blurred_complexity: float, rate_factor: float,
                    pict_type: int) -> float:
        """get_qscale (ratecontrol.c:868-905)."""
        q = blurred_complexity ** (1 - self.qcompress)
        if not math.isfinite(q) or self.last_satd == 0:
            return self.last_qscale_for[pict_type]
        self.last_rceq = q
        q /= rate_factor
        self.last_qscale = q
        return q

    def _rate_estimate_qscale(self, pict_type: int, frame_satd: int) -> float:
        """rate_estimate_qscale (ratecontrol.c:1108-1230), no-VBV path."""
        p = self.param
        abr_buffer = 2 * self.rate_tolerance * self.bitrate
        overflow = 1.0

        self.last_satd = frame_satd
        self.short_term_cplxsum *= 0.5
        self.short_term_cplxcount *= 0.5
        self.short_term_cplxsum += frame_satd
        self.short_term_cplxcount += 1
        blurred = self.short_term_cplxsum / self.short_term_cplxcount

        if p.rc.i_rc_method == P.RC_CRF:
            q = self._get_qscale(blurred, self.rate_factor_constant,
                                 pict_type)
        else:
            q = self._get_qscale(
                blurred, self.wanted_bits_window / self.cplxr_sum, pict_type)
            # ABR overflow control is counterproductive in CBR (:1165)
            if self.last_satd and not self.b_vbv_min_rate:
                i_frame_done = self.i_frame
                time_done = i_frame_done / self.fps
                wanted_bits = time_done * self.bitrate
                if wanted_bits > 0:
                    abr_buffer *= max(1.0, math.sqrt(time_done))
                    overflow = float(np.clip(
                        1.0 + (self.total_bits - wanted_bits) / abr_buffer,
                        0.5, 2.0))
                    q *= overflow

        if (pict_type == P.SLICE_TYPE_I and p.i_keyint_max > 1
                and self.last_non_b_pict_type != P.SLICE_TYPE_I):
            q = qp2qscale(self.accum_p_qp / self.accum_p_norm)
            q /= abs(p.rc.f_ip_factor)
        elif self.i_frame > 0:
            if p.rc.i_rc_method != P.RC_CRF:
                lmin = self.last_qscale_for[pict_type] / self.lstep
                lmax = self.last_qscale_for[pict_type] * self.lstep
                if overflow > 1.1 and self.i_frame > 3:
                    lmax *= self.lstep
                elif overflow < 0.9:
                    lmin /= self.lstep
                q = float(np.clip(q, lmin, lmax))
        elif p.rc.i_rc_method == P.RC_CRF and self.qcompress != 1:
            q = qp2qscale(self.abr_init_qp) / abs(p.rc.f_ip_factor)

        self.qp_novbv = qscale2qp(q) if q > 0 else 0.0
        q = self._clip_qscale(pict_type, q)

        self.last_qscale_for[pict_type] = self.last_qscale = q
        if self.i_frame == 0:
            self.last_qscale_for[P.SLICE_TYPE_P] = q * abs(p.rc.f_ip_factor)

        # frame_size_planned (:1220-1228)
        self.frame_size_planned = self.pred[pict_type].predict(
            q, self.last_satd)
        if self.single_frame_vbv:
            self.frame_size_planned = self.buffer_rate
        if self.b_vbv:
            self.frame_size_planned = min(self.frame_size_planned,
                                          self.frame_size_maximum)
        return q

    def _clip_qscale(self, pict_type: int, q: float) -> float:
        """clip_qscale (ratecontrol.c:968-1106): lmin/lmax plus both VBV
        paths — the lookahead planner over the buffered frame queue
        (:979-1038, active when rc_lookahead > 0 and the encoder holds
        delayed frames) and the reactive no-lookahead fallback
        (:1040-1060, the fork default rc_lookahead=0)."""
        lmin = self.lmin[pict_type]
        lmax = self.lmax[pict_type]
        if self.rate_factor_max_increment:
            # CRF-max cap (ratecontrol.c:974-975)
            lmax = min(lmax, qp2qscale(self.qp_novbv
                                       + self.rate_factor_max_increment))
        q0 = q
        if self.b_vbv and self.last_satd > 0:
            if self.param.rc.i_lookahead and self.planned:
                # Lookahead VBV: raise q until no planned frame overflows
                # and the buffer ends the window in a reasonable state
                # (ratecontrol.c:985-1038). Planned types/satd come from
                # the slicetype decisions of the queued frames
                # (i_planned_type/i_planned_satd, frame.h:148-150);
                # durations are 1/fps (CFR input, pic_struct progressive).
                dur = 1.0 / self.fps
                terminate = 0
                for _ in range(1000):
                    if terminate == 3:
                        break
                    cur_bits = self.pred[pict_type].predict(
                        q, self.last_satd)
                    buffer_fill_cur = self.buffer_fill - cur_bits
                    total_duration = 0.0
                    # frame_q indexed by slice type (P=0, B=1, I=2)
                    q_p = (q * self.param.rc.f_ip_factor
                           if pict_type == P.SLICE_TYPE_I else q)
                    frame_q = {
                        P.SLICE_TYPE_P: q_p,
                        P.SLICE_TYPE_I: q_p / self.param.rc.f_ip_factor,
                    }
                    for (i_type, i_satd) in self.planned:
                        if not (0 <= buffer_fill_cur <= self.buffer_size):
                            break
                        total_duration += dur
                        buffer_fill_cur += self.vbv_max_rate * dur
                        buffer_fill_cur -= self.pred[i_type].predict(
                            frame_q[i_type], i_satd)
                    # buffer at least 50% filled, no impossible goals
                    target_fill = min(
                        self.buffer_fill
                        + total_duration * self.vbv_max_rate * 0.5,
                        self.buffer_size * 0.5)
                    if buffer_fill_cur < target_fill:
                        q *= 1.01
                        terminate |= 1
                        continue
                    # buffer no more than 80% filled
                    target_fill = float(np.clip(
                        self.buffer_fill
                        - total_duration * self.vbv_max_rate * 0.5,
                        self.buffer_size * 0.8, self.buffer_size))
                    if self.b_vbv_min_rate and buffer_fill_cur > target_fill:
                        q /= 1.01
                        terminate |= 2
                        continue
                    break
            else:
                # purely-reactive algorithm, no lookahead
                if ((pict_type == P.SLICE_TYPE_P
                     or (pict_type == P.SLICE_TYPE_I
                         and self.last_non_b_pict_type == P.SLICE_TYPE_I))
                        and self.buffer_fill / self.buffer_size < 0.5):
                    q /= float(np.clip(
                        2.0 * self.buffer_fill / self.buffer_size,
                        0.5, 1.0))
                bits = self.pred[pict_type].predict(q, self.last_satd)
                # hard threshold so the frame fits in VBV (mostly I frames)
                max_fill_factor = (
                    2.0 if self.buffer_size >= 5 * self.buffer_rate else 1.0)
                min_fill_factor = 1.0 if self.single_frame_vbv else 2.0
                if bits > self.buffer_fill / max_fill_factor:
                    qf = float(np.clip(
                        self.buffer_fill / (max_fill_factor * bits),
                        0.2, 1.0))
                    q /= qf
                    bits *= qf
                if bits < self.buffer_rate / min_fill_factor:
                    q *= bits * min_fill_factor / self.buffer_rate
                q = max(q0, q)

            # MinCR restriction (:1064-1067)
            bits = self.pred[pict_type].predict(q, self.last_satd)
            if bits > self.frame_size_maximum:
                q *= bits / self.frame_size_maximum
            bits = self.pred[pict_type].predict(q, self.last_satd)

            # use up bits that would overflow before the next P (:1072-1096,
            # nb=0 without B-frames)
            if pict_type == P.SLICE_TYPE_P and not self.single_frame_vbv:
                space = (self.buffer_fill + self.buffer_rate
                         - self.buffer_size)
                if bits < space:
                    q *= max(bits / space, bits / (0.5 * self.buffer_size))
                q = max(q0 / 2, q)

            if not self.b_vbv_min_rate:
                q = max(q0, q)

        if lmin == lmax:
            return lmin
        return float(np.clip(q, lmin, lmax))

    def frame_size_limit(self) -> float:
        """Hard per-frame bit ceiling for the in-band re-encode path:
        the MinCR frame-size maximum (ratecontrol.c:536-562) and VBV
        underflow avoidance (the row re-encode trigger of :756-780 at
        frame granularity — actual slice size replaces row predictors)."""
        limit = self.frame_size_maximum
        if self.b_vbv:
            limit = min(limit, self.buffer_fill)
        return max(limit, 1.0)

    # ---- per-row VBV (x264_ratecontrol_mb, ratecontrol.c:599-780) ----
    def _predict_row_size(self, pred0, pred1, pict_type, row_satd, y,
                          qscale):
        """predict_row_size (:599-626): average of the SATD predictor
        and the colocated previous-frame row scaled by satd and qscale
        ratios; intra fallback when our QP undercuts the reference's."""
        prev = self.prev_row
        pred_s = pred0.predict(qscale, row_satd[y])
        if (pict_type == P.SLICE_TYPE_I or prev is None
                or qscale >= prev["qscale"][y]):
            if (pict_type == P.SLICE_TYPE_P and prev is not None
                    and prev["type"] == pict_type
                    and prev["qscale"][y] > 0 and prev["satd"][y] > 0
                    and abs(prev["satd"][y] - row_satd[y])
                    < row_satd[y] / 2):
                pred_t = (prev["bits"][y] * row_satd[y] / prev["satd"][y]
                          * prev["qscale"][y] / qscale)
                return (pred_s + pred_t) * 0.5
            return pred_s
        return pred1.predict(qscale, row_satd[y]) + pred_s

    def row_vbv_adjust(self, pict_type, row_qp, row_bits, row_satd):
        """One simulated walk of the reference's end-of-row QP-step
        loops (:651-780) over MEASURED row bits at the current per-row
        QP ramp. The device encodes whole frames, so instead of
        re-encoding from the violating row mid-stream, the caller
        re-encodes the frame with the returned ramp and iterates to a
        fixed point. Predictors adapt on a scratch copy (the real ones
        update once per final frame in row_vbv_commit). Returns the new
        integer per-row QP ramp, or None when the walk changes nothing."""
        if not self.b_vbv or len(row_bits) < 2:
            return None
        import copy
        p = self.param
        pred0 = copy.deepcopy(self.row_pred[pict_type][0])
        pred1 = copy.deepcopy(self.row_pred[pict_type][1])
        n = len(row_bits)
        new_qp = np.asarray(row_qp, np.float64).copy()
        prev = self.prev_row
        buffer_left_planned = self.buffer_fill - self.frame_size_planned
        slice_size_planned = self.frame_size_planned
        max_frame_error = max(0.05, 1.0 / n)
        bits_so_far = 0.0
        for y in range(n - 1):
            qpm = float(new_qp[y])
            qs_y = qp2qscale(qpm)
            pred0.update(qs_y, row_satd[y], row_bits[y])
            if (pict_type == P.SLICE_TYPE_P and prev is not None
                    and qpm < prev["qp"][y]):
                pred1.update(qs_y, row_satd[y], row_bits[y])
            bits_so_far += row_bits[y]

            prev_row_qp = qpm
            qp_absolute_max = float(p.rc.i_qp_max)
            if self.rate_factor_max_increment:
                # CRF-max cap on the row walk (ratecontrol.c:692-693)
                qp_absolute_max = min(
                    qp_absolute_max,
                    self.qp_novbv + self.rate_factor_max_increment)
            qp_max = min(prev_row_qp + p.rc.i_qp_step, qp_absolute_max)
            qp_min = max(prev_row_qp - p.rc.i_qp_step,
                         float(p.rc.i_qp_min))
            step = 0.5
            rc_tol = buffer_left_planned * self.rate_tolerance

            def b1_at(q, y=y):
                qs = qp2qscale(q)
                return bits_so_far + sum(
                    self._predict_row_size(pred0, pred1, pict_type,
                                           row_satd, i, qs)
                    for i in range(y + 1, n))

            b1 = b1_at(qpm)
            if bits_so_far < 0.05 * slice_size_planned:
                qp_max = qp_absolute_max = prev_row_qp
            if pict_type != P.SLICE_TYPE_I:
                rc_tol *= 0.5
            if not self.b_vbv_min_rate:
                qp_min = max(qp_min, self.qp_novbv)
            while (qpm < qp_max
                   and ((b1 > self.frame_size_planned + rc_tol)
                        or (self.buffer_fill - b1
                            < buffer_left_planned * 0.5)
                        or (b1 > self.frame_size_planned
                            and qpm < self.qp_novbv))):
                qpm += step
                b1 = b1_at(qpm)
            while (qpm > qp_min
                   and (qpm > new_qp[0] or self.single_frame_vbv)
                   and ((b1 < self.frame_size_planned * 0.8
                         and qpm <= prev_row_qp)
                        or b1 < (self.buffer_fill - self.buffer_size
                                 + self.buffer_rate) * 1.1)):
                qpm -= step
                b1 = b1_at(qpm)
            # avoid VBV underflow / MinCR violation (:746-752)
            while (qpm < qp_absolute_max
                   and ((self.buffer_fill - b1
                         < self.buffer_rate * max_frame_error)
                        or (self.frame_size_maximum - b1
                            < self.frame_size_maximum
                            * max_frame_error))):
                qpm += step
                b1 = b1_at(qpm)
            new_qp[y + 1:] = qpm
        ramp = np.clip(np.round(new_qp), p.rc.i_qp_min,
                       p.rc.i_qp_max).astype(np.int32)
        if np.array_equal(ramp, np.asarray(row_qp, np.int32)):
            return None
        return ramp

    def row_vbv_commit(self, pict_type, row_qp, row_bits, row_satd):
        """End-of-frame predictor update + previous-frame row snapshot
        (the :675-681 updates, once per FINAL encode of the frame)."""
        n = len(row_bits)
        qscales = np.array([qp2qscale(float(q)) for q in row_qp])
        prev = self.prev_row
        for y in range(n):
            self.row_pred[pict_type][0].update(qscales[y], row_satd[y],
                                               row_bits[y])
            if (pict_type == P.SLICE_TYPE_P and prev is not None
                    and row_qp[y] < prev["qp"][y]):
                self.row_pred[pict_type][1].update(
                    qscales[y], row_satd[y], row_bits[y])
        self.prev_row = {"type": pict_type,
                         "qp": np.asarray(row_qp, np.float64),
                         "qscale": qscales,
                         "satd": np.asarray(row_satd, np.float64),
                         "bits": np.asarray(row_bits, np.float64)}

    def _update_vbv_plan(self, overhead: float):
        """update_vbv_plan (ratecontrol.c:959-966)."""
        self.buffer_fill = min(self.buffer_fill_final, self.buffer_size)
        self.buffer_fill -= overhead

    def _update_vbv(self, pict_type: int, bits: int) -> int:
        """update_vbv (ratecontrol.c:924-957). Returns the CBR-HRD
        filler payload size in bytes (0 unless i_nal_hrd == CBR and the
        buffer would overflow, :945-952)."""
        filler = 0
        if self.last_satd >= self.nmb:
            self.pred[pict_type].update(qp2qscale(self.qpa_rc),
                                        self.last_satd, bits)
        if not self.b_vbv:
            return filler
        self.buffer_fill_final -= bits
        self.buffer_fill_final = max(self.buffer_fill_final, 0.0)
        self.buffer_fill_final += self.buffer_rate
        if self.b_cbr_hrd and self.buffer_fill_final > self.buffer_size:
            filler = int(math.ceil(
                (self.buffer_fill_final - self.buffer_size) / 8.0))
            # FILLER_OVERHEAD = NALU_OVERHEAD + 1 (common/common.h:59-60)
            fbits = max(6 - self.param.b_annexb, filler) * 8
            self.buffer_fill_final -= fbits
        else:
            self.buffer_fill_final = min(self.buffer_fill_final,
                                         self.buffer_size)
        return filler

    # ------------------------------------------------------------------
    def start(self, pict_type: int, frame_satd: int,
              overhead: float = 0.0,
              planned: list[tuple[int, int]] | None = None) -> int:
        """x264_ratecontrol_start (:518-600). Returns the frame QP.
        planned = (type, satd) of the still-queued lookahead frames,
        consumed by _clip_qscale's lookahead VBV planner."""
        p = self.param
        self.planned = planned or []
        if self.b_vbv:
            self._update_vbv_plan(overhead)
            # MinCR frame-size ceiling from the H.264 level (:536-562)
            l = self._mincr_level
            if l is not None:
                if self.i_frame == 0:
                    pic_mbs = self.nmb
                    self.frame_size_maximum = (
                        384 * 8 * max(pic_mbs, l.mbps / 172.0) / l.mincr)
                else:
                    self.frame_size_maximum = (
                        384 * 8 * (1.0 / self.fps) * l.mbps / l.mincr)
        if self.b_abr:
            q = qscale2qp(self._rate_estimate_qscale(pict_type, frame_satd))
        else:
            q = float(self.qp_constant[pict_type])
        q = float(np.clip(q, p.rc.i_qp_min, p.rc.i_qp_max))
        self.qpm = q
        self.qpa_rc = q  # constant over the frame until per-MB QP lands
        # accum_p_qp_update (:505-516)
        self.accum_p_qp *= 0.95
        self.accum_p_norm *= 0.95
        self.accum_p_norm += 1
        self.accum_p_qp += q + (self.ip_offset
                                if pict_type == P.SLICE_TYPE_I else 0)
        self.last_non_b_pict_type = pict_type
        return int(np.clip(q + 0.5, 0, P.QP_MAX))

    def end(self, pict_type: int, bits: int) -> int:
        """x264_ratecontrol_end (:813-860) + update_vbv, frame-level.
        Returns the CBR-HRD filler size in bytes (0 when none due)."""
        if self.b_abr:
            self.cplxr_sum += bits * qp2qscale(self.qpa_rc) / self.last_rceq
            self.cplxr_sum *= self.cbr_decay
            self.wanted_bits_window += self.bitrate / self.fps
            self.wanted_bits_window *= self.cbr_decay
        filler = self._update_vbv(pict_type, bits)
        self.total_bits += bits
        self.i_frame += 1
        return filler

    def hrd_fullness(self, sps) -> tuple:
        """x264_hrd_fullness analog: (initial_cpb_removal_delay,
        initial_cpb_removal_delay_offset) in 90 kHz ticks for the
        buffering-period SEI, from the current CPB fill."""
        bitrate = float(sps.hrd_bit_rate_unscaled) or 1.0
        cpb_size = float(sps.hrd_cpb_size_unscaled)
        fill = float(np.clip(self.buffer_fill_final, 0.0, cpb_size))
        delay = int(round(90000.0 * fill / bitrate))
        offset = int(round(90000.0 * (cpb_size - fill) / bitrate))
        return delay, offset


# float32 constants of log2_f32: the Cephes log polynomial (p0..p8), the
# split ln 2 (q1 + q2) and 1 / ln 2
_LOG_P = tuple(float(np.float32(v)) for v in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = float(np.float32(0.693359375))
_SQRTHF = float(np.float32(0.707106781186547524))
_LOG2E = float(np.float32(1.44269502))


def _fma(a, b, c):
    """a * b + c rounded once to float32 (a, b float32; a product of two
    float32 values is exact in float64). Checked against the fused
    multiply-add over every input log2_f32 can get from aq_offsets."""
    return (a.double() * b + c).float()


def log2_f32(x):
    """log2 of a positive float32 tensor as the JAX package computes it on
    the CPU, bit for bit: jnp.log2 is log(x) * float32(1 / ln 2), and
    XLA's CPU log is Cephes' polynomial over the mantissa in
    [sqrt(1/2), sqrt(2)) with fused multiply-adds. torch.log2 differs from
    it by one ulp on about a fifth of the integers below 2**23, enough to
    move a variance-AQ QP across a rounding edge. Plain float32 / float64
    operations, so the CPU and the card give the same bits."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7f).float() + 1.0
    m = ((bits & ~0x7f800000) | 0x3f000000).view(torch.float32)
    low = m < _SQRTHF
    m = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.float()
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    m = _fma(x2, -0.5, m) + y
    return _fma(e, _LOG_Q2, m) * _LOG2E


def aq_offsets(fenc_y, fenc_u, fenc_v, strength: float, mb_w: int,
               mb_h: int):
    """Variance-AQ per-MB QP offsets — port of ratecontrol.py:619-645
    aq_offsets (x264_adaptive_quant_frame, ratecontrol.c:192-300), plain
    PyTorch on the planes' device: energy = AC energy of the 16x16 luma
    block (shift 8) + both 8x8 chroma blocks (shift 6), exact in int64;
    offset = strength·1.0397·(log2(max(energy, 1)) − 14.427) in float32,
    the reference's dtype at every step (its Python scalars are weak), with
    the reference's log2 (log2_f32). fenc_*: the padded (H, W) planes.
    Returns (mb_h, mb_w) float32."""
    def energy(plane, size, shift):
        blk = plane.to(torch.int64).reshape(mb_h, size, mb_w, size)
        s = blk.sum((1, 3))
        return (blk * blk).sum((1, 3)) - ((s * s) >> shift)

    return energy_offsets((energy(fenc_y, 16, 8) + energy(fenc_u, 8, 6)
                           + energy(fenc_v, 8, 6)).clamp(min=1), strength)


def energy_offsets(energy, strength: float):
    """aq_offsets' QP offsets of integer AC energies (>= 1):
    strength·1.0397·(log2(energy) − 14.427), float32 at every step."""
    return (log2_f32(energy.to(torch.float32)) - float(np.float32(14.427))) \
        * float(np.float32(strength * 1.0397))
