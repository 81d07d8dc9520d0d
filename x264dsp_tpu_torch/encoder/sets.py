"""SPS / PPS construction and serialization.

Mirrors encoder/set.c: x264_sps_init (:71), x264_sps_write (:245),
x264_pps_init (:400), x264_pps_write (:467). Field derivations follow the
reference exactly so headers are byte-identical for the shared feature set
(flat CQM, 4:2:0, 8-bit, progressive).

Copied from x264dsp_tpu/encoder/sets.py
so that the port imports nothing of the JAX package; only the import
lines differ.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .. import params as P
from ..entropy.bitstream import BitWriter


@dataclass
class SPS:
    i_id: int = 0
    i_profile_idc: int = P.PROFILE_BASELINE
    i_level_idc: int = 0
    b_constraint_set0: int = 0
    b_constraint_set1: int = 0
    b_constraint_set2: int = 0
    b_constraint_set3: int = 0
    i_log2_max_frame_num: int = 4
    i_poc_type: int = 2
    i_log2_max_poc_lsb: int = 4
    i_num_ref_frames: int = 1
    b_gaps_in_frame_num_value_allowed: int = 0
    i_mb_width: int = 0
    i_mb_height: int = 0
    b_frame_mbs_only: int = 1
    b_mb_adaptive_frame_field: int = 0
    b_direct8x8_inference: int = 1
    b_crop: int = 0
    crop: tuple = (0, 0, 0, 0)  # left, right, top, bottom
    i_chroma_format_idc: int = P.CHROMA_420
    b_qpprime_y_zero_transform_bypass: int = 0

    b_vui: int = 1
    vui_sar: tuple = (0, 0)
    vui_overscan_present: int = 0
    vui_overscan: int = 0
    vui_signal_type_present: int = 0
    vui_vidformat: int = 5
    vui_fullrange: int = 0
    vui_color_description_present: int = 0
    vui_colorprim: int = 2
    vui_transfer: int = 2
    vui_colmatrix: int = 2
    vui_chroma_loc_present: int = 0
    vui_chroma_loc: int = 0
    vui_timing_info_present: int = 0
    vui_num_units_in_tick: int = 0
    vui_time_scale: int = 0
    vui_fixed_frame_rate: int = 0
    vui_nal_hrd_present: int = 0
    vui_pic_struct_present: int = 0
    vui_bitstream_restriction: int = 1
    vui_mv_over_bounds: int = 1
    vui_log2_max_mv_length: int = 9
    vui_num_reorder_frames: int = 0
    vui_max_dec_frame_buffering: int = 1

    # NAL HRD (common/set.h:146-165; the fork keeps the SPS write path
    # at set.c:359-375 but dropped the scale derivation — recomputed
    # here so i_nal_hrd produces a conformant stream)
    hrd_cpb_cnt: int = 1
    hrd_bit_rate_scale: int = 0
    hrd_cpb_size_scale: int = 0
    hrd_bit_rate_value: int = 0
    hrd_cpb_size_value: int = 0
    hrd_bit_rate_unscaled: int = 0
    hrd_cpb_size_unscaled: int = 0
    hrd_cbr: int = 0
    hrd_initial_cpb_removal_delay_length: int = 24
    hrd_cpb_removal_delay_length: int = 24
    hrd_dpb_output_delay_length: int = 24
    hrd_time_offset_length: int = 0

    @staticmethod
    def init(param: P.Param, i_id: int = 0) -> "SPS":
        """x264_sps_init (encoder/set.c:71-243)."""
        sps = SPS()
        sps.i_id = i_id
        sps.i_mb_width = (param.i_width + 15) >> 4
        sps.i_mb_height = (param.i_height + 15) >> 4
        sps.i_chroma_format_idc = P.CHROMA_420
        sps.b_qpprime_y_zero_transform_bypass = int(
            param.rc.i_rc_method == P.RC_CQP and param.rc.i_qp_constant == 0)

        # profile decision flow (set.c:83-104)
        if sps.b_qpprime_y_zero_transform_bypass:
            sps.i_profile_idc = P.PROFILE_HIGH444_PREDICTIVE
        elif param.analyse.b_transform_8x8 or param.i_cqm_preset != P.CQM_FLAT:
            sps.i_profile_idc = P.PROFILE_HIGH
        elif param.b_cabac or param.i_bframe > 0 or param.analyse.i_weighted_pred > 0:
            sps.i_profile_idc = P.PROFILE_MAIN
        else:
            sps.i_profile_idc = P.PROFILE_BASELINE

        sps.b_constraint_set0 = int(sps.i_profile_idc == P.PROFILE_BASELINE)
        sps.b_constraint_set1 = int(sps.i_profile_idc <= P.PROFILE_MAIN)
        sps.b_constraint_set2 = 0
        sps.b_constraint_set3 = 0

        sps.i_level_idc = param.i_level_idc
        if param.i_level_idc == 9 and sps.i_profile_idc in (
                P.PROFILE_BASELINE, P.PROFILE_MAIN):
            sps.b_constraint_set3 = 1
            sps.i_level_idc = 11
        if param.i_keyint_max == 1 and sps.i_profile_idc > P.PROFILE_HIGH:
            sps.b_constraint_set3 = 1

        sps.vui_num_reorder_frames = 1 if param.i_bframe else 0
        if param.i_bframe_pyramid:
            sps.vui_num_reorder_frames = 2
        sps.i_num_ref_frames = min(
            P.REF_MAX,
            max(param.i_frame_reference, 1 + sps.vui_num_reorder_frames,
                4 if param.i_bframe_pyramid else 1, param.i_dpb_size))
        sps.vui_max_dec_frame_buffering = sps.i_num_ref_frames
        if param.i_keyint_max == 1:
            sps.i_num_ref_frames = 0
            sps.vui_max_dec_frame_buffering = 0

        max_frame_num = sps.vui_max_dec_frame_buffering * (
            (1 if param.i_bframe_pyramid else 0) + 1) + 1
        if param.b_intra_refresh:
            # intra refresh cannot write a recovery time greater than
            # max_frame_num - 1 (set.c:138-143)
            time_to_recovery = min(sps.i_mb_width - 1,
                                   param.i_keyint_max) + param.i_bframe - 1
            max_frame_num = max(max_frame_num, time_to_recovery + 1)
        sps.i_log2_max_frame_num = 4
        while (1 << sps.i_log2_max_frame_num) <= max_frame_num:
            sps.i_log2_max_frame_num += 1

        sps.i_poc_type = 0 if param.i_bframe or param.b_interlaced else 2
        if sps.i_poc_type == 0:
            max_delta_poc = (param.i_bframe + 2) * (
                (1 if param.i_bframe_pyramid else 0) + 1) * 2
            sps.i_log2_max_poc_lsb = 4
            while (1 << sps.i_log2_max_poc_lsb) <= max_delta_poc * 2:
                sps.i_log2_max_poc_lsb += 1

        sps.b_vui = 1
        sps.b_frame_mbs_only = 1
        sps.b_mb_adaptive_frame_field = 0
        sps.b_direct8x8_inference = 1

        cl, ct, cr, cb = param.crop_rect
        crop_r = cr + sps.i_mb_width * 16 - param.i_width
        crop_b = cb + sps.i_mb_height * 16 - param.i_height
        sps.crop = (cl, crop_r, ct, crop_b)
        sps.b_crop = int(any(sps.crop))

        vui = param.vui
        if vui.i_sar_width > 0 and vui.i_sar_height > 0:
            sps.vui_sar = (vui.i_sar_width, vui.i_sar_height)
        sps.vui_overscan_present = int(0 < vui.i_overscan <= 2)
        sps.vui_overscan = int(vui.i_overscan == 2)
        sps.vui_vidformat = vui.i_vidformat if 0 <= vui.i_vidformat <= 5 else 5
        sps.vui_fullrange = vui.b_fullrange if 0 <= vui.b_fullrange <= 1 else 0
        sps.vui_colorprim = vui.i_colorprim if 0 <= vui.i_colorprim <= 8 else 2
        sps.vui_transfer = vui.i_transfer if 0 <= vui.i_transfer <= 10 else 2
        sps.vui_colmatrix = vui.i_colmatrix if 0 <= vui.i_colmatrix <= 8 else 2
        sps.vui_color_description_present = int(
            sps.vui_colorprim != 2 or sps.vui_transfer != 2
            or sps.vui_colmatrix != 2)
        sps.vui_signal_type_present = int(
            sps.vui_vidformat != 5 or sps.vui_fullrange
            or sps.vui_color_description_present)
        sps.vui_chroma_loc_present = int(0 < vui.i_chroma_loc <= 5)
        sps.vui_chroma_loc = vui.i_chroma_loc
        sps.vui_timing_info_present = int(
            param.i_timebase_num > 0 and param.i_timebase_den > 0)
        if sps.vui_timing_info_present:
            sps.vui_num_units_in_tick = param.i_timebase_num
            sps.vui_time_scale = param.i_timebase_den * 2
            sps.vui_fixed_frame_rate = int(not param.b_vfr_input)
        sps.vui_nal_hrd_present = int(bool(param.i_nal_hrd))
        if sps.vui_nal_hrd_present:
            # scale derivation (E.2.2): value * 2^(6+scale) == rate.
            # Largest scale that keeps the value exact (trailing-zero
            # count), clipped to the 4-bit field.
            bitrate = param.rc.i_vbv_max_bitrate * 1000
            bufsize = param.rc.i_vbv_buffer_size * 1000
            brs = min(max(_ctz(bitrate) - 6, 0), 15)
            cps = min(max(_ctz(bufsize) - 4, 0), 15)
            sps.hrd_bit_rate_scale = brs
            sps.hrd_cpb_size_scale = cps
            sps.hrd_bit_rate_value = bitrate >> (6 + brs)
            sps.hrd_cpb_size_value = bufsize >> (4 + cps)
            sps.hrd_bit_rate_unscaled = sps.hrd_bit_rate_value << (6 + brs)
            sps.hrd_cpb_size_unscaled = sps.hrd_cpb_size_value << (4 + cps)
            sps.hrd_cbr = int(param.i_nal_hrd == P.NAL_HRD_CBR)
        sps.vui_pic_struct_present = param.b_pic_struct
        sps.vui_bitstream_restriction = 1
        sps.vui_log2_max_mv_length = int(
            math.log2(max(1, param.analyse.i_mv_range * 4 - 1))) + 1
        return sps

    def write(self, bw: BitWriter) -> None:
        """x264_sps_write (encoder/set.c:245-398)."""
        bw.write(8, self.i_profile_idc)
        bw.write1(self.b_constraint_set0)
        bw.write1(self.b_constraint_set1)
        bw.write1(self.b_constraint_set2)
        bw.write1(self.b_constraint_set3)
        bw.write(4, 0)
        bw.write(8, self.i_level_idc)
        bw.write_ue(self.i_id)
        if self.i_profile_idc >= P.PROFILE_HIGH:
            bw.write_ue(self.i_chroma_format_idc)
            bw.write_ue(P.BIT_DEPTH - 8)
            bw.write_ue(P.BIT_DEPTH - 8)
            bw.write1(self.b_qpprime_y_zero_transform_bypass)
            bw.write1(0)
        bw.write_ue(self.i_log2_max_frame_num - 4)
        bw.write_ue(self.i_poc_type)
        if self.i_poc_type == 0:
            bw.write_ue(self.i_log2_max_poc_lsb - 4)
        bw.write_ue(self.i_num_ref_frames)
        bw.write1(self.b_gaps_in_frame_num_value_allowed)
        bw.write_ue(self.i_mb_width - 1)
        bw.write_ue(self.i_mb_height - 1)
        bw.write1(self.b_frame_mbs_only)
        if not self.b_frame_mbs_only:
            bw.write1(self.b_mb_adaptive_frame_field)
        bw.write1(self.b_direct8x8_inference)
        bw.write1(self.b_crop)
        if self.b_crop:
            h_shift = int(self.i_chroma_format_idc in (P.CHROMA_420, P.CHROMA_422))
            v_shift = int(self.i_chroma_format_idc == P.CHROMA_420)
            left, right, top, bottom = self.crop
            bw.write_ue(left >> h_shift)
            bw.write_ue(right >> h_shift)
            bw.write_ue(top >> v_shift)
            bw.write_ue(bottom >> v_shift)
        bw.write1(self.b_vui)
        if self.b_vui:
            self._write_vui(bw)
        bw.rbsp_trailing()

    def _write_vui(self, bw: BitWriter) -> None:
        sar_w, sar_h = self.vui_sar
        present = int(sar_w > 0 and sar_h > 0)
        bw.write1(present)
        if present:
            table = [(1, 1, 1), (12, 11, 2), (10, 11, 3), (16, 11, 4),
                     (40, 33, 5), (24, 11, 6), (20, 11, 7), (32, 11, 8),
                     (80, 33, 9), (18, 11, 10), (15, 11, 11), (64, 33, 12),
                     (160, 99, 13), (4, 3, 14), (3, 2, 15), (2, 1, 16)]
            idc = next((s for w, h, s in table if (w, h) == (sar_w, sar_h)), 255)
            bw.write(8, idc)
            if idc == 255:
                bw.write(16, sar_w)
                bw.write(16, sar_h)
        bw.write1(self.vui_overscan_present)
        if self.vui_overscan_present:
            bw.write1(self.vui_overscan)
        bw.write1(self.vui_signal_type_present)
        if self.vui_signal_type_present:
            bw.write(3, self.vui_vidformat)
            bw.write1(self.vui_fullrange)
            bw.write1(self.vui_color_description_present)
            if self.vui_color_description_present:
                bw.write(8, self.vui_colorprim)
                bw.write(8, self.vui_transfer)
                bw.write(8, self.vui_colmatrix)
        bw.write1(self.vui_chroma_loc_present)
        if self.vui_chroma_loc_present:
            bw.write_ue(self.vui_chroma_loc)
            bw.write_ue(self.vui_chroma_loc)
        bw.write1(self.vui_timing_info_present)
        if self.vui_timing_info_present:
            bw.write32(self.vui_num_units_in_tick)
            bw.write32(self.vui_time_scale)
            bw.write1(self.vui_fixed_frame_rate)
        bw.write1(self.vui_nal_hrd_present)
        if self.vui_nal_hrd_present:
            # hrd_parameters (set.c:360-375)
            bw.write_ue(self.hrd_cpb_cnt - 1)
            bw.write(4, self.hrd_bit_rate_scale)
            bw.write(4, self.hrd_cpb_size_scale)
            bw.write_ue(self.hrd_bit_rate_value - 1)
            bw.write_ue(self.hrd_cpb_size_value - 1)
            bw.write1(self.hrd_cbr)
            bw.write(5, self.hrd_initial_cpb_removal_delay_length - 1)
            bw.write(5, self.hrd_cpb_removal_delay_length - 1)
            bw.write(5, self.hrd_dpb_output_delay_length - 1)
            bw.write(5, self.hrd_time_offset_length)
        bw.write1(0)  # vcl_hrd_parameters_present (set.c:228)
        if self.vui_nal_hrd_present:
            bw.write1(0)  # low_delay_hrd_flag (set.c:380)
        bw.write1(self.vui_pic_struct_present)
        bw.write1(self.vui_bitstream_restriction)
        if self.vui_bitstream_restriction:
            bw.write1(self.vui_mv_over_bounds)
            bw.write_ue(0)  # max_bytes_per_pic_denom
            bw.write_ue(0)  # max_bits_per_mb_denom
            bw.write_ue(self.vui_log2_max_mv_length)
            bw.write_ue(self.vui_log2_max_mv_length)
            bw.write_ue(self.vui_num_reorder_frames)
            bw.write_ue(self.vui_max_dec_frame_buffering)


@dataclass
class PPS:
    i_id: int = 0
    i_sps_id: int = 0
    b_cabac: int = 0
    b_pic_order: int = 0
    i_num_slice_groups: int = 1
    i_num_ref_idx_l0_default_active: int = 1
    i_num_ref_idx_l1_default_active: int = 1
    b_weighted_pred: int = 0
    b_weighted_bipred: int = 0
    i_pic_init_qp: int = 26
    i_pic_init_qs: int = 26
    i_chroma_qp_index_offset: int = 0
    b_deblocking_filter_control: int = 1
    b_constrained_intra_pred: int = 0
    b_redundant_pic_cnt: int = 0
    b_transform_8x8_mode: int = 0
    i_cqm_preset: int = P.CQM_FLAT
    # 4x4 scaling lists in set order 4IY/4PY/4IC/4PC (set.h:61-64),
    # natural raster
    scaling_list: tuple = ()

    @staticmethod
    def init(param: P.Param, sps: SPS, i_id: int = 0) -> "PPS":
        """x264_pps_init (encoder/set.c:404-465)."""
        pps = PPS()
        pps.i_id = i_id
        pps.i_sps_id = sps.i_id
        pps.b_cabac = param.b_cabac
        pps.b_pic_order = 0
        pps.i_num_slice_groups = 1
        pps.i_num_ref_idx_l0_default_active = param.i_frame_reference
        pps.i_num_ref_idx_l1_default_active = 1
        pps.b_weighted_pred = int(param.analyse.i_weighted_pred > 0)
        pps.b_weighted_bipred = 2 if param.analyse.b_weighted_bipred else 0
        pps.i_pic_init_qp = (26 + P.QP_BD_OFFSET
                             if param.rc.i_rc_method == P.RC_ABR
                             else P.spec_qp(param.rc.i_qp_constant))
        pps.i_pic_init_qs = 26 + P.QP_BD_OFFSET
        pps.i_chroma_qp_index_offset = param.analyse.i_chroma_qp_offset
        pps.b_deblocking_filter_control = 1
        pps.b_constrained_intra_pred = param.b_constrained_intra
        pps.b_transform_8x8_mode = int(bool(param.analyse.b_transform_8x8))
        pps.i_cqm_preset = param.i_cqm_preset
        from ..ops.tables import CQM_FLAT_LISTS, CQM_JVT_LISTS
        if pps.i_cqm_preset == P.CQM_JVT:
            pps.scaling_list = CQM_JVT_LISTS
        elif pps.i_cqm_preset == P.CQM_CUSTOM:
            pps.scaling_list = (tuple(param.cqm_4iy), tuple(param.cqm_4py),
                                tuple(param.cqm_4ic), tuple(param.cqm_4pc))
        else:
            pps.scaling_list = CQM_FLAT_LISTS
        return pps

    def write(self, bw: BitWriter) -> None:
        """x264_pps_write (encoder/set.c:467-530), flat-CQM path."""
        bw.write_ue(self.i_id)
        bw.write_ue(self.i_sps_id)
        bw.write1(self.b_cabac)
        bw.write1(self.b_pic_order)
        bw.write_ue(self.i_num_slice_groups - 1)
        bw.write_ue(self.i_num_ref_idx_l0_default_active - 1)
        bw.write_ue(self.i_num_ref_idx_l1_default_active - 1)
        bw.write1(self.b_weighted_pred)
        bw.write(2, self.b_weighted_bipred)
        bw.write_se(self.i_pic_init_qp - 26 - P.QP_BD_OFFSET)
        bw.write_se(self.i_pic_init_qs - 26 - P.QP_BD_OFFSET)
        bw.write_se(self.i_chroma_qp_index_offset)
        bw.write1(self.b_deblocking_filter_control)
        bw.write1(self.b_constrained_intra_pred)
        bw.write1(self.b_redundant_pic_cnt)
        assert not self.b_transform_8x8_mode, "8x8 transform not supported"
        if self.i_cqm_preset != P.CQM_FLAT:
            # high-profile trailer (set.c:493-524, 4:2:0 / no-8x8 path)
            bw.write1(self.b_transform_8x8_mode)
            bw.write1(1)  # pic_scaling_matrix_present
            self._scaling_list_write(bw, 0)          # 4IY
            self._scaling_list_write(bw, 2)          # 4IC
            bw.write1(0)                             # Cr = Cb
            self._scaling_list_write(bw, 1)          # 4PY
            self._scaling_list_write(bw, 3)          # 4PC
            bw.write1(0)                             # Cr = Cb
            bw.write_se(self.i_chroma_qp_index_offset)
        bw.rbsp_trailing()

    def _scaling_list_write(self, bw: BitWriter, idx: int) -> None:
        """scaling_list_write (encoder/set.c:13-47), 4x4 lists only."""
        from ..ops.tables import CQM_JVT_LISTS, ZIGZAG_4x4
        lst = self.scaling_list[idx]
        # fallback list: the same-luma list for chroma, else JVT
        def_list = (self.scaling_list[0] if idx == 2
                    else self.scaling_list[1] if idx == 3
                    else CQM_JVT_LISTS[idx])
        if tuple(lst) == tuple(def_list):
            bw.write1(0)              # scaling_list_present_flag
            return
        bw.write1(1)
        if tuple(lst) == tuple(CQM_JVT_LISTS[idx]):
            bw.write_se(-8)           # use default (JVT) list
            return
        from ..entropy.bitstream import size_se

        def int8(x):
            return ((x + 128) & 255) - 128    # the reference's int8_t cast

        zz = [int(lst[i]) for i in ZIGZAG_4x4]
        # run-length compress trailing equal values (set.c:35-40); after
        # the loop zz[run-1..15] are all equal, so -zz[run] drives
        # nextScale to 0 and the decoder repeats lastScale
        run = 16
        while run > 1 and zz[run - 1] == zz[run - 2]:
            run -= 1
        if run < 16 and 16 - run < size_se(int8(-zz[run])):
            run = 16                           # truncation saves nothing
        for j in range(run):
            bw.write_se(int8(zz[j] - (zz[j - 1] if j > 0 else 8)))
        if run < 16:
            bw.write_se(int8(-zz[run]))


# ---------------------------------------------------------------------------
# SEI / filler writers (encoder/set.c:50-69, 528-760)
# ---------------------------------------------------------------------------

SEI_BUFFERING_PERIOD = 0
SEI_PIC_TIMING = 1
SEI_USER_DATA_UNREGISTERED = 5
SEI_RECOVERY_POINT = 6
SEI_DEC_REF_PIC_MARKING = 7
SEI_FRAME_PACKING = 45

# clock timestamp count per pic_struct (set.c:11)
NUM_CLOCK_TS = (0, 1, 1, 1, 2, 2, 3, 3, 2, 3)


def _ctz(x: int) -> int:
    """Count of trailing zero bits (x > 0)."""
    return (x & -x).bit_length() - 1


def write_sei(bw: BitWriter, payload: bytes, payload_type: int) -> None:
    """x264_sei_write (encoder/set.c:50-69): 255-escaped type and size,
    payload bytes, rbsp trailing."""
    t = payload_type
    while t >= 255:
        bw.write(8, 255)
        t -= 255
    bw.write(8, t)
    n = len(payload)
    while n >= 255:
        bw.write(8, 255)
        n -= 255
    bw.write(8, n)
    for b in payload:
        bw.write(8, b)
    bw.rbsp_trailing()


def _payload(inner: BitWriter) -> bytes:
    inner.align_10()
    return inner.get_bytes()


def sei_recovery_point_rbsp(recovery_frame_cnt: int) -> bytes:
    """x264_sei_recovery_point_write (set.c:528-545)."""
    q = BitWriter()
    q.write_ue(recovery_frame_cnt)
    q.write1(1)      # exact_match_flag
    q.write1(0)      # broken_link_flag
    q.write(2, 0)    # changing_slice_group
    bw = BitWriter()
    write_sei(bw, _payload(q), SEI_RECOVERY_POINT)
    return bw.get_bytes()


def sei_buffering_period_rbsp(sps: SPS, initial_cpb_removal_delay: int,
                              initial_cpb_removal_delay_offset: int) -> bytes:
    """x264_sei_buffering_period_write (set.c:577-597)."""
    q = BitWriter()
    q.write_ue(sps.i_id)
    if sps.vui_nal_hrd_present:
        L = sps.hrd_initial_cpb_removal_delay_length
        q.write(L, initial_cpb_removal_delay)
        q.write(L, initial_cpb_removal_delay_offset)
    bw = BitWriter()
    write_sei(bw, _payload(q), SEI_BUFFERING_PERIOD)
    return bw.get_bytes()


def sei_pic_timing_rbsp(sps: SPS, cpb_removal_delay: int,
                        dpb_output_delay: int, pic_struct: int = 1) -> bytes:
    """x264_sei_pic_timing_write (set.c:599-630)."""
    q = BitWriter()
    if sps.vui_nal_hrd_present:
        q.write(sps.hrd_cpb_removal_delay_length, cpb_removal_delay)
        q.write(sps.hrd_dpb_output_delay_length, dpb_output_delay)
    if sps.vui_pic_struct_present:
        q.write(4, pic_struct - 1)
        for _ in range(NUM_CLOCK_TS[pic_struct]):
            q.write1(0)  # clock_timestamp_flag
    bw = BitWriter()
    write_sei(bw, _payload(q), SEI_PIC_TIMING)
    return bw.get_bytes()


def sei_frame_packing_rbsp(frame_packing: int, is_frame0: bool) -> bytes:
    """x264_sei_frame_packing_write (set.c:632-668)."""
    quincunx = int(frame_packing == 0)
    q = BitWriter()
    q.write_ue(0)                    # arrangement_id
    q.write1(0)                      # cancel_flag
    q.write(7, frame_packing)        # arrangement_type
    q.write1(quincunx)
    q.write(6, 1)                    # content_interpretation_type
    q.write1(0)                      # spatial_flipping_flag
    q.write1(0)                      # frame0_flipped_flag
    q.write1(0)                      # field_views_flag
    q.write1(int(frame_packing == 5 and is_frame0))
    q.write1(0)                      # frame0_self_contained_flag
    q.write1(0)                      # frame1_self_contained_flag
    if quincunx == 0 and frame_packing != 5:
        for _ in range(4):
            q.write(4, 0)            # grid positions
    q.write(8, 0)                    # reserved byte
    q.write_ue(1)                    # repetition_period
    q.write1(0)                      # extension_flag
    bw = BitWriter()
    write_sei(bw, _payload(q), SEI_FRAME_PACKING)
    return bw.get_bytes()


def sei_dec_ref_pic_marking_rbsp(frame_num: int, mmco: list) -> bytes:
    """x264_sei_dec_ref_pic_marking_write (set.c:686-714);
    mmco: list of difference_of_pic_nums values."""
    q = BitWriter()
    q.write1(0)                      # original_idr_flag
    q.write_ue(frame_num)            # original_frame_num
    q.write1(int(bool(mmco)))
    if mmco:
        for diff in mmco:
            q.write_ue(1)
            q.write_ue(diff - 1)
        q.write_ue(0)
    bw = BitWriter()
    write_sei(bw, _payload(q), SEI_DEC_REF_PIC_MARKING)
    return bw.get_bytes()


def filler_rbsp(n_bytes: int) -> bytes:
    """x264_filler_write (set.c:671-683): n 0xff bytes + rbsp trailing."""
    return b"\xff" * n_bytes + b"\x80"
