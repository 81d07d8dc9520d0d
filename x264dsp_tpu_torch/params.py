"""Encoder parameters — the TPU-native equivalent of x264_param_t.

Mirrors the public parameter surface of the reference
(``common/x264.h:189-705``) and its fork-modified defaults
(``common/common.c:19-147``), normalized by :func:`validate_parameters`
(``encoder/encoder.c:15-409``).

This is a plain dataclass (config lives on host; device code receives only
the derived static ints it needs, so params never leak traced values into
jit).

Copied from x264dsp_tpu/params.py
so that the port imports nothing of the JAX package; only the import
lines differ.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

# ---------------------------------------------------------------------------
# Enum constants (common/x264.h:24-137). Values preserved exactly, including
# this fork's RC enum order (CQP=0, CRF=1, ABR=2 — x264.h:125-127).
# ---------------------------------------------------------------------------

NAL_UNKNOWN = 0
NAL_SLICE = 1
NAL_SLICE_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8
NAL_AUD = 9
NAL_FILLER = 12

# NAL HRD modes (common/x264.h:185-187)
NAL_HRD_NONE = 0
NAL_HRD_VBR = 1
NAL_HRD_CBR = 2

NAL_PRIORITY_DISPOSABLE = 0
NAL_PRIORITY_LOW = 1
NAL_PRIORITY_HIGH = 2
NAL_PRIORITY_HIGHEST = 3

ANALYSE_I4x4 = 0x0001
ANALYSE_I8x8 = 0x0002
ANALYSE_PSUB16x16 = 0x0010
ANALYSE_PSUB8x8 = 0x0020
ANALYSE_BSUB16x16 = 0x0100

ME_DIA = 0
ME_HEX = 1
ME_UMH = 2
ME_ESA = 3
ME_TESA = 4

CQM_FLAT = 0
CQM_JVT = 1
CQM_CUSTOM = 2

RC_CQP = 0
RC_CRF = 1
RC_ABR = 2

AQ_NONE = 0
AQ_VARIANCE = 1
AQ_AUTOVARIANCE = 2

WEIGHTP_NONE = 0
WEIGHTP_SIMPLE = 1
WEIGHTP_SMART = 2

# Slice types (common/common.h)
SLICE_TYPE_P = 0
SLICE_TYPE_B = 1
SLICE_TYPE_I = 2

# Frame types (common/x264.h X264_TYPE_*)
TYPE_AUTO = 0
TYPE_IDR = 1
TYPE_I = 2
TYPE_P = 3
TYPE_BREF = 4
TYPE_B = 5
TYPE_KEYFRAME = 6

# Profiles (common/set.h)
PROFILE_BASELINE = 66
PROFILE_MAIN = 77
PROFILE_HIGH = 100
PROFILE_HIGH10 = 110
PROFILE_HIGH422 = 122
PROFILE_HIGH444_PREDICTIVE = 244

CHROMA_400 = 0
CHROMA_420 = 1
CHROMA_422 = 2
CHROMA_444 = 3

# CSP (common/x264.h)
CSP_I420 = 0x0002  # not load-bearing; we only accept planar 4:2:0

# Bit depth / QP limits (common/common.h:39-43, 8-bit build)
BIT_DEPTH = 8
QP_BD_OFFSET = 0
QP_MAX_SPEC = 51
QP_MAX = QP_MAX_SPEC + 18
PIXEL_MAX = 255

# Compile-time caps (common/common.h:34-38)
BFRAME_MAX = 4
REF_MAX = 4
THREAD_MAX = 4
LOOKAHEAD_MAX = 5

KEYINT_MIN_AUTO = 0
KEYINT_MAX_INFINITE = 1 << 30


def spec_qp(qp: int) -> int:
    """SPEC_QP: clamp lossless-extended QP into the spec range."""
    return min(qp, QP_MAX_SPEC)


# ---------------------------------------------------------------------------
# Level table (encoder/set.c:717-750)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Level:
    level_idc: int
    mbps: int
    frame_size: int
    dpb: int
    bitrate: int
    cpb: int
    mv_range: int
    mvs_per_2mb: int
    slice_rate: int
    mincr: int
    bipred8x8: int
    direct8x8: int
    frame_only: int


LEVELS = (
    Level(10, 1485, 99, 152064, 64, 175, 64, 64, 0, 2, 0, 0, 1),
    Level(9, 1485, 99, 152064, 128, 350, 64, 64, 0, 2, 0, 0, 1),  # "1b"
    Level(11, 3000, 396, 345600, 192, 500, 128, 64, 0, 2, 0, 0, 1),
    Level(12, 6000, 396, 912384, 384, 1000, 128, 64, 0, 2, 0, 0, 1),
    Level(13, 11880, 396, 912384, 768, 2000, 128, 64, 0, 2, 0, 0, 1),
    Level(20, 11880, 396, 912384, 2000, 2000, 128, 64, 0, 2, 0, 0, 1),
    Level(21, 19800, 792, 1824768, 4000, 4000, 256, 64, 0, 2, 0, 0, 0),
    Level(22, 20250, 1620, 3110400, 4000, 4000, 256, 64, 0, 2, 0, 0, 0),
    Level(30, 40500, 1620, 3110400, 10000, 10000, 256, 32, 22, 2, 0, 1, 0),
    Level(31, 108000, 3600, 6912000, 14000, 14000, 512, 16, 60, 4, 1, 1, 0),
    Level(32, 216000, 5120, 7864320, 20000, 20000, 512, 16, 60, 4, 1, 1, 0),
    Level(40, 245760, 8192, 12582912, 20000, 25000, 512, 16, 60, 4, 1, 1, 0),
    Level(41, 245760, 8192, 12582912, 50000, 62500, 512, 16, 24, 2, 1, 1, 0),
    Level(42, 522240, 8704, 13369344, 50000, 62500, 512, 16, 24, 2, 1, 1, 1),
    Level(50, 589824, 22080, 42393600, 135000, 135000, 512, 16, 24, 2, 1, 1, 1),
    Level(51, 983040, 36864, 70778880, 240000, 240000, 512, 16, 24, 2, 1, 1, 1),
    Level(52, 2073600, 36864, 70778880, 240000, 240000, 512, 16, 24, 2, 1, 1, 1),
)


# ---------------------------------------------------------------------------
# Parameter groups
# ---------------------------------------------------------------------------

@dataclass
class VuiParam:
    i_sar_width: int = 0
    i_sar_height: int = 0
    i_overscan: int = 0
    i_vidformat: int = 5
    b_fullrange: int = -1
    i_colorprim: int = 2
    i_transfer: int = 2
    i_colmatrix: int = -1
    i_chroma_loc: int = 0


@dataclass
class RcParam:
    """Rate-control params (x264.h rc struct; defaults common/common.c:69-95)."""
    i_rc_method: int = RC_CRF
    i_qp_constant: int = 23 + QP_BD_OFFSET
    i_qp_min: int = 0
    i_qp_max: int = QP_MAX
    i_qp_step: int = 4
    i_bitrate: int = 0
    f_rf_constant: float = 28.0
    f_rf_constant_max: float = 0.0
    f_rate_tolerance: float = 1.0
    i_vbv_max_bitrate: int = 0
    i_vbv_buffer_size: int = 0
    f_vbv_buffer_init: float = 0.9
    f_ip_factor: float = 1.4
    f_pb_factor: float = 1.3
    i_aq_mode: int = AQ_NONE
    f_aq_strength: float = 1.0
    b_mb_tree: int = 0
    i_lookahead: int = 0
    b_stat_write: int = 0
    b_stat_read: int = 0
    f_qcompress: float = 0.6
    f_qblur: float = 0.5
    f_complexity_blur: float = 20.0


@dataclass
class AnalyseParam:
    """Analysis params (x264.h analyse struct; defaults common/common.c:105-131)."""
    intra: int = ANALYSE_I4x4
    inter: int = 0
    b_transform_8x8: int = 0
    i_weighted_pred: int = WEIGHTP_NONE
    b_weighted_bipred: int = 1
    i_direct_mv_pred: int = 1  # X264_DIRECT_PRED_SPATIAL
    i_chroma_qp_offset: int = 0
    i_me_method: int = ME_DIA
    i_me_range: int = 16
    i_mv_range: int = -1
    i_mv_range_thread: int = -1
    i_subpel_refine: int = 1
    b_chroma_me: int = 0
    b_mixed_references: int = 0
    i_trellis: int = 0
    b_fast_pskip: int = 1
    i_noise_reduction: int = 0
    f_psy_rd: float = 1.0
    f_psy_trellis: float = 0.0
    b_psy: int = 0
    i_luma_deadzone: tuple = (21, 11)
    b_psnr: int = 0
    b_ssim: int = 0
    b_dct_decimate: int = 1


@dataclass
class Param:
    """The x264_param_t equivalent (common/x264.h:189-705)."""
    cpu: int = 0
    i_threads: int = 1
    b_deterministic: int = 0

    i_width: int = 0
    i_height: int = 0
    i_csp: int = CSP_I420
    i_level_idc: int = -1
    i_frame_total: int = 0

    vui: VuiParam = field(default_factory=VuiParam)

    i_fps_num: int = 25
    i_fps_den: int = 1
    i_timebase_num: int = 0
    i_timebase_den: int = 0
    b_vfr_input: int = 0

    i_frame_reference: int = 1
    i_dpb_size: int = 1
    i_keyint_max: int = 50
    i_keyint_min: int = KEYINT_MIN_AUTO
    i_scenecut_threshold: int = 20
    b_intra_refresh: int = 0

    i_bframe: int = 0
    i_bframe_adaptive: int = 1
    i_bframe_bias: int = 0
    i_bframe_pyramid: int = 0
    b_open_gop: int = 0
    b_bluray_compat: int = 0

    b_deblocking_filter: int = 1
    i_deblocking_filter_alphac0: int = 0
    i_deblocking_filter_beta: int = 0

    b_cabac: int = 1
    i_cabac_init_idc: int = 0

    b_interlaced: int = 0
    b_constrained_intra: int = 0
    b_fake_interlaced: int = 0

    i_cqm_preset: int = CQM_FLAT
    # custom 4x4 scaling lists (x264_param_t cqm_4iy/4py/4ic/4pc,
    # x264.h:500-507), natural raster order; used when CQM_CUSTOM
    cqm_4iy: tuple = (16,) * 16
    cqm_4py: tuple = (16,) * 16
    cqm_4ic: tuple = (16,) * 16
    cqm_4pc: tuple = (16,) * 16

    rc: RcParam = field(default_factory=RcParam)
    analyse: AnalyseParam = field(default_factory=AnalyseParam)

    i_slice_max_size: int = 0
    i_slice_max_mbs: int = 0
    i_slice_count: int = 0

    b_aud: int = 0
    b_repeat_headers: int = 1
    b_annexb: int = 1
    i_sps_id: int = 0
    i_nal_hrd: int = 0
    b_tff: int = 1
    b_pic_struct: int = 0
    b_pulldown: int = 0
    b_sliced_threads: int = 0
    i_frame_packing: int = -1
    crop_rect: tuple = (0, 0, 0, 0)  # left, top, right, bottom
    i_log_level: int = 2  # X264_LOG_INFO
    pf_log: object = None        # pluggable log callback (x264.h:324-326)
    p_log_private: object = None

    # TPU-native extensions (not in the reference): batched multi-stream
    # encode (the reference's frame-threading slot, SURVEY §2.6) and device
    # placement knobs.
    n_streams: int = 1

    def copy(self) -> "Param":
        return dataclasses.replace(
            self,
            vui=dataclasses.replace(self.vui),
            rc=dataclasses.replace(self.rc),
            analyse=dataclasses.replace(self.analyse),
        )


def param_default() -> Param:
    """x264_param_default (common/common.c:19-147) — fork defaults."""
    return Param()


def clip3(v, lo, hi):
    return max(lo, min(hi, v))


class ValidationError(ValueError):
    pass


def validate_parameters(p: Param) -> Param:
    """Normalize/clamp parameters (encoder/encoder.c:15-409 subset).

    Covers every field the supported feature set consumes; rejects what the
    fork cannot encode instead of silently mis-encoding.
    """
    p = p.copy()
    if p.i_width <= 0 or p.i_height <= 0:
        raise ValidationError(f"invalid width x height ({p.i_width}x{p.i_height})")
    if p.i_width % 2 or p.i_height % 2:
        raise ValidationError(f"width or height not divisible by 2 ({p.i_width}x{p.i_height})")

    p.i_threads = 1  # encoder.c:57 forces single "thread"; we batch instead

    # timebase from fps when not VFR (encoder.c:220-224)
    if (not p.i_timebase_num or not p.i_timebase_den
            or not (p.b_vfr_input or p.b_pulldown)):
        p.i_timebase_num = p.i_fps_den
        p.i_timebase_den = p.i_fps_num
    p.n_streams = max(1, int(p.n_streams))

    if p.b_interlaced or p.b_fake_interlaced:
        raise ValidationError("interlaced encoding is not supported (osdep.h:16)")
    p.i_bframe = 0  # fork: no B-frame analysis (analyse.c:1080-1223)

    p.i_frame_reference = clip3(p.i_frame_reference, 1, REF_MAX)
    p.i_dpb_size = max(1, p.i_dpb_size)

    p.i_keyint_max = clip3(p.i_keyint_max, 1, KEYINT_MAX_INFINITE)
    if p.i_keyint_max == 1:
        p.b_intra_refresh = 0
        p.analyse.i_weighted_pred = 0
    # periodic-intra-refresh constraints (encoder.c:193-198); note the
    # fork's intra-in-P analysis is compiled out (analyse.c:1214-1219),
    # so no refresh wave can be emitted — only the parameter's
    # observable plumbing (ref clamp, SPS frame_num sizing, keyint/HRD
    # gating) is reproduced
    if p.b_intra_refresh and (p.i_frame_reference > 1 or p.i_dpb_size > 1):
        x264_log(p, LOG_WARNING, "ref > 1 + intra-refresh is not supported")
        p.i_frame_reference = 1
        p.i_dpb_size = 1
    if p.i_keyint_min == KEYINT_MIN_AUTO:
        p.i_keyint_min = max(p.i_keyint_max // 10, 1)
    p.i_keyint_min = clip3(p.i_keyint_min, 1, p.i_keyint_max // 2 + 1)

    # rate-control normalization (encoder.c:76-149)
    rc = p.rc
    if rc.i_rc_method not in (RC_CQP, RC_CRF, RC_ABR):
        raise ValidationError("no ratecontrol method specified")
    rc.f_rf_constant = clip3(rc.f_rf_constant, -QP_BD_OFFSET, 51)
    rc.f_rf_constant_max = clip3(rc.f_rf_constant_max, -QP_BD_OFFSET, 51)
    rc.i_qp_constant = clip3(rc.i_qp_constant, 0, QP_MAX)
    rc.f_ip_factor = max(rc.f_ip_factor, 0.01)
    rc.f_pb_factor = max(rc.f_pb_factor, 0.01)
    if rc.i_rc_method == RC_CRF:
        rc.i_qp_constant = int(rc.f_rf_constant + QP_BD_OFFSET)
        rc.i_bitrate = 0
    if rc.i_rc_method == RC_CQP:
        qp_p = float(rc.i_qp_constant)
        qp_i = qp_p - 6 * math.log2(rc.f_ip_factor)
        qp_b = qp_p + 6 * math.log2(rc.f_pb_factor)
        rc.i_qp_min = clip3(int(min(qp_p, qp_i, qp_b)), 0, QP_MAX)
        rc.i_qp_max = clip3(int(max(qp_p, qp_i, qp_b) + .999), 0, QP_MAX)
        rc.i_aq_mode = 0
        rc.b_mb_tree = 0
        rc.i_bitrate = 0
    rc.i_qp_max = clip3(rc.i_qp_max, 0, QP_MAX)
    rc.i_qp_min = clip3(rc.i_qp_min, 0, rc.i_qp_max)
    rc.i_qp_step = clip3(rc.i_qp_step, 2, QP_MAX)
    rc.i_bitrate = clip3(rc.i_bitrate, 0, 2000000)
    if rc.i_rc_method == RC_ABR and not rc.i_bitrate:
        raise ValidationError("bitrate not specified for ABR")
    rc.i_vbv_buffer_size = clip3(rc.i_vbv_buffer_size, 0, 2000000)
    rc.i_vbv_max_bitrate = clip3(rc.i_vbv_max_bitrate, 0, 2000000)
    rc.f_vbv_buffer_init = clip3(rc.f_vbv_buffer_init, 0, 2000000)
    if rc.i_vbv_buffer_size:
        if rc.i_rc_method == RC_CQP:
            rc.i_vbv_max_bitrate = 0
            rc.i_vbv_buffer_size = 0
        elif rc.i_vbv_max_bitrate == 0:
            if rc.i_rc_method == RC_ABR:
                rc.i_vbv_max_bitrate = rc.i_bitrate
            else:
                rc.i_vbv_buffer_size = 0
        elif (rc.i_vbv_max_bitrate < rc.i_bitrate
              and rc.i_rc_method == RC_ABR):
            rc.i_vbv_max_bitrate = rc.i_bitrate
    elif rc.i_vbv_max_bitrate:
        rc.i_vbv_max_bitrate = 0
    rc.i_lookahead = clip3(rc.i_lookahead, 0, LOOKAHEAD_MAX)

    # slicing (encoder.c:150-162): count clipped to MB rows (our slices
    # are row-granular device bands); max_mbs converts to a row count;
    # max_size (bytes, incl. NAL overhead) splits bands until each NAL
    # fits the budget (MB-row granularity)
    p.i_slice_max_size = max(p.i_slice_max_size, 0)
    p.i_slice_max_mbs = max(p.i_slice_max_mbs, 0)
    max_slices = (p.i_height + 15) >> 4
    p.i_slice_count = clip3(p.i_slice_count, 0, max_slices)
    if p.i_slice_max_mbs:
        p.i_slice_count = 0

    # CQM preset (common/x264.h:122-124, pps scaling lists set.c:429-465)
    p.i_cqm_preset = clip3(p.i_cqm_preset, CQM_FLAT, CQM_CUSTOM)
    if p.i_cqm_preset == CQM_CUSTOM:
        from .ops.tables import CQM_JVT_LISTS
        lists = []
        for k, jvt in zip(("cqm_4iy", "cqm_4py", "cqm_4ic", "cqm_4pc"),
                          CQM_JVT_LISTS):
            l = tuple(int(v) for v in getattr(p, k))
            if len(l) != 16:
                raise ValidationError(f"{k} must have 16 entries")
            if any(v == 0 for v in l):
                l = jvt           # zero entry -> JVT list (set.c:458-462)
            if any(not 0 < v <= 255 for v in l):
                raise ValidationError(f"{k} entries must be in 1..255")
            lists.append(l)
        p.cqm_4iy, p.cqm_4py, p.cqm_4ic, p.cqm_4pc = lists

    # NAL HRD signalling (encoder.c:360-372)
    p.i_nal_hrd = clip3(p.i_nal_hrd, NAL_HRD_NONE, NAL_HRD_CBR)
    if p.i_nal_hrd and not rc.i_vbv_buffer_size:
        x264_log(p, LOG_WARNING, "NAL HRD parameters require VBV parameters")
        p.i_nal_hrd = NAL_HRD_NONE
    if p.i_nal_hrd == NAL_HRD_CBR and (
            rc.i_rc_method != RC_ABR or rc.i_bitrate != rc.i_vbv_max_bitrate):
        x264_log(p, LOG_WARNING, "CBR HRD requires constant bitrate")
        p.i_nal_hrd = NAL_HRD_VBR

    # no B-frames in the fork → zero B-only features (encoder.c:183-188)
    a = p.analyse
    a.i_direct_mv_pred = 0
    a.b_weighted_bipred = 0
    p.b_open_gop = 0

    a.i_me_range = clip3(a.i_me_range, 4, 1024)
    a.i_subpel_refine = clip3(a.i_subpel_refine, 0, 11)
    a.i_chroma_qp_offset = clip3(a.i_chroma_qp_offset, -12, 12)
    if a.b_transform_8x8:
        raise ValidationError("8x8 transform is not supported (common/common.c:123)")
    if a.i_trellis:
        a.i_trellis = 0  # trellis disabled in the fork
    if a.i_me_method > ME_ESA:
        a.i_me_method = ME_ESA

    # Profile/level indication (encoder/encoder.c:313-344)
    if p.i_level_idc < 0:
        from .encoder.sets import SPS  # local import to avoid a cycle
        sps = SPS.init(p, p.i_sps_id)
        for lvl in LEVELS:
            p.i_level_idc = lvl.level_idc
            if not _validate_levels(p, sps, lvl):
                break
    else:
        if not any(l.level_idc == p.i_level_idc for l in LEVELS):
            raise ValidationError(f"invalid level_idc: {p.i_level_idc}")
    level = next(l for l in LEVELS if l.level_idc == p.i_level_idc)
    if a.i_mv_range <= 0:
        a.i_mv_range = level.mv_range
    else:
        a.i_mv_range = clip3(a.i_mv_range, 32, 512)

    p.i_sps_id &= 31
    return p


def _validate_levels(p: Param, sps, level: Level) -> bool:
    """x264_validate_levels (encoder/set.c:761-800). True = violates level."""
    mb_w = (p.i_width + 15) >> 4
    mb_h = (p.i_height + 15) >> 4
    mbs = mb_w * mb_h
    dpb = mbs * 384 * sps.vui_max_dec_frame_buffering
    fail = False
    if (level.frame_size < mbs
            or level.frame_size * 8 < mb_w * mb_w
            or level.frame_size * 8 < mb_h * mb_h):
        fail = True
    if dpb > level.dpb:
        fail = True
    cbp_factor = 4
    if p.rc.i_vbv_max_bitrate > (level.bitrate * cbp_factor) // 4:
        fail = True
    if p.rc.i_vbv_buffer_size > (level.cpb * cbp_factor) // 4:
        fail = True
    if p.analyse.i_mv_range > level.mv_range:
        fail = True
    if p.i_fps_den > 0 and mbs * p.i_fps_num // p.i_fps_den > level.mbps:
        fail = True
    return fail


# logging levels (x264.h X264_LOG_*)
LOG_NONE = -1
LOG_ERROR = 0
LOG_WARNING = 1
LOG_INFO = 2
LOG_DEBUG = 3


def param2string(p: Param, b_res: bool = False) -> str:
    """x264_param2string (common/common.c:306-420) for the supported
    feature set — the options line embedded in the version SEI and
    printed at open."""
    s = []
    if b_res:
        s.append(f"{p.i_width}x{p.i_height}")
        s.append(f"fps={p.i_fps_num}/{p.i_fps_den}")
        s.append(f"timebase={p.i_timebase_num}/{p.i_timebase_den}")
        s.append("bitdepth=8")
    a, rc = p.analyse, p.rc
    s.append(f"cabac={p.b_cabac}")
    s.append(f"ref={p.i_frame_reference}")
    s.append(f"deblock={p.b_deblocking_filter}:"
             f"{p.i_deblocking_filter_alphac0}:{p.i_deblocking_filter_beta}")
    s.append(f"analyse={a.intra:#x}:{a.inter:#x}")
    s.append(f"me={a.i_me_method}")
    s.append(f"subme={a.i_subpel_refine}")
    s.append(f"psy={a.b_psy}")
    s.append(f"mixed_ref={a.b_mixed_references}")
    s.append(f"me_range={a.i_me_range}")
    s.append(f"chroma_me={a.b_chroma_me}")
    s.append(f"trellis={a.i_trellis}")
    s.append(f"8x8dct={a.b_transform_8x8}")
    s.append(f"cqm={p.i_cqm_preset}")
    s.append(f"deadzone={a.i_luma_deadzone[0]},{a.i_luma_deadzone[1]}")
    s.append(f"fast_pskip={a.b_fast_pskip}")
    s.append(f"chroma_qp_offset={a.i_chroma_qp_offset}")
    s.append(f"threads={p.i_threads}")
    s.append(f"sliced_threads={p.b_sliced_threads}")
    s.append(f"nr={a.i_noise_reduction}")
    s.append(f"decimate={a.b_dct_decimate}")
    s.append(f"interlaced={p.b_interlaced}")
    s.append(f"constrained_intra={p.b_constrained_intra}")
    s.append(f"bframes={p.i_bframe}")
    s.append(f"weightp={max(a.i_weighted_pred, 0)}")
    s.append(f"keyint={p.i_keyint_max}")
    s.append(f"keyint_min={p.i_keyint_min} "
             f"scenecut={p.i_scenecut_threshold} "
             f"intra_refresh={p.b_intra_refresh}")
    if rc.b_mb_tree or rc.i_vbv_buffer_size:
        s.append(f"rc_lookahead={rc.i_lookahead}")
    mode = ("cbr" if rc.i_vbv_max_bitrate == rc.i_bitrate else "abr") \
        if rc.i_rc_method == RC_ABR else \
        "crf" if rc.i_rc_method == RC_CRF else "cqp"
    s.append(f"rc={mode} mbtree={rc.b_mb_tree}")
    if rc.i_rc_method in (RC_ABR, RC_CRF):
        if rc.i_rc_method == RC_CRF:
            s.append(f"crf={rc.f_rf_constant:.1f}")
        else:
            s.append(f"bitrate={rc.i_bitrate} "
                     f"ratetol={rc.f_rate_tolerance:.1f}")
        s.append(f"qcomp={rc.f_qcompress:.2f} qpmin={rc.i_qp_min} "
                 f"qpmax={rc.i_qp_max} qpstep={rc.i_qp_step}")
        if rc.i_vbv_buffer_size:
            s.append(f"vbv_maxrate={rc.i_vbv_max_bitrate} "
                     f"vbv_bufsize={rc.i_vbv_buffer_size}")
    else:
        s.append(f"qp={rc.i_qp_constant}")
    s.append(f"ip_ratio={rc.f_ip_factor:.2f}")
    if rc.i_aq_mode:
        s.append(f"aq={rc.i_aq_mode}:{rc.f_aq_strength:.2f}")
    else:
        s.append(f"aq={rc.i_aq_mode}")
    return " ".join(s)


def x264_log(param: Param | None, level: int, msg: str):
    """x264_log twin (common/common.c:152-192): leveled, with a
    pluggable pf_log callback on the param."""
    if param is not None and level > param.i_log_level:
        return
    pf = getattr(param, "pf_log", None) if param is not None else None
    if pf is not None:
        pf(getattr(param, "p_log_private", None), level, msg)
        return
    prefix = {LOG_ERROR: "error", LOG_WARNING: "warning",
              LOG_INFO: "info", LOG_DEBUG: "debug"}.get(level, "unknown")
    print(f"x264 [{prefix}]: {msg}")
