"""The measured configurations' settings and clips.

- main path: bench.py:429-454's BatchEncoder parameters and a torch twin
  of its synthetic clip (bench.py:91-135 make_synth_device: a smooth
  gradient, two moving sinusoid textures and light noise, made on the
  device);
- faster-1ref: x264's ``--preset faster`` analysis (HEX search, subme 4,
  the p8x8 partitions) cut to what the baseline BatchEncoder codes (no
  i8x8, one reference, no B-frames), on a device twin of the
  split-motion clip of tests/test_partitions.py:21 (two halves moving
  in different directions, so partitions win on some MBs);
- v2: the main path's settings under CRF, x264's default rate control,
  on the synthetic clip with a noise scale per stream, so that the
  streams' rate controls pick different QPs; and the two rate-controlled
  settings that the small card-against-CPU checks drive: CRF with UMH
  and subme 0, ABR with ESA and the partitions;
- encoder: the single-stream Encoder at param_default() (CRF 28, CABAC,
  scenecut, keyint 50), and the small clip with a scene cut and the CQP
  + CABAC settings with forced frame types and QPs that hold it to the
  JAX Encoder (tests/test_torch_encoder.py) and the card to the CPU;
- encoder-cbr: the Encoder as a live stream's CBR (encoder_cbr_param:
  6000 kbit/s, NAL HRD, variance AQ, the lookahead queue);
- encoder-refs: the Encoder with x264 --preset medium's three
  references, the JVT scaling lists, noise reduction and CAVLC
  (encoder_refs_param), and the small clip whose blocks cycle through
  three patterns (multiref_clip), with the reference marks and the
  forced extreme frame (REFS_MARKS, REFS_FORCED, extreme_frame) that
  hold the multi-ref DPB, recovery paths (a) and (c) and frame packing
  5 to the JAX Encoder (tests/test_torch_refs.py) and the card to the
  CPU;
- encoder-slices: the Encoder with several slices per frame (Blu-ray
  authoring's --slices 4 at 1080p) and with periodic intra refresh, and
  the small clip and the settings (SLICE_CASES, encoder_slices_param,
  slices_clip) that hold them to the JAX Encoder
  (tests/test_torch_slices.py) and the card to the CPU.

The parameter helpers set their fields on ``p`` when given (any Param
with the package's fields: the tests pass the JAX package's so that both
encoders get the same settings), else on the port's ``param_default()``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import RC_ABR, TYPE_I, TYPE_IDR


def main_path_param(w: int, h: int, qp: int = 26, keyint: int = 50, p=None):
    """param_default() analysis with CQP at `qp`, CAVLC, IPPP `keyint`."""
    from .. import params as P
    p = P.param_default() if p is None else p
    p.i_width, p.i_height = w, h
    p.b_cabac = 0
    p.rc.i_rc_method = P.RC_CQP
    p.rc.i_qp_constant = qp
    p.i_keyint_max = keyint
    p.i_scenecut_threshold = 0
    p.rc.i_lookahead = 0
    return p


def faster_1ref_param(w: int, h: int, qp: int = 26, keyint: int = 50,
                      p=None):
    """The main path's settings with x264 --preset faster's P analysis:
    HEX over +-16, subme 4, 16x8/8x16/8x8 partitions, fast P-skip and DCT
    decimation on, one reference."""
    from .. import params as P
    p = main_path_param(w, h, qp, keyint, p)
    a = p.analyse
    a.inter = P.ANALYSE_PSUB16x16
    a.i_me_method = P.ME_HEX
    a.i_subpel_refine = 4
    a.i_me_range = 16
    a.b_fast_pskip = 1
    a.b_dct_decimate = 1
    p.i_frame_reference = 1
    return p


def crf_param(w: int, h: int, crf: float = 23.0, keyint: int = 50,
              p=None):
    """The main path's settings with CRF at `crf` in place of CQP (23 is
    x264's documented default; the package's param_default has 28)."""
    from .. import params as P
    p = main_path_param(w, h, keyint=keyint, p=p)
    p.rc.i_rc_method = P.RC_CRF
    p.rc.f_rf_constant = crf
    return p


def crf_umh_param(w: int, h: int, keyint: int, p=None):
    """CRF 30 with the UMH search and subme 0 (no subpel refine), the
    main path's other settings."""
    from .. import params as P
    p = crf_param(w, h, 30.0, keyint, p)
    p.analyse.i_me_method = P.ME_UMH
    p.analyse.i_subpel_refine = 0
    return p


def abr_esa_param(w: int, h: int, keyint: int, p=None):
    """ABR at 200 kbit/s with the ESA search, subme 2 and the
    16x8/8x16/8x8 partitions, the main path's other settings."""
    from .. import params as P
    p = main_path_param(w, h, keyint=keyint, p=p)
    p.rc.i_rc_method = P.RC_ABR
    p.rc.i_bitrate = 200
    p.analyse.i_me_method = P.ME_ESA
    p.analyse.i_subpel_refine = 2
    p.analyse.inter = P.ANALYSE_PSUB16x16
    return p


def encoder_param(w: int, h: int, p=None):
    """param_default() at w x h: what an x264.h user gets without asking
    (CRF 28, CABAC, scenecut 20, keyint 50, DIA, subme 1, one reference,
    deblock on)."""
    from .. import params as P
    p = P.param_default() if p is None else p
    p.i_width, p.i_height = w, h
    return p


def encoder_cqp_param(w: int, h: int, p=None):
    """CQP 20 with CABAC, HEX, subme 4, the 16x8/8x16/8x8 partitions,
    deblock offsets (-2, 1) (so the filter is off at the I frames' QP 17
    and on at the P frames' 20), chroma QP offset 2, PSNR and SSIM, no
    in-band headers; drive it with ENCODER_FORCED."""
    from .. import params as P
    p = encoder_param(w, h, p)
    p.rc.i_rc_method = P.RC_CQP
    p.rc.i_qp_constant = 20
    p.analyse.inter = P.ANALYSE_PSUB16x16
    p.analyse.i_me_method = P.ME_HEX
    p.analyse.i_subpel_refine = 4
    p.analyse.i_chroma_qp_offset = 2
    p.analyse.b_psnr = p.analyse.b_ssim = 1
    p.i_deblocking_filter_alphac0, p.i_deblocking_filter_beta = -2, 1
    p.b_repeat_headers = 0
    return p


def encoder_cbr_param(w: int, h: int, kbit: int = 6000, p=None):
    """A live stream into an ingest server: 30 fps, CBR at `kbit` kbit/s
    with a 2 s keyframe interval (keyint 60; Twitch's Broadcasting
    Guidelines ask for 6000 kbit/s), i.e. ABR with VBV max rate = buffer
    = `kbit` and the NAL HRD in CBR mode (x264 --nal-hrd cbr, which
    needs --vbv-maxrate and --vbv-bufsize), and x264's default variance
    AQ (--aq-mode 1, strength 1.0); i_lookahead 4 (x264's default is 40,
    cut for the smoke run's time); the rest param_default()."""
    from .. import params as P
    p = encoder_param(w, h, p)
    p.i_fps_num, p.i_fps_den = 30, 1
    p.i_keyint_max = 60
    p.rc.i_rc_method = P.RC_ABR
    p.rc.i_bitrate = p.rc.i_vbv_max_bitrate = p.rc.i_vbv_buffer_size = kbit
    p.i_nal_hrd = P.NAL_HRD_CBR
    p.rc.i_aq_mode = P.AQ_VARIANCE
    p.rc.f_aq_strength = 1.0
    p.rc.i_lookahead = 4
    return p


def encoder_refs_param(w: int, h: int, n_ref: int = 3, cabac: int = 0,
                       p=None):
    """param_default() with n_ref references (x264 --preset medium has 3),
    the JVT scaling lists (x264 --cqm jvt), noise reduction 100 (x264
    --nr 100) and CAVLC unless `cabac`."""
    from .. import params as P
    p = encoder_param(w, h, p)
    p.b_cabac = cabac
    p.i_frame_reference = n_ref
    p.i_cqm_preset = P.CQM_JVT
    p.analyse.i_noise_reduction = 100
    return p


def extreme_frame(w: int, h: int):
    """tests/test_recovery.py:22 _extreme_frame: a black top MB row over
    white, whose I16 MBs in row 1 predict DC 0 from the black row; at QP 0
    their luma DC levels pass CAVLC's escape range (level_code >= 1<<12,
    cavlc.c:44-59), the more so under the JVT lists (a DC weight of 6
    against the flat 16)."""
    y = np.full((h, w), 255, np.uint8)
    y[:16] = 0
    u = np.full((h // 2, w // 2), 128, np.uint8)
    return y, u, u.copy()


def multiref_clip(w: int = 56, h: int = 40, n: int = 7, period: int = 3,
                  seed: int = 5):
    """n frames of (y, u, v) uint8 numpy planes: a slowly moving texture
    in which three MBs cycle through `period` random patterns, so that the
    reference `period` frames back is the best match there (the JAX
    multi-ref analysis picks it) while too little changes for a scene
    cut. The last frame is extreme_frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    pats = [rng.integers(30, 225, (16, 16)).astype(np.float32)
            for _ in range(period)]
    frames = []
    for t in range(n - 1):
        y = (110 + 60 * np.sin((xx + t) / 13.0) * np.cos(yy / 17.0)
             + rng.normal(0, 1.5, (h, w)))
        for by, bx in ((0, 16), (16, 32), (16, 0)):
            y[by:by + 16, bx:bx + 16] = pats[t % period]
        u = (120 + 30 * np.sin((xx[::2, ::2] + t) / 23.0)).clip(0, 255)
        v = (128 + 30 * np.cos((yy[::2, ::2] + t) / 29.0)).clip(0, 255)
        frames.append((y.clip(0, 255).astype(np.uint8), u.astype(np.uint8),
                       v.astype(np.uint8)))
    frames.append(extreme_frame(w, h))
    return frames


# the multi-slice and intra-refresh settings at CQP 26 (encoder_slices_
# param), name: {field: value}, a dotted field naming one of p.rc's; on a
# 64x96 frame (4x6 MBs) each makes 3 bands of 2 MB rows
SLICE_CASES = {
    "count3-cavlc": {"i_slice_count": 3},
    "count3-cabac": {"i_slice_count": 3, "b_cabac": 1},
    "max-mbs8": {"i_slice_max_mbs": 8},
    # tests/test_slices.py:101-108: the I frame's bands pass the budget
    # and are split
    "max-size400": {"i_slice_count": 3, "i_slice_max_size": 400},
    # tests/test_intra_refresh.py:59-72: keyint applies to frame 0 only
    "intra-refresh": {"b_intra_refresh": 1, "i_slice_count": 3,
                      "i_keyint_max": 4, "i_scenecut_threshold": 0},
    # a VBV tight enough that the I frame is encoded again
    "vbv-slices": {"i_slice_count": 3, "rc.i_rc_method": RC_ABR,
                   "rc.i_bitrate": 20, "rc.i_vbv_max_bitrate": 20,
                   "rc.i_vbv_buffer_size": 2},
    # 2 references: a P frame past the first reads each band's rows of
    # both (the stacked crops, K4)
    "refs2": {"i_slice_count": 3, "i_frame_reference": 2},
}


def encoder_slices_param(w: int, h: int, name: str, p=None):
    """param_default() at CQP 26 under CAVLC with the settings of
    SLICE_CASES[name]."""
    from .. import params as P
    p = encoder_param(w, h, p)
    p.b_cabac = 0
    p.rc.i_rc_method = P.RC_CQP
    p.rc.i_qp_constant = 26
    for k, v in SLICE_CASES[name].items():
        obj = p.rc if k.startswith("rc.") else p
        setattr(obj, k.removeprefix("rc."), v)
    return p


def slices_clip(w: int = 64, h: int = 96, n: int = 5, seed: int = 5):
    """n frames of (y, u, v) uint8 numpy planes: a moving sinusoid texture
    with light noise (tests/test_slices.py:15 _clip), detailed enough that
    the I frame's slices pass 400 bytes at QP 26."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = (120 + 60 * np.sin((xx + 3 * t) / 9.0) * np.cos(yy / 7.0)
             + rng.normal(0, 3, (h, w))).clip(0, 255).astype(np.uint8)
        u = (128 + 30 * np.sin((xx[::2, ::2] + t) / 5.0)).clip(
            0, 255).astype(np.uint8)
        v = (128 + 30 * np.cos(yy[::2, ::2] / 6.0)).clip(0, 255).astype(
            np.uint8)
        frames.append((y, u, v))
    return frames


# multiref_clip's reference marks: before frame 5 the newest reference
# (frame 4) is marked corrupt, so the list skips it and the slice headers
# carry ref_pic_list_modification; before frame 6, the extreme frame,
# every reference, so no valid one is left and it is forced to an IDR
REFS_MARKS = {5: 4, 6: None}
# and its Picture fields: the extreme frame forced to QP 0, where its
# CAVLC levels overflow (recovery path (a))
REFS_FORCED = {6: {"i_qpplus1": 1}}


class MarkingEncoder:
    """An Encoder whose encode(pic) first calls mark_reference_corrupt(
    marks[t]) when the t-th picture is in `marks` (for encode_clip), and
    keeps each encoded frame's last_frame record (active references,
    reorder, device encodes) in `frames` (the port's Encoder; the JAX one
    keeps no such record)."""

    def __init__(self, enc, marks: dict):
        self.enc, self.marks, self.t = enc, marks, 0
        self.frames = []

    def headers(self):
        return self.enc.headers()

    def encode(self, pic):
        if pic is not None:
            if self.t in self.marks:
                self.enc.mark_reference_corrupt(self.marks[self.t])
            self.t += 1
        nals, po = self.enc.encode(pic)
        rec = getattr(self.enc._core, "last_frame", None)
        if po is not None and rec is not None:
            self.frames.append(dict(rec))
        return nals, po

    def close(self):
        return self.enc.close()


# encoder_cqp_param's Picture fields per frame: a forced IDR, a forced I
# inside keyint_min (a non-IDR I) and a P frame forced to QP 18 (the
# filter off)
ENCODER_FORCED = {2: {"i_type": TYPE_IDR}, 4: {"i_type": TYPE_I},
                  5: {"i_qpplus1": 19}}


def scene_cut_clip(w: int = 56, h: int = 40, n: int = 8, cut: int = 6):
    """n frames of (y, u, v) uint8 numpy planes: a moving texture whose
    luma inverts at frame `cut`, a scene cut that the lowres costs see (no
    P block beats its intra cost)."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for t in range(n):
        y = (110 + 60 * np.sin((xx + 2 * t) / 13.0) * np.cos(yy / 17.0)
             + rng.normal(0, 2, (h, w))).clip(0, 255).astype(np.uint8)
        if t >= cut:
            y = 255 - y
        u = (120 + 30 * np.sin((xx[::2, ::2] + t) / 23.0)).clip(
            0, 255).astype(np.uint8)
        v = (128 + 30 * np.cos((yy[::2, ::2] + t) / 29.0)).clip(
            0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def encode_clip(enc, frames, forced=None, picture=None):
    """Encode (y, u, v) frames (numpy or tensors) with an Encoder, each
    Picture (`picture`, the port's by default) with the fields of
    forced[t], then drain it with encode(None) until that returns
    ([], None). Returns the headers; each encoded frame's NALs as (type,
    bytes) and its pic_out, in output order (the drained frames last);
    the calls with a picture that returned nothing (waiting, the
    lookahead queue filling); what the last encode(None) returned (tail)
    and the close() summary."""
    if picture is None:
        from ..api import Picture as picture
    headers = [(n.i_type, n.payload) for n in enc.headers()]
    nals, pics, waiting = [], [], []

    def keep(out, po):
        if po is None:
            return False
        nals.append([(n.i_type, n.payload) for n in out])
        pics.append(po)
        return True
    for t, planes in enumerate(frames):
        pic = picture.from_planes(*planes, pts=t)
        for k, v in (forced or {}).get(t, {}).items():
            setattr(pic, k, v)
        if not keep(*enc.encode(pic)):
            waiting.append(t)
    tail = enc.encode(None)
    while keep(*tail):
        tail = enc.encode(None)
    return dict(headers=headers, nals=nals, pics=pics, waiting=waiting,
                tail=tail, summary=enc.close())


def encode_diff(a: dict, b: dict):
    """The first difference between two encode_clip results (headers,
    the calls that returned no frame, NALs, pic_out types, QPs and planes,
    close() summary) as text, or None when they are equal."""
    if a["headers"] != b["headers"]:
        return "headers"
    if a["waiting"] != b["waiting"]:
        return "the calls that returned no frame"
    for t, (na, nb) in enumerate(zip(a["nals"], b["nals"])):
        if na != nb:
            return f"NALs of frame {t}"
    for t, (pa, pb) in enumerate(zip(a["pics"], b["pics"])):
        if (pa.i_frame_type, pa.i_frame_qp) != (pb.i_frame_type,
                                                pb.i_frame_qp):
            return f"type or QP of frame {t}"
        for plane in "yuv":
            if not np.array_equal(getattr(pa, plane), getattr(pb, plane)):
                return f"pic_out {plane} of frame {t}"
    if len(a["nals"]) != len(b["nals"]) or a["summary"] != b["summary"]:
        return "close() summary"
    return None


def synth_clip(w: int, h: int, device, sigma: float = 2.0):
    """Returns frame(t) -> (y, u, v) uint8 planes of size h x w on
    `device`; t is the (fractional) frame phase and `sigma` the standard
    deviation of the luma noise (the detail the encoder sees)."""
    rng = np.random.default_rng(0)
    noise = torch.as_tensor(rng.normal(0, sigma, (h, w)).astype(np.float32),
                            device=device)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None] \
        .expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :] \
        .expand(h, w)
    base = 96 + 48 * torch.sin(yy / 97.0) + 32 * torch.cos(xx / 131.0)

    def frame(t: float):
        dx, dy = 2.6 * t, 1.3 * t
        tex = (28 * torch.sin((xx + dx) / 11.0 + (yy + dy) / 17.0)
               + 22 * torch.cos((xx - 1.7 * dx) / 23.0))
        y = (base + tex + noise).clamp(0, 255).to(torch.uint8)
        yc, xc = yy[::2, ::2], xx[::2, ::2]
        u = (120 + 40 * torch.sin((xc + dx) / 53.0)).clamp(0, 255) \
            .to(torch.uint8)
        v = (128 + 40 * torch.cos((yc + dy) / 47.0)).clamp(0, 255) \
            .to(torch.uint8)
        return y, u, v
    return frame


def split_motion_clip(w: int, h: int, device, seed: int = 11):
    """Device twin of tests/test_partitions.py:21 _split_motion_clip:
    frame(t) -> (y, u, v) uint8 planes on `device`, equal to that clip's
    frame t (integer t). The top half moves down and the bottom half
    right, 3 px per frame, over a textured base made once with numpy
    (the same seed and draws) and kept on the device."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h * 2, 0:w * 2]
    base = (110 + 70 * np.sin(xx / 7.3) * np.cos(yy / 5.1)
            + rng.normal(0, 4, (h * 2, w * 2))).clip(0, 255)
    base = torch.as_tensor(base.astype(np.uint8), device=device)
    xc, yc = xx[:h:2, :w:2], yy[:h:2, :w:2]

    def frame(t: float):
        d = 3 * int(t)
        if 8 + d + h // 2 > 2 * h:
            raise ValueError(f"frame {t} lies beyond the base texture")
        y = torch.cat([base[8 + d:8 + d + h // 2, 8:8 + w],
                       base[8:8 + h - h // 2, 8 + d:8 + d + w]])
        u = (120 + 30 * np.sin((xc + d) / 9.0)).clip(0, 255)
        v = (128 + 30 * np.cos((yc + d) / 11.0)).clip(0, 255)
        return (y, torch.as_tensor(u.astype(np.uint8), device=device),
                torch.as_tensor(v.astype(np.uint8), device=device))
    return frame


def detail_clips(w: int, h: int, device, S: int):
    """S synth_clip frame functions whose luma noise doubles from stream to
    stream, 1, 2, 4, 8, 1, ... (for stacked_slot)."""
    return [synth_clip(w, h, device, 2.0 ** (s % 4)) for s in range(S)]


def stacked_slot(frame, t: int, S: int):
    """Slot t of S streams; stream s shows the clip at phase 1 + t + 3s
    (`frame` one frame function, or one per stream). Returns stacked
    (S, H, W) y and (S, H/2, W/2) u, v."""
    frames = frame if isinstance(frame, (list, tuple)) else [frame] * S
    fr = [frames[s](1.0 + t + 3 * s) for s in range(S)]
    return tuple(torch.stack([f[i] for f in fr]) for i in range(3))


def payload_vs_writers(be):
    """Hold the newest slot's device CAVLC payloads to the host C++
    writers: `be` is a BatchEncoder (or an Encoder's core) with
    keep_syntax set that has just encoded a slot (a frame). Pulls that slot's syntax once, writes every stream's
    slice with native.write_slice_p / _i, with that stream's slice header
    and QP, and compares bytes, bit counts and skip counts. Returns the
    streams' bit counts; raises RuntimeError on the first difference."""
    from .. import params as P
    from ..encoder import core as C
    from ..entropy import native
    slot = be.last_slot
    S = len(slot["qps"])
    is_p = slot["slice_type"] == P.SLICE_TYPE_P
    host = C.pull_syntax(slot["syn"], C.SYN_P if is_p else C.SYN_I, S)
    bits = slot["bits"].cpu().numpy()
    payload = slot["payload"].cpu().numpy()
    n_skip = slot["n_skip"].cpu().numpy()
    if slot["ov"].any().item():
        raise RuntimeError("the device packer raised its overflow flag")
    for s in range(S):
        qp, header = slot["qps"][s], slot["headers"][s]
        grid = np.full((be.mb_h, be.mb_w), qp, np.int16)
        if is_p:
            want, want_skip = native.write_slice_p(
                header, be.mb_w, be.mb_h, qp, host[s], qp_mb=grid)
        else:
            want, want_skip = native.write_slice_i(
                header, be.mb_w, be.mb_h, qp, host[s], qp_mb=grid), 0
        nbytes = (int(bits[s]) + 7) // 8
        if (nbytes != len(want) or int(n_skip[s]) != want_skip
                or payload[s, :nbytes].tobytes() != want
                or payload[s, nbytes:].any()):
            raise RuntimeError(
                f"stream {s}: the device payload ({bits[s]} bits, "
                f"{n_skip[s]} skips) differs from the host writer's "
                f"({len(want)} bytes, {want_skip} skips)")
    return [int(b) for b in bits]


def cabac_twin(param, run, frames, n: int):
    """Hold a CABAC Encoder run to its CAVLC twin over its first n frames.
    `run` is encode_clip's result for `frames` under `param` (CABAC, no
    forced fields). The twin (CAVLC, keep_syntax, on the device of
    frames[0]) encodes each frame forced to the run's QP; the analysis does
    not read the entropy mode, so:
      - its frame type, QP and pic_out planes must be the run's;
      - its device CAVLC payload must equal the host C++ writers'
        (payload_vs_writers);
      - its syntax, every key of the device dict but the recon planes
        pulled on its own (so that neither the Encoder's key lists
        SYN_CABAC_P / SYN_CABAC_I nor its int16 pull_syntax is taken on
        trust), written by the C++ CABAC writer under `param` with the
        twin's slice header fields (frame_num, idr_pic_id, the input frame
        counter), must give the run's slice NAL byte for byte.
    Returns each frame's device payload bits; raises RuntimeError on the
    first difference."""
    import copy

    from .. import params as P
    from ..api import Encoder, Picture
    from ..encoder import core as C
    from ..entropy.bitstream import nal_unit
    twin_param = copy.deepcopy(param)
    twin_param.b_cabac = 0
    twin = Encoder(twin_param, device=frames[0][0].device
                   if torch.is_tensor(frames[0][0]) else "cpu")
    core = twin._core
    core.keep_syntax = True
    # the writer only writes slices: its counters are set from the twin's
    writer = C.EncoderCore(copy.deepcopy(param), device="cpu")
    bits = []
    for t in range(n):
        want = run["pics"][t]
        fields = (core.frame_num, core.i_frame, core.idr_pic_id)
        pic = Picture.from_planes(*frames[t], pts=t)
        pic.i_qpplus1 = want.i_frame_qp + 1
        _, po = twin.encode(pic)
        if (po.i_frame_type, po.i_frame_qp) != (want.i_frame_type,
                                                want.i_frame_qp) or not all(
                np.array_equal(getattr(po, k), getattr(want, k))
                for k in "yuv"):
            raise RuntimeError(f"frame {t}: the CAVLC twin's type, QP or "
                               "pic_out differs from the CABAC run's")
        bits.append(payload_vs_writers(core)[0])
        slot = core.last_slot
        is_p = slot["slice_type"] == P.SLICE_TYPE_P
        host = {k: v[0].cpu().numpy() for k, v in slot["syn"].items()
                if torch.is_tensor(v) and not k.startswith("recon")}
        is_idr = po.i_frame_type == P.TYPE_IDR
        # an IDR resets frame_num before its slice header is written
        writer.frame_num = 0 if is_idr else fields[0]
        writer.i_frame = fields[1]
        payload, _, _ = writer._write_slice_cabac(
            host, slot["slice_type"], po.i_frame_qp,
            fields[2] if is_idr else -1,
            np.full((writer.mb_h, writer.mb_w), po.i_frame_qp, np.int32))
        nal_type = P.NAL_SLICE_IDR if is_idr else P.NAL_SLICE
        slices = [b for ty, b in run["nals"][t]
                  if ty in (P.NAL_SLICE, P.NAL_SLICE_IDR)]
        if slices != [nal_unit(nal_type, P.NAL_PRIORITY_HIGHEST, payload)]:
            raise RuntimeError(f"frame {t}: the C++ CABAC writer on the "
                               "twin's syntax differs from the CABAC run's "
                               "slice")
    twin.close()
    return bits
