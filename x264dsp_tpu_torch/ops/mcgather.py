"""Batched motion compensation over per-MB reference windows — port of
x264dsp_tpu/ops/mcgather.py.

``luma_windows`` / ``chroma_windows`` cut each MB's search window out of
the padded hpel planes (kernels K2a / K2b, ``csrc/windows.cu``, on a
CUDA tensor; ``*_plain`` on a CPU tensor). The windows are uint8: pixels
are <= 255, so they equal the TPU path's bf16 windows at half the bytes.
K2 replaces x264dsp_tpu/ops/pallas/windows.py::luma_windows_pallas and
::chroma_windows_pallas; on the H100 it is a bandwidth-bound copy (K2a and
K2b each through a ring of source rows in shared memory, csrc/windows.cu).

The MC functions read blocks out of the windows with direct indexed
loads (``torch.gather``) where the TPU path multiplies by one-hot bf16
selector matrices (mcgather.py:_select_block, _plane_select). MVs are
qpel; mc_luma (common/mc.c:216-240) averages two hpel samples chosen by
HPEL_REF0/1, mc_chroma (:295-323) is the 1/8-pel bilinear.
"""

from __future__ import annotations

import torch

from .. import _build
from . import mc as MC
from .devtab import device_table

M_LUMA = 20
WIN_L = 16 + 2 * M_LUMA          # 56
M_CHROMA = 11
WIN_C = 8 + 2 * M_CHROMA + 2     # 32

launches = {"luma_windows": 0, "chroma_windows": 0}   # K2a / K2b


def _check_ref(t, lead: int, name: str):
    if t.dtype != torch.int32 or t.dim() != lead:
        raise ValueError(f"{name}: expected a {lead}-d int32 tensor")


def luma_windows_plain(ref4, mb_w: int, mb_h: int):
    """ref4 (S, 4, Hp, Wp) -> (S, mb_h*mb_w, 4, WIN_L, WIN_L) uint8;
    window of MB (y, x) starts at (16y + PAD_MC - M_LUMA, 16x + ...)."""
    S = ref4.shape[0]
    o = MC.PAD_MC - M_LUMA
    span_y, span_x = 16 * mb_h + WIN_L - 16, 16 * mb_w + WIN_L - 16
    w = ref4[:, :, o:o + span_y, o:o + span_x].unfold(2, WIN_L, 16) \
        .unfold(3, WIN_L, 16)                     # (S, 4, mbh, mbw, W, W)
    return w.permute(0, 2, 3, 1, 4, 5).reshape(
        S, mb_h * mb_w, 4, WIN_L, WIN_L).to(torch.uint8)


def chroma_windows_plain(refc, mb_w: int, mb_h: int):
    """refc (S, Hc+P, Wc+P) -> (S, mb_h*mb_w, WIN_C, WIN_C) uint8."""
    S = refc.shape[0]
    o = MC.PAD_MC // 2 - M_CHROMA
    span_y, span_x = 8 * mb_h + WIN_C - 8, 8 * mb_w + WIN_C - 8
    w = refc[:, o:o + span_y, o:o + span_x].unfold(1, WIN_C, 8) \
        .unfold(2, WIN_C, 8)                      # (S, mbh, mbw, W, W)
    return w.reshape(S, mb_h * mb_w, WIN_C, WIN_C).to(torch.uint8)


def luma_windows_cuda(ref4, mb_w: int, mb_h: int):
    S, _, Hp, Wp = ref4.shape
    _build.require_cuda(ref4, torch.int32, (S, 4, Hp, Wp), "ref4")
    if Hp < 16 * mb_h + 2 * MC.PAD_MC or Wp < 16 * mb_w + 2 * MC.PAD_MC:
        raise ValueError("ref4 smaller than the padded frame")
    if ref4.data_ptr() % 16 or Wp % 4:
        raise ValueError("ref4: the kernel's 16-byte loads need a 16-byte "
                         "aligned tensor whose width is a multiple of 4")
    out = torch.empty((S, mb_h * mb_w, 4, WIN_L, WIN_L), dtype=torch.uint8,
                      device=ref4.device)
    code = _build.lib().x264t_luma_windows(
        ref4.data_ptr(), out.data_ptr(), S, mb_h, mb_w, Hp, Wp, M_LUMA,
        MC.PAD_MC, _build.stream_ptr(ref4.device))
    _build.check(code, "x264t_luma_windows")
    _build.count_launch(launches, "luma_windows")
    return out


def chroma_windows_cuda(refc, mb_w: int, mb_h: int):
    S, Hc, Wc = refc.shape
    _build.require_cuda(refc, torch.int32, (S, Hc, Wc), "refc")
    if Hc < 8 * mb_h + MC.PAD_MC or Wc < 8 * mb_w + MC.PAD_MC:
        raise ValueError("refc smaller than the padded frame")
    if refc.data_ptr() % 16 or Wc % 4:
        raise ValueError("refc: the kernel's 16-byte loads need a 16-byte "
                         "aligned tensor whose width is a multiple of 4")
    out = torch.empty((S, mb_h * mb_w, WIN_C, WIN_C), dtype=torch.uint8,
                      device=refc.device)
    code = _build.lib().x264t_chroma_windows(
        refc.data_ptr(), out.data_ptr(), S, mb_h, mb_w, Hc, Wc, M_CHROMA,
        MC.PAD_MC // 2, _build.stream_ptr(refc.device))
    _build.check(code, "x264t_chroma_windows")
    _build.count_launch(launches, "chroma_windows")
    return out


def luma_windows(ref4, mb_w: int, mb_h: int):
    _check_ref(ref4, 4, "ref4")
    fn = luma_windows_cuda if ref4.is_cuda else luma_windows_plain
    return fn(ref4, mb_w, mb_h)


def chroma_windows(refc, mb_w: int, mb_h: int):
    _check_ref(refc, 3, "refc")
    fn = chroma_windows_cuda if refc.is_cuda else chroma_windows_plain
    return fn(refc, mb_w, mb_h)


# ---------------------------------------------------------------------------
# MC by direct indexed loads
# ---------------------------------------------------------------------------

def _gather_blocks(wins, plane, row0, col0, bh: int, bw: int):
    """wins (N, P, W, W) -> (N, C, bh, bw) int32 blocks whose top-left
    is (row0, col0) of plane `plane`; plane/row0/col0 (N, C)."""
    N, _, Wn, _ = wins.shape
    C = row0.shape[1]
    dev = wins.device
    r = torch.arange(bh, device=dev)[:, None]
    c = torch.arange(bw, device=dev)[None, :]
    idx = ((plane.long() * Wn + row0.long())[..., None, None] + r) * Wn \
        + col0.long()[..., None, None] + c               # (N, C, bh, bw)
    flat = wins.reshape(N, -1)
    out = torch.gather(flat, 1, idx.reshape(N, C * bh * bw))
    return out.reshape(N, C, bh, bw).to(torch.int32)


def clamp_qpel(mv, margin: int = M_LUMA):
    return mv.clamp(-4 * (margin - 1), 4 * (margin - 1) - 1)


def mc_luma_multi(wins4, mvx, mvy, bh: int, bw: int, sub_y: int = 0,
                  sub_x: int = 0, margin: int = M_LUMA):
    """wins4 (N, 4, W, W); mvx/mvy (N, C) qpel MVs relative to the
    window's centre block -> (N, C, bh, bw) int32 (mc_luma)."""
    ref0 = device_table(MC.HPEL_REF0, wins4.device, torch.long)
    ref1 = device_table(MC.HPEL_REF1, wins4.device, torch.long)
    qidx = (((mvy & 3) << 2) + (mvx & 3)).long()
    fy = (mvy >> 2) + margin + sub_y
    fx = (mvx >> 2) + margin + sub_x
    y1 = fy + ((mvy & 3) == 3).to(torch.int32)
    x2 = fx + ((mvx & 3) == 3).to(torch.int32)
    src1 = _gather_blocks(wins4, ref0[qidx], y1, fx, bh, bw)
    src2 = _gather_blocks(wins4, ref1[qidx], fy, x2, bh, bw)
    avg = (src1 + src2 + 1) >> 1
    return torch.where(((qidx & 5) != 0)[..., None, None], avg, src1)


def mc_luma_batched(wins4, mvx, mvy, bh: int, bw: int, sub_y: int = 0,
                    sub_x: int = 0, margin: int = M_LUMA):
    """Single-candidate mc_luma: mvx/mvy (N,) -> (N, bh, bw) int32."""
    return mc_luma_multi(wins4, mvx[:, None], mvy[:, None], bh, bw, sub_y,
                         sub_x, margin)[:, 0]


def mc_chroma_batched(winsc, mvx, mvy, bh: int, bw: int, sub_y: int = 0,
                      sub_x: int = 0):
    """1/8-pel bilinear chroma MC: winsc (N, WIN_C, WIN_C); mv in luma
    qpel units (= chroma 1/8 pel), (N,) -> (N, bh, bw) int32."""
    d8x = (mvx & 7)[:, None, None]
    d8y = (mvy & 7)[:, None, None]
    fy = (mvy >> 3) + M_CHROMA + sub_y
    fx = (mvx >> 3) + M_CHROMA + sub_x
    win = _gather_blocks(winsc[:, None], torch.zeros_like(fy)[:, None],
                         fy[:, None], fx[:, None], bh + 1, bw + 1)[:, 0]
    s00 = win[:, 0:bh, 0:bw]
    s01 = win[:, 0:bh, 1:bw + 1]
    s10 = win[:, 1:bh + 1, 0:bw]
    s11 = win[:, 1:bh + 1, 1:bw + 1]
    return ((8 - d8x) * (8 - d8y) * s00 + d8x * (8 - d8y) * s01
            + (8 - d8x) * d8y * s10 + d8x * d8y * s11 + 32) >> 6


def extract_windows4(wins4, base_x, base_y, bh: int, bw: int, m: int,
                     sub_y: int = 0, sub_x: int = 0):
    """Re-centre per-MB hpel windows on full-pel (base_y, base_x):
    (N, 4, WIN_L, WIN_L) -> (N, 4, bh+2m, bw+2m) uint8."""
    N = wins4.shape[0]
    rows_n, cols_n = bh + 2 * m, bw + 2 * m
    planes = torch.arange(4, device=wins4.device, dtype=torch.int32)
    r0 = (base_y + (M_LUMA + sub_y - m))[:, None].expand(N, 4)
    c0 = (base_x + (M_LUMA + sub_x - m))[:, None].expand(N, 4)
    out = _gather_blocks(wins4, planes[None].expand(N, 4), r0, c0, rows_n,
                         cols_n)
    return out.to(torch.uint8)
