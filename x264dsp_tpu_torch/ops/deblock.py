"""In-loop deblocking (common/deblock.c) — port of x264dsp_tpu/ops/deblock.py.

``deblock_frame`` filters a batch of S frames in raster MB order:
alpha/beta/tc0 spec tables (deblock.c:26-78), the normal and intra edge
filters (:80-295), per-MB decoded QP with the (qp + qp_nb + 1) >> 1
average on MB edges (:341-430). On a CUDA tensor it launches kernel K3
(``csrc/deblock.cu``); on a CPU tensor it runs ``deblock_frame_plain``,
the same wavefront written in plain PyTorch: one step per diagonal
x + 2y = d, each step gathering the 20x20 luma / 12x12 chroma region of
every MB on the diagonal (all streams at once), filtering the 4+4 luma
and 2+2 chroma edges in deblock.c order, and scattering the regions
back. Regions on one diagonal are disjoint, so the scatter writes
disjoint indices.

Kernel K3 replaces x264dsp_tpu/ops/pallas/deblock_skew.py::
deblock_skew_call. It is bound by the latency of the 254 dependent
diagonal steps at 1080p, so it runs one block per (stream, plane group)
that walks every diagonal, with the raw per-MB grids as parameters in
place of the TPU's skewed lane layout (see the source note in the .cu).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .devtab import device_table

# spec tables (common/deblock.c:26-78), index 0..51; copied from
# x264dsp_tpu/ops/deblock.py (that module imports JAX)
ALPHA_TABLE = np.zeros(52, np.int32)
ALPHA_TABLE[16:52] = [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25,
                      28, 32, 36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113,
                      127, 144, 162, 182, 203, 226, 255, 255]
BETA_TABLE = np.zeros(52, np.int32)
BETA_TABLE[16:52] = [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9,
                     10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16,
                     17, 17, 18, 18]
TC0_TABLE = np.zeros((52, 4), np.int32)
TC0_TABLE[:, 0] = -1
_TC0_ROWS = [
    (17, [0, 0, 1]), (18, [0, 0, 1]), (19, [0, 0, 1]), (20, [0, 0, 1]),
    (21, [0, 1, 1]), (22, [0, 1, 1]), (23, [1, 1, 1]), (24, [1, 1, 1]),
    (25, [1, 1, 1]), (26, [1, 1, 1]), (27, [1, 1, 2]), (28, [1, 1, 2]),
    (29, [1, 1, 2]), (30, [1, 1, 2]), (31, [1, 2, 3]), (32, [1, 2, 3]),
    (33, [2, 2, 3]), (34, [2, 2, 4]), (35, [2, 3, 4]), (36, [2, 3, 4]),
    (37, [3, 3, 5]), (38, [3, 4, 6]), (39, [3, 4, 6]), (40, [4, 5, 7]),
    (41, [4, 5, 8]), (42, [4, 6, 9]), (43, [5, 7, 10]), (44, [6, 8, 11]),
    (45, [6, 8, 13]), (46, [7, 10, 14]), (47, [8, 11, 16]),
    (48, [9, 12, 18]), (49, [10, 13, 20]), (50, [11, 15, 23]),
    (51, [13, 17, 25]),
]
for _qp, _v in _TC0_ROWS:
    TC0_TABLE[_qp, 1:] = _v
# the kernel's one parameter table: alpha | beta | tc0 rows
_KERNEL_TAB = np.concatenate([ALPHA_TABLE, BETA_TABLE, TC0_TABLE.ravel()])

PAD_DB = 8
launches = 0            # K3 launches (chip_smoke.py checks the main path)


def diag_schedule(mb_w: int, mb_h: int):
    """2:1 wavefront: per diagonal d, the MB rows y with 0 <= d-2y < mb_w
    (x = d - 2y). Returns a list of (ys, xs) int lists."""
    n_diag = mb_w + 2 * mb_h - 2
    out = []
    for d in range(n_diag):
        ys = [y for y in range(mb_h) if 0 <= d - 2 * y < mb_w]
        out.append((ys, [d - 2 * y for y in ys]))
    return out


def compute_strengths(nnz4, mv4, ref4, intra_mb):
    """deblock_strength_c (common/deblock.c:297) + intra rules over frame
    4x4-block grids with a leading stream axis: nnz4, ref4 (S, 4mb_h,
    4mb_w); mv4 (S, 4mb_h, 4mb_w, 2); intra_mb (S, mb_h, mb_w) bool.
    Returns bs (S, mb_h, mb_w, 2, 4, 4) int32 [dir][edge][i]."""
    S, h4, w4 = nnz4.shape
    mb_h, mb_w = h4 // 4, w4 // 4

    def one_dir(sy, sx):
        n_nb = torch.roll(nnz4, (sy, sx), dims=(1, 2))
        r_nb = torch.roll(ref4, (sy, sx), dims=(1, 2))
        m_nb = torch.roll(mv4, (sy, sx), dims=(1, 2))
        bs2 = (nnz4 | n_nb) != 0
        bs1 = (ref4 != r_nb) | ((mv4 - m_nb).abs() >= 4).any(-1)
        return torch.where(bs2, 2, torch.where(bs1, 1, 0)).to(torch.int32)

    bs_v = one_dir(0, 1).reshape(S, mb_h, 4, mb_w, 4).permute(0, 1, 3, 4, 2)
    bs_h = one_dir(1, 0).reshape(S, mb_h, 4, mb_w, 4).permute(0, 1, 3, 2, 4)
    bs = torch.stack([bs_v, bs_h], dim=3)
    return torch.where(intra_mb[:, :, :, None, None, None], 3, bs) \
        .to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU path, and the reference K3 is held to)
# ---------------------------------------------------------------------------

def _filter_normal_luma(p2, p1, p0, q0, q1, q2, alpha, beta, tc0):
    """deblock_edge_luma_c (common/deblock.c:80-121)."""
    filt = (((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta)
            & ((q1 - q0).abs() < beta) & (tc0 >= 0))
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta
    pq1 = (p0 + q0 + 1) >> 1
    p1n = p1 + torch.maximum(torch.minimum(((p2 + pq1) >> 1) - p1, tc0), -tc0)
    q1n = q1 + torch.maximum(torch.minimum(((q2 + pq1) >> 1) - q1, tc0), -tc0)
    p1o = torch.where(filt & ap & (tc0 > 0), p1n, p1)
    q1o = torch.where(filt & aq & (tc0 > 0), q1n, q1)
    tc = tc0 + ap.to(torch.int32) + aq.to(torch.int32)
    delta = (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3
    delta = torch.maximum(torch.minimum(delta, tc), -tc)
    p0o = torch.where(filt, (p0 + delta).clamp(0, 255), p0)
    q0o = torch.where(filt, (q0 - delta).clamp(0, 255), q0)
    return p1o, p0o, q0o, q1o


def _filter_intra_luma(p3, p2, p1, p0, q0, q1, q2, q3, alpha, beta):
    """deblock_edge_luma_intra_c (common/deblock.c:196-246)."""
    filt = (((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta)
            & ((q1 - q0).abs() < beta))
    strong = (p0 - q0).abs() < ((alpha >> 2) + 2)
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta
    p0s = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
    p1s = (p2 + p1 + p0 + q0 + 2) >> 2
    p2s = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3
    q0s = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3
    q1s = (p0 + q0 + q1 + q2 + 2) >> 2
    q2s = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3
    p0w = (2 * p1 + p0 + q1 + 2) >> 2
    q0w = (2 * q1 + q0 + p1 + 2) >> 2
    sp = filt & strong & ap
    sq = filt & strong & aq
    return (torch.where(sp, p2s, p2), torch.where(sp, p1s, p1),
            torch.where(filt, torch.where(strong & ap, p0s, p0w), p0),
            torch.where(filt, torch.where(strong & aq, q0s, q0w), q0),
            torch.where(sq, q1s, q1), torch.where(sq, q2s, q2))


def _filter_chroma(p1, p0, q0, q1, alpha, beta, tc, intra):
    """deblock_edge_chroma_c / _intra_c (common/deblock.c:147-195);
    tc already +1."""
    base = (((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta)
            & ((q1 - q0).abs() < beta))
    filt = base & (tc > 0)
    delta = (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3
    delta = torch.maximum(torch.minimum(delta, tc), -tc)
    p0n = torch.where(filt, (p0 + delta).clamp(0, 255), p0)
    q0n = torch.where(filt, (q0 - delta).clamp(0, 255), q0)
    p0i = torch.where(base, (2 * p1 + p0 + q1 + 2) >> 2, p0)
    q0i = torch.where(base, (2 * q1 + q0 + p1 + 2) >> 2, q0)
    return torch.where(intra, p0i, p0n), torch.where(intra, q0i, q0n)


def _luma_edge(reg, dir_, e, bs, use_intra, enabled, alpha, beta, ia, tc0t):
    """Filter luma edge e of direction dir_ in the (S, K, 20, 20) regions
    (MB at [4:20, 4:20]) in place. bs (S, K, 4) groups; per-(S, K)
    scalars otherwise."""
    c = 4 + 4 * e
    if dir_ == 0:
        line = [reg[:, :, 4:20, c - 4 + i] for i in range(8)]
    else:
        line = [reg[:, :, c - 4 + i, 4:20] for i in range(8)]
    p3, p2, p1, p0, q0, q1, q2, q3 = line
    tc0 = tc0t[ia[..., None], bs.clamp(0, 3)].repeat_interleave(4, -1)
    a, b = alpha[..., None], beta[..., None]
    p1n, p0n, q0n, q1n = _filter_normal_luma(p2, p1, p0, q0, q1, q2, a, b,
                                             tc0)
    ui = use_intra[..., None]
    intra = _filter_intra_luma(p3, p2, p1, p0, q0, q1, q2, q3, a, b)
    new = [torch.where(ui, intra[0], p2), torch.where(ui, intra[1], p1n),
           torch.where(ui, intra[2], p0n), torch.where(ui, intra[3], q0n),
           torch.where(ui, intra[4], q1n), torch.where(ui, intra[5], q2)]
    en = enabled[..., None]
    new = [torch.where(en, nv, ov) for nv, ov in zip(new, line[1:7])]
    for i, nv in enumerate(new):
        if dir_ == 0:
            reg[:, :, 4:20, c - 3 + i] = nv
        else:
            reg[:, :, c - 3 + i, 4:20] = nv


def _chroma_edge(reg, dir_, e, bs, use_intra, enabled, alpha, beta, ia,
                 tc0t):
    """Chroma edge e (0 = MB edge, 1 = internal) of the (S, K, 2, 12, 12)
    u/v regions (MB at [4:12, 4:12]) in place; bs (S, K, 4)."""
    c = 4 + 4 * e
    if dir_ == 0:
        line = [reg[..., 4:12, c - 2 + i] for i in range(4)]
    else:
        line = [reg[..., c - 2 + i, 4:12] for i in range(4)]
    p1, p0, q0, q1 = line
    tc = tc0t[ia[..., None], bs.clamp(0, 3)].repeat_interleave(2, -1) + 1
    tc = tc[:, :, None]
    a, b = alpha[:, :, None, None], beta[:, :, None, None]
    p0o, q0o = _filter_chroma(p1, p0, q0, q1, a, b, tc,
                              use_intra[:, :, None, None])
    en = enabled[:, :, None, None]
    p0o = torch.where(en, p0o, p0)
    q0o = torch.where(en, q0o, q0)
    if dir_ == 0:
        reg[..., 4:12, c - 1] = p0o
        reg[..., 4:12, c] = q0o
    else:
        reg[..., c - 1, 4:12] = p0o
        reg[..., c, 4:12] = q0o


def deblock_frame_plain(y, u, v, bs, intra_mb, first_edge_only, qp, qpc,
                        alpha_off: int, beta_off: int, mb_w: int, mb_h: int):
    """Plain-PyTorch deblock of S frames: y (S, 16mb_h, 16mb_w), u/v
    (S, 8mb_h, 8mb_w); bs (S, mb_h, mb_w, 2, 4, 4); intra_mb,
    first_edge_only, qp, qpc (S, mb_h, mb_w) decoded-QP grids. Returns
    filtered int32 (y, u, v)."""
    dev = y.device
    i32 = torch.int32
    S = y.shape[0]
    alpha_t = torch.as_tensor(ALPHA_TABLE, device=dev)
    beta_t = torch.as_tensor(BETA_TABLE, device=dev)
    tc0t = torch.as_tensor(TC0_TABLE, device=dev)
    P = PAD_DB
    yp = torch.nn.functional.pad(y.to(i32), (P, P, P, P))
    cp = torch.nn.functional.pad(torch.stack([u.to(i32), v.to(i32)], 1),
                                 (P, P, P, P))
    sidx = torch.arange(S, device=dev)
    ar20 = torch.arange(20, device=dev)
    ar12 = torch.arange(12, device=dev)

    def ab(qpe):
        ia = (qpe + alpha_off).clamp(0, 51).long()
        ib = (qpe + beta_off).clamp(0, 51).long()
        return alpha_t[ia], beta_t[ib], ia

    for ys_l, xs_l in diag_schedule(mb_w, mb_h):
        ys = torch.tensor(ys_l, device=dev)
        xs = torch.tensor(xs_l, device=dev)
        xl = (xs - 1).clamp(min=0)
        yt = (ys - 1).clamp(min=0)
        has_l = (xs > 0)[None].expand(S, -1)
        has_t = (ys > 0)[None].expand(S, -1)
        ic = intra_mb[:, ys, xs] > 0
        il = intra_mb[:, ys, xl] > 0
        it = intra_mb[:, yt, xs] > 0
        internal = first_edge_only[:, ys, xs] == 0
        bs_mb = bs[:, ys, xs]                         # (S, K, 2, 4, 4)

        ry = (ys[:, None] * 16 + P - 4 + ar20)[None, :, :, None]
        rx = (xs[:, None] * 16 + P - 4 + ar20)[None, :, None, :]
        regy = yp[sidx[:, None, None, None], ry, rx]  # (S, K, 20, 20)
        cy = (ys[:, None] * 8 + P - 4 + ar12)[None, :, None, :, None]
        cx = (xs[:, None] * 8 + P - 4 + ar12)[None, :, None, None, :]
        ch = torch.arange(2, device=dev)[None, None, :, None, None]
        regc = cp[sidx[:, None, None, None, None], ch, cy, cx]

        for grid, reg, edge_fn, n_e in ((qp, regy, _luma_edge, 4),
                                        (qpc, regc, _chroma_edge, 2)):
            cur = grid[:, ys, xs]
            for dir_, nb, has, i_nb in ((0, grid[:, ys, xl], has_l, il),
                                        (1, grid[:, yt, xs], has_t, it)):
                a0, b0, ia0 = ab((cur + nb + 1) >> 1)
                a1, b1, ia1 = ab(cur)
                for e in range(n_e):
                    bs_row = e if n_e == 4 else 2 * e
                    edge_fn(reg, dir_, e, bs_mb[:, :, dir_, bs_row],
                            (ic | i_nb) & (e == 0),
                            has if e == 0 else internal,
                            a0 if e == 0 else a1, b0 if e == 0 else b1,
                            ia0 if e == 0 else ia1, tc0t)
        yp[sidx[:, None, None, None], ry, rx] = regy
        cp[sidx[:, None, None, None, None], ch, cy, cx] = regc
    H, W = 16 * mb_h, 16 * mb_w
    return (yp[:, P:P + H, P:P + W], cp[:, 0, P:P + H // 2, P:P + W // 2],
            cp[:, 1, P:P + H // 2, P:P + W // 2])


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def deblock_frame_cuda(y, u, v, bs, intra_mb, first_edge_only, qp, qpc,
                       alpha_off: int, beta_off: int, mb_w: int, mb_h: int):
    """Launch kernel K3 on S frames (arguments as deblock_frame_plain,
    all int32 CUDA tensors). Returns new filtered planes."""
    global launches
    S = y.shape[0]
    H, W = 16 * mb_h, 16 * mb_w
    grid = (S, mb_h, mb_w)
    for t, shape, name in ((y, (S, H, W), "y"), (u, (S, H // 2, W // 2), "u"),
                           (v, (S, H // 2, W // 2), "v"),
                           (bs, grid + (2, 4, 4), "bs"),
                           (intra_mb, grid, "intra_mb"),
                           (first_edge_only, grid, "first_edge_only"),
                           (qp, grid, "qp"), (qpc, grid, "qpc")):
        _build.require_cuda(t, torch.int32, shape, name)
    oy, ou, ov = (torch.empty_like(t) for t in (y, u, v))
    oy.copy_(y)
    ou.copy_(u)
    ov.copy_(v)
    lib = _build.lib()
    code = lib.x264t_deblock(
        oy.data_ptr(), ou.data_ptr(), ov.data_ptr(), bs.data_ptr(),
        intra_mb.data_ptr(), first_edge_only.data_ptr(), qp.data_ptr(),
        qpc.data_ptr(), device_table(_KERNEL_TAB, y.device).data_ptr(), S, mb_h, mb_w,
        int(alpha_off), int(beta_off), _build.stream_ptr(y.device))
    _build.check(code, "x264t_deblock")
    launches += 1
    return oy, ou, ov


def deblock_frame(y, u, v, bs, intra_mb, first_edge_only, qp, qpc,
                  alpha_off: int, beta_off: int, mb_w: int, mb_h: int):
    """Deblock S frames (see deblock_frame_plain for the arguments):
    kernel K3 on a CUDA tensor, the plain version on a CPU tensor."""
    fn = deblock_frame_cuda if y.is_cuda else deblock_frame_plain
    return fn(y, u, v, bs, intra_mb, first_edge_only, qp, qpc, alpha_off,
              beta_off, mb_w, mb_h)
