"""In-loop deblocking (common/deblock.c) — port of x264dsp_tpu/ops/deblock.py.

``deblock_frame`` filters a batch of S frames in raster MB order:
alpha/beta/tc0 spec tables (deblock.c:26-78), the normal and intra edge
filters (:80-295), per-MB decoded QP with the (qp + qp_nb + 1) >> 1
average on MB edges (:341-430). It has three routes that compute the
same function, the counterpart of the JAX ``use_pallas`` argument:

- ``route=None`` (default): kernel K3 (``csrc/deblock.cu``) reads the raw
  per-MB grids and filters the whole frame in one launch, one warp per MB
  row, each row 2 MBs behind the row above;
- ``route="wave"``: ``wave_lanes`` precomputes the per-diagonal per-slot
  filter lanes, then kernels K5a (``deblock_wave_luma``) and K5b
  (``deblock_wave_chroma``) filter the whole frame from those lanes, one
  launch each, in K3's row pipeline;
- ``route="region"``: per diagonal x + 2y = d, an indexed gather of the
  20x20 luma / 12x12 chroma regions of every MB on it (all streams at
  once), kernel K6 (``filter_regions``) on the gathered regions with that
  diagonal's lanes, and an indexed scatter back; one launch per diagonal.

On a CPU tensor each wrapper runs its plain PyTorch version instead
(``deblock_frame_plain``, ``deblock_wave_luma_plain``,
``deblock_wave_chroma_plain``, ``filter_regions_plain``): one step per
diagonal, each filtering the 4+4 luma and 2+2 chroma edges in deblock.c
order. Regions on one diagonal are disjoint, so a scatter writes
disjoint indices.

K3 replaces x264dsp_tpu/ops/pallas/deblock_skew.py::deblock_skew_call,
K5a/K5b replace ops/pallas/deblock_wave.py::deblock_wave_luma/_chroma and
K6 replaces ops/pallas/deblock_filter.py::filter_regions. K3 and K5 are
bound by the latency of the 254 dependent MB steps at 1080p, and share
one row pipeline: one warp per MB row (of each stream and plane group)
walks its row 2 MBs behind the row above, progress counters between
rows, the rows of all streams across the SMs; K3 reads its filter
parameters from the grids, K5a / K5b from the lanes (the 2:1 diagonals
order every pair of overlapping MB regions as raster order does). K6
moves under 2 MB a launch, so one warp per MB stages its regions and
lanes in shared memory with 16-byte copies before the chain (see the
source notes in the .cu). None keeps the TPU's skewed lane layout,
superwindows or one-hot matmuls.
"""

from __future__ import annotations

import functools

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
KB = 16                 # filter_regions takes a multiple of KB regions
# CUDA launches of K3 / K5a / K5b / K6 (chip_smoke.py checks the paths)
launches = {"deblock": 0, "deblock_wave_luma": 0, "deblock_wave_chroma": 0,
            "filter_regions": 0}


def diag_schedule(mb_w: int, mb_h: int):
    """2:1 wavefront: per diagonal d, the MB rows y with 0 <= d-2y < mb_w
    (x = d - 2y). Returns a list of (ys, xs) int lists."""
    n_diag = mb_w + 2 * mb_h - 2
    out = []
    for d in range(n_diag):
        ys = [y for y in range(mb_h) if 0 <= d - 2 * y < mb_w]
        out.append((ys, [d - 2 * y for y in ys]))
    return out


@functools.lru_cache(maxsize=None)
def diag_slots(mb_w: int, mb_h: int):
    """The schedule as (D, K) int64 arrays (ys, xs): slot k of diagonal d
    is MB (ys[d, k], xs[d, k]); K is the longest diagonal and unused
    slots hold -1 (they trail the used ones)."""
    sched = diag_schedule(mb_w, mb_h)
    K = max(len(ys) for ys, _ in sched)
    ys = np.full((len(sched), K), -1, np.int64)
    xs = np.full((len(sched), K), -1, np.int64)
    for d, (ys_l, xs_l) in enumerate(sched):
        ys[d, :len(ys_l)] = ys_l
        xs[d, :len(xs_l)] = xs_l
    return ys, xs


def _device_slots(mb_w: int, mb_h: int, dev):
    """diag_slots as device tensors, and each diagonal's slot count."""
    ys, xs = diag_slots(mb_w, mb_h)
    return (device_table(ys, dev, torch.long),
            device_table(xs, dev, torch.long), (ys >= 0).sum(1).tolist())


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


def _luma_edge_lanes(reg, dir_, e, tc0, use_intra, enabled, alpha, beta):
    """Filter luma edge e of direction dir_ in the (..., 20, 20) regions
    (MB at [4:20, 4:20]) in place. tc0 (..., 16) per pixel line;
    use_intra, enabled (bool), alpha, beta (..., 1) per region."""
    c = 4 + 4 * e
    if dir_ == 0:
        line = [reg[..., 4:20, c - 4 + i] for i in range(8)]
    else:
        line = [reg[..., c - 4 + i, 4:20] for i in range(8)]
    p3, p2, p1, p0, q0, q1, q2, q3 = line
    p1n, p0n, q0n, q1n = _filter_normal_luma(p2, p1, p0, q0, q1, q2, alpha,
                                             beta, tc0)
    intra = _filter_intra_luma(p3, p2, p1, p0, q0, q1, q2, q3, alpha, beta)
    ui = use_intra
    new = [torch.where(ui, intra[0], p2), torch.where(ui, intra[1], p1n),
           torch.where(ui, intra[2], p0n), torch.where(ui, intra[3], q0n),
           torch.where(ui, intra[4], q1n), torch.where(ui, intra[5], q2)]
    new = [torch.where(enabled, nv, ov) for nv, ov in zip(new, line[1:7])]
    for i, nv in enumerate(new):
        if dir_ == 0:
            reg[..., 4:20, c - 3 + i] = nv
        else:
            reg[..., c - 3 + i, 4:20] = nv


def _chroma_edge_lanes(reg, dir_, e, tc, use_intra, enabled, alpha, beta):
    """Chroma edge e (0 = MB edge, 1 = internal) of the (..., 12, 12)
    regions (MB at [4:12, 4:12]) in place. tc (..., 8) per pixel line,
    already +1; use_intra, enabled (bool), alpha, beta (..., 1)."""
    c = 4 + 4 * e
    if dir_ == 0:
        line = [reg[..., 4:12, c - 2 + i] for i in range(4)]
    else:
        line = [reg[..., c - 2 + i, 4:12] for i in range(4)]
    p1, p0, q0, q1 = line
    p0o, q0o = _filter_chroma(p1, p0, q0, q1, alpha, beta, tc, use_intra)
    p0o = torch.where(enabled, p0o, p0)
    q0o = torch.where(enabled, q0o, q0)
    if dir_ == 0:
        reg[..., 4:12, c - 1] = p0o
        reg[..., 4:12, c] = q0o
    else:
        reg[..., c - 1, 4:12] = p0o
        reg[..., c, 4:12] = q0o


def _luma_edge(reg, dir_, e, bs, use_intra, enabled, alpha, beta, ia, tc0t):
    """Luma edge e of direction dir_ of the (S, K, 20, 20) regions in
    place, from raw grids: bs (S, K, 4) groups; per-(S, K) scalars
    otherwise."""
    tc0 = tc0t[ia[..., None], bs.clamp(0, 3)].repeat_interleave(4, -1)
    _luma_edge_lanes(reg, dir_, e, tc0, use_intra[..., None],
                     enabled[..., None], alpha[..., None], beta[..., None])


def _chroma_edge(reg, dir_, e, bs, use_intra, enabled, alpha, beta, ia,
                 tc0t):
    """Chroma edge e of the (S, K, 2, 12, 12) u/v regions in place, from
    raw grids; bs (S, K, 4)."""
    tc = tc0t[ia[..., None], bs.clamp(0, 3)].repeat_interleave(2, -1) + 1
    exp = (slice(None), slice(None), None, None)
    _chroma_edge_lanes(reg, dir_, e, tc[:, :, None], use_intra[exp],
                       enabled[exp], alpha[exp], beta[exp])


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
        if not ys_l:        # the odd diagonals of a frame one MB wide
            continue
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
# K3: whole-frame kernel from the raw grids
# ---------------------------------------------------------------------------

def _copy(t):
    """A new contiguous tensor holding t (the kernels filter in place)."""
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    out.copy_(t)
    return out


def _row_sync(rows: int, dev):
    """A new scratch for a row-pipeline launch (K3, K5a, K5b): its ticket
    and the rows' progress counters, zeroed by the C entry point on the
    launch's stream. Never shared: two launches in flight would mix their
    counters."""
    return torch.empty(1 + rows, dtype=torch.int32, device=dev)


def deblock_frame_cuda(y, u, v, bs, intra_mb, first_edge_only, qp, qpc,
                       alpha_off: int, beta_off: int, mb_w: int, mb_h: int):
    """Launch kernel K3 on S frames (arguments as deblock_frame_plain,
    all int32 CUDA tensors). Returns new filtered planes."""
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
    oy, ou, ov = _copy(y), _copy(u), _copy(v)
    lib = _build.lib()
    code = lib.x264t_deblock(
        oy.data_ptr(), ou.data_ptr(), ov.data_ptr(), bs.data_ptr(),
        intra_mb.data_ptr(), first_edge_only.data_ptr(), qp.data_ptr(),
        qpc.data_ptr(), device_table(_KERNEL_TAB, y.device).data_ptr(),
        _row_sync(2 * S * mb_h, y.device).data_ptr(), S, mb_h, mb_w,
        int(alpha_off), int(beta_off), _build.stream_ptr(y.device))
    _build.check(code, "x264t_deblock")
    _build.count_launch(launches, "deblock")
    return oy, ou, ov


# ---------------------------------------------------------------------------
# filter lanes (the wave and region routes)
# ---------------------------------------------------------------------------

def wave_lanes(bs, intra_mb, first_edge_only, qp, qpc, alpha_off: int,
               beta_off: int, mb_w: int, mb_h: int):
    """Per-diagonal per-slot filter lanes for all wavefront steps at once
    (x264dsp_tpu/ops/deblock.py:371 _wave_lanes with a leading stream
    axis, same layouts). Arguments as deblock_frame_plain. Returns
    (tc0y, eny, uiy, aly, bly), (tcc, enc, uic, alc, blc) int32 with
    D = mb_w + 2 mb_h - 2 diagonals and K slots (diag_slots):
    tc0y (S, D, K, 128) at [dir * 64 + edge * 16 + pixel line];
    eny, uiy, aly, bly (S, D, K, 8) at [dir * 4 + edge]: edge enabled,
    intra filter, alpha, beta; tcc (S, D, 2K, 32) at [dir * 16 + edge * 8
    + line], tc0 + 1 from bs edge rows 0 and 2; enc, uic, alc, blc
    (S, D, 2K, 4) at [dir * 2 + edge]. Chroma slots interleave (u, v).
    Unused slots have every enable 0."""
    dev = bs.device
    i32 = torch.int32
    S = bs.shape[0]
    ys, xs, _ = _device_slots(mb_w, mb_h, dev)
    D, K = ys.shape
    valid = ys >= 0
    yc, xc = ys.clamp(min=0), xs.clamp(min=0)
    xl, yt = (xc - 1).clamp(min=0), (yc - 1).clamp(min=0)
    alpha_t = device_table(ALPHA_TABLE, dev)
    beta_t = device_table(BETA_TABLE, dev)
    tc0t = device_table(TC0_TABLE, dev)

    bs_mb = bs[:, yc, xc].clamp(0, 3).long()           # (S, D, K, 2, 4, 4)
    ic = intra_mb[:, yc, xc] > 0
    il = intra_mb[:, yc, xl] > 0
    it = intra_mb[:, yt, xc] > 0
    feo = first_edge_only[:, yc, xc] > 0
    has_l = ((xs > 0) & valid).to(i32)[None].expand(S, D, K)
    has_t = ((ys > 0) & valid).to(i32)[None].expand(S, D, K)
    internal = (~feo & valid).to(i32)
    f0 = torch.zeros((S, D, K), dtype=i32, device=dev)

    def edge_idx(grid, n_edges):
        cur = grid[:, yc, xc]
        qpe = cur[..., None, None].repeat(1, 1, 1, 2, n_edges)
        qpe[..., 0, 0] = (cur + grid[:, yc, xl] + 1) >> 1
        qpe[..., 1, 0] = (cur + grid[:, yt, xc] + 1) >> 1
        return ((qpe + alpha_off).clamp(0, 51).long(),
                (qpe + beta_off).clamp(0, 51).long())

    ia_l, ib_l = edge_idx(qp, 4)                        # (S, D, K, 2, 4)
    ia_c, ib_c = edge_idx(qpc, 2)
    tc0y = tc0t[ia_l[..., None], bs_mb].repeat_interleave(4, -1) \
        .reshape(S, D, K, 128)
    tcc = (tc0t[ia_c[..., None], bs_mb[..., ::2, :]] + 1) \
        .repeat_interleave(2, -1).reshape(S, D, K, 32)
    ui_l = (ic | il).to(i32)
    ui_t = (ic | it).to(i32)
    eny = torch.stack([has_l, internal, internal, internal,
                       has_t, internal, internal, internal], -1)
    uiy = torch.stack([ui_l, f0, f0, f0, ui_t, f0, f0, f0], -1)
    enc = torch.stack([has_l, internal, has_t, internal], -1)
    uic = torch.stack([ui_l, f0, ui_t, f0], -1)
    luma = (tc0y, eny, uiy, alpha_t[ia_l].reshape(S, D, K, 8),
            beta_t[ib_l].reshape(S, D, K, 8))
    chroma = (tcc, enc, uic, alpha_t[ia_c].reshape(S, D, K, 4),
              beta_t[ib_c].reshape(S, D, K, 4))
    return (tuple(t.contiguous() for t in luma),
            tuple(t.repeat_interleave(2, 2).contiguous() for t in chroma))


# ---------------------------------------------------------------------------
# K6: the 12-edge chain on gathered regions
# ---------------------------------------------------------------------------

def _luma_chain(reg, tc0y, eny, uiy, aly, bly):
    """The 8 luma edges (4 vertical, then 4 horizontal) of the
    (..., 20, 20) regions in place, lanes (..., 128) / (..., 8)."""
    for d in range(2):
        for e in range(4):
            k = d * 4 + e
            _luma_edge_lanes(reg, d, e, tc0y[..., 16 * k:16 * k + 16],
                             uiy[..., k:k + 1] != 0, eny[..., k:k + 1] != 0,
                             aly[..., k:k + 1], bly[..., k:k + 1])


def _chroma_chain(reg, tcc, enc, uic, alc, blc):
    """The 4 chroma edges of the (..., 12, 12) regions in place, lanes
    (..., 32) / (..., 4)."""
    for d in range(2):
        for e in range(2):
            k = d * 2 + e
            _chroma_edge_lanes(reg, d, e, tcc[..., 8 * k:8 * k + 8],
                               uic[..., k:k + 1] != 0, enc[..., k:k + 1] != 0,
                               alc[..., k:k + 1], blc[..., k:k + 1])


def filter_regions_plain(regy, regc, tc0y, tcc, eny, uiy, enc, uic,
                         aly, bly, alc, blc):
    """Plain version of filter_regions: the 12-edge chain (4 + 4 luma,
    2 + 2 chroma, vertical before horizontal) on gathered regions. regy
    (K, 20, 20), regc (2K, 12, 12) with chroma rows interleaved per MB
    (u then v); lanes as wave_lanes lays them out, without the stream
    and diagonal axes. Returns new (regy, regc)."""
    oy = regy.to(torch.int32).clone()
    oc = regc.to(torch.int32).clone()
    _luma_chain(oy, tc0y, eny, uiy, aly, bly)
    _chroma_chain(oc, tcc, enc, uic, alc, blc)
    return oy, oc


def _region_shapes(K: int):
    return (("regy", (K, 20, 20)), ("regc", (2 * K, 12, 12)),
            ("tc0y", (K, 128)), ("tcc", (2 * K, 32)), ("eny", (K, 8)),
            ("uiy", (K, 8)), ("enc", (2 * K, 4)), ("uic", (2 * K, 4)),
            ("aly", (K, 8)), ("bly", (K, 8)), ("alc", (2 * K, 4)),
            ("blc", (2 * K, 4)))


def filter_regions_cuda(regy, regc, tc0y, tcc, eny, uiy, enc, uic,
                        aly, bly, alc, blc):
    """Launch kernel K6 (arguments as filter_regions_plain, int32 CUDA
    tensors with 16-byte aligned bases, K a multiple of KB). Returns new
    (regy, regc)."""
    K = regy.shape[0]
    if K % KB:
        raise ValueError(f"filter_regions: K = {K} is no multiple of {KB}")
    args = (regy, regc, tc0y, tcc, eny, uiy, enc, uic, aly, bly, alc, blc)
    ptrs = []
    for t, (name, shape) in zip(args, _region_shapes(K)):
        _build.require_cuda(t, torch.int32, shape, name)
        ptrs.append(t.data_ptr())
        if ptrs[-1] % 16:
            raise ValueError(f"{name}: the kernel's 16-byte copies need a "
                             "16-byte aligned tensor")
    oy, oc = torch.empty_like(regy), torch.empty_like(regc)
    code = _build.lib().x264t_filter_regions(
        oy.data_ptr(), oc.data_ptr(), *ptrs, K,
        _build.stream_ptr(regy.device))
    _build.check(code, "x264t_filter_regions")
    _build.count_launch(launches, "filter_regions")
    return oy, oc


def filter_regions(regy, regc, tc0y, tcc, eny, uiy, enc, uic, aly, bly,
                   alc, blc):
    """The 12-edge chain on gathered regions (see filter_regions_plain):
    kernel K6 on CUDA tensors, the plain version on CPU tensors."""
    fn = filter_regions_cuda if regy.is_cuda else filter_regions_plain
    return fn(regy, regc, tc0y, tcc, eny, uiy, enc, uic, aly, bly, alc, blc)


# ---------------------------------------------------------------------------
# K5a / K5b: whole-frame wavefront from precomputed lanes
# ---------------------------------------------------------------------------

def region_index(ys, xs, mb: int, size: int, dev):
    """Row and column indices (k, size, 1) / (k, 1, size) of the regions
    of MBs (ys, xs) in a plane padded by 4."""
    ar = torch.arange(size, device=dev)
    return ((ys[:, None] * mb + ar)[:, :, None],
            (xs[:, None] * mb + ar)[:, None, :])


def deblock_wave_luma_plain(y, tc0y, eny, uiy, aly, bly, mb_w: int,
                            mb_h: int):
    """Plain version of deblock_wave_luma: for each diagonal in order,
    gather its slots' 20x20 regions, filter the 8 luma edges with that
    diagonal's lanes, scatter back."""
    dev = y.device
    yp = torch.nn.functional.pad(y.to(torch.int32), (4, 4, 4, 4))
    ys_all, xs_all, counts = _device_slots(mb_w, mb_h, dev)
    for d, k in enumerate(counts):
        ry, rx = region_index(ys_all[d, :k], xs_all[d, :k], 16, 20, dev)
        reg = yp[:, ry, rx]                              # (S, k, 20, 20)
        _luma_chain(reg, *(t[:, d, :k] for t in (tc0y, eny, uiy, aly, bly)))
        yp[:, ry, rx] = reg
    return yp[:, 4:-4, 4:-4].contiguous()


def deblock_wave_chroma_plain(u, v, tcc, enc, uic, alc, blc, mb_w: int,
                              mb_h: int):
    """Plain version of deblock_wave_chroma: as the luma one with 12x12
    regions of u and v and 4 edges; lane slots interleave (u, v)."""
    dev = u.device
    cp = torch.nn.functional.pad(
        torch.stack([u.to(torch.int32), v.to(torch.int32)], 1), (4, 4, 4, 4))
    ys_all, xs_all, counts = _device_slots(mb_w, mb_h, dev)
    S = u.shape[0]
    for d, k in enumerate(counts):
        ry, rx = region_index(ys_all[d, :k], xs_all[d, :k], 8, 12, dev)
        # (S, 2, k, 12, 12) -> (S, 2k, 12, 12), (u, v) interleaved per slot
        reg = cp[:, :, ry, rx].transpose(1, 2).reshape(S, 2 * k, 12, 12)
        _chroma_chain(reg, *(t[:, d, :2 * k]
                             for t in (tcc, enc, uic, alc, blc)))
        cp[:, :, ry, rx] = reg.reshape(S, k, 2, 12, 12).transpose(1, 2)
    return (cp[:, 0, 4:-4, 4:-4].contiguous(),
            cp[:, 1, 4:-4, 4:-4].contiguous())


def _require_lanes(lanes, names, S, D, K, widths):
    for t, name, w in zip(lanes, names, widths):
        _build.require_cuda(t, torch.int32, (S, D, K, w), name)


def deblock_wave_luma_cuda(y, tc0y, eny, uiy, aly, bly, mb_w: int,
                           mb_h: int):
    """Launch kernel K5a (arguments as deblock_wave_luma_plain, int32
    CUDA tensors). Returns new filtered planes."""
    S, D, K = eny.shape[:3]
    _build.require_cuda(y, torch.int32, (S, 16 * mb_h, 16 * mb_w), "y")
    if D != mb_w + 2 * mb_h - 2:
        raise ValueError(f"eny: expected {mb_w + 2 * mb_h - 2} diagonals")
    lanes = (tc0y, eny, uiy, aly, bly)
    _require_lanes(lanes, ("tc0y", "eny", "uiy", "aly", "bly"), S, D, K,
                   (128, 8, 8, 8, 8))
    oy = _copy(y)
    code = _build.lib().x264t_deblock_wave_luma(
        oy.data_ptr(), *(t.data_ptr() for t in lanes),
        _row_sync(S * mb_h, y.device).data_ptr(), S, mb_h, mb_w, K,
        _build.stream_ptr(y.device))
    _build.check(code, "x264t_deblock_wave_luma")
    _build.count_launch(launches, "deblock_wave_luma")
    return oy


def deblock_wave_chroma_cuda(u, v, tcc, enc, uic, alc, blc, mb_w: int,
                             mb_h: int):
    """Launch kernel K5b (arguments as deblock_wave_chroma_plain, int32
    CUDA tensors). Returns new filtered (u, v)."""
    S, D, K2 = enc.shape[:3]
    for t, name in ((u, "u"), (v, "v")):
        _build.require_cuda(t, torch.int32, (S, 8 * mb_h, 8 * mb_w), name)
    if D != mb_w + 2 * mb_h - 2 or K2 % 2:
        raise ValueError(f"enc: expected {mb_w + 2 * mb_h - 2} diagonals "
                         "and (u, v) slot pairs")
    lanes = (tcc, enc, uic, alc, blc)
    _require_lanes(lanes, ("tcc", "enc", "uic", "alc", "blc"), S, D, K2,
                   (32, 4, 4, 4, 4))
    ou, ov = _copy(u), _copy(v)
    code = _build.lib().x264t_deblock_wave_chroma(
        ou.data_ptr(), ov.data_ptr(), *(t.data_ptr() for t in lanes),
        _row_sync(S * mb_h, u.device).data_ptr(), S, mb_h, mb_w, K2 // 2,
        _build.stream_ptr(u.device))
    _build.check(code, "x264t_deblock_wave_chroma")
    _build.count_launch(launches, "deblock_wave_chroma")
    return ou, ov


def deblock_wave_luma(y, tc0y, eny, uiy, aly, bly, mb_w: int, mb_h: int):
    """Whole-frame luma deblock of S planes y (S, 16mb_h, 16mb_w) int32
    from the precomputed lanes of wave_lanes: kernel K5a on CUDA tensors,
    the plain version on CPU tensors."""
    fn = deblock_wave_luma_cuda if y.is_cuda else deblock_wave_luma_plain
    return fn(y, tc0y, eny, uiy, aly, bly, mb_w, mb_h)


def deblock_wave_chroma(u, v, tcc, enc, uic, alc, blc, mb_w: int,
                        mb_h: int):
    """Whole-frame chroma deblock of u, v (S, 8mb_h, 8mb_w) int32 from
    the precomputed lanes: kernel K5b on CUDA tensors, the plain version
    on CPU tensors."""
    fn = deblock_wave_chroma_cuda if u.is_cuda else deblock_wave_chroma_plain
    return fn(u, v, tcc, enc, uic, alc, blc, mb_w, mb_h)


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------

def deblock_frame_wave(y, u, v, bs, intra_mb, first_edge_only, qp, qpc,
                       alpha_off: int, beta_off: int, mb_w: int, mb_h: int):
    """Route "wave" (x264dsp_tpu/ops/deblock.py:581
    deblock_frame_wave_batched): the lanes of every diagonal, then one
    luma and one chroma wavefront call."""
    luma_l, chroma_l = wave_lanes(bs, intra_mb, first_edge_only, qp, qpc,
                                  alpha_off, beta_off, mb_w, mb_h)
    dy = deblock_wave_luma(y.to(torch.int32).contiguous(), *luma_l, mb_w,
                           mb_h)
    du, dv = deblock_wave_chroma(u.to(torch.int32).contiguous(),
                                 v.to(torch.int32).contiguous(), *chroma_l,
                                 mb_w, mb_h)
    return dy, du, dv


def _pad_kb(t, n: int):
    """Pad axis 0 with n zero rows (zero regions, zero enables)."""
    if not n:
        return t.contiguous()
    return torch.cat([t, t.new_zeros((n,) + tuple(t.shape[1:]))])


def deblock_frame_region(y, u, v, bs, intra_mb, first_edge_only, qp, qpc,
                         alpha_off: int, beta_off: int, mb_w: int,
                         mb_h: int):
    """Route "region" (the filter_regions path of x264dsp_tpu/ops/
    deblock.py:649-787): per diagonal, an indexed gather of the regions
    of all streams, one filter_regions call on them (padded to a multiple
    of KB with zero regions and zero enables) with that diagonal's slice
    of the lanes, and an indexed scatter."""
    dev = y.device
    S = y.shape[0]
    luma_l, chroma_l = wave_lanes(bs, intra_mb, first_edge_only, qp, qpc,
                                  alpha_off, beta_off, mb_w, mb_h)
    yp = torch.nn.functional.pad(y.to(torch.int32), (4, 4, 4, 4))
    cp = torch.nn.functional.pad(
        torch.stack([u.to(torch.int32), v.to(torch.int32)], 1), (4, 4, 4, 4))
    ys_all, xs_all, counts = _device_slots(mb_w, mb_h, dev)
    for d, k in enumerate(counts):
        n = S * k
        pad = -n % KB
        ys, xs = ys_all[d, :k], xs_all[d, :k]
        ry, rx = region_index(ys, xs, 16, 20, dev)
        cy, cx = region_index(ys, xs, 8, 12, dev)
        regy = yp[:, ry, rx].reshape(n, 20, 20)
        regc = cp[:, :, cy, cx].transpose(1, 2).reshape(2 * n, 12, 12)
        ly = [_pad_kb(t[:, d, :k].reshape(n, -1), pad) for t in luma_l]
        lc = [_pad_kb(t[:, d, :2 * k].reshape(2 * n, -1), 2 * pad)
              for t in chroma_l]
        oy, oc = filter_regions(
            _pad_kb(regy, pad), _pad_kb(regc, 2 * pad), ly[0], lc[0], ly[1],
            ly[2], lc[1], lc[2], ly[3], ly[4], lc[3], lc[4])
        yp[:, ry, rx] = oy[:n].reshape(S, k, 20, 20)
        cp[:, :, cy, cx] = oc[:2 * n].reshape(S, k, 2, 12, 12) \
            .transpose(1, 2)
    return (yp[:, 4:-4, 4:-4].contiguous(),
            cp[:, 0, 4:-4, 4:-4].contiguous(),
            cp[:, 1, 4:-4, 4:-4].contiguous())


def deblock_frame(y, u, v, bs, intra_mb, first_edge_only, qp, qpc,
                  alpha_off: int, beta_off: int, mb_w: int, mb_h: int,
                  route: str | None = None):
    """Deblock S frames (see deblock_frame_plain for the arguments).
    route None: kernel K3 on a CUDA tensor, deblock_frame_plain on a CPU
    tensor; "wave": wave_lanes, K5a and K5b; "region": one K6 call per
    diagonal. All three return the same planes."""
    args = (y, u, v, bs, intra_mb, first_edge_only, qp, qpc, alpha_off,
            beta_off, mb_w, mb_h)
    if route == "wave":
        return deblock_frame_wave(*args)
    if route == "region":
        return deblock_frame_region(*args)
    if route is not None:
        raise ValueError(f"unknown deblock route {route!r}")
    fn = deblock_frame_cuda if y.is_cuda else deblock_frame_plain
    return fn(*args)
