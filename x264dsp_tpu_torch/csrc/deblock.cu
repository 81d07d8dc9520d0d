// H.264 in-loop deblocking filter: kernels K3 (whole frame from the raw
// per-MB grids), K5a / K5b (whole frame from precomputed filter lanes) and
// K6 (the edge chain on gathered regions). All share the edge filters
// edge_luma / edge_chroma and the line walk filter_line; K3, K5a and K5b
// share one row walk, deblock_row, which takes its filter parameters from
// a source: GridSource (K3) or LaneSource (K5a, K5b).
//
// K3
// --
// Replaces x264dsp_tpu/ops/pallas/deblock_skew.py::deblock_skew_call
// (Pallas _kernel, _edge_luma, _edge_chroma), reached from
// ops/deblock.py::deblock_frame_skew_batched: the normal (bS < 4) and
// intra (bS = 4) luma and chroma edge filters of common/deblock.c, in
// raster MB order, with per-MB decoded QP and the (qp + qp_nb + 1) >> 1
// average on MB edges.
//
// Layout: planes in place, y (S, H, W), u and v (S, H/2, W/2) int32;
// bs (S, mb_h, mb_w, 2, 4, 4) [dir][edge][group]; intra, feo, qp, qpc
// (S, mb_h, mb_w) int32; tab = alpha[52] | beta[52] | tc0[52][4]; sync
// (1 + 2 S mb_h) int32 scratch, zeroed by the entry point on the launch's
// stream.
//
// Raster order makes MB (x, y) wait for its left neighbour and for MB
// (x + 1, y - 1), whose edge 0 writes the 3 right columns of (x, y - 1)
// that the top edge of (x, y) reads and writes. Bound on the H100: not
// bytes (0.06 ms at 1080p, S = 8) or operations but the critical path,
// mb_w + 2 (mb_h - 1) dependent MB steps (254 at 1080p) and mb_h - 1
// handoffs between rows. Design: a row pipeline. One warp per (MB row,
// stream, plane group) walks its row in order, 2 MBs behind the row above
// (1088 CTAs at 1080p, S = 8, so the rows of all streams run at once):
// - each row publishes its count of finished MBs (__threadfence, then
//   st.release.gpu) and the row below spins on it with ld.acquire.gpu;
//   pixels another row wrote are read with __ldcg, past the SM's L1;
// - a CTA takes its row from an atomic ticket, rows in order, so it only
//   ever waits on a CTA that has started (blockIdx order is not relied on);
// - per MB, the critical path holds one wait, one L2 read of the 4 rows
//   above, the filter and the stores: the MB's own pixels and its edge
//   parameters are read before the wait, the alpha / beta / tc0 table
//   sits in shared memory, and the MB is filtered in a shared tile with
//   its left halo carried from the previous MB;
// - 16 lanes own one pixel line each in registers for the 4 vertical edges,
//   then one column each for the 4 horizontal edges, in deblock.c order.
//
// K5a / K5b
// ---------
// Replace x264dsp_tpu/ops/pallas/deblock_wave.py::deblock_wave_luma
// (_luma_kernel, _filter_luma_regs) and ::deblock_wave_chroma
// (_chroma_kernel, _filter_chroma_regs), reached from ops/deblock.py::
// deblock_frame_wave_batched. They compute K3's function, but every filter
// parameter comes from the caller's lane tensors, laid out per stream,
// diagonal d (x + 2y = d) and slot k (MB row y0(d) + k, y0(d) =
// max(0, (d - mb_w + 2) / 2)):
//   luma   tc0y (S, D, K, 128) at [dir * 64 + edge * 16 + pixel line],
//          eny / uiy / aly / bly (S, D, K, 8) at [dir * 4 + edge]
//          (enabled, intra filter, alpha, beta);
//   chroma tcc (S, D, 2K, 32) at [dir * 16 + edge * 8 + line] (tc0 + 1),
//          enc / uic / alc / blc (S, D, 2K, 4) at [dir * 2 + edge], slot
//          2k for u and 2k + 1 for v.
// An unused slot has every enable 0 and is never read here.
//
// Every pair of MBs whose 20x20 (12x12) regions overlap comes in the same
// order on the 2:1 diagonals and in raster order, so the lanes drive K3's
// row pipeline unchanged: one warp per (MB row, stream), luma alone (K5a,
// S mb_h CTAs) or u and v together (K5b), each MB's lanes read before the
// wait with its pixels. Unlike K3's grids, lanes may enable an edge on the
// frame border. The plain version and the TPU kernel read pixels outside
// the frame as 0 and write the p side of such an edge into their zero pad,
// which no later filter reads (each filter spans positions >= 4 of its
// line only). Here the tile's left halo is 0 at x = 0 and its top halo is
// set to 0 at every MB of row 0, and nothing is stored outside the frame.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ int clip3(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// deblock_edge_luma_c / deblock_edge_luma_intra_c on a[c-4 .. c+3]
__device__ __forceinline__ void edge_luma(int* a, int c, int alpha,
                                          int beta, int tc0, bool intra) {
    const int p3 = a[c - 4], p2 = a[c - 3], p1 = a[c - 2], p0 = a[c - 1];
    const int q0 = a[c], q1 = a[c + 1], q2 = a[c + 2], q3 = a[c + 3];
    const bool filt = iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta
                      && iabs(q1 - q0) < beta;
    const bool ap = iabs(p2 - p0) < beta;
    const bool aq = iabs(q2 - q0) < beta;
    if (intra) {
        if (!filt) return;
        const bool strong = iabs(p0 - q0) < ((alpha >> 2) + 2);
        if (strong && ap) {
            a[c - 1] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
            a[c - 2] = (p2 + p1 + p0 + q0 + 2) >> 2;
            a[c - 3] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
        } else {
            a[c - 1] = (2 * p1 + p0 + q1 + 2) >> 2;
        }
        if (strong && aq) {
            a[c] = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3;
            a[c + 1] = (p0 + q0 + q1 + q2 + 2) >> 2;
            a[c + 2] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
        } else {
            a[c] = (2 * q1 + q0 + p1 + 2) >> 2;
        }
        return;
    }
    if (!filt || tc0 < 0) return;
    const int pq1 = (p0 + q0 + 1) >> 1;
    if (ap && tc0 > 0)
        a[c - 2] = p1 + clip3(((p2 + pq1) >> 1) - p1, -tc0, tc0);
    if (aq && tc0 > 0)
        a[c + 1] = q1 + clip3(((q2 + pq1) >> 1) - q1, -tc0, tc0);
    const int tc = tc0 + (ap ? 1 : 0) + (aq ? 1 : 0);
    const int delta = clip3((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc);
    a[c - 1] = clip3(p0 + delta, 0, 255);
    a[c] = clip3(q0 - delta, 0, 255);
}

// deblock_edge_chroma_c / deblock_edge_chroma_intra_c on a[c-2 .. c+1]
__device__ __forceinline__ void edge_chroma(int* a, int c, int alpha,
                                            int beta, int tc, bool intra) {
    const int p1 = a[c - 2], p0 = a[c - 1], q0 = a[c], q1 = a[c + 1];
    const bool filt = iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta
                      && iabs(q1 - q0) < beta;
    if (!filt) return;
    if (intra) {
        a[c - 1] = (2 * p1 + p0 + q1 + 2) >> 2;
        a[c] = (2 * q1 + q0 + p1 + 2) >> 2;
        return;
    }
    if (tc <= 0) return;
    const int delta = clip3((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc);
    a[c - 1] = clip3(p0 + delta, 0, 255);
    a[c] = clip3(q0 - delta, 0, 255);
}

// Filter parameters of one pixel line across the MB's edges of one
// direction, from the grids: edge 0 (the MB edge, averaged QP, on when
// the neighbour exists) and the internal edges (the MB's QP, off for
// first-edge-only MBs). The accessors take the edge as a constant of an
// unrolled loop, so they fold away.
struct GridLine {
    int alpha0, beta0, alpha1, beta1;
    int tcs[4];             // per edge: tc0 (luma) or tc0 + 1 (chroma)
    bool on0, internal, intra0;
    __device__ bool on(int ed) const { return ed == 0 ? on0 : internal; }
    __device__ int alpha(int ed) const { return ed == 0 ? alpha0 : alpha1; }
    __device__ int beta(int ed) const { return ed == 0 ? beta0 : beta1; }
    __device__ int tc(int ed) const { return tcs[ed]; }
    __device__ bool intra(int ed) const { return ed == 0 && intra0; }
};

// The same from the lanes: every edge has its own enable, intra flag,
// alpha and beta, and each line its own tc, for E edges.
template <int E>
struct LaneLine {
    int tcs[E], alphas[E], betas[E];
    unsigned ens, uis;      // bit ed: enabled, intra filter
    __device__ bool on(int ed) const { return (ens >> ed) & 1u; }
    __device__ int alpha(int ed) const { return alphas[ed]; }
    __device__ int beta(int ed) const { return betas[ed]; }
    __device__ int tc(int ed) const { return tcs[ed]; }
    __device__ bool intra(int ed) const { return (uis >> ed) & 1u; }
};

// One line's lanes: tc at the line's entry of edge 0 (edges N entries
// apart), en / ui / al / bl at edge 0 of the direction. N = 16: luma,
// 4 edges; N = 8: chroma, 2 edges.
template <int N>
__device__ __forceinline__ LaneLine<N / 4> lane_line(
        const int* tc, const int* en, const int* ui, const int* al,
        const int* bl) {
    LaneLine<N / 4> lp;
    lp.ens = lp.uis = 0u;
#pragma unroll
    for (int ed = 0; ed < N / 4; ++ed) {
        lp.tcs[ed] = tc[ed * N];
        lp.alphas[ed] = al[ed];
        lp.betas[ed] = bl[ed];
        lp.ens |= (en[ed] != 0 ? 1u : 0u) << ed;
        lp.uis |= (ui[ed] != 0 ? 1u : 0u) << ed;
    }
    return lp;
}

// One pixel line across the MB's edges of one direction, in shared
// memory: px[(i - 4) * step] for i in 0..N+3 (the first 4 are the
// neighbour's p side; they are filtered only when edge 0 is on).
template <int N, class Line>
__device__ __forceinline__ void filter_line(int* px, int step,
                                            const Line& lp) {
    constexpr int L = N + 4;
    int a[L];
#pragma unroll
    for (int i = 0; i < L; ++i) a[i] = px[(i - 4) * step];
#pragma unroll
    for (int ed = 0; ed < N / 4; ++ed) {
        if (!lp.on(ed)) continue;
        if constexpr (N == 16)
            edge_luma(a, 4 + 4 * ed, lp.alpha(ed), lp.beta(ed), lp.tc(ed),
                      lp.intra(ed));
        else
            edge_chroma(a, 4 + 4 * ed, lp.alpha(ed), lp.beta(ed), lp.tc(ed),
                        lp.intra(ed));
    }
#pragma unroll
    for (int i = 1; i < L; ++i) px[(i - 4) * step] = a[i];
}

__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release_gpu(int* p, int v) {
    asm volatile("st.release.gpu.global.s32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void put4(int* d, int4 t) {
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
}

__device__ __forceinline__ int4 get4(const int* d) {
    return make_int4(d[0], d[1], d[2], d[3]);
}

#define ROW_THREADS 32

// One MB row of one stream and plane group, walked by one warp. N = 16,
// NP = 1: luma; N = 8, NP = 2: u and v. The tile holds, per plane, the
// MB (rows and columns 4..N+3) with 4 halo columns on the left (the
// previous MB's last 4 columns, carried in shared memory; 0 at x = 0) and
// 4 halo rows on top (the row above's pixels, read after the wait; 0 in
// row 0). src.line<N>(s, y, x, dir, lane) gives the filter parameters of
// compute lane `lane`'s line (plane lane / N, line lane % N).
template <int N, int NP, class Src>
__device__ void deblock_row(int* p0, int* p1, const Src& src, int* tile,
                            int s, int y, int mb_h, int mb_w,
                            const int* above, int* mine) {
    constexpr int T = N + 4;        // tile side
    constexpr int TS = T + 1;       // odd row stride: no bank conflicts
    constexpr int TP = T * TS;      // ints per plane
    constexpr int V = N / 4;        // int4 per MB pixel row
    constexpr int OWN = NP * N * V / ROW_THREADS;   // int4 per lane
    const int lane = threadIdx.x;
    const int Wp = N * mb_w;
    const long long frame = (long long)s * N * mb_h * Wp;
    const int pl = lane / N, k = lane % N;      // compute lanes: 0..15
    auto at = [&](int p, int r, int c) {
        return (p ? p1 : p0) + frame + (long long)r * Wp + c;
    };
    for (int i = lane; i < NP * TP; i += ROW_THREADS) tile[i] = 0;
    __syncwarp();
    int seen = 0;
    for (int x = 0; x < mb_w; ++x) {
        // The MB's own pixels are untouched until this step (every MB
        // that writes them comes later in raster order), and its filter
        // parameters never depend on pixels: both are read before the
        // wait.
        int4 own[OWN];
#pragma unroll
        for (int j = 0; j < OWN; ++j) {
            const int i = lane + ROW_THREADS * j;
            const int p = i / (N * V), r = (i / V) % N, v = i % V;
            own[j] = __ldcg(reinterpret_cast<const int4*>(
                at(p, N * y + r, N * x + 4 * v)));
        }
        const auto lv = src.template line<N>(s, y, x, 0, lane);
        const auto lh = src.template line<N>(s, y, x, 1, lane);
        if (y > 0) {
            // the row above has finished MB x + 1 (its edge 0 writes the
            // 3 right columns of MB x there), or its last MB
            const int need = min(x + 2, mb_w);
            while (seen < need) seen = ld_acquire_gpu(above);
            __syncwarp();
            if (lane < NP * 4 * V) {        // top halo, past L1
                const int p = lane / (4 * V), r = (lane / V) % 4;
                const int v = lane % V;
                put4(tile + p * TP + r * TS + 4 + 4 * v,
                     __ldcg(reinterpret_cast<const int4*>(
                         at(p, N * y - 4 + r, N * x + 4 * v))));
            }
        } else if (lane < NP * 4 * V) {
            // above the frame: 0 at every MB (the top edge of the previous
            // MB may have filtered its copy of the top halo)
            const int p = lane / (4 * V), r = (lane / V) % 4;
            const int v = lane % V;
            put4(tile + p * TP + r * TS + 4 + 4 * v, make_int4(0, 0, 0, 0));
        }
#pragma unroll
        for (int j = 0; j < OWN; ++j) {
            const int i = lane + ROW_THREADS * j;
            const int p = i / (N * V), r = (i / V) % N, v = i % V;
            put4(tile + p * TP + (4 + r) * TS + 4 + 4 * v, own[j]);
        }
        __syncwarp();
        if (lane < NP * N)          // row k: the vertical edges
            filter_line<N>(tile + pl * TP + (4 + k) * TS + 4, 1, lv);
        __syncwarp();
        if (lane < NP * N)          // column k: the horizontal edges
            filter_line<N>(tile + pl * TP + 4 * TS + 4 + k, TS, lh);
        __syncwarp();
        // Write back what is final for this row: the top halo's 3 rows
        // the MB's top edge filtered, and tile columns 0..N-1 (the left
        // neighbour's last 4 columns and this MB's first N - 4). The MB's
        // last 4 columns wait for the next MB's edge 0, except at the end.
        if (y > 0 && lane < NP * 3 * V) {
            const int p = lane / (3 * V), r = 1 + (lane / V) % 3;
            const int v = lane % V;
            *reinterpret_cast<int4*>(at(p, N * y - 4 + r, N * x + 4 * v)) =
                get4(tile + p * TP + r * TS + 4 + 4 * v);
        }
        for (int i = lane; i < NP * N * V; i += ROW_THREADS) {
            const int p = i / (N * V), r = (i / V) % N, v = i % V;
            if (v == 0 && x == 0) continue;     // left of the frame
            *reinterpret_cast<int4*>(at(p, N * y + r, N * x - 4 + 4 * v)) =
                get4(tile + p * TP + (4 + r) * TS + 4 * v);
        }
        if (x == mb_w - 1 && lane < NP * N) {
            const int p = lane / N, r = lane % N;
            *reinterpret_cast<int4*>(at(p, N * y + r, N * x + N - 4)) =
                get4(tile + p * TP + (4 + r) * TS + N);
        }
        // publish: every lane's stores, then the row's progress
        __threadfence();
        __syncwarp();
        if (lane == 0) st_release_gpu(mine, x + 1);
        // carry this MB's last 4 columns into the next tile's left halo
        for (int i = lane; i < NP * N * 4; i += ROW_THREADS) {
            const int p = i / (4 * N), r = (i / 4) % N, c = i % 4;
            int* row = tile + p * TP + (4 + r) * TS;
            row[c] = row[N + c];
        }
        __syncwarp();
    }
}

// A CTA's row: sync[0] hands out tickets in the start order of the CTAs,
// and rows take them in order, so a CTA waits only on a row whose CTA
// started before it.
__device__ __forceinline__ int row_ticket(int* sync, int* ticket) {
    if (threadIdx.x == 0) *ticket = atomicAdd(sync, 1);
    __syncwarp();
    return *ticket;
}

// Zero a row pipeline's ticket and its rows' progress counters on the
// launch's stream (the entry points of K3, K5a and K5b).
static cudaError_t zero_sync(int* sync, int rows, cudaStream_t stream) {
    return cudaMemsetAsync(sync, 0, sizeof(int) * (1 + rows), stream);
}

// ---------------------------------------------------------------------------
// K3: the parameters from the raw grids
// ---------------------------------------------------------------------------

struct Params {
    const int* bs;
    const int* intra;
    const int* feo;
    const int* qp;
    const int* qpc;
    const int* tab;
    int mb_h, mb_w, alpha_off, beta_off;
};

// qgrid is qp (luma) or qpc (chroma); tab the CTA's shared copy of
// alpha | beta | tc0.
struct GridSource {
    Params P;
    const int* qgrid;
    const int* tab;

    // N = 16: luma line k, 4 edges on bS rows 0..3, group k / 4.
    // N = 8: chroma line k, 2 edges on bS rows 0 and 2, group k / 2.
    template <int N>
    __device__ __forceinline__ GridLine line(int s, int y, int x, int dir,
                                             int lane) const {
        const int k = lane % N;
        const int g = (s * P.mb_h + y) * P.mb_w + x;
        const bool has_nb = dir == 0 ? x > 0 : y > 0;
        const int gn = !has_nb ? g : dir == 0 ? g - 1 : g - P.mb_w;
        GridLine lp;
        const int q = __ldg(qgrid + g);
        const int qe = (q + __ldg(qgrid + gn) + 1) >> 1;
        const int ia0 = clip3(qe + P.alpha_off, 0, 51);
        const int ia1 = clip3(q + P.alpha_off, 0, 51);
        lp.alpha0 = tab[ia0];
        lp.beta0 = tab[52 + clip3(qe + P.beta_off, 0, 51)];
        lp.alpha1 = tab[ia1];
        lp.beta1 = tab[52 + clip3(q + P.beta_off, 0, 51)];
        lp.on0 = has_nb;
        lp.internal = __ldg(P.feo + g) == 0;
        lp.intra0 = __ldg(P.intra + g) != 0
                    || (has_nb && __ldg(P.intra + gn) != 0);
        const int* bs = P.bs + ((long long)g * 2 + dir) * 16;
#pragma unroll
        for (int ed = 0; ed < N / 4; ++ed) {
            const int row = N == 16 ? ed : 2 * ed;
            const int grp = N == 16 ? k >> 2 : k >> 1;
            lp.tcs[ed] = tab[104 + (ed == 0 ? ia0 : ia1) * 4
                             + clip3(__ldg(bs + row * 4 + grp), 0, 3)]
                         + (N == 16 ? 0 : 1);
        }
        return lp;
    }
};

// One CTA (one warp) per (MB row, stream, plane group).
// sync[1 + (2 s + group) * mb_h + row] is a row's count of finished MBs.
__global__ void __launch_bounds__(ROW_THREADS)
deblock_kernel(int* y, int* u, int* v, Params P, int S, int* sync) {
    __shared__ int tab[312];
    __shared__ int tile[20 * 21];   // luma 20 x 21; chroma 2 x 12 x 13
    __shared__ int ticket;
    for (int i = threadIdx.x; i < 312; i += ROW_THREADS) tab[i] = P.tab[i];
    const int t = row_ticket(sync, &ticket);
    const int row = t / (2 * S), grp = t % (2 * S);
    int* prog = sync + 1 + grp * P.mb_h;
    const int* above = row > 0 ? prog + row - 1 : prog;
    if (grp & 1)
        deblock_row<8, 2>(u, v, GridSource{P, P.qpc, tab}, tile, grp >> 1,
                          row, P.mb_h, P.mb_w, above, prog + row);
    else
        deblock_row<16, 1>(y, y, GridSource{P, P.qp, tab}, tile, grp >> 1,
                           row, P.mb_h, P.mb_w, above, prog + row);
}

extern "C" int x264t_deblock(int* y, int* u, int* v, const int* bs,
                             const int* intra, const int* feo, const int* qp,
                             const int* qpc, const int* tab, int* sync,
                             int S, int mb_h, int mb_w, int alpha_off,
                             int beta_off, void* stream) {
    Params P{bs, intra, feo, qp, qpc, tab, mb_h, mb_w, alpha_off, beta_off};
    const int rows = 2 * S * mb_h;
    cudaError_t err = zero_sync(sync, rows, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    deblock_kernel<<<rows, ROW_THREADS, 0, (cudaStream_t)stream>>>(y, u, v, P,
                                                                   S, sync);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5a / K5b: the parameters from the lanes
// ---------------------------------------------------------------------------

// One plane family's lanes (tc0y, eny, uiy, aly, bly or tcc, enc, uic,
// alc, blc); D diagonals of K MB slots (K5b: 2K lane slots, u and v).
struct LaneSource {
    const int* tc;
    const int* en;
    const int* ui;
    const int* al;
    const int* bl;
    int mb_w, D, K;

    // N = 16: luma line lane % 16; N = 8: chroma line lane % 8 of plane
    // lane / 8 (u, v).
    template <int N>
    __device__ __forceinline__ LaneLine<N / 4> line(int s, int y, int x,
                                                    int dir,
                                                    int lane) const {
        constexpr int E = N / 4;            // edges per direction
        constexpr int NP = N == 16 ? 1 : 2; // lane slots per MB
        const int d = x + 2 * y;
        const int k = y - max(0, (d - mb_w + 2) / 2);
        const int pl = (lane / N) & (NP - 1);
        const long long slot = (((long long)s * D + d) * K + k) * NP + pl;
        const long long e0 = slot * 2 * E + dir * E;
        return lane_line<N>(tc + slot * 2 * E * N + dir * E * N + lane % N,
                            en + e0, ui + e0, al + e0, bl + e0);
    }
};

// One CTA (one warp) per (MB row, stream); sync[1 + s * mb_h + row] is a
// row's count of finished MBs.
__global__ void __launch_bounds__(ROW_THREADS)
deblock_wave_luma_kernel(int* y, LaneSource L, int S, int mb_h, int* sync) {
    __shared__ int tile[20 * 21];
    __shared__ int ticket;
    const int t = row_ticket(sync, &ticket);
    const int row = t / S, s = t % S;
    int* prog = sync + 1 + s * mb_h;
    deblock_row<16, 1>(y, y, L, tile, s, row, mb_h, L.mb_w,
                       row > 0 ? prog + row - 1 : prog, prog + row);
}

__global__ void __launch_bounds__(ROW_THREADS)
deblock_wave_chroma_kernel(int* u, int* v, LaneSource L, int S, int mb_h,
                           int* sync) {
    __shared__ int tile[2 * 12 * 13];
    __shared__ int ticket;
    const int t = row_ticket(sync, &ticket);
    const int row = t / S, s = t % S;
    int* prog = sync + 1 + s * mb_h;
    deblock_row<8, 2>(u, v, L, tile, s, row, mb_h, L.mb_w,
                      row > 0 ? prog + row - 1 : prog, prog + row);
}

// sync: (1 + S mb_h) int32 scratch, zeroed here on the stream.
extern "C" int x264t_deblock_wave_luma(int* y, const int* tc0y,
                                       const int* eny, const int* uiy,
                                       const int* aly, const int* bly,
                                       int* sync, int S, int mb_h, int mb_w,
                                       int K, void* stream) {
    const LaneSource L{tc0y, eny, uiy, aly, bly, mb_w, mb_w + 2 * mb_h - 2,
                       K};
    cudaError_t err = zero_sync(sync, S * mb_h, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    deblock_wave_luma_kernel<<<S * mb_h, ROW_THREADS, 0,
                               (cudaStream_t)stream>>>(y, L, S, mb_h, sync);
    return (int)cudaGetLastError();
}

// K: MB slots per diagonal (the lanes hold 2K)
extern "C" int x264t_deblock_wave_chroma(int* u, int* v, const int* tcc,
                                         const int* enc, const int* uic,
                                         const int* alc, const int* blc,
                                         int* sync, int S, int mb_h,
                                         int mb_w, int K, void* stream) {
    const LaneSource L{tcc, enc, uic, alc, blc, mb_w, mb_w + 2 * mb_h - 2,
                       K};
    cudaError_t err = zero_sync(sync, S * mb_h, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    deblock_wave_chroma_kernel<<<S * mb_h, ROW_THREADS, 0,
                                 (cudaStream_t)stream>>>(u, v, L, S, mb_h,
                                                         sync);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K6: the 12-edge chain on gathered regions
// ---------------------------------------------------------------------------
//
// Replaces x264dsp_tpu/ops/pallas/deblock_filter.py::filter_regions
// (_kernel), called once per diagonal by the region route of ops/deblock.py::
// deblock_frame: regy (K, 20, 20) luma and regc (2K, 12, 12) chroma regions
// (u then v per MB; the MB sits at [4:, 4:], its left and top halo in front)
// and the lanes of K5a / K5b without the stream and diagonal axes. All four
// vertical edges, then all four horizontal ones (2 + 2 for chroma): a
// horizontal edge reads pixels a vertical edge wrote.
//
// Bound: bytes (each region and lane read once, each region written once);
// a launch of one diagonal (480 regions at 1080p, S = 8) moves under 2 MB,
// so what a launch costs is its chain of dependent memory latencies. Design:
// one warp per MB, RW warps per CTA. A warp first brings all of its
// MB's data into shared memory in one batch of 16-byte cp.async copies
// (3776 bytes: the 20x20 luma and two 12x12 chroma regions and every lane:
// tc0y, tcc, and the enables, intra flags, alphas and betas of the 8 luma
// and 2 x 4 chroma edges), waits once, and then runs the chain on shared
// memory and registers alone: threads 0-15 own a luma pixel line each,
// threads 16-31 a chroma line of u or v, a warp barrier between the
// directions; the regions go back with 16-byte stores. Every per-MB row is
// a multiple of 16 bytes, so 16-byte aligned bases (the wrapper checks)
// keep every copy aligned. The caller pads K to a multiple of 16 with zero
// regions and zero enables, which filter to themselves.

// warps (MBs) per CTA: 1 beat 2, 4 and 8 at 480 regions on the H100
// (tools/kernel_sweep.py, PERF.md)
constexpr int RW = 1;

// One MB's regions and lanes in shared memory, in int32 words; every
// member is a multiple of 4 words, so each starts 16-byte aligned.
struct RegionMB {
    int y[400];         // 20 x 20 luma region
    int c[288];         // 12 x 12 u region, then v
    int tc0y[128];
    int tcc[64];        // u slot, then v slot
    // eny, uiy, aly, bly (8 luma edges), enc, uic, alc, blc (u, then v)
    int e[8][8];
};
enum { EN_Y, UI_Y, AL_Y, BL_Y, EN_C, UI_C, AL_C, BL_C };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(gmem) : "memory");
}

// copy n int32 words (a multiple of 4) with the warp's lanes
__device__ __forceinline__ void warp_copy_in(int* dst, const int* src, int n,
                                             int lane) {
    for (int i = 4 * lane; i < n; i += 128) cp_async16(dst + i, src + i);
}

__device__ __forceinline__ void warp_copy_out(int* __restrict__ dst,
                                              const int* src, int n,
                                              int lane) {
    for (int i = 4 * lane; i < n; i += 128)
        *reinterpret_cast<int4*>(dst + i) =
            *reinterpret_cast<const int4*>(src + i);
}

__global__ void __launch_bounds__(32 * RW)
filter_regions_kernel(int* __restrict__ oy, int* __restrict__ oc,
                      const int* __restrict__ regy,
                      const int* __restrict__ regc,
                      const int* __restrict__ tc0y,
                      const int* __restrict__ tcc,
                      const int* __restrict__ eny,
                      const int* __restrict__ uiy,
                      const int* __restrict__ enc,
                      const int* __restrict__ uic,
                      const int* __restrict__ aly,
                      const int* __restrict__ bly,
                      const int* __restrict__ alc,
                      const int* __restrict__ blc) {
    __shared__ __align__(16) RegionMB mbs[RW];
    const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
    const long long k = (long long)blockIdx.x * RW + w;
    RegionMB& m = mbs[w];
    warp_copy_in(m.y, regy + k * 400, 400, t);
    warp_copy_in(m.c, regc + k * 288, 288, t);
    warp_copy_in(m.tc0y, tc0y + k * 128, 128, t);
    warp_copy_in(m.tcc, tcc + k * 64, 64, t);
    if (t < 16) {       // the eight 8-word edge rows, two copies each
        const int i = t >> 1, h = 4 * (t & 1);
        const int* src = i == EN_Y ? eny : i == UI_Y ? uiy : i == AL_Y ? aly
                         : i == BL_Y ? bly : i == EN_C ? enc : i == UI_C
                         ? uic : i == AL_C ? alc : blc;
        cp_async16(m.e[i] + h, src + k * 8 + h);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    for (int dir = 0; dir < 2; ++dir) {
        if (t < 16) {
            int* px = dir == 0 ? m.y + (4 + t) * 20 + 4 : m.y + 4 * 20 + 4 + t;
            const int e0 = dir * 4;
            filter_line<16>(px, dir == 0 ? 1 : 20,
                            lane_line<16>(m.tc0y + dir * 64 + t,
                                          m.e[EN_Y] + e0, m.e[UI_Y] + e0,
                                          m.e[AL_Y] + e0, m.e[BL_Y] + e0));
        } else {
            const int ch = (t - 16) >> 3, l = t & 7;
            int* reg = m.c + ch * 144;
            int* px = dir == 0 ? reg + (4 + l) * 12 + 4 : reg + 4 * 12 + 4 + l;
            const int e0 = ch * 4 + dir * 2;
            filter_line<8>(px, dir == 0 ? 1 : 12,
                           lane_line<8>(m.tcc + ch * 32 + dir * 16 + l,
                                        m.e[EN_C] + e0, m.e[UI_C] + e0,
                                        m.e[AL_C] + e0, m.e[BL_C] + e0));
        }
        __syncwarp();
    }
    warp_copy_out(oy + k * 400, m.y, 400, t);
    warp_copy_out(oc + k * 288, m.c, 288, t);
}

// K a multiple of RW and every pointer 16-byte aligned (the wrapper checks
// both: K is a multiple of 16, and the tensors' bases are aligned).
extern "C" int x264t_filter_regions(int* oy, int* oc, const int* regy,
                                    const int* regc, const int* tc0y,
                                    const int* tcc, const int* eny,
                                    const int* uiy, const int* enc,
                                    const int* uic, const int* aly,
                                    const int* bly, const int* alc,
                                    const int* blc, int K, void* stream) {
    if (K <= 0) return 0;
    const void* ptrs[14] = {oy, oc, regy, regc, tc0y, tcc, eny, uiy, enc,
                            uic, aly, bly, alc, blc};
    for (const void* q : ptrs)
        if (reinterpret_cast<uintptr_t>(q) % 16 != 0)
            return (int)cudaErrorInvalidValue;
    if (K % RW != 0) return (int)cudaErrorInvalidValue;
    filter_regions_kernel<<<K / RW, 32 * RW, 0, (cudaStream_t)stream>>>(
        oy, oc, regy, regc, tc0y, tcc, eny, uiy, enc, uic, aly, bly, alc,
        blc);
    return (int)cudaGetLastError();
}
