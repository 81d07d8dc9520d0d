// H.264 in-loop deblocking filter: kernel K3 (whole frame from the raw
// per-MB grids) and, further down, K5a / K5b (whole frame from precomputed
// filter lanes) and K6 (the edge chain on gathered regions). All share the
// edge filters edge_luma / edge_chroma below.
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
// (S, mb_h, mb_w) int32; tab = alpha[52] | beta[52] | tc0[52][4].
//
// Raster order makes each MB depend on its left, top and top-right
// neighbours, so the MBs of one diagonal x + 2y = d are independent and
// their pixel footprints are disjoint. Bound on the H100: latency of the
// mb_w + 2*mb_h - 2 dependent diagonal steps (254 at 1080p), not bytes
// or operations. Design: one block per (stream, plane group) walks all
// diagonals with __syncthreads between steps, so there is one launch per
// frame batch and no skewed layout. Per MB, 16 threads own one pixel row
// each for the 4 vertical edges (row held in registers), then one pixel
// column each for the 4 horizontal edges, in deblock.c order; the p-side
// writes land in the left and top neighbours.

#include <cuda_runtime.h>

#define NTHREADS 512

struct Params {
    const int* bs;
    const int* intra;
    const int* feo;
    const int* qp;
    const int* qpc;
    const int* tab;
    int mb_h, mb_w, alpha_off, beta_off;
};

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

struct EdgeSet {      // per-MB per-direction edge parameters
    int alpha0, beta0, ia0, alpha1, beta1, ia1;
    bool has0, internal, intra0;
};

__device__ EdgeSet edge_params(const Params& P, const int* qgrid, int s,
                               int mby, int mbx, int dir) {
    const int* alpha = P.tab;
    const int* beta = P.tab + 52;
    const int g = (s * P.mb_h + mby) * P.mb_w + mbx;
    const bool has_nb = dir == 0 ? mbx > 0 : mby > 0;
    const int gn = has_nb ? (dir == 0 ? g - 1 : g - P.mb_w) : g;
    const int q = qgrid[g];
    const int qe = (q + qgrid[gn] + 1) >> 1;
    EdgeSet e;
    e.ia0 = clip3(qe + P.alpha_off, 0, 51);
    e.alpha0 = alpha[e.ia0];
    e.beta0 = beta[clip3(qe + P.beta_off, 0, 51)];
    e.ia1 = clip3(q + P.alpha_off, 0, 51);
    e.alpha1 = alpha[e.ia1];
    e.beta1 = beta[clip3(q + P.beta_off, 0, 51)];
    e.has0 = has_nb;
    e.internal = P.feo[g] == 0;
    e.intra0 = P.intra[g] != 0 || (has_nb && P.intra[gn] != 0);
    return e;
}

// One pixel line of one MB across its 4 luma edges of direction dir:
// line k (row for dir 0, column for dir 1), pixels at base + i*step for
// i in -4..15 (the 4 p-side pixels belong to the neighbour MB).
__device__ void luma_line(int* plane, long long base, long long step,
                          const Params& P, const EdgeSet& e, int s, int mby,
                          int mbx, int dir, int k) {
    int a[20];
#pragma unroll
    for (int i = 0; i < 20; ++i)
        a[i] = (i >= 4 || e.has0) ? plane[base + (i - 4) * step] : 0;
    const int* tc0t = P.tab + 104;
    const int* bs = P.bs + ((((long long)s * P.mb_h + mby) * P.mb_w + mbx)
                            * 2 + dir) * 16;
    const int grp = k >> 2;
#pragma unroll
    for (int ed = 0; ed < 4; ++ed) {
        const bool on = ed == 0 ? e.has0 : e.internal;
        if (!on) continue;
        const int ia = ed == 0 ? e.ia0 : e.ia1;
        const int tc0 = tc0t[ia * 4 + clip3(bs[ed * 4 + grp], 0, 3)];
        edge_luma(a, 4 + 4 * ed, ed == 0 ? e.alpha0 : e.alpha1,
                  ed == 0 ? e.beta0 : e.beta1, tc0, ed == 0 && e.intra0);
    }
#pragma unroll
    for (int i = 1; i < 20; ++i)
        if (i >= 4 || e.has0) plane[base + (i - 4) * step] = a[i];
}

// One chroma pixel line across the 2 chroma edges (bs rows 0 and 2).
__device__ void chroma_line(int* plane, long long base, long long step,
                            const Params& P, const EdgeSet& e, int s,
                            int mby, int mbx, int dir, int k) {
    int a[12];
#pragma unroll
    for (int i = 0; i < 12; ++i)
        a[i] = (i >= 4 || e.has0) ? plane[base + (i - 4) * step] : 0;
    const int* tc0t = P.tab + 104;
    const int* bs = P.bs + ((((long long)s * P.mb_h + mby) * P.mb_w + mbx)
                            * 2 + dir) * 16;
    const int grp = k >> 1;
#pragma unroll
    for (int ed = 0; ed < 2; ++ed) {
        const bool on = ed == 0 ? e.has0 : e.internal;
        if (!on) continue;
        const int ia = ed == 0 ? e.ia0 : e.ia1;
        const int tc = tc0t[ia * 4 + clip3(bs[(2 * ed) * 4 + grp], 0, 3)]
                       + 1;
        edge_chroma(a, 4 + 4 * ed, ed == 0 ? e.alpha0 : e.alpha1,
                    ed == 0 ? e.beta0 : e.beta1, tc, ed == 0 && e.intra0);
    }
#pragma unroll
    for (int i = 2; i < 12; ++i)
        if (i >= 4 || e.has0) plane[base + (i - 4) * step] = a[i];
}

__global__ void __launch_bounds__(NTHREADS)
deblock_kernel(int* y, int* u, int* v, Params P) {
    const int s = blockIdx.x;
    const bool luma = blockIdx.y == 0;
    const int mb_h = P.mb_h, mb_w = P.mb_w;
    const int n_diag = mb_w + 2 * mb_h - 2;
    const int slot = threadIdx.x >> 4;          // 16 threads per MB
    const int lane = threadIdx.x & 15;
    const int n_slots = NTHREADS / 16;
    const int W = 16 * mb_w, H = 16 * mb_h;
    const int Wc = W / 2, Hc = H / 2;
    for (int d = 0; d < n_diag; ++d) {
        const int y_lo = d - mb_w + 1 > 0 ? (d - mb_w + 2) / 2 : 0;
        const int y_hi = min(mb_h - 1, d / 2);
        for (int dir = 0; dir < 2; ++dir) {
            for (int k = y_lo + slot; k <= y_hi; k += n_slots) {
                const int mby = k, mbx = d - 2 * k;
                if (luma) {
                    const EdgeSet e = edge_params(P, P.qp, s, mby, mbx, dir);
                    long long base, step;
                    if (dir == 0) {     // row `lane`, vertical edges
                        base = ((long long)s * H + 16 * mby + lane) * W
                               + 16 * mbx;
                        step = 1;
                    } else {            // column `lane`, horizontal edges
                        base = ((long long)s * H + 16 * mby) * W + 16 * mbx
                               + lane;
                        step = W;
                    }
                    luma_line(y, base, step, P, e, s, mby, mbx, dir, lane);
                } else {
                    const EdgeSet e = edge_params(P, P.qpc, s, mby, mbx,
                                                  dir);
                    int* plane = (lane & 8) ? v : u;
                    const int k8 = lane & 7;
                    long long base, step;
                    if (dir == 0) {
                        base = ((long long)s * Hc + 8 * mby + k8) * Wc
                               + 8 * mbx;
                        step = 1;
                    } else {
                        base = ((long long)s * Hc + 8 * mby) * Wc + 8 * mbx
                               + k8;
                        step = Wc;
                    }
                    chroma_line(plane, base, step, P, e, s, mby, mbx, dir,
                                k8);
                }
            }
            __syncthreads();
        }
    }
}

extern "C" int x264t_deblock(int* y, int* u, int* v, const int* bs,
                             const int* intra, const int* feo, const int* qp,
                             const int* qpc, const int* tab, int S, int mb_h,
                             int mb_w, int alpha_off, int beta_off,
                             void* stream) {
    Params P{bs, intra, feo, qp, qpc, tab, mb_h, mb_w, alpha_off, beta_off};
    dim3 grid(S, 2);
    deblock_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(y, u, v, P);
    return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// K5a / K5b: whole-frame wavefront from precomputed per-diagonal lanes
// ---------------------------------------------------------------------------
//
// Replace x264dsp_tpu/ops/pallas/deblock_wave.py::deblock_wave_luma
// (_luma_kernel, _filter_luma_regs) and ::deblock_wave_chroma
// (_chroma_kernel, _filter_chroma_regs), reached from ops/deblock.py::
// deblock_frame_wave_batched. They compute K3's function, but every filter
// parameter comes from the caller's lane tensors, laid out per stream,
// diagonal d (x + 2y = d) and slot k (MB row y0(d) + k):
//   luma   tc0y (S, D, K, 128) at [dir * 64 + edge * 16 + pixel line],
//          eny / uiy / aly / bly (S, D, K, 8) at [dir * 4 + edge]
//          (enabled, intra filter, alpha, beta);
//   chroma tcc (S, D, 2K, 32) at [dir * 16 + edge * 8 + line] (tc0 + 1),
//          enc / uic / alc / blc (S, D, 2K, 4) at [dir * 2 + edge], slot
//          2k for u and 2k + 1 for v.
// An unused slot has every enable 0.
//
// Bound on the H100: as K3, the latency of the D dependent diagonal steps,
// not bytes or operations. Design: one block per stream walks all
// diagonals in the plane itself (global memory; a 1080p int32 plane fits
// the L2 cache), 16 threads per slot, __syncthreads between the vertical
// and the horizontal edges and between diagonals. A thread addresses
// plane[16y + r][16x + c] directly: the TPU kernel's 256-wide superwindow,
// its one-hot column matmuls and additive one-hot placements stand in for
// loads and stores it does not have. Pixels left of or above the frame
// read as 0 and are never written.

// One luma pixel line across its 4 edges, parameters from the lanes:
// px points at the line's first pixel inside the MB, tc0 at this line's
// lane of edge 0 (edges are 16 lanes apart), en / ui / al / bl at edge 0.
__device__ __forceinline__ void luma_line_lanes(
        int* px, long long step, bool has_nb, const int* tc0, const int* en,
        const int* ui, const int* al, const int* bl) {
    int a[20];
#pragma unroll
    for (int i = 0; i < 20; ++i)
        a[i] = (i >= 4 || has_nb) ? px[(i - 4) * step] : 0;
#pragma unroll
    for (int ed = 0; ed < 4; ++ed)
        if (en[ed] != 0)
            edge_luma(a, 4 + 4 * ed, al[ed], bl[ed], tc0[16 * ed],
                      ui[ed] != 0);
#pragma unroll
    for (int i = 1; i < 20; ++i)
        if (i >= 4 || has_nb) px[(i - 4) * step] = a[i];
}

// One chroma pixel line across its 2 edges (edges are 8 lanes apart).
__device__ __forceinline__ void chroma_line_lanes(
        int* px, long long step, bool has_nb, const int* tc, const int* en,
        const int* ui, const int* al, const int* bl) {
    int a[12];
#pragma unroll
    for (int i = 0; i < 12; ++i)
        a[i] = (i >= 4 || has_nb) ? px[(i - 4) * step] : 0;
#pragma unroll
    for (int ed = 0; ed < 2; ++ed)
        if (en[ed] != 0)
            edge_chroma(a, 4 + 4 * ed, al[ed], bl[ed], tc[8 * ed],
                        ui[ed] != 0);
#pragma unroll
    for (int i = 2; i < 12; ++i)
        if (i >= 4 || has_nb) px[(i - 4) * step] = a[i];
}

#define WAVE_MAX_THREADS 1024

__global__ void __launch_bounds__(WAVE_MAX_THREADS)
deblock_wave_luma_kernel(int* y, const int* tc0y, const int* eny,
                         const int* uiy, const int* aly, const int* bly,
                         int mb_h, int mb_w, int K) {
    const int s = blockIdx.x;
    const int n_diag = mb_w + 2 * mb_h - 2;
    const int lane = threadIdx.x & 15;          // 16 threads per slot
    const int n_slots = blockDim.x >> 4;
    const int W = 16 * mb_w, H = 16 * mb_h;
    int* plane = y + (long long)s * H * W;
    for (int d = 0; d < n_diag; ++d) {
        const int y0 = d - mb_w + 1 > 0 ? (d - mb_w + 2) / 2 : 0;
        for (int dir = 0; dir < 2; ++dir) {
            for (int k = threadIdx.x >> 4; k < K; k += n_slots) {
                const int mby = y0 + k, mbx = d - 2 * mby;
                if (mby >= mb_h || mbx < 0) break;
                const long long slot = ((long long)s * n_diag + d) * K + k;
                const int* tc0 = tc0y + slot * 128 + dir * 64 + lane;
                const long long e0 = slot * 8 + dir * 4;
                if (dir == 0)       // row `lane`, vertical edges
                    luma_line_lanes(
                        plane + (long long)(16 * mby + lane) * W + 16 * mbx,
                        1, mbx > 0, tc0, eny + e0, uiy + e0, aly + e0,
                        bly + e0);
                else                // column `lane`, horizontal edges
                    luma_line_lanes(
                        plane + (long long)(16 * mby) * W + 16 * mbx + lane,
                        W, mby > 0, tc0, eny + e0, uiy + e0, aly + e0,
                        bly + e0);
            }
            __syncthreads();
        }
    }
}

__global__ void __launch_bounds__(WAVE_MAX_THREADS)
deblock_wave_chroma_kernel(int* u, int* v, const int* tcc, const int* enc,
                           const int* uic, const int* alc, const int* blc,
                           int mb_h, int mb_w, int K) {
    const int s = blockIdx.x;
    const int n_diag = mb_w + 2 * mb_h - 2;
    const int ch = (threadIdx.x >> 3) & 1;      // 8 threads per (slot, plane)
    const int lane = threadIdx.x & 7;
    const int n_slots = blockDim.x >> 4;
    const int Wc = 8 * mb_w, Hc = 8 * mb_h;
    int* plane = (ch ? v : u) + (long long)s * Hc * Wc;
    for (int d = 0; d < n_diag; ++d) {
        const int y0 = d - mb_w + 1 > 0 ? (d - mb_w + 2) / 2 : 0;
        for (int dir = 0; dir < 2; ++dir) {
            for (int k = threadIdx.x >> 4; k < K; k += n_slots) {
                const int mby = y0 + k, mbx = d - 2 * mby;
                if (mby >= mb_h || mbx < 0) break;
                const long long slot =
                    ((long long)s * n_diag + d) * 2 * K + 2 * k + ch;
                const int* tc = tcc + slot * 32 + dir * 16 + lane;
                const long long e0 = slot * 4 + dir * 2;
                if (dir == 0)
                    chroma_line_lanes(
                        plane + (long long)(8 * mby + lane) * Wc + 8 * mbx,
                        1, mbx > 0, tc, enc + e0, uic + e0, alc + e0,
                        blc + e0);
                else
                    chroma_line_lanes(
                        plane + (long long)(8 * mby) * Wc + 8 * mbx + lane,
                        Wc, mby > 0, tc, enc + e0, uic + e0, alc + e0,
                        blc + e0);
            }
            __syncthreads();
        }
    }
}

// 16 threads per slot, whole warps, at most WAVE_MAX_THREADS: a frame whose
// longest diagonal has more slots loops over them.
static int wave_threads(int K) {
    const int t = ((16 * K + 31) / 32) * 32;
    return t < 32 ? 32 : (t > WAVE_MAX_THREADS ? WAVE_MAX_THREADS : t);
}

extern "C" int x264t_deblock_wave_luma(int* y, const int* tc0y,
                                       const int* eny, const int* uiy,
                                       const int* aly, const int* bly, int S,
                                       int mb_h, int mb_w, int K,
                                       void* stream) {
    deblock_wave_luma_kernel<<<S, wave_threads(K), 0,
                               (cudaStream_t)stream>>>(
        y, tc0y, eny, uiy, aly, bly, mb_h, mb_w, K);
    return (int)cudaGetLastError();
}

extern "C" int x264t_deblock_wave_chroma(int* u, int* v, const int* tcc,
                                         const int* enc, const int* uic,
                                         const int* alc, const int* blc,
                                         int S, int mb_h, int mb_w, int K,
                                         void* stream) {
    deblock_wave_chroma_kernel<<<S, wave_threads(K), 0,
                                 (cudaStream_t)stream>>>(
        u, v, tcc, enc, uic, alc, blc, mb_h, mb_w, K);
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
// and the lanes of K5 without the stream and diagonal axes. All four
// vertical edges, then all four horizontal ones (2 + 2 for chroma): a
// horizontal edge reads pixels a vertical edge wrote.
//
// Bound: bytes (each region and lane read once, each region written once);
// a launch of one diagonal moves under 2 MB. Design: one warp per MB keeps
// its three regions in shared memory; threads 0-15 own a luma pixel line
// each, threads 16-31 a chroma line of u or v, with a block sync between
// the directions. The caller pads K to a multiple of 16 with zero regions
// and zero enables, which filter to themselves.

__global__ void __launch_bounds__(32)
filter_regions_kernel(int* oy, int* oc, const int* regy, const int* regc,
                      const int* tc0y, const int* tcc, const int* eny,
                      const int* uiy, const int* enc, const int* uic,
                      const int* aly, const int* bly, const int* alc,
                      const int* blc) {
    __shared__ int sy[20 * 20];
    __shared__ int sc[2 * 12 * 12];
    const long long k = blockIdx.x;
    const int t = threadIdx.x;
    for (int i = t; i < 400; i += 32) sy[i] = regy[k * 400 + i];
    for (int i = t; i < 288; i += 32) sc[i] = regc[k * 288 + i];
    __syncthreads();
    for (int dir = 0; dir < 2; ++dir) {
        if (t < 16) {
            int* px = dir == 0 ? sy + (4 + t) * 20 + 4 : sy + 4 * 20 + 4 + t;
            const long long e0 = k * 8 + dir * 4;
            luma_line_lanes(px, dir == 0 ? 1 : 20, true,
                            tc0y + k * 128 + dir * 64 + t, eny + e0,
                            uiy + e0, aly + e0, bly + e0);
        } else {
            const int ch = (t - 16) >> 3, l = t & 7;
            int* reg = sc + ch * 144;
            int* px = dir == 0 ? reg + (4 + l) * 12 + 4 : reg + 4 * 12 + 4 + l;
            const long long kc = 2 * k + ch;
            const long long e0 = kc * 4 + dir * 2;
            chroma_line_lanes(px, dir == 0 ? 1 : 12, true,
                              tcc + kc * 32 + dir * 16 + l, enc + e0,
                              uic + e0, alc + e0, blc + e0);
        }
        __syncthreads();
    }
    for (int i = t; i < 400; i += 32) oy[k * 400 + i] = sy[i];
    for (int i = t; i < 288; i += 32) oc[k * 288 + i] = sc[i];
}

extern "C" int x264t_filter_regions(int* oy, int* oc, const int* regy,
                                    const int* regc, const int* tc0y,
                                    const int* tcc, const int* eny,
                                    const int* uiy, const int* enc,
                                    const int* uic, const int* aly,
                                    const int* bly, const int* alc,
                                    const int* blc, int K, void* stream) {
    if (K <= 0) return 0;
    filter_regions_kernel<<<K, 32, 0, (cudaStream_t)stream>>>(
        oy, oc, regy, regc, tc0y, tcc, eny, uiy, enc, uic, aly, bly, alc,
        blc);
    return (int)cudaGetLastError();
}
