// Whole-frame H.264 in-loop deblocking filter (kernel K3).
//
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
