// Full-pel DIA / HEX pattern walk of the P analysis (me.c:237-274 DIA,
// :276-387 HEX): one launch walks every MB of every stream once.
//
// It replaces no TPU kernel: the JAX package walks in plain JAX
// (x264dsp_tpu/encoder/inter_frame.py:349 _pattern_walk), every MB in
// lockstep as masked array ops. The port did the same in PyTorch, about
// 170 device operations per diamond step and one host sync per step
// (whether any MB still walks), up to 48 steps per P frame in three
// walks. Here each MB is one thread that walks until it stops or reaches
// the step cap, which gives the lockstep walk's result bit for bit
// without a sync; ops/me_walk.py pattern_walk_plain is that lockstep
// walk, and the tests hold the two equal.
//
// Inputs (int32, contiguous):
//   surf  (S, mb_h, n, n, mb_w) K1's lanes [LANES] or (S, mb_h, mb_w, n, n)
//         the classic layout, n = 2R+1: the full-pel 16x16 SADs
//   lam   (S, mb_h, mb_w)       lambda per MB
//   bits  (4096,)               mv_bits of |d| (ops/me_walk.py _MVBITS)
//   lo_x, hi_x (mb_w,), lo_y, hi_y (mb_h,)  full-pel legal range
//   prev  (S, mb_h, mb_w, 2)    the previous walk's full-pel field, or
//         null for the first walk (zero MVP, no candidates)
// Outputs: best (S, mb_h, mb_w, 2) full-pel, cost (S, mb_h, mb_w) and
// mvp (S, mb_h, mb_w, 2) the qpel MVP the walk costed against.
//
// Per MB: the MVP median of the previous field's neighbours A (left), B
// (top), C (top-right, else top-left) (common/mvpred.c:103-137), its
// full-pel point (mvp + 2) >> 2 clamped to [-R, R] costed without bias;
// the candidates (its own previous MV, left, top, top-right, zero
// outside the frame, each clamped to [-R, R]) and (0, 0) costed with
// lambda * (mv_bits(dx) + mv_bits(dy)), taken in that order when
// strictly cheaper; then up to R diamonds (DIA) or max(R >> 1, 1)
// hexagons around the centre at the step's entry, stopping when a step
// leaves the centre where it was, and for HEX one 8-point square. A
// point outside the surface or the legal range costs 1 << 28.
//
// Bound on the H100. A walk reads at most 70 (DIA: 1 + 4 + 1 + 16 x 4)
// or 62 (HEX: 1 + 4 + 1 + 8 x 6 + 8) surface words per MB. At 1080p, S =
// 32 (261,120 MBs) that is 585 MB if no two reads share a 32-byte sector,
// 0.175 ms at 3.35 TB/s; the arithmetic is a few integer operations per
// read. The reads of one step depend on the step before, so the walk is
// a chain of at most 17 rounds of loads (the start point, the candidates
// and (0, 0) in one round; 16 diamonds, or 8 hexagons and the square):
// its time is the rounds' memory latency, not the bytes. Design: one
// thread per MB, mb_x fastest, so neighbouring threads read neighbouring
// words of K1's lanes while they walk in step; all loads of a round are
// issued before the round's compares; the 16 KB mv_bits table is read
// through the read-only cache (the costs index at most 8R + 8 words of
// it). No shared memory, no host sync, nothing allocated.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 28;
constexpr int MVBITS_MAX = 4095;
constexpr int NT = 256;           // threads per CTA

struct Args {
    const int* surf;
    const int* lam;
    const int* bits;
    const int* lo_x;
    const int* hi_x;
    const int* lo_y;
    const int* hi_y;
    const int* prev;
    int* best;
    int* cost;
    int* mvp;
    int S, mb_h, mb_w, R;
};

// One MB's surface: offset (x, y) at base[((y + R) * n + x + R) * step]
template <bool LANES>
struct MbSurface {
    const int* base;
    const int* bits;
    int step, R, n, lo_x, hi_x, lo_y, hi_y, lam, mvpx, mvpy;

    __device__ __forceinline__ bool legal(int x, int y) const {
        return x >= lo_x && x <= hi_x && y >= lo_y && y <= hi_y
            && abs(x) <= R && abs(y) <= R;
    }
    __device__ __forceinline__ int raw(int x, int y) const {
        if (!legal(x, y)) return BIG;
        const size_t k = (size_t)((y + R) * n + x + R);
        return __ldg(base + (LANES ? k * step : k));
    }
    __device__ __forceinline__ int mvbits(int d) const {
        return __ldg(bits + min(abs(d), MVBITS_MAX));
    }
    __device__ __forceinline__ int biased(int x, int y) const {
        if (!legal(x, y)) return BIG;
        return raw(x, y) + lam * (mvbits(x * 4 - mvpx) + mvbits(y * 4 - mvpy));
    }
};

__device__ __forceinline__ int clamp_r(int v, int R) {
    return min(max(v, -R), R);
}

// Strict-less acceptance, in order, of the costs c[] of the points
// (ox + dx[k], oy + dy[k])
template <int K>
__device__ __forceinline__ void take(const int (&c)[K], const int (&dx)[K],
                                     const int (&dy)[K], int ox, int oy,
                                     int& bcost, int& bx, int& by) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
        if (c[k] < bcost) {
            bcost = c[k];
            bx = ox + dx[k];
            by = oy + dy[k];
        }
    }
}

// One step of K points around (bx, by): every load first, then the
// compares. Returns whether the centre moved.
template <bool LANES, int K>
__device__ __forceinline__ bool step(const MbSurface<LANES>& m,
                                     const int (&dx)[K], const int (&dy)[K],
                                     int& bcost, int& bx, int& by) {
    const int ox = bx, oy = by;
    int c[K];
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] = m.biased(ox + dx[k], oy + dy[k]);
    take(c, dx, dy, ox, oy, bcost, bx, by);
    return bx != ox || by != oy;
}

template <bool LANES, bool HEX>
__global__ void __launch_bounds__(NT) pattern_walk_kernel(Args a) {
    const int i = blockIdx.x * NT + threadIdx.x;
    const int mb_w = a.mb_w, mb_h = a.mb_h;
    if (i >= a.S * mb_h * mb_w) return;
    const int x = i % mb_w;
    const int y = (i / mb_w) % mb_h;
    const int row = i / mb_w;                 // s * mb_h + y
    const int R = a.R, n = 2 * R + 1;

    MbSurface<LANES> m;
    m.base = LANES ? a.surf + (size_t)row * n * n * mb_w + x
                   : a.surf + (size_t)i * n * n;
    m.bits = a.bits;
    m.step = mb_w;
    m.R = R;
    m.n = n;
    m.lo_x = a.lo_x[x];
    m.hi_x = a.hi_x[x];
    m.lo_y = a.lo_y[y];
    m.hi_y = a.hi_y[y];
    m.lam = a.lam[i];

    // the MVP and the candidates from the previous field
    int mvp[2] = {0, 0};
    int cx[4] = {0, 0, 0, 0}, cy[4] = {0, 0, 0, 0};
    const int* p = a.prev;
    if (p != nullptr) {
        const bool ok_a = x >= 1, ok_b = y >= 1;
        const bool ok_c = y >= 1 && x + 1 < mb_w, ok_d = y >= 1 && x >= 1;
        const int* self = p + 2 * (size_t)i;
        const int* left = self - 2;
        const int* top = self - 2 * mb_w;
        const int* top_c = ok_c ? top + 2 : top - 2;
        const int count = ok_a + ok_b + (ok_c || ok_d);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const int va = ok_a ? 4 * left[c] : 0;
            const int vb = ok_b ? 4 * top[c] : 0;
            const int vc = ok_c || ok_d ? 4 * top_c[c] : 0;
            const int med = va + vb + vc - min(va, min(vb, vc))
                - max(va, max(vb, vc));
            const int single = ok_a ? va : ok_b ? vb : vc;
            mvp[c] = count == 1 ? single : med;
        }
        cx[0] = self[0];
        cy[0] = self[1];
        cx[1] = ok_a ? left[0] : 0;
        cy[1] = ok_a ? left[1] : 0;
        cx[2] = ok_b ? top[0] : 0;
        cy[2] = ok_b ? top[1] : 0;
        cx[3] = ok_c ? top[2] : 0;
        cy[3] = ok_c ? top[3] : 0;
    }
    m.mvpx = mvp[0];
    m.mvpy = mvp[1];

    // round 1: the MVP point (no bias), the candidates and (0, 0)
    int bx = clamp_r((mvp[0] + 2) >> 2, R);
    int by = clamp_r((mvp[1] + 2) >> 2, R);
    int bcost = m.raw(bx, by);
    const int zc = m.biased(0, 0);
    if (p != nullptr) {
        int c[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            cx[k] = clamp_r(cx[k], R);
            cy[k] = clamp_r(cy[k], R);
            c[k] = m.biased(cx[k], cy[k]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (c[k] < bcost) {
                bcost = c[k];
                bx = cx[k];
                by = cy[k];
            }
        }
    }
    if ((bx != 0 || by != 0) && zc < bcost) {
        bcost = zc;
        bx = 0;
        by = 0;
    }

    if (HEX) {
        constexpr int hx[6] = {-2, -1, 1, 2, 1, -1};
        constexpr int hy[6] = {0, 2, 2, 0, -2, -2};
        constexpr int sx[8] = {0, 0, -1, 1, -1, -1, 1, 1};
        constexpr int sy[8] = {-1, 1, 0, 0, -1, 1, -1, 1};
        const int n_iter = max(R >> 1, 1);
        for (int it = 0; it < n_iter; ++it)
            if (!step(m, hx, hy, bcost, bx, by)) break;
        step(m, sx, sy, bcost, bx, by);
    } else {
        constexpr int dx[4] = {0, 0, -1, 1};
        constexpr int dy[4] = {-1, 1, 0, 0};
        for (int it = 0; it < R; ++it)
            if (!step(m, dx, dy, bcost, bx, by)) break;
    }

    a.best[2 * (size_t)i] = bx;
    a.best[2 * (size_t)i + 1] = by;
    a.cost[i] = bcost;
    a.mvp[2 * (size_t)i] = mvp[0];
    a.mvp[2 * (size_t)i + 1] = mvp[1];
}

template <bool LANES, bool HEX>
void launch_walk(const Args& a, int blocks, cudaStream_t st) {
    pattern_walk_kernel<LANES, HEX><<<blocks, NT, 0, st>>>(a);
}

}  // namespace

extern "C" int x264t_pattern_walk(const int* surf, const int* lam,
                                  const int* bits, const int* lo_x,
                                  const int* hi_x, const int* lo_y,
                                  const int* hi_y, const int* prev,
                                  int* best, int* cost, int* mvp, int S,
                                  int mb_h, int mb_w, int R, int lanes,
                                  int hex, void* stream) {
    const Args a{surf, lam, bits, lo_x, hi_x, lo_y, hi_y, prev, best, cost,
                 mvp, S, mb_h, mb_w, R};
    const long total = (long)S * mb_h * mb_w;
    if (total <= 0) return (int)cudaGetLastError();
    const int blocks = (int)((total + NT - 1) / NT);
    cudaStream_t st = (cudaStream_t)stream;
    if (lanes)
        hex ? launch_walk<true, true>(a, blocks, st)
            : launch_walk<true, false>(a, blocks, st);
    else
        hex ? launch_walk<false, true>(a, blocks, st)
            : launch_walk<false, false>(a, blocks, st);
    return (int)cudaGetLastError();
}
