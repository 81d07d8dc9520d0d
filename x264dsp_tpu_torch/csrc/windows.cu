// Per-MB motion-compensation reference windows (kernels K2a, K2b).
//
// Replace x264dsp_tpu/ops/pallas/windows.py::luma_windows_pallas
// (Pallas _kernel) and ::chroma_windows_pallas (_kernel_c):
//   luma   ref4 (S, 4, Hp, Wp) int32 -> (S, mb_h*mb_w, 4, win, win) uint8
//          win = 16 + 2*margin, window of MB (y, x) starts at
//          (16*y + pad - margin, 16*x + pad - margin) of each hpel plane
//   chroma refc (S, Hc, Wc) int32   -> (S, mb_h*mb_w, win, win) uint8
//          win = 8 + 2*margin + 2, origin (8*y + pad - margin, ...)
// Pixels are <= 255, so uint8 holds the TPU's bf16 windows exactly at
// half the bytes (1080p x 8 streams: 0.82 GB of luma windows, not 1.6).
// Both are bound on the H100 by device-memory bandwidth: a copy.
//
// K2a: the Pallas kernel pins one MB row's strip in VMEM. Here one CTA per
// (stream, hpel plane, column group of G = 8 MBs) walks down the MB rows
// with a ring of 56 source rows x (16 G + 40) bytes in shared memory,
// stored as uint8: each MB row loads only its 16 new source rows (16-byte
// loads of the int32 rows, converted on the way in; the next rows are
// loaded into registers while the current windows are written), so the
// source is read (16 G + 40) / 16 G = 1.3 times, and each 56 x 56 window
// (196 x 16 bytes, contiguous in the output) is written with 16-byte
// streaming stores. Window size and origin are compile-time constants:
// no 64-bit division. 1080p, S = 8: 480 CTAs, 0.38 GB read and 0.82 GB
// written, a floor of about 0.36 ms.
//
// K2b: a grid-stride loop, one output byte per thread step, consecutive
// threads on consecutive output bytes (coalesced writes; the reads of a
// window row are consecutive too).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int M_LUMA = 20;                  // ops/mcgather.py M_LUMA
constexpr int PAD_MC = 32;                  // ops/mc.py PAD_MC
constexpr int WIN_L = 16 + 2 * M_LUMA;      // 56
constexpr int ORIGIN = PAD_MC - M_LUMA;     // 12
constexpr int G = 8;                        // MBs per column group
constexpr int RING_W = 16 * G + 40;         // bytes per ring row
constexpr int NT = 256;                     // threads per CTA
constexpr int CHUNKS = WIN_L * WIN_L / 16;  // 16-byte stores per window
constexpr int PF = (16 * RING_W / 4 + NT - 1) / NT;   // int4 per thread
}

__device__ __forceinline__ uint32_t pack_u8(int4 q) {
    return (uint32_t)(q.x & 255) | (uint32_t)(q.y & 255) << 8
           | (uint32_t)(q.z & 255) << 16 | (uint32_t)(q.w & 255) << 24;
}

// grid (column groups, 4 hpel planes, S). Ring slot of source row R
// (counted from the group's first window row) is R % WIN_L.
__global__ void __launch_bounds__(NT)
luma_windows_kernel(const int* __restrict__ ref4, uint8_t* __restrict__ out,
                    int mb_h, int mb_w, int Hp, int Wp) {
    __shared__ __align__(16) uint8_t ring[WIN_L * RING_W];
    const int x0 = G * blockIdx.x, p = blockIdx.y, s = blockIdx.z;
    const int gw = min(G, mb_w - x0);       // MBs in this group
    const int nv = 4 * gw + 10;             // int4 per source row
    const int* src = ref4 + ((long long)(s * 4 + p) * Hp + ORIGIN) * Wp
                     + 16 * x0 + ORIGIN;
    uint8_t* dst = out + (((long long)s * mb_h * mb_w + x0) * 4 + p)
                         * (WIN_L * WIN_L);
    for (int i = threadIdx.x; i < WIN_L * nv; i += NT) {
        const int r = i / nv, c = i - r * nv;
        *reinterpret_cast<uint32_t*>(ring + r * RING_W + 4 * c) = pack_u8(
            __ldg(reinterpret_cast<const int4*>(src + (long long)r * Wp)
                  + c));
    }
    __syncthreads();
    for (int y = 0; y < mb_h; ++y) {
        const int base = 16 * y % WIN_L;    // ring slot of window row 0
        // the 16 source rows MB row y + 1 adds: R = 16 y + 56 + r
        const bool more = y + 1 < mb_h;
        int4 pf[PF];
#pragma unroll
        for (int j = 0; j < PF; ++j) {
            const int i = threadIdx.x + NT * j;
            if (more && i < 16 * nv) {
                const int r = i / nv, c = i - r * nv;
                pf[j] = __ldg(reinterpret_cast<const int4*>(
                    src + (long long)(16 * y + WIN_L + r) * Wp) + c);
            }
        }
        // the windows of MB row y: two 8-byte halves per 16-byte store
        // (a window row is 7 halves)
        for (int i = threadIdx.x; i < gw * CHUNKS; i += NT) {
            const int m = i / CHUNKS, j = i - m * CHUNKS;
            uint2 h[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int b = 16 * j + 8 * e;
                const int r = b / WIN_L;
                int slot = base + r;
                if (slot >= WIN_L) slot -= WIN_L;
                h[e] = *reinterpret_cast<const uint2*>(
                    ring + slot * RING_W + 16 * m + b - r * WIN_L);
            }
            __stcs(reinterpret_cast<uint4*>(
                       dst + ((long long)y * mb_w + m) * 4 * WIN_L * WIN_L)
                       + j,
                   make_uint4(h[0].x, h[0].y, h[1].x, h[1].y));
        }
        __syncthreads();
        if (more) {
#pragma unroll
            for (int j = 0; j < PF; ++j) {
                const int i = threadIdx.x + NT * j;
                if (i < 16 * nv) {
                    const int r = i / nv, c = i - r * nv;
                    int slot = base + r;
                    if (slot >= WIN_L) slot -= WIN_L;
                    *reinterpret_cast<uint32_t*>(
                        ring + slot * RING_W + 4 * c) = pack_u8(pf[j]);
                }
            }
        }
        __syncthreads();
    }
}

__global__ void chroma_windows_kernel(const int* __restrict__ refc,
                                      uint8_t* __restrict__ out,
                                      long long total, int mb_h, int mb_w,
                                      int Hc, int Wc, int win, int origin) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += step) {
        long long t = i;
        const int c = (int)(t % win); t /= win;
        const int r = (int)(t % win); t /= win;
        const int mbx = (int)(t % mb_w); t /= mb_w;
        const int mby = (int)(t % mb_h); t /= mb_h;
        const long long s = t;
        const int y = 8 * mby + origin + r;
        const int x = 8 * mbx + origin + c;
        out[i] = (uint8_t)refc[(s * Hc + y) * (long long)Wc + x];
    }
}

static int grid_for(long long total) {
    long long blocks = (total + 255) / 256;
    return (int)(blocks < 132 * 32 ? blocks : 132 * 32);
}

// margin and pad must be M_LUMA and PAD_MC, Wp a multiple of 4 and ref4
// 16-byte aligned (the wrapper checks; 16-byte loads).
extern "C" int x264t_luma_windows(const int* ref4, uint8_t* out, int S,
                                  int mb_h, int mb_w, int Hp, int Wp,
                                  int margin, int pad, void* stream) {
    if (margin != M_LUMA || pad != PAD_MC || Wp % 4 != 0
        || reinterpret_cast<uintptr_t>(ref4) % 16 != 0
        || reinterpret_cast<uintptr_t>(out) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    dim3 grid((mb_w + G - 1) / G, 4, S);
    luma_windows_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
        ref4, out, mb_h, mb_w, Hp, Wp);
    return (int)cudaGetLastError();
}

extern "C" int x264t_chroma_windows(const int* refc, uint8_t* out, int S,
                                    int mb_h, int mb_w, int Hc, int Wc,
                                    int margin, int pad, void* stream) {
    const int win = 8 + 2 * margin + 2;
    const long long total = (long long)S * mb_h * mb_w * win * win;
    chroma_windows_kernel<<<grid_for(total), 256, 0,
                            (cudaStream_t)stream>>>(
        refc, out, total, mb_h, mb_w, Hc, Wc, win, pad - margin);
    return (int)cudaGetLastError();
}
