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
// K2b: K2a's ring copy for the 32 x 32 chroma windows (window of MB (y, x)
// at rows and columns 8 y + 5 and 8 x + 5 of the padded plane). One CTA per
// (stream, column group of G = 8 MBs, band of MB rows) keeps a ring of 32
// source rows x (8 G + 32) bytes; each MB row adds 8 source rows (loaded
// into registers while the current windows are written), each window is
// 64 16-byte streaming stores. The window's first column, 8 x + 5, is
// 20 bytes into the int32 row, so the ring is loaded from the aligned
// column 8 x0 + 4 and every output word is a byte funnel (PRMT) of two
// neighbouring ring words. K2a's grid would give 1080p S = 8 only 120
// CTAs, fewer than the 132 SMs: the MB rows are cut into bands, each of
// which loads its first 32 rows anew (1080p S = 8: 5 bands of <= 14 rows,
// 600 CTAs, the source read about 1.2 x 1.4 times). 1080p S = 8: 18.3 MB
// read and 66.8 MB written, a floor of 0.025 ms.

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
// K2b
constexpr int M_CHROMA = 11;                // ops/mcgather.py M_CHROMA
constexpr int WIN_C = 8 + 2 * M_CHROMA + 2; // 32
constexpr int ORIGIN_C = PAD_MC / 2 - M_CHROMA;   // 5
constexpr int RING_C = 8 * G + 32;          // bytes per ring row
constexpr int NV_C = 2 * G + 7;             // int4 per source row, at most
constexpr int INIT_C = (WIN_C * NV_C + NT - 1) / NT;  // int4 per thread
constexpr int PF_C = (8 * NV_C + NT - 1) / NT;
// CTAs the band split aims at, 4 per SM; G = 8 and 528 were within 2% of
// the best variant at 1080p S = 8 (tools/kernel_sweep.py, PERF.md)
constexpr int CTAS_C = 528;
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

// grid (column groups, bands of `band` MB rows, S). Ring slot of source
// row R (counted from the band's first window row) is R % WIN_C; ring byte
// b of a row is column 8 x0 + 4 + b of the plane.
__global__ void __launch_bounds__(NT)
chroma_windows_kernel(const int* __restrict__ refc, uint8_t* __restrict__ out,
                      int mb_h, int mb_w, int Hc, int Wc, int band) {
    __shared__ __align__(16) uint8_t ring[WIN_C * RING_C];
    const int x0 = G * blockIdx.x, y0 = band * blockIdx.y, s = blockIdx.z;
    const int gw = min(G, mb_w - x0);
    const int nb = min(band, mb_h - y0);    // MB rows in this band
    const int nv = 2 * gw + 7;              // int4 per source row
    const int* src = refc + ((long long)s * Hc + 8 * y0 + ORIGIN_C) * Wc
                     + 8 * x0 + ORIGIN_C - 1;
    uint8_t* dst = out + (((long long)s * mb_h + y0) * mb_w + x0)
                         * (WIN_C * WIN_C);
    {   // the band's first 32 source rows, all loads in flight at once
        int4 q[INIT_C];
#pragma unroll
        for (int j = 0; j < INIT_C; ++j) {
            const int i = threadIdx.x + NT * j;
            if (i < WIN_C * nv) {
                const int r = i / nv, c = i - r * nv;
                q[j] = __ldg(reinterpret_cast<const int4*>(
                    src + (long long)r * Wc) + c);
            }
        }
#pragma unroll
        for (int j = 0; j < INIT_C; ++j) {
            const int i = threadIdx.x + NT * j;
            if (i < WIN_C * nv) {
                const int r = i / nv, c = i - r * nv;
                *reinterpret_cast<uint32_t*>(ring + r * RING_C + 4 * c) =
                    pack_u8(q[j]);
            }
        }
    }
    __syncthreads();
    for (int y = 0; y < nb; ++y) {
        const int base = 8 * y % WIN_C;     // ring slot of window row 0
        // the 8 source rows MB row y + 1 adds: R = 8 y + 32 + r
        const bool more = y + 1 < nb;
        int4 pf[PF_C];
#pragma unroll
        for (int j = 0; j < PF_C; ++j) {
            const int i = threadIdx.x + NT * j;
            if (more && i < 8 * nv) {
                const int r = i / nv, c = i - r * nv;
                pf[j] = __ldg(reinterpret_cast<const int4*>(
                    src + (long long)(8 * y + WIN_C + r) * Wc) + c);
            }
        }
        // the windows of MB row y: 16-byte chunk j of window m is row j / 2,
        // bytes 16 (j % 2) .. + 15, i.e. ring bytes 8 m + 16 (j % 2) + 1 ..
        for (int i = threadIdx.x; i < gw * 64; i += NT) {
            const int m = i >> 6, j = i & 63;
            const uint8_t* row = ring + ((base + (j >> 1)) & (WIN_C - 1))
                                 * RING_C + 8 * m + 16 * (j & 1);
            const uint2 a = *reinterpret_cast<const uint2*>(row);
            const uint2 b = *reinterpret_cast<const uint2*>(row + 8);
            const uint32_t c = *reinterpret_cast<const uint32_t*>(row + 16);
            __stcs(reinterpret_cast<uint4*>(
                       dst + ((long long)y * mb_w + m) * (WIN_C * WIN_C))
                       + j,
                   make_uint4(__byte_perm(a.x, a.y, 0x4321),
                              __byte_perm(a.y, b.x, 0x4321),
                              __byte_perm(b.x, b.y, 0x4321),
                              __byte_perm(b.y, c, 0x4321)));
        }
        __syncthreads();
        if (more) {
#pragma unroll
            for (int j = 0; j < PF_C; ++j) {
                const int i = threadIdx.x + NT * j;
                if (i < 8 * nv) {
                    const int r = i / nv, c = i - r * nv;
                    *reinterpret_cast<uint32_t*>(
                        ring + ((base + r) & (WIN_C - 1)) * RING_C + 4 * c) =
                        pack_u8(pf[j]);
                }
            }
        }
        __syncthreads();
    }
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

// margin and pad must be M_CHROMA and PAD_MC / 2, Wc a multiple of 4 and
// refc 16-byte aligned (the wrapper checks; 16-byte loads). Bands of MB
// rows are cut so that the grid has about CTAS_C CTAs.
extern "C" int x264t_chroma_windows(const int* refc, uint8_t* out, int S,
                                    int mb_h, int mb_w, int Hc, int Wc,
                                    int margin, int pad, void* stream) {
    if (margin != M_CHROMA || pad != PAD_MC / 2 || Wc % 4 != 0
        || reinterpret_cast<uintptr_t>(refc) % 16 != 0
        || reinterpret_cast<uintptr_t>(out) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const int groups = (mb_w + G - 1) / G;
    const int want = (CTAS_C + groups * S - 1) / (groups * S);
    const int n_bands = want < mb_h ? want : mb_h;
    const int band = (mb_h + n_bands - 1) / n_bands;
    dim3 grid(groups, (mb_h + band - 1) / band, S);
    chroma_windows_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
        refc, out, mb_h, mb_w, Hc, Wc, band);
    return (int)cudaGetLastError();
}
