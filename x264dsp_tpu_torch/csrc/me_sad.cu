// Full-pel SAD cost surfaces for motion estimation: the whole-MB 16x16
// surface (kernel K1) and the four 8x8-quadrant surfaces (kernel K4).
//
// K1 replaces x264dsp_tpu/ops/pallas/me_sad.py:138
// sad_cost_surface16_lanes (Pallas kernel _kernel16), K4 replaces
// me_sad.py:72 sad_cost_surfaces_8x8 (Pallas kernel _kernel). Inputs:
//   fenc   (S, 16*mb_h, 16*mb_w)            int32
//   strips (S, mb_h, 16+2R, 16*mb_w+2R)     int32  (make_ref_strips)
// Outputs, int32:
//   K1 (S, mb_h, 2R+1, 2R+1, mb_w)          [row, dy, dx, mbx]
//   K4 (S, mb_h, mb_w, 2, 2, 2R+1, 2R+1)    [row, mbx, qy, qx, dy, dx]
// K1[s][row][dy][dx][mbx] = sum over the 16x16 MB of
//   |fenc[s][16*row+r][16*mbx+c] - strips[s][row][dy+r][16*mbx+dx+c]|;
// K4 holds the same sum over each 8x8 quadrant (qy, qx).
//
// Precondition: every input value is a pixel, 0..255. Both kernels pack
// the inputs to bytes (the low byte of each int32) and do not check the
// range. The largest sums, 65,280 (K1) and 16,320 (K4), fit 32 bits.
//
// Bound on the H100. At 1080p, 8 streams, R = 16 the work is 65,280 MBs
// x 256 pixels x 1,089 offsets = 18.2 G absolute differences, 4.55 G
// sums of four packed bytes; bytes moved: 0.56 GB for K1 (0.166 ms at
// 3.35 TB/s) and 1.41 GB for K4 (0.420 ms, of which the 1.14 GB output
// is 0.34 ms). Counted as int32 work (a subtract-absolute and an add per
// difference, 16.7 TOP/s) the bound was 2.176 ms: the bound of the int32
// formulation, which this design does not use. Here a packed sum is one
// SASS instruction, VABSDIFF4.U8.ACC, which issues at the int32 rate of
// 64 lanes per SM and clock: 16.7 T sums/s at 132 SMs x 1.98 GHz. The
// bound is the larger of the bytes and the 4.55 G packed sums at that
// peak, 0.272 ms, so K1 is bound by operations and K4 by bytes. The probe
// tools/sad_rate.cu measures the rate the instruction reaches on the card
// (about 15.6 T sums/s on an H100 80GB HBM3 at 700 W).
//
// Design. A CTA owns (stream, MB row, a group of G = 8 MB columns, a
// tile of at most 9 dx quads, a tile of dy rows); the dx and dy tiles
// keep shared memory bounded for any R. It loads its reference rows
// once (16-byte loads of 4 int32 pixels, coalesced along the row, LB of
// them in flight per thread), packs them to one 32-bit word per 4
// pixels in shared memory, and packs its MBs' source pixels the same way
// (64 words per MB). Each thread then owns one MB, 4 consecutive dx (a
// quad) and TY consecutive dy, and slides down the TY + 15 reference rows
// its offsets touch. Per row it reads 5 aligned words, forms the three
// byte-shifted copies (dx + 1..3) with one PRMT per word, and for each
// of its dy that the row serves reads the matching source row (one
// 16-byte shared-memory load, a broadcast among the threads of one MB)
// and adds 16 packed sums (4 dx x 4 words) with vabsdiff4's
// accumulate. So one load of a reference word serves 4 dx x TY dy
// outputs and one shift serves TY of them. K4 keeps two sums per
// (dy, dx) (words 0-1 of a row are qx = 0, words 2-3 qx = 1) and flushes
// them to a 16-bit shared-memory stage after source rows 7 (qy = 0) and
// 15 (qy = 1); the CTA then copies its stage to the output with
// consecutive threads on consecutive dx, the tile's rows of one
// (MB, quadrant) being one contiguous run when one dx tile covers all
// of them. K1 writes straight from registers: 8 neighbouring threads
// hold the 8 MB columns of one (dy, dx), mbx is the output's fastest
// axis, so each store fills whole 32-byte sectors.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int G = 8;          // MB columns per CTA
constexpr int QMAX = 9;       // dx quads per CTA at most (36 offsets)
constexpr int NT_MAX = 256;   // threads per CTA at most
constexpr int TY16 = 11;      // dy rows per thread, K1 (33 = 3 x 11)
constexpr int TY8 = 6;        // dy rows per thread, K4 (8 sums per dy:
                              // 11 rows do not fit the registers)
constexpr int FSTRIDE = 68;   // packed source words per MB in shared
                              // memory (64 + 4: no bank conflicts)
constexpr int TW = 4 * (G - 1) + QMAX + 4;   // words per shared tile row
constexpr int LB = 4;         // 16-byte loads in flight per thread

struct Args {
    const int* fenc;
    const int* strips;
    int* out;
    int mb_h, mb_w, R;
    int QT, ntq;              // dx quads per CTA, dx tiles
    int DG, ntd;              // dy groups (of TY) per CTA, dy tiles
    int rows;                 // shared reference tile: rows x TW words
    int fpo;                  // its size rounded up to 16 bytes (words)
    int pitch;                // K4 stage row pitch (entries)
    int vec_ref, vec_fenc;    // 16-byte loads allowed
};

// 4 pixels from p, p[k] only for k < lim (zero beyond); one 16-byte load
// when vec (then p is 16-byte aligned and lim >= 4 or lim <= 0)
__device__ __forceinline__ int4 load4(const int* p, bool vec, int lim) {
    if (vec) return lim > 0 ? *(const int4*)p : make_int4(0, 0, 0, 0);
    return make_int4(lim > 0 ? p[0] : 0, lim > 1 ? p[1] : 0,
                     lim > 2 ? p[2] : 0, lim > 3 ? p[3] : 0);
}

__device__ __forceinline__ unsigned pack4(int a, int b, int c, int d) {
    return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                       0x5410);
}

// acc + |a.b0 - b.b0| + ... + |a.b3 - b.b3|
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b,
                                         unsigned acc) {
    unsigned d;
    asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
        : "=r"(d) : "r"(a), "r"(b), "r"(acc));
    return d;
}

template <bool QUAD, int TY>
__device__ __forceinline__ void sad_tile(const Args& a) {
    extern __shared__ __align__(16) unsigned smem[];
    unsigned* ref = smem;                          // rows x TW
    unsigned* fp = ref + a.fpo;                    // G x FSTRIDE
    // K4's stage: (G*4, DYL, pitch) quadrant sums, 16 bits (at most 16,320)
    unsigned short* stage = (unsigned short*)(fp + G * FSTRIDE);

    const int mb_w = a.mb_w, mb_h = a.mb_h;
    const int n = 2 * a.R + 1;
    const int W = 16 * mb_w;
    const int Ws = W + 2 * a.R;
    const int Hs = 16 + 2 * a.R;
    const int ngrp = (mb_w + G - 1) / G;
    int bx = blockIdx.x;
    const int grp = bx % ngrp;
    bx /= ngrp;
    const int tq = bx % a.ntq;
    const int td = bx / a.ntq;
    const int row = blockIdx.y;
    const int s = blockIdx.z;
    const int mbx0 = grp * G;
    const int q0 = tq * a.QT;
    const int DYL = a.DG * TY;
    const int dy0 = td * DYL;
    const int col0 = 16 * mbx0 + 4 * q0;     // strip column of tile word 0
    const size_t sr = (size_t)s * mb_h + row;
    const int* st = a.strips + sr * Hs * Ws;

    // reference rows dy0 .. dy0 + rows - 1, packed (zero past the strip),
    // and the G MBs' source pixels (word 4r + w of MB m: row r, columns
    // 4w .. 4w + 3); each thread issues LB 16-byte loads before it packs
    const int* f = a.fenc + sr * 16 * W;
    const int nref = a.rows * TW;
    const int nall = nref + 16 * G * 4;
    for (int i0 = threadIdx.x; i0 < nall; i0 += LB * blockDim.x) {
        int4 v[LB];
#pragma unroll
        for (int u = 0; u < LB; ++u) {
            const int i = i0 + u * blockDim.x;
            v[u] = make_int4(0, 0, 0, 0);
            if (i < nref) {
                const int rr = i / TW;
                const int y = dy0 + rr;
                const int x = col0 + 4 * (i - rr * TW);
                if (y < Hs)
                    v[u] = load4(st + (size_t)y * Ws + x, a.vec_ref, Ws - x);
            } else if (i < nall) {
                const int e = i - nref;     // threads run along the row
                const int r = e / (G * 4);
                const int mm = (e >> 2) % G;
                if (mbx0 + mm < mb_w)
                    v[u] = load4(f + (size_t)r * W + 16 * (mbx0 + mm)
                                 + 4 * (e & 3), a.vec_fenc, 4);
            }
        }
#pragma unroll
        for (int u = 0; u < LB; ++u) {
            const int i = i0 + u * blockDim.x;
            const unsigned w = pack4(v[u].x, v[u].y, v[u].z, v[u].w);
            if (i < nref) {
                ref[i] = w;
            } else if (i < nall) {
                const int e = i - nref;
                fp[((e >> 2) % G) * FSTRIDE + 4 * (e / (G * 4)) + (e & 3)] = w;
            }
        }
    }
    __syncthreads();

    // this thread: MB m, dx quad q (dx = 4(q0 + q) + k), dy group jg
    // (dy = dy0 + TY jg + j); blockDim = G x QT x DG
    const int t = threadIdx.x;
    const int m = t % G;
    const int q = (t / G) % a.QT;
    const int jg = t / (G * a.QT);
    const unsigned* fm = fp + m * FSTRIDE;
    const unsigned* rp = ref + jg * TY * TW + 4 * m + q;
    constexpr int NA = QUAD ? 2 : 1;
    unsigned acc[TY][4][NA];
#pragma unroll
    for (int j = 0; j < TY; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int h = 0; h < NA; ++h) acc[j][k][h] = 0;

#pragma unroll
    for (int r = 0; r < TY + 15; ++r) {
        // the row's 5 words and their copies shifted by k = 1..3 bytes
        unsigned x[5], sh[4][4];
#pragma unroll
        for (int w = 0; w < 5; ++w) x[w] = rp[r * TW + w];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int w = 0; w < 4; ++w)
                sh[k][w] = k == 0 ? x[w]
                                  : __byte_perm(x[w], x[w + 1],
                                                0x3210 + 0x1111 * k);
#pragma unroll
        for (int j = 0; j < TY; ++j) {
            const int fy = r - j;                  // source row
            if (fy < 0 || fy > 15) continue;
            const uint4 f4 = *(const uint4*)(fm + 4 * fy);
            const unsigned fw[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
#pragma unroll
                for (int w = 0; w < 4; ++w) {
                    unsigned& c = acc[j][k][QUAD ? w >> 1 : 0];
                    c = sad4(fw[w], sh[k][w], c);
                }
                if (QUAD && (fy == 7 || fy == 15)) {
                    const int dxl = 4 * q + k;
                    if (dxl < a.pitch) {
#pragma unroll
                        for (int h = 0; h < NA; ++h) {
                            const int qq = 2 * (fy >> 3) + h;
                            stage[((m * 4 + qq) * DYL + TY * jg + j)
                                  * a.pitch + dxl] =
                                (unsigned short)acc[j][k][h];
                            acc[j][k][h] = 0;
                        }
                    }
                }
            }
        }
    }

    if (!QUAD) {
        const int mbx = mbx0 + m;
        if (mbx >= mb_w) return;
        const int dyb = dy0 + TY * jg;
        const int dxb = 4 * (q0 + q);
        // offsets within the (stream, row) slab of n * n * mb_w ints
        int* o = a.out + sr * n * n * mb_w + mbx;
        const int off = (dyb * n + dxb) * mb_w;
#pragma unroll
        for (int j = 0; j < TY; ++j)
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (dyb + j < n && dxb + k < n)
                    o[off + (j * n + k) * mb_w] = (int)acc[j][k][0];
        return;
    }

    // K4: copy the stage to the output, consecutive threads on
    // consecutive dx. With one dx tile (pitch = n) the tile's rows of one
    // (MB, quadrant) are one contiguous run, copied without the row
    // split: K4 at 1080p, S = 8, R = 16 takes 0.99 ms on an H100 this
    // way, 1.06 ms with the general loop alone.
    __syncthreads();
    const int gv = min(G, mb_w - mbx0);
    const int dyn = min(DYL, n - dy0);
    const int dxn = min(4 * a.QT, n - 4 * q0);
    int* ob = a.out + (sr * mb_w + mbx0) * 4 * n * n + (size_t)dy0 * n
              + 4 * q0;
    for (int mq = 0; mq < 4 * gv; ++mq) {          // m * 4 + quadrant
        const unsigned short* sp = stage + mq * DYL * a.pitch;
        int* op = ob + (size_t)mq * n * n;
        if (a.ntq == 1) {
            for (int i = t; i < dyn * n; i += blockDim.x) op[i] = sp[i];
        } else {
            for (int e = t; e < dyn * dxn; e += blockDim.x) {
                const int dyl = e / dxn;
                const int i = e - dyl * dxn;
                op[dyl * n + i] = sp[dyl * a.pitch + i];
            }
        }
    }
}

__global__ void __launch_bounds__(NT_MAX)
sad_surface16_kernel(Args a) { sad_tile<false, TY16>(a); }

__global__ void __launch_bounds__(NT_MAX)
sad_surfaces_8x8_kernel(Args a) { sad_tile<true, TY8>(a); }

// the launch for TY dy rows per thread: the kernel's arguments, its
// dynamic shared memory, threads per CTA and the grid's x
Args geometry(bool quad, int TY, const int* fenc, const int* strips,
              int* out, int mb_h, int mb_w, int R, size_t* smem,
              int* threads, int* grid_x) {
    Args a;
    a.fenc = fenc; a.strips = strips; a.out = out;
    a.mb_h = mb_h; a.mb_w = mb_w; a.R = R;
    const int n = 2 * R + 1;
    const int nq = (n + 3) / 4;
    a.ntq = (nq + QMAX - 1) / QMAX;
    a.QT = (nq + a.ntq - 1) / a.ntq;
    const int ndyg = (n + TY - 1) / TY;
    int dgmax = NT_MAX / (G * a.QT);
    if (dgmax < 1) dgmax = 1;
    a.ntd = (ndyg + dgmax - 1) / dgmax;
    a.DG = (ndyg + a.ntd - 1) / a.ntd;
    a.rows = a.DG * TY + 15;
    a.fpo = (a.rows * TW + 3) & ~3;
    a.pitch = a.ntq == 1 ? n : 4 * a.QT;
    const int Ws = 16 * mb_w + 2 * R;
    a.vec_ref = (Ws % 4 == 0) && ((uintptr_t)strips % 16 == 0);
    a.vec_fenc = (uintptr_t)fenc % 16 == 0;
    *smem = sizeof(unsigned) * ((size_t)a.fpo + G * FSTRIDE)
            + (quad ? sizeof(unsigned short) * (size_t)G * 4 * a.DG * TY
                      * a.pitch
                    : 0);
    *threads = G * a.QT * a.DG;
    *grid_x = ((mb_w + G - 1) / G) * a.ntq * a.ntd;
    return a;
}

int launch(void (*kern)(Args), bool quad, int TY, const int* fenc,
           const int* strips, int* out, int S, int mb_h, int mb_w, int R,
           void* stream) {
    const long long n = 2 * R + 1;
    if (n * n * mb_w > INT_MAX)     // K1's 32-bit offsets in a row's slab
        return (int)cudaErrorInvalidValue;
    size_t smem;
    int threads, gx;
    const Args a = geometry(quad, TY, fenc, strips, out, mb_h, mb_w, R,
                            &smem, &threads, &gx);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid(gx, mb_h, S);
    kern<<<grid, threads, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int x264t_sad_surface16(const int* fenc, const int* strips,
                                   int* out, int S, int mb_h, int mb_w,
                                   int R, void* stream) {
    return launch(sad_surface16_kernel, false, TY16, fenc, strips, out, S,
                  mb_h, mb_w, R, stream);
}

extern "C" int x264t_sad_surfaces_8x8(const int* fenc, const int* strips,
                                      int* out, int S, int mb_h, int mb_w,
                                      int R, void* stream) {
    return launch(sad_surfaces_8x8_kernel, true, TY8, fenc, strips, out, S,
                  mb_h, mb_w, R, stream);
}
