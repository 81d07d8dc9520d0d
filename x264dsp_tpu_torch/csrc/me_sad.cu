// Full-pel SAD cost surfaces for motion estimation: the whole-MB 16x16
// surface (kernel K1) and the four 8x8-quadrant surfaces (kernel K4).
//
// K1 replaces x264dsp_tpu/ops/pallas/me_sad.py::sad_cost_surface16_lanes
// (Pallas kernel _kernel16). Same inputs and output layout:
//   fenc   (S, 16*mb_h, 16*mb_w)            int32
//   strips (S, mb_h, 16+2R, 16*mb_w+2R)     int32  (make_ref_strips)
//   out    (S, mb_h, 2R+1, 2R+1, mb_w)      int32  [row, dy, dx, mbx]
// out[s][row][dy][dx][mbx] = sum over the 16x16 MB of
//   |fenc[s][16*row+r][16*mbx+c] - strips[s][row][dy+r][16*mbx+dx+c]|.
//
// Bound on the H100: load issue. Each output reads 2x256 int32 values,
// about 36 G loads per 1080p 8-stream frame, almost all served by L1/L2
// (the inputs are ~50 MB per stream). The TPU kernel's hi/lo-byte bf16
// dot only kept the MXU exact; here the sums are plain int32 adds.
// Design: one block per (stream, MB row, dy); a thread per (mbx, dx)
// with dx fastest, so a warp's strip reads are consecutive addresses
// and its fenc reads are broadcasts of the same MB pixels.

#include <cuda_runtime.h>

__global__ void sad_surface16_kernel(const int* __restrict__ fenc,
                                     const int* __restrict__ strips,
                                     int* __restrict__ out,
                                     int mb_h, int mb_w, int R) {
    const int n = 2 * R + 1;
    const int W = 16 * mb_w;
    const int Ws = W + 2 * R;
    const int row = blockIdx.x;
    const int dy = blockIdx.y;
    const int s = blockIdx.z;
    const int* f = fenc + ((size_t)s * 16 * mb_h + 16 * row) * W;
    const int* st = strips + (((size_t)s * mb_h + row) * (16 + 2 * R) + dy)
                    * Ws;
    int* o = out + (((size_t)s * mb_h + row) * n + dy) * n * mb_w;
    for (int t = threadIdx.x; t < n * mb_w; t += blockDim.x) {
        const int mbx = t / n;
        const int dx = t - mbx * n;
        const int* fp = f + 16 * mbx;
        const int* rp = st + 16 * mbx + dx;
        int acc = 0;
#pragma unroll 4
        for (int r = 0; r < 16; ++r) {
#pragma unroll
            for (int c = 0; c < 16; ++c) {
                acc += abs(fp[r * W + c] - rp[r * Ws + c]);
            }
        }
        o[dx * mb_w + mbx] = acc;
    }
}

extern "C" int x264t_sad_surface16(const int* fenc, const int* strips,
                                   int* out, int S, int mb_h, int mb_w,
                                   int R, void* stream) {
    dim3 grid(mb_h, 2 * R + 1, S);
    sad_surface16_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        fenc, strips, out, mb_h, mb_w, R);
    return (int)cudaGetLastError();
}

// K4: the four 8x8-quadrant SAD surfaces of every MB (the P partition
// cost surfaces; 16x8/8x16/16x16 are quadrant sums).
//
// Replaces x264dsp_tpu/ops/pallas/me_sad.py::sad_cost_surfaces_8x8
// (Pallas kernel _kernel). Same inputs as K1; output in the JAX public
// layout with a leading stream axis:
//   out    (S, mb_h, mb_w, 2, 2, 2R+1, 2R+1)   int32 [mbx, qy, qx, dy, dx]
// out[s][row][mbx][qy][qx][dy][dx] = sum over the 8x8 quadrant (qy, qx)
// of |fenc - strips| at offset (dy, dx), as in K1.
//
// Bound on the H100: integer issue. At 1080p, 8 streams, R = 16 it takes
// 65,280 MBs x 256 px x 1,089 offsets = 18.2 G absolute differences (a
// subtract, an absolute value and an add each) against 1.41 GB moved
// (fenc 66.8 MB, strips 203.9 MB, output 1.14 GB). The TPU kernel's
// hi/lo-byte bf16 dot with a 0/1 selection matrix only kept the MXU
// exact; here the sums are plain int32 adds. Design: K1's mapping (one
// block per (stream, MB row, dy), a thread per (mbx, dx), dx fastest);
// each thread keeps the four quadrant sums in registers and writes them
// to out[s][row][mbx][qy][qx][dy][dx], so neighbouring threads write
// neighbouring addresses.
__global__ void sad_surfaces_8x8_kernel(const int* __restrict__ fenc,
                                        const int* __restrict__ strips,
                                        int* __restrict__ out,
                                        int mb_h, int mb_w, int R) {
    const int n = 2 * R + 1;
    const int nn = n * n;
    const int W = 16 * mb_w;
    const int Ws = W + 2 * R;
    const int row = blockIdx.x;
    const int dy = blockIdx.y;
    const int s = blockIdx.z;
    const int* f = fenc + ((size_t)s * 16 * mb_h + 16 * row) * W;
    const int* st = strips + (((size_t)s * mb_h + row) * (16 + 2 * R) + dy)
                    * Ws;
    int* o = out + ((size_t)s * mb_h + row) * mb_w * 4 * nn + dy * n;
    for (int t = threadIdx.x; t < n * mb_w; t += blockDim.x) {
        const int mbx = t / n;
        const int dx = t - mbx * n;
        const int* fp = f + 16 * mbx;
        const int* rp = st + 16 * mbx + dx;
        int acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int qy = 0; qy < 2; ++qy) {
#pragma unroll 2
            for (int r = 8 * qy; r < 8 * qy + 8; ++r) {
#pragma unroll
                for (int c = 0; c < 16; ++c) {
                    acc[2 * qy + (c >> 3)] += abs(fp[r * W + c]
                                                  - rp[r * Ws + c]);
                }
            }
        }
        int* op = o + (size_t)mbx * 4 * nn + dx;
#pragma unroll
        for (int q = 0; q < 4; ++q) op[q * nn] = acc[q];
    }
}

extern "C" int x264t_sad_surfaces_8x8(const int* fenc, const int* strips,
                                      int* out, int S, int mb_h, int mb_w,
                                      int R, void* stream) {
    dim3 grid(mb_h, 2 * R + 1, S);
    sad_surfaces_8x8_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        fenc, strips, out, mb_h, mb_w, R);
    return (int)cudaGetLastError();
}
