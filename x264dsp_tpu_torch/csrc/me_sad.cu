// Whole-MB 16x16 SAD cost surface for motion estimation (kernel K1).
//
// Replaces x264dsp_tpu/ops/pallas/me_sad.py::sad_cost_surface16_lanes
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
