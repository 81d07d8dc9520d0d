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
//
// Bound on the H100: device-memory bandwidth (a pure gather-copy: one
// int32 read, L2-shared by the overlapping windows, and one byte written
// per output). Design: a grid-stride loop, one output byte per thread
// step, consecutive threads on consecutive output bytes (coalesced
// writes; the reads of a window row are consecutive too).

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void luma_windows_kernel(const int* __restrict__ ref4,
                                    uint8_t* __restrict__ out, long long total,
                                    int mb_h, int mb_w, int Hp, int Wp,
                                    int win, int origin) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += step) {
        long long t = i;
        const int c = (int)(t % win); t /= win;
        const int r = (int)(t % win); t /= win;
        const int p = (int)(t % 4); t /= 4;
        const int mbx = (int)(t % mb_w); t /= mb_w;
        const int mby = (int)(t % mb_h); t /= mb_h;
        const long long s = t;
        const int y = 16 * mby + origin + r;
        const int x = 16 * mbx + origin + c;
        out[i] = (uint8_t)ref4[((s * 4 + p) * Hp + y) * (long long)Wp + x];
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

extern "C" int x264t_luma_windows(const int* ref4, uint8_t* out, int S,
                                  int mb_h, int mb_w, int Hp, int Wp,
                                  int margin, int pad, void* stream) {
    const int win = 16 + 2 * margin;
    const long long total = (long long)S * mb_h * mb_w * 4 * win * win;
    luma_windows_kernel<<<grid_for(total), 256, 0, (cudaStream_t)stream>>>(
        ref4, out, total, mb_h, mb_w, Hp, Wp, win, pad - margin);
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
