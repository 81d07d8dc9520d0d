// Probe: the issue rate of the packed-byte SAD that csrc/me_sad.cu uses,
// PTX vabsdiff4.u32.u32.u32.add (four |a - b| bytes added to a 32-bit
// sum; SASS VABSDIFF4.U8.ACC). Each thread keeps 16 sums in registers
// and, per loop step, adds to each the SAD of another sum's bytes against
// a word held in a register, so no operand is loop-invariant and the 16
// chains stay independent; the loop body is the 16 SADs and the loop
// control. Built and timed by x264dsp_tpu_torch/tools/sad_rate.py: the
// packed sums per second it reaches, against the instruction's peak.

#include <cuda_runtime.h>

namespace {

constexpr int NACC = 16;

__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b,
                                         unsigned acc) {
    unsigned d;
    asm volatile("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
                 : "=r"(d) : "r"(a), "r"(b), "r"(acc));
    return d;
}

__global__ void sad_rate_kernel(unsigned* out, int iters) {
    const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
    unsigned acc[NACC], b[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
        acc[i] = t * 0x9E3779B9u + i;
        b[i] = (t + i) * 0x01234567u;     // in registers, not immediates
    }
#pragma unroll 1
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int i = 0; i < NACC; ++i)
            acc[i] = sad4(acc[(i + 1) % NACC], b[i], acc[i]);
    }
    unsigned x = 0;
#pragma unroll
    for (int i = 0; i < NACC; ++i) x ^= acc[i];
    out[t] = x;
}

}  // namespace

// out holds blocks x threads words; each thread does 16 x iters packed
// sums
extern "C" int x264t_sad_rate(unsigned* out, int blocks, int threads,
                              int iters, void* stream) {
    sad_rate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(out,
                                                                  iters);
    return (int)cudaGetLastError();
}
