// Block-wide reductions shared by the row-normalisation kernels.
#pragma once

#include <cuda_runtime.h>

// Sum of `v` over every thread of the block; each thread gets the total.
// blockDim.x must be a multiple of 32 (full-warp shuffles). `scratch` is
// 32 floats of shared memory; the trailing barrier leaves it free for the
// next call.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    const int n_warps = blockDim.x >> 5;
    float t = lane < n_warps ? scratch[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    __syncthreads();
    return t;
}

// Threads for one row of width d when a thread takes g columns a step:
// one step a thread where the row allows, a whole number of warps, at most
// 1024.
inline int row_threads(long long d, int g) {
    long long t = (d + g - 1) / g;
    t = (t + 31) / 32 * 32;
    if (t < 32) t = 32;
    if (t > 1024) t = 1024;
    return static_cast<int>(t);
}
