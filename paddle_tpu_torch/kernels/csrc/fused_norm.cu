// LayerNorm forward over the last axis, fp32.
//
// Replaces: paddle_tpu/kernels/fused_norm.py, _ln_fwd_kernel (launched by
// _ln_forward). Same arithmetic: fp32 mean, then the centred variance
// (two passes, not E[x^2] - E[x]^2), rstd = rsqrt(var + eps), optional
// weight and bias, and the fp32 per-row mean/rstd the backward needs.
//
// Bound on the H100: bytes. One row of D floats is read and one written
// (8 bytes an element) for about 8 flops an element, so at 3.35 TB/s
// against 67 TFLOP/s fp32 the memory side is ~20x the arithmetic side.
//
// Design: one thread block per row, a grid-stride loop over D, warp
// shuffles plus a 32-float shared scratch for the block sums. The row is
// read from device memory once; the second and third passes hit L1 (a
// BERT-large row is 4 KB). Any N and any D: no row tiling, so no
// multiple-of-8 rule as on the TPU. Null weight/bias mean no affine; null
// mean/rstd mean the caller does not want the statistics (serving).
#include <cstdint>

#include "block_reduce.cuh"

namespace {

__global__ void layer_norm_fwd_kernel(const float* __restrict__ x,
                                      const float* __restrict__ w,
                                      const float* __restrict__ b,
                                      float* __restrict__ y,
                                      float* __restrict__ mean_out,
                                      float* __restrict__ rstd_out,
                                      int64_t d, float eps) {
    __shared__ float scratch[32];
    const int64_t row = blockIdx.x;
    const float* xr = x + row * d;
    float* yr = y + row * d;

    float s = 0.f;
    for (int64_t i = threadIdx.x; i < d; i += blockDim.x) s += xr[i];
    const float mean = block_sum(s, scratch) / static_cast<float>(d);

    float ss = 0.f;
    for (int64_t i = threadIdx.x; i < d; i += blockDim.x) {
        const float c = xr[i] - mean;
        ss += c * c;
    }
    const float var = block_sum(ss, scratch) / static_cast<float>(d);
    const float rstd = rsqrtf(var + eps);

    for (int64_t i = threadIdx.x; i < d; i += blockDim.x) {
        float v = (xr[i] - mean) * rstd;
        if (w != nullptr) v *= w[i];
        if (b != nullptr) v += b[i];
        yr[i] = v;
    }
    if (threadIdx.x == 0) {
        if (mean_out != nullptr) mean_out[row] = mean;
        if (rstd_out != nullptr) rstd_out[row] = rstd;
    }
}

}  // namespace

// x, y: (n, d) contiguous fp32. w, b: (d,) or null. mean, rstd: (n,) or
// null. Returns cudaGetLastError() after the launch.
extern "C" int ptt_layer_norm_fwd(const void* x, const void* w, const void* b,
                                  void* y, void* mean, void* rstd, int64_t n,
                                  int64_t d, float eps, void* stream) {
    if (n <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
    layer_norm_fwd_kernel<<<static_cast<unsigned>(n), row_threads(d), 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(y),
        static_cast<float*>(mean), static_cast<float*>(rstd), d, eps);
    return static_cast<int>(cudaGetLastError());
}
