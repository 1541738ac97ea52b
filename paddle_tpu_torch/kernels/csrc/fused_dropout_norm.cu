// Dropout + residual add + LayerNorm forward over the last axis, and the
// dropout-mask gradient, fp32:
//   yin = residual + x * keep / (1 - p),  y = LayerNorm(yin)
//   dx  = d_yin * keep / (1 - p)          (the same mask, regenerated)
//
// Replaces: paddle_tpu/kernels/fused_dropout_norm.py, _fwd_kernel (launched
// by _fused_fwd) and _dmask_kernel (launched by _apply_dropout_grad). The
// mask comes from philox.cuh, keyed on (seed, offset, row * d + column), so
// it is never stored: the forward saves (seed, offset) and the gradient
// kernel rebuilds the bits.
//
// Bound on the H100: bytes, both kernels. The forward reads x and residual
// once and writes y (and yin, mean, rstd in training): 12-16 bytes an
// element against ~9 flops plus a quarter of a Philox call (~25 integer
// operations); the gradient reads and writes 4 bytes an element.
//
// Design: one thread block per row as in fused_norm.cu. Without dropout
// the sum is formed again in each of the three passes (mean, centred
// variance, output) instead of stored, so serving writes one (N, D)
// array. With dropout a thread takes four neighbouring columns a step, so
// one Philox call (four words) serves four elements when d % 4 == 0; the
// sum goes to yin once and the later passes read it back (from L1/L2)
// rather than run the generator three times. The gradient kernel is flat
// over N * D: one thread, one Philox call, four elements, 16-byte loads
// and stores when the pointers allow.
#include <cstdint>

#include "block_reduce.cuh"
#include "philox.cuh"

namespace {

__global__ void add_layer_norm_fwd_kernel(const float* __restrict__ x,
                                          const float* __restrict__ res,
                                          const float* __restrict__ w,
                                          const float* __restrict__ b,
                                          float* __restrict__ y,
                                          float* __restrict__ yin,
                                          float* __restrict__ mean_out,
                                          float* __restrict__ rstd_out,
                                          int64_t d, float eps) {
    __shared__ float scratch[32];
    const int64_t row = blockIdx.x;
    const float* xr = x + row * d;
    const float* rr = res + row * d;
    float* yr = y + row * d;

    float s = 0.f;
    for (int64_t i = threadIdx.x; i < d; i += blockDim.x) {
        const float v = rr[i] + xr[i];
        if (yin != nullptr) yin[row * d + i] = v;
        s += v;
    }
    const float mean = block_sum(s, scratch) / static_cast<float>(d);

    float ss = 0.f;
    for (int64_t i = threadIdx.x; i < d; i += blockDim.x) {
        const float c = rr[i] + xr[i] - mean;
        ss += c * c;
    }
    const float var = block_sum(ss, scratch) / static_cast<float>(d);
    const float rstd = rsqrtf(var + eps);

    for (int64_t i = threadIdx.x; i < d; i += blockDim.x) {
        float v = (rr[i] + xr[i] - mean) * rstd;
        if (w != nullptr) v *= w[i];
        if (b != nullptr) v += b[i];
        yr[i] = v;
    }
    if (threadIdx.x == 0) {
        if (mean_out != nullptr) mean_out[row] = mean;
        if (rstd_out != nullptr) rstd_out[row] = rstd;
    }
}

// The dropout branch. yin is always written (the caller allocates it) and
// is read back by the second and third pass; block_sum's barriers order
// those reads after every thread's writes.
__global__ void dropout_add_layer_norm_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ res,
    const float* __restrict__ w, const float* __restrict__ b,
    float* __restrict__ y, float* yin, float* __restrict__ mean_out,
    float* __restrict__ rstd_out, int64_t d, float eps, DropoutArgs drop) {
    __shared__ float scratch[32];
    const int64_t row = blockIdx.x;
    const float* xr = x + row * d;
    const float* rr = res + row * d;
    float* sr = yin + row * d;
    float* yr = y + row * d;

    float s = 0.f;
    for (int64_t c0 = 4 * static_cast<int64_t>(threadIdx.x); c0 < d;
         c0 += 4 * static_cast<int64_t>(blockDim.x)) {
        PhiloxWords r;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int64_t col = c0 + e;
            if (col >= d) break;
            const uint64_t idx = static_cast<uint64_t>(row * d + col);
            // a new group of four starts here (always at e == 0; again
            // inside the step only when d % 4 != 0)
            if (e == 0 || (idx & 3) == 0)
                r = philox4x32_10(drop.seed, drop.offset, idx >> 2);
            const float ks =
                philox_word(r, static_cast<uint32_t>(idx) & 3u) >=
                        drop.threshold ? drop.scale : 0.f;
            const float v = rr[col] + xr[col] * ks;
            sr[col] = v;
            s += v;
        }
    }
    const float mean = block_sum(s, scratch) / static_cast<float>(d);

    float ss = 0.f;
    for (int64_t i = threadIdx.x; i < d; i += blockDim.x) {
        const float c = sr[i] - mean;
        ss += c * c;
    }
    const float var = block_sum(ss, scratch) / static_cast<float>(d);
    const float rstd = rsqrtf(var + eps);

    for (int64_t i = threadIdx.x; i < d; i += blockDim.x) {
        float v = (sr[i] - mean) * rstd;
        if (w != nullptr) v *= w[i];
        if (b != nullptr) v += b[i];
        yr[i] = v;
    }
    if (threadIdx.x == 0) {
        if (mean_out != nullptr) mean_out[row] = mean;
        if (rstd_out != nullptr) rstd_out[row] = rstd;
    }
}

constexpr int kGradThreads = 256;

// out[i] = g[i] * keep_scale(i) over n elements; thread t owns elements
// 4t .. 4t + 3, which share one Philox call.
template <bool kVec>
__global__ void __launch_bounds__(kGradThreads)
dropout_grad_kernel(const float* __restrict__ g, float* __restrict__ out,
                    int64_t n, DropoutArgs drop) {
    const int64_t group =
        static_cast<int64_t>(blockIdx.x) * kGradThreads + threadIdx.x;
    const int64_t i0 = 4 * group;
    if (i0 >= n) return;
    const PhiloxWords r = philox4x32_10(drop.seed, drop.offset,
                                        static_cast<uint64_t>(group));
    float ks[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
        ks[e] = r.w[e] >= drop.threshold ? drop.scale : 0.f;
    if (kVec && i0 + 3 < n) {
        const float4 v = reinterpret_cast<const float4*>(g)[group];
        reinterpret_cast<float4*>(out)[group] =
            make_float4(v.x * ks[0], v.y * ks[1], v.z * ks[2], v.w * ks[3]);
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (i0 + e < n) out[i0 + e] = g[i0 + e] * ks[e];
    }
}

}  // namespace

// x, res, y, yin: (n, d) contiguous fp32. w, b: (d,) or null. mean, rstd:
// (n,) or null. Dropout is on iff drop_scale != 1; yin must then be given,
// otherwise it is null unless wanted. Returns cudaGetLastError() after the
// launch.
extern "C" int ptt_add_layer_norm_fwd(const void* x, const void* res,
                                      const void* w, const void* b, void* y,
                                      void* yin, void* mean, void* rstd,
                                      int64_t n, int64_t d, float eps,
                                      uint64_t seed, uint64_t offset,
                                      uint32_t threshold, float drop_scale,
                                      void* stream) {
    if (n <= 0 || n > 0x7fffffff || d <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto st = static_cast<cudaStream_t>(stream);
    const auto grid = static_cast<unsigned>(n);
    if (drop_scale != 1.f) {
        if (yin == nullptr) return static_cast<int>(cudaErrorInvalidValue);
        dropout_add_layer_norm_fwd_kernel<<<grid, row_threads(d), 0, st>>>(
            static_cast<const float*>(x), static_cast<const float*>(res),
            static_cast<const float*>(w), static_cast<const float*>(b),
            static_cast<float*>(y), static_cast<float*>(yin),
            static_cast<float*>(mean), static_cast<float*>(rstd), d, eps,
            DropoutArgs{seed, offset, threshold, drop_scale});
    } else {
        add_layer_norm_fwd_kernel<<<grid, row_threads(d), 0, st>>>(
            static_cast<const float*>(x), static_cast<const float*>(res),
            static_cast<const float*>(w), static_cast<const float*>(b),
            static_cast<float*>(y), static_cast<float*>(yin),
            static_cast<float*>(mean), static_cast<float*>(rstd), d, eps);
    }
    return static_cast<int>(cudaGetLastError());
}

// g, out: n contiguous fp32 elements (the flattened (N, D) gradient).
// Returns cudaGetLastError() after the launch.
extern "C" int ptt_dropout_grad(const void* g, void* out, int64_t n,
                                uint64_t seed, uint64_t offset,
                                uint32_t threshold, float drop_scale,
                                void* stream) {
    const int64_t groups = (n + 3) / 4;
    const int64_t blocks = (groups + kGradThreads - 1) / kGradThreads;
    if (n <= 0 || blocks > 0x7fffffff)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto st = static_cast<cudaStream_t>(stream);
    const auto gp = static_cast<const float*>(g);
    const auto op = static_cast<float*>(out);
    const DropoutArgs drop{seed, offset, threshold, drop_scale};
    const bool vec = reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const auto grid = static_cast<unsigned>(blocks);
    if (vec)
        dropout_grad_kernel<true><<<grid, kGradThreads, 0, st>>>(gp, op, n,
                                                                 drop);
    else
        dropout_grad_kernel<false><<<grid, kGradThreads, 0, st>>>(gp, op, n,
                                                                  drop);
    return static_cast<int>(cudaGetLastError());
}
