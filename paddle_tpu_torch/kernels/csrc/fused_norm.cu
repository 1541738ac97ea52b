// LayerNorm and RMSNorm forward over the last axis, fp32, bf16 or fp16.
//
// Replaces: paddle_tpu/kernels/fused_norm.py, _ln_fwd_kernel (launched by
// _ln_forward) and _rms_fwd_kernel (launched by _rms_forward). Same
// arithmetic: x is read in its dtype and widened to fp32; LayerNorm takes
// the fp32 mean, then the centred variance (two passes, not
// E[x^2] - E[x]^2), rstd = rsqrt(var + eps), optional weight and bias;
// RMSNorm takes ms = mean(x^2), rstd = rsqrt(ms + eps), y = x * rstd * w.
// y is stored in x's dtype, the per-row statistics the backward needs
// (mean and rstd, or rstd) in fp32. The reference's TPU gate
// (D % 128 == 0) does not apply: any N, any D.
//
// Bound on the H100: bytes. One row is read and one written (4 bytes an
// element in bf16, 8 in fp32) for about 8 flops an element, far below the
// ridge of either the fp32 pipes or the tensor cores.
//
// Design. Each forward has two routes, chosen in C from the width, the
// dtype and the pointers (dispatch_ln, dispatch_rms), never by the caller:
//
// - the register path (ln_rows_warp_kernel, rms_rows_warp_kernel) for rows
//   whose width is a whole number of 16-byte chunks (8 bf16 or 4 fp32
//   columns), at most kWarpRowColumns wide, with every pointer 16-byte
//   aligned: the widths BERT uses (768, 1024). One warp a row, the row in
//   registers, shuffle reductions: norm_warp_row in norm_rows.cuh, which
//   the add+LayerNorm forward (fused_dropout_norm.cu) shares. x is read
//   from device memory once and never again from L1.
// - the block path (layer_norm_fwd_kernel, rms_norm_fwd_kernel) for every
//   other row: one thread block a row, each thread taking 16 bytes of the
//   row a step (4 fp32 or 8 bf16 values, one vector load) when the width
//   and the pointers allow, else 4 elements one by one; warp shuffles plus
//   a 32-float shared scratch for the block sums. The row is read from
//   device memory once; the later passes hit L1. Past kWarpRowColumns
//   (row_threads gives each thread one 16-byte chunk up to 8192 bf16 or
//   4096 fp32 columns) a register row spread over several warps would save
//   only those L1 re-reads.
//
// Null weight/bias mean no affine; null statistics mean the caller does not
// want them (serving).
#include <cstdint>

#include "block_reduce.cuh"
#include "dtype.cuh"
#include "norm_rows.cuh"

namespace {

template <typename T, bool kVec>
__global__ void layer_norm_fwd_kernel(const T* __restrict__ x,
                                      const T* __restrict__ w,
                                      const T* __restrict__ b,
                                      T* __restrict__ y,
                                      float* __restrict__ mean_out,
                                      float* __restrict__ rstd_out,
                                      int64_t d, float eps) {
    using IO = RowIO<T, kVec>;
    constexpr int G = IO::G;
    __shared__ float scratch[32];
    const int64_t row = blockIdx.x;
    const T* xr = x + row * d;
    T* yr = y + row * d;
    const int64_t first = G * static_cast<int64_t>(threadIdx.x);
    const int64_t step = G * static_cast<int64_t>(blockDim.x);

    float s = 0.f;
    for (int64_t c0 = first; c0 < d; c0 += step) {
        float v[G];
        IO::load(xr, c0, d, v);
#pragma unroll
        for (int e = 0; e < G; ++e) s += v[e];     // 0 past d
    }
    const float mean = block_sum(s, scratch) / static_cast<float>(d);

    float ss = 0.f;
    for (int64_t c0 = first; c0 < d; c0 += step) {
        float v[G];
        IO::load(xr, c0, d, v);
#pragma unroll
        for (int e = 0; e < G; ++e) {
            const float c = IO::in(c0, e, d) ? v[e] - mean : 0.f;
            ss += c * c;
        }
    }
    const float var = block_sum(ss, scratch) / static_cast<float>(d);
    const float rstd = rsqrtf(var + eps);

    for (int64_t c0 = first; c0 < d; c0 += step) {
        float v[G], wv[G], bv[G];
        IO::load(xr, c0, d, v);
        if (w != nullptr) IO::load(w, c0, d, wv);
        if (b != nullptr) IO::load(b, c0, d, bv);
#pragma unroll
        for (int e = 0; e < G; ++e) {
            float o = (v[e] - mean) * rstd;
            if (w != nullptr) o *= wv[e];
            if (b != nullptr) o += bv[e];
            v[e] = o;
        }
        IO::store(yr, c0, d, v);
    }
    if (threadIdx.x == 0) {
        if (mean_out != nullptr) mean_out[row] = mean;
        if (rstd_out != nullptr) rstd_out[row] = rstd;
    }
}

template <typename T, bool kVec>
__global__ void rms_norm_fwd_kernel(const T* __restrict__ x,
                                    const T* __restrict__ w,
                                    T* __restrict__ y,
                                    float* __restrict__ rstd_out, int64_t d,
                                    float eps) {
    using IO = RowIO<T, kVec>;
    constexpr int G = IO::G;
    __shared__ float scratch[32];
    const int64_t row = blockIdx.x;
    const T* xr = x + row * d;
    T* yr = y + row * d;
    const int64_t first = G * static_cast<int64_t>(threadIdx.x);
    const int64_t step = G * static_cast<int64_t>(blockDim.x);

    float ss = 0.f;
    for (int64_t c0 = first; c0 < d; c0 += step) {
        float v[G];
        IO::load(xr, c0, d, v);
#pragma unroll
        for (int e = 0; e < G; ++e) ss += v[e] * v[e];   // 0 past d
    }
    const float ms = block_sum(ss, scratch) / static_cast<float>(d);
    const float rstd = rsqrtf(ms + eps);

    for (int64_t c0 = first; c0 < d; c0 += step) {
        float v[G], wv[G];
        IO::load(xr, c0, d, v);
        if (w != nullptr) IO::load(w, c0, d, wv);
#pragma unroll
        for (int e = 0; e < G; ++e) {
            float o = v[e] * rstd;
            if (w != nullptr) o *= wv[e];
            v[e] = o;
        }
        IO::store(yr, c0, d, v);
    }
    if (threadIdx.x == 0 && rstd_out != nullptr) rstd_out[row] = rstd;
}

// LayerNorm of a row a warp, K 16-byte chunks a lane (norm_rows.cuh). w,
// b, mean_out and rstd_out may be null.
template <typename T, int K>
__global__ void __launch_bounds__(32 * kRowWarps,
                                  (warp_row_min_blocks<K, false>()))
ln_rows_warp_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ b, T* __restrict__ y,
                    float* __restrict__ mean_out,
                    float* __restrict__ rstd_out, int64_t n, int64_t d,
                    float eps) {
    norm_warp_row<T, K, false, false, true>(x, nullptr, w, b, y, nullptr,
                                            mean_out, rstd_out, n, d, eps,
                                            DropoutKeys{});
}

// RMSNorm of a row a warp. w and rstd_out may be null.
template <typename T, int K>
__global__ void __launch_bounds__(32 * kRowWarps,
                                  (warp_row_min_blocks<K, false>()))
rms_rows_warp_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, float* __restrict__ rstd_out,
                     int64_t n, int64_t d, float eps) {
    norm_warp_row<T, K, false, false, false>(x, nullptr, w, nullptr, y,
                                             nullptr, nullptr, rstd_out, n,
                                             d, eps, DropoutKeys{});
}

template <typename T, bool kVec>
int launch_ln(const void* x, const void* w, const void* b, void* y,
              void* mean, void* rstd, int64_t n, int64_t d, float eps,
              cudaStream_t st) {
    layer_norm_fwd_kernel<T, kVec>
        <<<static_cast<unsigned>(n), row_threads(d, RowIO<T, kVec>::G), 0,
           st>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                 static_cast<const T*>(b), static_cast<T*>(y),
                 static_cast<float*>(mean), static_cast<float*>(rstd), d,
                 eps);
    return static_cast<int>(cudaGetLastError());
}

// The route: the register path where the width is a whole number of
// 16-byte chunks, at most kWarpRowColumns, and every pointer is 16-byte
// aligned; else the block path, with 16-byte accesses where the width and
// pointers allow them.
template <typename T>
int dispatch_ln(const void* x, const void* w, const void* b, void* y,
                void* mean, void* rstd, int64_t n, int64_t d, float eps,
                cudaStream_t st) {
    if (!rows_vectorise<T>(d, {x, w, b, y}))
        return launch_ln<T, false>(x, w, b, y, mean, rstd, n, d, eps, st);
    if (d > kWarpRowColumns)
        return launch_ln<T, true>(x, w, b, y, mean, rstd, n, d, eps, st);
    return dispatch_row_chunks<T>(row_chunks<T>(d), [&](auto chunks) {
        ln_rows_warp_kernel<T, decltype(chunks)::value>
            <<<warp_row_blocks(n), 32 * kRowWarps, 0, st>>>(
                static_cast<const T*>(x), static_cast<const T*>(w),
                static_cast<const T*>(b), static_cast<T*>(y),
                static_cast<float*>(mean), static_cast<float*>(rstd), n, d,
                eps);
        return static_cast<int>(cudaGetLastError());
    });
}

template <typename T, bool kVec>
int launch_rms(const void* x, const void* w, void* y, void* rstd, int64_t n,
               int64_t d, float eps, cudaStream_t st) {
    rms_norm_fwd_kernel<T, kVec>
        <<<static_cast<unsigned>(n), row_threads(d, RowIO<T, kVec>::G), 0,
           st>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                 static_cast<T*>(y), static_cast<float*>(rstd), d, eps);
    return static_cast<int>(cudaGetLastError());
}

// The route, as dispatch_ln's
template <typename T>
int dispatch_rms(const void* x, const void* w, void* y, void* rstd,
                 int64_t n, int64_t d, float eps, cudaStream_t st) {
    if (!rows_vectorise<T>(d, {x, w, y}))
        return launch_rms<T, false>(x, w, y, rstd, n, d, eps, st);
    if (d > kWarpRowColumns)
        return launch_rms<T, true>(x, w, y, rstd, n, d, eps, st);
    return dispatch_row_chunks<T>(row_chunks<T>(d), [&](auto chunks) {
        rms_rows_warp_kernel<T, decltype(chunks)::value>
            <<<warp_row_blocks(n), 32 * kRowWarps, 0, st>>>(
                static_cast<const T*>(x), static_cast<const T*>(w),
                static_cast<T*>(y), static_cast<float*>(rstd), n, d, eps);
        return static_cast<int>(cudaGetLastError());
    });
}

}  // namespace

// x, y: (n, d) contiguous, fp32 (dtype kF32), bf16 (kBF16) or fp16 (kF16). w,
// b: (d,) in the same dtype, or null. mean, rstd: (n,) fp32 or null. Returns
// cudaGetLastError() after the launch.
extern "C" int ptt_layer_norm_fwd(const void* x, const void* w, const void* b,
                                  void* y, void* mean, void* rstd, int64_t n,
                                  int64_t d, float eps, int dtype,
                                  void* stream) {
    if (n <= 0 || n > 0x7fffffff || d <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto st = static_cast<cudaStream_t>(stream);
    if (dtype == kF32)
        return dispatch_ln<float>(x, w, b, y, mean, rstd, n, d, eps, st);
    if (dtype == kBF16)
        return dispatch_ln<__nv_bfloat16>(x, w, b, y, mean, rstd, n, d, eps,
                                          st);
    if (dtype == kF16)
        return dispatch_ln<__half>(x, w, b, y, mean, rstd, n, d, eps, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// x, y: (n, d) contiguous fp32, bf16 or fp16 (dtype). w: (d,) in the same
// dtype, or null. rstd: (n,) fp32, or null when the caller does not want it.
// Returns cudaGetLastError() after the launch.
extern "C" int ptt_rms_norm_fwd(const void* x, const void* w, void* y,
                                void* rstd, int64_t n, int64_t d, float eps,
                                int dtype, void* stream) {
    if (n <= 0 || n > 0x7fffffff || d <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto st = static_cast<cudaStream_t>(stream);
    if (dtype == kF32)
        return dispatch_rms<float>(x, w, y, rstd, n, d, eps, st);
    if (dtype == kBF16)
        return dispatch_rms<__nv_bfloat16>(x, w, y, rstd, n, d, eps, st);
    if (dtype == kF16)
        return dispatch_rms<__half>(x, w, y, rstd, n, d, eps, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
