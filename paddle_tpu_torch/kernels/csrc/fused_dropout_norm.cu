// Dropout + residual add + LayerNorm forward over the last axis, and the
// dropout-mask gradient, fp32 or bf16:
//   yin = residual + x * keep / (1 - p),  y = LayerNorm(yin)
//   dx  = d_yin * keep / (1 - p)          (the same mask, regenerated)
//
// Replaces: paddle_tpu/kernels/fused_dropout_norm.py, _fwd_kernel (launched
// by _fused_fwd) and _dmask_kernel (launched by _apply_dropout_grad). The
// mask comes from philox.cuh, keyed on (seed, offset, row * d + column), so
// it is never stored and does not depend on the dtype: the forward saves
// (seed, offset) and the gradient kernel rebuilds the bits. As in the
// reference, the sum is formed in fp32 and the statistics come from that
// fp32 sum; y and yin are stored in the input dtype, mean and rstd in
// fp32. The backward (torch ops) forms xhat from the stored yin, so at
// bf16 it sees the rounded sum, as the reference's _fdln_bwd does.
//
// Bound on the H100: bytes, both kernels. The forward reads x and residual
// once and writes y (and yin, mean, rstd in training): 6-8 bytes an
// element in bf16, 12-16 in fp32, against ~9 flops plus a quarter of a
// Philox call (~25 integer operations); the gradient reads and writes 4
// bytes an element in bf16, 8 in fp32.
//
// Design: one thread block per row as in fused_norm.cu, each thread taking
// 16 bytes a step (4 fp32 or 8 bf16 columns) when the width and pointers
// allow, else 4 columns one by one. Without dropout the sum is formed again
// in each of the three passes (mean, centred variance, output) instead of
// stored, so serving writes one (N, D) array. With dropout one Philox call
// (four words) serves four neighbouring columns; the fp32 sum is parked
// once, so the generator runs once an element: in yin itself at fp32, in
// dynamic shared memory (4 bytes a column) at bf16, where yin holds only
// the rounded sum. The gradient kernel is flat over N * D: one thread, one
// Philox call, four elements, one vector access when the pointers allow.
#include <cstdint>
#include <type_traits>

#include "block_reduce.cuh"
#include "dtype.cuh"
#include "philox.cuh"

namespace {

template <typename T, bool kVec>
__global__ void add_layer_norm_fwd_kernel(const T* __restrict__ x,
                                          const T* __restrict__ res,
                                          const T* __restrict__ w,
                                          const T* __restrict__ b,
                                          T* __restrict__ y,
                                          T* __restrict__ yin,
                                          float* __restrict__ mean_out,
                                          float* __restrict__ rstd_out,
                                          int64_t d, float eps) {
    using IO = RowIO<T, kVec>;
    constexpr int G = IO::G;
    __shared__ float scratch[32];
    const int64_t row = blockIdx.x;
    const T* xr = x + row * d;
    const T* rr = res + row * d;
    const int64_t first = G * static_cast<int64_t>(threadIdx.x);
    const int64_t step = G * static_cast<int64_t>(blockDim.x);

    float s = 0.f;
    for (int64_t c0 = first; c0 < d; c0 += step) {
        float xv[G], rv[G];
        IO::load(xr, c0, d, xv);
        IO::load(rr, c0, d, rv);
#pragma unroll
        for (int e = 0; e < G; ++e) {
            xv[e] += rv[e];
            s += xv[e];                 // 0 past d
        }
        if (yin != nullptr) IO::store(yin + row * d, c0, d, xv);
    }
    const float mean = block_sum(s, scratch) / static_cast<float>(d);

    float ss = 0.f;
    for (int64_t c0 = first; c0 < d; c0 += step) {
        float xv[G], rv[G];
        IO::load(xr, c0, d, xv);
        IO::load(rr, c0, d, rv);
#pragma unroll
        for (int e = 0; e < G; ++e) {
            const float c = IO::in(c0, e, d) ? rv[e] + xv[e] - mean : 0.f;
            ss += c * c;
        }
    }
    const float var = block_sum(ss, scratch) / static_cast<float>(d);
    const float rstd = rsqrtf(var + eps);

    for (int64_t c0 = first; c0 < d; c0 += step) {
        float xv[G], rv[G], wv[G], bv[G];
        IO::load(xr, c0, d, xv);
        IO::load(rr, c0, d, rv);
        if (w != nullptr) IO::load(w, c0, d, wv);
        if (b != nullptr) IO::load(b, c0, d, bv);
#pragma unroll
        for (int e = 0; e < G; ++e) {
            float o = (rv[e] + xv[e] - mean) * rstd;
            if (w != nullptr) o *= wv[e];
            if (b != nullptr) o += bv[e];
            xv[e] = o;
        }
        IO::store(y + row * d, c0, d, xv);
    }
    if (threadIdx.x == 0) {
        if (mean_out != nullptr) mean_out[row] = mean;
        if (rstd_out != nullptr) rstd_out[row] = rstd;
    }
}

// The dropout branch. yin is always written (the caller allocates it). The
// fp32 sum is parked where the second and third pass read it back: yin at
// fp32, `park_smem` (d floats of dynamic shared memory, 16-byte aligned)
// at bf16, each read and written like the row itself (RowIO);
// block_sum's barriers order those reads after every thread's writes.
template <typename T, bool kVec>
__global__ void dropout_add_layer_norm_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ res,
    const T* __restrict__ w, const T* __restrict__ b, T* __restrict__ y,
    T* yin, float* __restrict__ mean_out, float* __restrict__ rstd_out,
    int64_t d, float eps, DropoutArgs drop) {
    using IO = RowIO<T, kVec>;
    constexpr int G = IO::G;
    constexpr bool kParkInYin = std::is_same<T, float>::value;
    extern __shared__ float4 park_smem[];   // float4: 16-byte aligned
    __shared__ float scratch[32];
    const int64_t row = blockIdx.x;
    const T* xr = x + row * d;
    const T* rr = res + row * d;
    T* sum_out = yin + row * d;
    float* park = kParkInYin ? reinterpret_cast<float*>(sum_out)
                             : reinterpret_cast<float*>(park_smem);
    const int64_t first = G * static_cast<int64_t>(threadIdx.x);
    const int64_t step = G * static_cast<int64_t>(blockDim.x);

    float s = 0.f;
    for (int64_t c0 = first; c0 < d; c0 += step) {
        float xv[G], rv[G];
        IO::load(xr, c0, d, xv);
        IO::load(rr, c0, d, rv);
        PhiloxWords r;
#pragma unroll
        for (int e = 0; e < G; ++e) {
            if (!IO::in(c0, e, d)) break;
            const uint64_t idx = static_cast<uint64_t>(row * d + c0 + e);
            // a new group of four starts here (at e == 0, and again inside
            // the step wherever the linear index is a multiple of 4)
            if (e == 0 || (idx & 3) == 0)
                r = philox4x32_10(drop.seed, drop.offset, idx >> 2);
            const float ks =
                philox_word(r, static_cast<uint32_t>(idx) & 3u) >=
                        drop.threshold ? drop.scale : 0.f;
            xv[e] = rv[e] + xv[e] * ks;
            s += xv[e];
        }
        IO::store(park, c0, d, xv);
        if constexpr (!kParkInYin) IO::store(sum_out, c0, d, xv);
    }
    const float mean = block_sum(s, scratch) / static_cast<float>(d);

    float ss = 0.f;
    for (int64_t c0 = first; c0 < d; c0 += step) {
        float v[G];
        IO::load(park, c0, d, v);
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
        IO::load(park, c0, d, v);
        if (w != nullptr) IO::load(w, c0, d, wv);
        if (b != nullptr) IO::load(b, c0, d, bv);
#pragma unroll
        for (int e = 0; e < G; ++e) {
            float o = (v[e] - mean) * rstd;
            if (w != nullptr) o *= wv[e];
            if (b != nullptr) o += bv[e];
            v[e] = o;
        }
        IO::store(y + row * d, c0, d, v);
    }
    if (threadIdx.x == 0) {
        if (mean_out != nullptr) mean_out[row] = mean;
        if (rstd_out != nullptr) rstd_out[row] = rstd;
    }
}

constexpr int kGradThreads = 256;

// out[i] = g[i] * keep(i) / (1 - p) over n elements; thread t owns elements
// 4t .. 4t + 3, which share one Philox call. The product is fp32, rounded
// once to T on the store.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kGradThreads)
dropout_grad_kernel(const T* __restrict__ g, T* __restrict__ out, int64_t n,
                    DropoutArgs drop) {
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
        const Pack<T, 4> v = reinterpret_cast<const Pack<T, 4>*>(g)[group];
        Pack<T, 4> o;
#pragma unroll
        for (int e = 0; e < 4; ++e)
            o.v[e] = from_f32<T>(to_f32(v.v[e]) * ks[e]);
        reinterpret_cast<Pack<T, 4>*>(out)[group] = o;
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (i0 + e < n)
                out[i0 + e] = from_f32<T>(to_f32(g[i0 + e]) * ks[e]);
    }
}

// shared memory a bf16 dropout row parks its fp32 sum in; above 48 KB a
// block's shared memory must be opted into, which the first launch at each
// width does (idempotent, so a race between two first callers is harmless)
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes, size_t* allowed) {
    if (bytes <= 48 * 1024 || bytes <= *allowed) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e == cudaSuccess) *allowed = bytes;
    return e;
}

template <typename T, bool kVec>
int launch_add_ln(const void* x, const void* res, const void* w,
                  const void* b, void* y, void* yin, void* mean, void* rstd,
                  int64_t n, int64_t d, float eps, const DropoutArgs& drop,
                  cudaStream_t st) {
    const auto grid = static_cast<unsigned>(n);
    const int threads = row_threads(d, RowIO<T, kVec>::G);
    const auto xp = static_cast<const T*>(x);
    const auto rp = static_cast<const T*>(res);
    const auto wp = static_cast<const T*>(w);
    const auto bp = static_cast<const T*>(b);
    const auto yp = static_cast<T*>(y);
    const auto sp = static_cast<T*>(yin);
    const auto mp = static_cast<float*>(mean);
    const auto rsp = static_cast<float*>(rstd);
    if (drop.scale != 1.f) {
        if (yin == nullptr) return static_cast<int>(cudaErrorInvalidValue);
        const size_t park =
            std::is_same<T, float>::value ? 0 : sizeof(float) * d;
        static size_t allowed = 0;
        const cudaError_t e = allow_shared(
            dropout_add_layer_norm_fwd_kernel<T, kVec>, park, &allowed);
        if (e != cudaSuccess) return static_cast<int>(e);
        dropout_add_layer_norm_fwd_kernel<T, kVec>
            <<<grid, threads, park, st>>>(xp, rp, wp, bp, yp, sp, mp, rsp, d,
                                          eps, drop);
    } else {
        add_layer_norm_fwd_kernel<T, kVec><<<grid, threads, 0, st>>>(
            xp, rp, wp, bp, yp, sp, mp, rsp, d, eps);
    }
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_add_ln(const void* x, const void* res, const void* w,
                    const void* b, void* y, void* yin, void* mean,
                    void* rstd, int64_t n, int64_t d, float eps,
                    const DropoutArgs& drop, cudaStream_t st) {
    return rows_vectorise<T>(d, {x, res, w, b, y, yin})
               ? launch_add_ln<T, true>(x, res, w, b, y, yin, mean, rstd, n,
                                        d, eps, drop, st)
               : launch_add_ln<T, false>(x, res, w, b, y, yin, mean, rstd, n,
                                         d, eps, drop, st);
}

template <typename T>
int launch_grad(const void* g, void* out, int64_t n, const DropoutArgs& drop,
                cudaStream_t st) {
    const int64_t groups = (n + 3) / 4;
    const auto grid =
        static_cast<unsigned>((groups + kGradThreads - 1) / kGradThreads);
    const size_t align = 4 * sizeof(T);
    const bool vec = reinterpret_cast<uintptr_t>(g) % align == 0 &&
                     reinterpret_cast<uintptr_t>(out) % align == 0;
    const auto gp = static_cast<const T*>(g);
    const auto op = static_cast<T*>(out);
    if (vec)
        dropout_grad_kernel<T, true><<<grid, kGradThreads, 0, st>>>(gp, op, n,
                                                                    drop);
    else
        dropout_grad_kernel<T, false><<<grid, kGradThreads, 0, st>>>(gp, op, n,
                                                                     drop);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, res, y, yin: (n, d) contiguous, fp32 (dtype kF32) or bf16 (kBF16). w,
// b: (d,) in the same dtype, or null. mean, rstd: (n,) fp32 or null.
// Dropout is on iff drop_scale != 1; yin must then be given (at bf16, d is
// at most 58080: the row's fp32 sum sits in shared memory), otherwise it is
// null unless wanted. Returns cudaGetLastError() after the launch.
extern "C" int ptt_add_layer_norm_fwd(const void* x, const void* res,
                                      const void* w, const void* b, void* y,
                                      void* yin, void* mean, void* rstd,
                                      int64_t n, int64_t d, float eps,
                                      uint64_t seed, uint64_t offset,
                                      uint32_t threshold, float drop_scale,
                                      int dtype, void* stream) {
    if (n <= 0 || n > 0x7fffffff || d <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto st = static_cast<cudaStream_t>(stream);
    const DropoutArgs drop{seed, offset, threshold, drop_scale};
    if (dtype == kF32)
        return dispatch_add_ln<float>(x, res, w, b, y, yin, mean, rstd, n, d,
                                      eps, drop, st);
    if (dtype == kBF16)
        return dispatch_add_ln<__nv_bfloat16>(x, res, w, b, y, yin, mean,
                                              rstd, n, d, eps, drop, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// g, out: n contiguous fp32 or bf16 (dtype) elements (the flattened (N, D)
// gradient). Returns cudaGetLastError() after the launch.
extern "C" int ptt_dropout_grad(const void* g, void* out, int64_t n,
                                uint64_t seed, uint64_t offset,
                                uint32_t threshold, float drop_scale,
                                int dtype, void* stream) {
    const int64_t groups = (n + 3) / 4;
    const int64_t blocks = (groups + kGradThreads - 1) / kGradThreads;
    if (n <= 0 || blocks > 0x7fffffff)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto st = static_cast<cudaStream_t>(stream);
    const DropoutArgs drop{seed, offset, threshold, drop_scale};
    if (dtype == kF32) return launch_grad<float>(g, out, n, drop, st);
    if (dtype == kBF16) return launch_grad<__nv_bfloat16>(g, out, n, drop, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
