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
// bytes an element in bf16, 8 in fp32. At the sizes training gives them
// (16-100 MB moved) a device-to-device copy of as many bytes takes about
// as long as either kernel, well above the byte bound: chip_smoke.py times
// one beside each (copy_ms).
//
// Design. The add+LayerNorm forward has two routes, chosen in C from the
// width, the dtype and the pointers (dispatch_add_ln), never by the
// caller:
//
// - the register path (add_layer_norm_warp_kernel), for rows whose width
//   is a multiple of 16 bytes' worth of columns (G = 8 bf16, 4 fp32), at
//   most kWarpRowColumns wide, with every pointer 16-byte aligned: the
//   widths BERT uses (768, 1024). One warp a row, the row and the residual
//   in registers, the keep bits drawn while the loads are in flight,
//   shuffle reductions: norm_warp_row in norm_rows.cuh, which the
//   LayerNorm and RMSNorm forwards (fused_norm.cu) share. 5-6 blocks of
//   four warps an SM (warp_row_min_blocks): at 8, ptxas spills the bf16
//   row of 1024 columns.
// - the block path (add_layer_norm_fwd_kernel and, with dropout,
//   dropout_add_layer_norm_fwd_kernel) for every other width: one thread
//   block a row, each thread taking 16 bytes a step (4 fp32 or 8 bf16
//   columns) when the width and pointers allow, else 4 columns one by one.
//   Without dropout the sum is formed again in each of the three passes
//   (mean, centred variance, output) instead of stored, so serving writes
//   one (N, D) array. With dropout the fp32 sum is parked once, so the
//   generator runs once an element: in yin itself at fp32, in dynamic
//   shared memory (4 bytes a column) at bf16, where yin holds only the
//   rounded sum.
//
// The mask gradient is flat over N * D. Where g and out are 16-byte
// aligned (dropout_grad_vec_kernel) a thread loads kGradPacks 16-byte packs
// (G elements each) before its first Philox call, so that the ten rounds
// overlap the loads' latency; the grid is one wave (the SM count times the
// blocks an SM holds at ptxas's register count) that strides over the
// tensor; the n % G elements past the last pack go one a thread in the
// same kernel. Otherwise (dropout_grad_kernel) a thread takes four
// elements one by one. The register path and the vector mask gradient
// take the Philox key schedule computed on the host (DropoutKeys).
#include <cstdint>
#include <type_traits>

#include "block_reduce.cuh"
#include "dtype.cuh"
#include "norm_rows.cuh"
#include "philox.cuh"

namespace {

// y = LayerNorm(res + dropout(x)), a row a warp, K 16-byte chunks a lane
// (norm_rows.cuh). kDrop: dropout on (drop used), else drop is ignored.
// yin, mean_out and rstd_out may be null.
template <typename T, int K, bool kDrop>
__global__ void __launch_bounds__(32 * kRowWarps,
                                  (warp_row_min_blocks<K, true>()))
add_layer_norm_warp_kernel(const T* __restrict__ x, const T* __restrict__ res,
                           const T* __restrict__ w, const T* __restrict__ b,
                           T* __restrict__ y, T* __restrict__ yin,
                           float* __restrict__ mean_out,
                           float* __restrict__ rstd_out, int64_t n,
                           int64_t d, float eps, DropoutKeys drop) {
    norm_warp_row<T, K, true, kDrop, true>(x, res, w, b, y, yin, mean_out,
                                           rstd_out, n, d, eps, drop);
}

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
// 16-byte packs a thread of dropout_grad_vec_kernel loads before its first
// Philox call
constexpr int kGradPacks = 2;

// out[i] = g[i] * keep(i) / (1 - p) over n elements, g and out 16-byte
// aligned. Pack p holds elements G p .. G p + G - 1, which take G / 4
// Philox calls (groups G / 4 p ..). A block's tile is kGradPacks *
// kGradThreads packs, thread t taking packs t, t + kGradThreads, ... of it,
// so that each warp-wide access reads 512 contiguous bytes; the grid
// strides over the tiles. Block 0 then takes the n % G elements past the
// last pack, one a thread. The product is fp32, rounded once to T.
template <typename T>
__global__ void __launch_bounds__(kGradThreads)
dropout_grad_vec_kernel(const T* __restrict__ g, T* __restrict__ out,
                        int64_t n, DropoutKeys drop) {
    constexpr int G = 16 / static_cast<int>(sizeof(T));
    using P = Pack<T, G>;
    const int64_t packs = n / G;
    constexpr int64_t kTile = static_cast<int64_t>(kGradPacks) * kGradThreads;
    for (int64_t t0 = blockIdx.x * kTile; t0 < packs;
         t0 += static_cast<int64_t>(gridDim.x) * kTile) {
        P v[kGradPacks];
#pragma unroll
        for (int q = 0; q < kGradPacks; ++q) {
            const int64_t pk = t0 + q * kGradThreads + threadIdx.x;
            if (pk < packs) v[q] = reinterpret_cast<const P*>(g)[pk];
        }
#pragma unroll
        for (int q = 0; q < kGradPacks; ++q) {
            const int64_t pk = t0 + q * kGradThreads + threadIdx.x;
            if (pk >= packs) continue;
            P o;
#pragma unroll
            for (int j = 0; j < G / 4; ++j) {
                const PhiloxWords r = philox4x32_10(
                    drop.keys, drop.offset,
                    static_cast<uint64_t>(pk) * (G / 4) + j);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float ks =
                        r.w[e] >= drop.threshold ? drop.scale : 0.f;
                    o.v[4 * j + e] = from_f32<T>(to_f32(v[q].v[4 * j + e]) *
                                                 ks);
                }
            }
            reinterpret_cast<P*>(out)[pk] = o;
        }
    }
    const int64_t i = packs * G + threadIdx.x;
    if (blockIdx.x == 0 && i < n) {
        const PhiloxWords r = philox4x32_10(drop.keys, drop.offset,
                                            static_cast<uint64_t>(i) >> 2);
        const float ks =
            philox_word(r, static_cast<uint32_t>(i) & 3u) >= drop.threshold
                ? drop.scale : 0.f;
        out[i] = from_f32<T>(to_f32(g[i]) * ks);
    }
}

// The same product where g or out is not 16-byte aligned: thread t owns
// elements 4t .. 4t + 3, which share one Philox call, read and written one
// by one.
template <typename T>
__global__ void __launch_bounds__(kGradThreads)
dropout_grad_kernel(const T* __restrict__ g, T* __restrict__ out, int64_t n,
                    DropoutArgs drop) {
    const int64_t group =
        static_cast<int64_t>(blockIdx.x) * kGradThreads + threadIdx.x;
    const int64_t i0 = 4 * group;
    if (i0 >= n) return;
    const PhiloxWords r = philox4x32_10(drop.seed, drop.offset,
                                        static_cast<uint64_t>(group));
#pragma unroll
    for (int e = 0; e < 4; ++e)
        if (i0 + e < n) {
            const float ks = r.w[e] >= drop.threshold ? drop.scale : 0.f;
            out[i0 + e] = from_f32<T>(to_f32(g[i0 + e]) * ks);
        }
}

// The blocks of `kernel` (`threads` threads, no dynamic shared memory)
// that the current device holds at once -> *blocks: its SM count times the
// blocks an SM takes at the kernel's register count, cached by device in
// `cache` (0: not asked yet).
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t one_wave(Kernel kernel, int threads, int (&cache)[kMaxDevices],
                     int* blocks) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices && cache[dev] > 0) {
        *blocks = cache[dev];
        return cudaSuccess;
    }
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, 0);
    if (e != cudaSuccess) return e;
    *blocks = sms * per_sm > 0 ? sms * per_sm : 1;
    if (dev < kMaxDevices) cache[dev] = *blocks;
    return cudaSuccess;
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

// the register path at K chunks a lane (norm_rows.cuh)
template <typename T>
int launch_warp_rows(const void* x, const void* res, const void* w,
                     const void* b, void* y, void* yin, void* mean,
                     void* rstd, int64_t n, int64_t d, float eps,
                     const DropoutArgs& drop, cudaStream_t st) {
    const unsigned grid = warp_row_blocks(n);
    const auto xp = static_cast<const T*>(x);
    const auto rp = static_cast<const T*>(res);
    const auto wp = static_cast<const T*>(w);
    const auto bp = static_cast<const T*>(b);
    const auto yp = static_cast<T*>(y);
    const auto sp = static_cast<T*>(yin);
    const auto mp = static_cast<float*>(mean);
    const auto rsp = static_cast<float*>(rstd);
    return dispatch_row_chunks<T>(row_chunks<T>(d), [&](auto chunks) {
        constexpr int K = decltype(chunks)::value;
        if (drop.scale != 1.f)
            add_layer_norm_warp_kernel<T, K, true>
                <<<grid, 32 * kRowWarps, 0, st>>>(xp, rp, wp, bp, yp, sp, mp,
                                                  rsp, n, d, eps,
                                                  dropout_keys(drop));
        else
            add_layer_norm_warp_kernel<T, K, false>
                <<<grid, 32 * kRowWarps, 0, st>>>(xp, rp, wp, bp, yp, sp, mp,
                                                  rsp, n, d, eps,
                                                  DropoutKeys{});
        return static_cast<int>(cudaGetLastError());
    });
}

// The route: the register path where the width is a whole number of
// 16-byte chunks, at most kWarpRowColumns, and every pointer is 16-byte
// aligned; else the block path, with 16-byte accesses where the width and
// pointers allow them.
template <typename T>
int dispatch_add_ln(const void* x, const void* res, const void* w,
                    const void* b, void* y, void* yin, void* mean,
                    void* rstd, int64_t n, int64_t d, float eps,
                    const DropoutArgs& drop, cudaStream_t st) {
    if (!rows_vectorise<T>(d, {x, res, w, b, y, yin}))
        return launch_add_ln<T, false>(x, res, w, b, y, yin, mean, rstd, n,
                                       d, eps, drop, st);
    if (d <= kWarpRowColumns)
        return launch_warp_rows<T>(x, res, w, b, y, yin, mean, rstd, n, d,
                                   eps, drop, st);
    return launch_add_ln<T, true>(x, res, w, b, y, yin, mean, rstd, n, d,
                                  eps, drop, st);
}

template <typename T>
int launch_grad(const void* g, void* out, int64_t n, const DropoutArgs& drop,
                cudaStream_t st) {
    const auto gp = static_cast<const T*>(g);
    const auto op = static_cast<T*>(out);
    if (reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(out) % 16 == 0) {
        constexpr int64_t G = 16 / static_cast<int64_t>(sizeof(T));
        constexpr int64_t kTile = static_cast<int64_t>(kGradPacks) *
                                  kGradThreads;
        static int wave[kMaxDevices] = {};
        int blocks = 0;
        const cudaError_t e = one_wave(dropout_grad_vec_kernel<T>,
                                       kGradThreads, wave, &blocks);
        if (e != cudaSuccess) return static_cast<int>(e);
        const int64_t tiles = (n / G + kTile - 1) / kTile;
        const auto grid = static_cast<unsigned>(
            tiles < 1 ? 1 : (tiles < blocks ? tiles : blocks));
        dropout_grad_vec_kernel<T><<<grid, kGradThreads, 0, st>>>(
            gp, op, n, dropout_keys(drop));
    } else {
        const int64_t groups = (n + 3) / 4;
        const auto grid =
            static_cast<unsigned>((groups + kGradThreads - 1) / kGradThreads);
        dropout_grad_kernel<T><<<grid, kGradThreads, 0, st>>>(gp, op, n,
                                                              drop);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, res, y, yin: (n, d) contiguous, fp32 (dtype kF32) or bf16 (kBF16). w,
// b: (d,) in the same dtype, or null. mean, rstd: (n,) fp32 or null.
// Dropout is on iff drop_scale != 1; yin must then be given (at bf16 on
// the block path, d is at most 58080: the row's fp32 sum sits in shared
// memory), otherwise it is null unless wanted. Returns cudaGetLastError()
// after the launch.
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
