// The register path of the three row normalisations: one warp a row, the
// row in registers. add_layer_norm_warp_kernel (fused_dropout_norm.cu),
// ln_rows_warp_kernel and rms_rows_warp_kernel (fused_norm.cu) each call
// norm_warp_row, which is templated over what the row reads besides x (the
// residual, the dropout keep bits) and over what it takes from the row
// (the mean and the centred variance for LayerNorm, the mean square for
// RMSNorm).
//
// The path takes rows whose width is a multiple of 16 bytes' worth of
// columns (G = 8 bf16, 4 fp32), at most kWarpRowColumns wide, with every
// pointer 16-byte aligned (each kernel's dispatch checks; rows_vectorise in
// dtype.cuh). Four rows a block, a warp each. A lane holds K 16-byte chunks
// of x (and of the residual), K = 1..4 at bf16, 1..8 at fp32, a
// compile-time count, at columns (k * 32 + lane) * G, so each warp-wide
// access reads 512 contiguous bytes; all of a row's loads go out in one
// burst before the first arithmetic. With dropout the lane's keep bits
// (K * G <= 32, one word) come next, while the loads are in flight: one
// Philox call (four words) serves four neighbouring columns, and a chunk
// starts at a multiple of G, so no group of four straddles two chunks. The
// row's fp32 values stay in registers (v[K][G]); each reduction is the
// lane's own sum, chunk by chunk and column by column, then an xor-shuffle
// tree (warp_sum): no shared memory, no barrier, and every input is read
// once. LayerNorm takes the mean, then the centred variance from the same
// registers (two passes, as the reference does); RMSNorm the mean square.
// yin (the sum, add+LayerNorm only) is stored right after it is formed, y
// in one pass that reads w and b a chunk at a time (they stay in L2 across
// rows).
#pragma once

#include <cstdint>
#include <type_traits>

#include "block_reduce.cuh"
#include "dtype.cuh"
#include "philox.cuh"

// rows (warps) a block, and the widest row the register path takes
constexpr int kRowWarps = 4;
constexpr int kWarpRowColumns = 1024;

// 16-byte chunks of a row a lane holds, at most: 4 bf16, 8 fp32
template <typename T>
constexpr int max_row_chunks() {
    return kWarpRowColumns / (32 * (16 / static_cast<int>(sizeof(T))));
}

// Blocks of 32 * kRowWarps threads an SM should hold (__launch_bounds__'s
// minimum) at K chunks a lane. With a residual: 6 (at most 80 registers a
// thread) while a lane's raw chunks of x and the residual fit in 32
// registers (bf16, and fp32 up to 512 columns), else 5 (at most 96); ptxas
// spills at 8 blocks (64 registers) for bf16 at 1024 columns, and at 6 for
// fp32 at 1024 columns with dropout. Without one (LayerNorm, RMSNorm) the
// lane holds half the raw chunks: 8 (at most 64 registers) fits every K
// without spills, and 4 and 6 compile to the same registers; at 10 ptxas
// spills the 1024-column rows, which then run 4-7 % slower
// (sweep_norm_rows.py, PERF.md §6).
constexpr int kRowMinBlocks = 8;

template <int K, bool kResidual>
constexpr int warp_row_min_blocks() {
    if (!kResidual) return kRowMinBlocks;
    return 2 * K * 16 / 4 <= 32 ? 6 : 5;
}

// Normalise row blockIdx.x * kRowWarps + warp of x (n rows of d columns)
// on the calling warp, whole in registers (a warp past the last row
// returns at once):
//   kResidual: v = res + x (kDrop: res + x * keep / (1 - p)), else v = x;
//   kCentre:   y = (v - mean) * rstd * w + b, rstd = rsqrt(var + eps),
//              var the centred variance (LayerNorm);
//   else:      y = v * rstd * w, rstd = rsqrt(mean(v^2) + eps) (RMSNorm).
// The arithmetic is fp32; y and yin are stored in T, mean and rstd in fp32.
// w, b, yin, mean_out and rstd_out may be null (b, yin and mean_out are
// ignored where the template has no use for them).
template <typename T, int K, bool kResidual, bool kDrop, bool kCentre>
__device__ __forceinline__ void norm_warp_row(
    const T* __restrict__ x, const T* __restrict__ res,
    const T* __restrict__ w, const T* __restrict__ b, T* __restrict__ y,
    T* __restrict__ yin, float* __restrict__ mean_out,
    float* __restrict__ rstd_out, int64_t n, int64_t d, float eps,
    DropoutKeys drop) {
    constexpr int G = 16 / static_cast<int>(sizeof(T));
    static_assert(!kDrop || (kResidual && K * G <= 32),
                  "dropout comes with the residual; a lane's keep bits fit "
                  "in one word");
    static_assert(kCentre || !kResidual, "RMSNorm takes no residual");
    using Chunk = Pack<T, G>;
    const int64_t row =
        static_cast<int64_t>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
    if (row >= n) return;                     // a whole warp leaves
    const int lane = threadIdx.x & 31;
    const int chunks = static_cast<int>(d / G);
    const int64_t at = row * (d / G);          // the row's first chunk

    Chunk xc[K], rc[kResidual ? K : 1];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int c = k * 32 + lane;
        if (c < chunks) {
            xc[k] = reinterpret_cast<const Chunk*>(x)[at + c];
            if constexpr (kResidual)
                rc[k] = reinterpret_cast<const Chunk*>(res)[at + c];
        }
    }

    // the row's keep bits first, while its loads are in flight: bit
    // k * G + e for column (k * 32 + lane) * G + e (K * G <= 32)
    uint32_t keep = 0;
    if constexpr (kDrop) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int c = k * 32 + lane;
            if (c >= chunks) continue;
            const uint64_t base4 = static_cast<uint64_t>(at + c) * (G / 4);
#pragma unroll
            for (int j = 0; j < G / 4; ++j) {
                const PhiloxWords r =
                    philox4x32_10(drop.keys, drop.offset, base4 + j);
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    keep |= static_cast<uint32_t>(r.w[q] >= drop.threshold)
                            << (k * G + 4 * j + q);
            }
        }
    }

    // v, and the lane's sum of it (LayerNorm) or of its squares (RMSNorm)
    float v[K][G];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int c = k * 32 + lane;
        if (c >= chunks) continue;
        // with dropout x * ks is rounded, then added: the reference's two
        // roundings, not one fused multiply-add
#pragma unroll
        for (int e = 0; e < G; ++e) {
            if constexpr (kDrop)
                v[k][e] = to_f32(rc[k].v[e]) +
                          __fmul_rn(to_f32(xc[k].v[e]),
                                    (keep >> (k * G + e)) & 1u ? drop.scale
                                                               : 0.f);
            else if constexpr (kResidual)
                v[k][e] = to_f32(rc[k].v[e]) + to_f32(xc[k].v[e]);
            else
                v[k][e] = to_f32(xc[k].v[e]);
        }
#pragma unroll
        for (int e = 0; e < G; ++e) {
            if constexpr (kCentre)
                s += v[k][e];
            else
                s += v[k][e] * v[k][e];
        }
        if constexpr (kResidual) {
            if (yin != nullptr) {
                Chunk o;
#pragma unroll
                for (int e = 0; e < G; ++e) o.v[e] = from_f32<T>(v[k][e]);
                reinterpret_cast<Chunk*>(yin)[at + c] = o;
            }
        }
    }

    float mean = 0.f, rstd;
    if constexpr (kCentre) {
        mean = warp_sum(s) / static_cast<float>(d);
        float ss = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            if (k * 32 + lane >= chunks) continue;
#pragma unroll
            for (int e = 0; e < G; ++e) {
                const float c = v[k][e] - mean;
                ss += c * c;
            }
        }
        rstd = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
    } else {
        rstd = rsqrtf(warp_sum(s) / static_cast<float>(d) + eps);
    }

#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int c = k * 32 + lane;
        if (c >= chunks) continue;
        Chunk wc, bc, o;
        if (w != nullptr) wc = reinterpret_cast<const Chunk*>(w)[c];
        if (kCentre && b != nullptr) bc = reinterpret_cast<const Chunk*>(b)[c];
#pragma unroll
        for (int e = 0; e < G; ++e) {
            float u = kCentre ? (v[k][e] - mean) * rstd : v[k][e] * rstd;
            if (w != nullptr) u *= to_f32(wc.v[e]);
            if (kCentre && b != nullptr) u += to_f32(bc.v[e]);
            o.v[e] = from_f32<T>(u);
        }
        reinterpret_cast<Chunk*>(y)[at + c] = o;
    }
    if (lane == 0) {
        if (kCentre && mean_out != nullptr) mean_out[row] = mean;
        if (rstd_out != nullptr) rstd_out[row] = rstd;
    }
}

// K for a register-path row of d columns: its chunks over the 32 lanes
template <typename T>
inline int row_chunks(int64_t d) {
    return static_cast<int>((d / (16 / static_cast<int64_t>(sizeof(T))) + 31)
                            / 32);
}

// blocks of kRowWarps rows for n rows
inline unsigned warp_row_blocks(int64_t n) {
    return static_cast<unsigned>((n + kRowWarps - 1) / kRowWarps);
}

// The register path at k chunks a lane: launch(integral_constant<int, K>)
// for K == k, K in 1 .. max_row_chunks<T>(); cudaErrorInvalidValue past it.
template <typename T, int K = 1, typename Launch>
int dispatch_row_chunks(int k, Launch&& launch) {
    if (k == K) return launch(std::integral_constant<int, K>{});
    if constexpr (K < max_row_chunks<T>())
        return dispatch_row_chunks<T, K + 1>(k, launch);
    return static_cast<int>(cudaErrorInvalidValue);
}
