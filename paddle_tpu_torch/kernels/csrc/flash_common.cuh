// What the flash-attention forward and backward kernels share: the tile
// sizes, the thread layout's row reductions and the masked score, so that
// the backward rebuilds exactly the scores the forward saw.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

constexpr int kBQ = 64;           // query rows per tile
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 128;     // 8 row groups x 16 column lanes
constexpr int kRows = kBQ / 8;    // query rows per thread: ty + 8 i
constexpr int kCols = kBK / 16;   // score columns per thread: tx + 16 j
constexpr float kNegInf = -1e30f;
constexpr float kLseEmpty = 1e30f;

__device__ __forceinline__ float max16(float v) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// The score of query row qr against key kc from their dot product: scale,
// then the key-padding bias. A key past L or above the causal diagonal (at
// absolute positions) weighs nothing: -inf, so exp(score - m) is 0 whatever
// the row's other keys are. (The reference writes NEG_INF there, which
// gives the same 0 on every row that has a finite score; -inf also keeps a
// row whose allowed keys are all -inf independent of the tiling.)
__device__ __forceinline__ float masked_score(float dot, float scale,
                                              const float* bias_row, int kc,
                                              int qr, int L, int causal) {
    if (kc >= L || (causal && kc > qr)) return __int_as_float(0xff800000);
    float x = dot * scale;
    if (bias_row != nullptr) x += bias_row[kc];
    return x;
}

// Linear index of attention probability (bh, qr, kc): the dropout mask's
// element counter, the same in the forward, dQ and dK/dV.
__device__ __forceinline__ uint64_t prob_index(int bh, int qr, int kc,
                                               int L) {
    return (static_cast<uint64_t>(bh) * L + qr) * L + kc;
}
