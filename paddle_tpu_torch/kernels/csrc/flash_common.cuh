// What the flash-attention forward and backward kernels share: the tile
// sizes, the thread layouts' row reductions, the masked score and the
// dropout mask of a fragment, so that the backward rebuilds exactly the
// scores and the bits the forward saw.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"

constexpr int kBQ = 64;           // query rows per tile
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 128;     // 4 warps; FMA: 8 rows x 16 columns
constexpr int kRows = kBQ / 8;    // FMA: query rows per thread, ty + 8 i
constexpr int kCols = kBK / 16;   // FMA: score columns per thread, tx + 16 j
constexpr float kNegInf = -1e30f;
constexpr float kLseEmpty = 1e30f;

// over the 4 lanes of a quad: the lanes that hold one row of an mma
// accumulator fragment (tensor_core.cuh)
__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

// The tensor-core kernels' scores are in the log2 domain: x * log2(e),
// so that exp(x - m) is one ex2 of a difference.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x on the special-function unit (2 ulp); 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// masked_score for one n-tile of an mma accumulator fragment (queries as
// rows: rows qr, qr + 8, keys kc, kc + 1, in fragment order), times
// log2(e): dot * scale2 + bias * log2(e) with scale2 = scale * log2(e),
// then -inf past L and above the causal diagonal. `edge`: whether the
// tile may hold such a key at all; a tile inside the matrix and below the
// diagonal skips the checks.
__device__ __forceinline__ void fragment_scores(float (&s)[4], float scale2,
                                                const float* bias_row,
                                                int kc, int qr, int L,
                                                int causal, bool edge) {
    float b0 = 0.f, b1 = 0.f;
    if (bias_row != nullptr) {
        b0 = kc < L ? bias_row[kc] * kLog2e : 0.f;
        b1 = kc + 1 < L ? bias_row[kc + 1] * kLog2e : 0.f;
    }
    s[0] = fmaf(s[0], scale2, b0);
    s[1] = fmaf(s[1], scale2, b1);
    s[2] = fmaf(s[2], scale2, b0);
    s[3] = fmaf(s[3], scale2, b1);
    if (edge) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int key = kc + (e & 1), row = qr + 8 * (e >> 1);
            if (key >= L || (causal && key > row))
                s[e] = __int_as_float(0xff800000);
        }
    }
}

// fragment_scores in natural units, rounded where the reference rounds:
// dot * scale, then + bias, as two fp32 operations (no fused multiply-add).
// Next to BERT's -1e4 bias a score's ulp is 2^-10, ten times the fp32
// gate on lse, so the fp32 forward takes its scores, and its row max, from
// the same two roundings as _attn_reference: then they are the
// reference's whenever the dot products agree to within a rounding.
__device__ __forceinline__ void fragment_scores_fp32(float (&s)[4],
                                                     float scale,
                                                     const float* bias_row,
                                                     int kc, int qr, int L,
                                                     int causal, bool edge) {
    float b0 = 0.f, b1 = 0.f;
    if (bias_row != nullptr) {
        b0 = kc < L ? bias_row[kc] : 0.f;
        b1 = kc + 1 < L ? bias_row[kc + 1] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
        s[e] = __fadd_rn(__fmul_rn(s[e], scale), e & 1 ? b1 : b0);
    if (edge) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int key = kc + (e & 1), row = qr + 8 * (e >> 1);
            if (key >= L || (causal && key > row))
                s[e] = __int_as_float(0xff800000);
        }
    }
}

// Linear index of attention probability (bh, qr, kc): the dropout mask's
// element counter, the same in the forward, dQ and dK/dV.
__device__ __forceinline__ uint64_t prob_index(int bh, int qr, int kc,
                                               int L) {
    return (static_cast<uint64_t>(bh) * L + qr) * L + kc;
}

// keep / (1 - p) of the four probabilities one lane holds in an m16n8
// accumulator fragment of scores (queries as rows): rows qr and qr + 8,
// keys kc and kc + 1, in fragment order (c0, c1, c2, c3). kc = the
// n-tile's first key + 2 * (lane % 4), the n-tile starting at a multiple
// of 8. Called by the whole warp.
//
// When L % 4 == 0 every Philox call covers four keys kc & ~3 .. +3 of one
// row, and those are held by the two lanes 2i, 2i + 1 of a quad (keys
// 0-1 and 2-3 of the call) for both rows. So the even lane makes row qr's
// call and the odd lane row qr + 8's, each keeps its own two words and
// hands the other two to its neighbour with one shuffle: one call per
// four probabilities, every word used. Otherwise a call's four elements
// straddle rows, and each probability makes its own call.
__device__ __forceinline__ void fragment_keep(const DropoutArgs& a, int bh,
                                              int qr, int kc, int L,
                                              int lane, float (&ks)[4]) {
    uint32_t w[4];
    if ((L & 3) == 0) {
        const bool odd = lane & 1;
        const PhiloxWords r =
            philox4x32_10(a.seed, a.offset,
                          prob_index(bh, odd ? qr + 8 : qr, kc & ~3, L) >> 2);
        const uint32_t own0 = odd ? r.w[2] : r.w[0];
        const uint32_t own1 = odd ? r.w[3] : r.w[1];
        const uint32_t got0 =
            __shfl_xor_sync(0xffffffffu, odd ? r.w[0] : r.w[2], 1);
        const uint32_t got1 =
            __shfl_xor_sync(0xffffffffu, odd ? r.w[1] : r.w[3], 1);
        w[0] = odd ? got0 : own0;   // row qr: the even lane's call
        w[1] = odd ? got1 : own1;
        w[2] = odd ? own0 : got0;   // row qr + 8: the odd lane's
        w[3] = odd ? own1 : got1;
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const uint64_t i =
                prob_index(bh, e < 2 ? qr : qr + 8, kc + (e & 1), L);
            w[e] = philox_word(philox4x32_10(a.seed, a.offset, i >> 2),
                               static_cast<uint32_t>(i) & 3u);
        }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) ks[e] = w[e] >= a.threshold ? a.scale : 0.f;
}

// As fragment_keep, for a fragment with KEYS as rows: rows kr and kr + 8
// are keys, columns qc and qc + 1 queries, in fragment order (c0 (kr, qc),
// c1 (kr, qc + 1), c2 (kr + 8, qc), c3 (kr + 8, qc + 1)); kr = the
// m-tile's first key (a multiple of 16) + lane / 4, qc = the n-tile's
// first query + 2 * (lane % 4).
//
// When L % 4 == 0 a Philox call covers four keys kr & ~3 .. + 3 of one
// query, which lie on four lanes (i = lane / 4 % 4 = 0..3, at one lane %
// 4). Those four lanes hold two such key blocks (kr & ~3 and + 8) of two
// queries: four calls, one a lane (lane i: key block + 8 (i >> 1), query
// + (i & 1), which is also the fragment element c = i those words go to).
// Three shuffles transpose the 4 x 4 words: in round r lane i hands word
// (i + r) % 4 of its call to lane (i + r) % 4 and gets word i of the call
// of lane (i - r) % 4. So again one call per four probabilities, every
// word used.
__device__ __forceinline__ void fragment_keep_t(const DropoutArgs& a, int bh,
                                                int kr, int qc, int L,
                                                int lane, float (&ks)[4]) {
    uint32_t w[4];
    if ((L & 3) == 0) {
        const int i = (lane >> 2) & 3;
        const PhiloxWords r = philox4x32_10(
            a.seed, a.offset,
            prob_index(bh, qc + (i & 1), (kr & ~3) + 8 * (i >> 1), L) >> 2);
        uint32_t v[4];   // v[r]: word i of the call of lane (i - r) % 4
        v[0] = philox_word(r, i);
#pragma unroll
        for (int rd = 1; rd < 4; ++rd)
            v[rd] = __shfl_sync(0xffffffffu, philox_word(r, (i + rd) & 3),
                                (lane & ~12) | (((i - rd) & 3) << 2));
#pragma unroll
        for (int c = 0; c < 4; ++c) {   // call c is element c: v[(i - c) % 4]
            const int rd = (i - c) & 3;
            w[c] = rd == 0 ? v[0] : rd == 1 ? v[1] : rd == 2 ? v[2] : v[3];
        }
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const uint64_t idx =
                prob_index(bh, qc + (e & 1), kr + 8 * (e >> 1), L);
            w[e] = philox_word(philox4x32_10(a.seed, a.offset, idx >> 2),
                               static_cast<uint32_t>(idx) & 3u);
        }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) ks[e] = w[e] >= a.threshold ? a.scale : 0.f;
}
