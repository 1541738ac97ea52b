// What the flash-attention forward and backward kernels share: the tile
// sizes, the row reductions over a quad, the scores of an accumulator
// fragment and its dropout mask, so that the backward rebuilds exactly the
// scores and the bits the forward saw.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"

constexpr int kBQ = 64;           // query rows per tile
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 128;     // 4 warps of 16 fragment rows each
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

// Scores and the softmax are in natural units; exp(x) is one ex2 of
// x * log2(e) on the special-function unit.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x on the special-function unit (2 ulp); 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// The forward's online softmax takes each probability in one FFMA and one
// ex2: p = ex2(fmaf(s, log2(e), -exp_offset(m))), m the row's running max.
// exp_offset(m) = m log2(e) rounded (never fused), so every p of the row,
// and the rescale ex2(exp_offset(m_old) - exp_offset(m_new)) of the earlier
// tiles, carries the same factor 2^r, r = m log2(e) - exp_offset(m) (the
// product's rounding error, up to 2^-11 next to a -1e4 bias): o = acc / l
// does not see it, and row_lse takes it out of the log-sum-exp exactly (r
// is an fp32 value, fmaf(m, log2(e), -exp_offset(m))). The scores and their
// max are the reference's (fragment_scores) either way.
__device__ __forceinline__ float exp_offset(float m) {
    return __fmul_rn(m, kLog2e);
}

// lse = m + log(l) of a row whose max is m and whose probabilities, taken
// as above, sum to l
__device__ __forceinline__ float row_lse(float m, float l) {
    return m + (logf(l) - fmaf(m, kLog2e, -exp_offset(m)) * kLn2);
}

// The key-padding bias of keys `key` and `key + step` (0 past L): the `kb`
// of fragment_scores.
__device__ __forceinline__ void key_bias(const float* bias_row, int key,
                                         int step, int L, float (&kb)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int at = key + step * i;
        kb[i] = bias_row != nullptr && at < L ? bias_row[at] : 0.f;
    }
}

// Whether key `key` weighs nothing for query `query`
__device__ __forceinline__ bool masked_key(int key, int query, int L,
                                           int causal) {
    return key >= L || (causal && key > query);
}

// The scores of one m16n8 accumulator fragment of dot products, rounded
// as every attention kernel rounds them, where the reference rounds them
// (_score_tile; the forwards take the same roundings in fwd_scores, below):
// dot * scale, then + the key-padding bias, as two fp32 operations (no
// fused multiply-add), in natural units. A key past L or above the causal
// diagonal (at absolute positions) weighs nothing: -inf, so exp(score - m)
// is 0 whatever the row's other keys are. (The reference writes NEG_INF
// there, which gives the same 0 on every row that has a finite score; -inf
// also keeps a row whose allowed keys are all -inf independent of the
// tiling.)
//
// Why natural units: next to BERT's -1e4 bias (-9984 at bf16) a score's
// ulp is 2^-10, ten times the 1e-4 gate on lse. Scores taken in the log2
// domain, fmaf(dot, scale * log2(e), bias * log2(e)), and an lse formed as
// m * ln(2) + log(l) each round once more at that magnitude, and put lse
// 2^-10 off the reference's on a row whose allowed keys all carry the
// bias. Rounded as here, the scores and the row max are the reference's
// whenever the dot products agree to within a rounding, and s - m, s - lse
// are exact (Sterbenz).
//
// Fragment order c0, c1, c2, c3: with queries as rows (kKeyRows false)
// rows `row`, row + 8 and keys `col`, col + 1, i.e. (row, col), (row, col
// + 1), (row + 8, col), (row + 8, col + 1); with keys as rows (true) keys
// `row`, row + 8 and queries `col`, col + 1 in the same order. kb: the bias
// of the fragment's two keys (key_bias; 0 without a bias, whose add changes
// no score). `edge`: whether the fragment may hold a masked key at all; one
// inside the matrix and below the diagonal skips the checks.
template <bool kKeyRows>
__device__ __forceinline__ void fragment_scores(float (&s)[4], float scale,
                                                const float (&kb)[2], int row,
                                                int col, int L, int causal,
                                                bool edge) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int i = kKeyRows ? e >> 1 : e & 1;   // which of the two keys
        float x = __fadd_rn(__fmul_rn(s[e], scale), kb[i]);
        if (edge) {
            const int key = kKeyRows ? row + 8 * i : col + i;
            const int query = kKeyRows ? col + (e & 1) : row + 8 * (e >> 1);
            if (masked_key(key, query, L, causal))
                x = __int_as_float(0xff800000);
        }
        s[e] = x;
    }
}

// fragment_scores' masks alone, on a fragment with queries as rows
__device__ __forceinline__ void fragment_mask(float (&s)[4], int qr, int kc,
                                              int L, int causal) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
        if (masked_key(kc + (e & 1), qr + 8 * (e >> 1), L, causal))
            s[e] = __int_as_float(0xff800000);
}

// The forward's scores of one n-tile (queries as rows: rows qr, qr + 8,
// keys kc, kc + 1). With a key bias (kBias) they are fragment_scores', its
// two roundings, with the masks taken after them in a pass of their own:
// the forwards measured faster so, the backward kernels slower (PERF.md).
// Without a bias they stay the dot products, masked, and the scale moves
// into the exponent: fwd_row_max turns a row's max dot product into the
// natural-unit max m (a product rounded once, as every score would be), and
// p = ex2(fmaf(dot, fwd_exp_scale(scale), -exp_offset(m))). That is bit for
// bit the natural-unit softmax when the scale is a power of two (D = 64:
// 1/8) and within an fp32 rounding of the exponent's argument otherwise
// (scores without a bias are O(10)), at one multiply a score fewer.
template <bool kBias>
__device__ __forceinline__ void fwd_scores(float (&s)[4], float scale,
                                           const float* bias_row, int qr,
                                           int kc, int L, int causal,
                                           bool edge) {
    if constexpr (kBias) {
        float kb[2];
        key_bias(bias_row, kc, 1, L, kb);
#pragma unroll
        for (int e = 0; e < 4; ++e)
            s[e] = __fadd_rn(__fmul_rn(s[e], scale), kb[e & 1]);
    }
    if (edge) fragment_mask(s, qr, kc, L, causal);
}

template <bool kBias>
__device__ __forceinline__ float fwd_row_max(float mx, float scale) {
    return kBias ? mx : __fmul_rn(mx, scale);
}

template <bool kBias>
__device__ __forceinline__ float fwd_exp_scale(float scale) {
    return kBias ? kLog2e : scale * kLog2e;
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

