// Flash attention backward, fp32 or bf16: dQ, and dK/dV, from (q, k, v, dO,
// lse, delta) with delta = rowsum(dO * O). Neither stores an (L, L) matrix:
// each rebuilds P = exp(S - lse) tile by tile, with
//   dP = dO V^T (times keep / (1 - p) under dropout),
//   dS = P * (dP - delta),
//   dQ = scale * dS K,   dK = scale * dS^T Q,   dV = (P * keep/(1-p))^T dO.
//
// Replaces: paddle_tpu/kernels/flash_attention.py, _dq_kernel and
// _dkv_kernel (both launched by _flash_backward). S is rebuilt as the
// forward built it (scale, key-padding bias, -inf above the causal
// diagonal and past L: fragment_scores in the log2 domain in the
// tensor-core kernels, masked_score in the FMA ones), and the dropout mask
// by philox.cuh from the element (bh, query row, key column), so both
// kernels see the forward's bits although they walk the matrix in other
// orders. A row
// whose every key was -inf has lse = 1e30: its P is exp(-inf) = 0 and all
// its gradients are 0, never NaN. The bias gets no gradient. At bf16,
// q/k/v/dO are read as bf16 (their products are exact in fp32) and lse,
// delta and every accumulator stay fp32; P (dropped) and dS are rounded to
// bf16 before the dV, dQ and dK products, where the reference casts them
// to the input dtype (flash_attention.py:254, :316, :319); dq/dk/dv are
// stored in bf16.
//
// Four kernels: at bf16 both on the tensor cores, at fp32 both on the FMA
// pipes.
//
// flash_dkv_mma_kernel (dK/dV at bf16; replaces _dkv_kernel there). Bound
// on the H100: four products (S, dP, P^T dO, dS^T Q), 8 L^2 D flops a head,
// against 12 L D bytes (q, k, v, dO read, dk, dv written, bf16) and 8 L of
// lse and delta: 340 flops a byte at L = 512, D = 64, above the 295
// flop/byte ridge, so the tensor cores bound it. Every product is a
// tensor-core mma.sync with fp32 accumulators. Grid (B*H, ceil(L/64)): a
// block owns 64 keys, K and V resident in shared memory as bf16, and
// streams Q, dO, lse and delta tiles of 64 queries through a three-stage
// cp.async ring (from the diagonal on when causal). 4 warps, each owning
// 16 keys against the whole query tile, with KEYS as the fragment rows:
// S^T = K Q^T and dP^T = V dO^T come out as fp32 fragments, P^T = exp(S^T
// - lse) and dS^T = P^T (dP^T keep/(1-p) - delta) are formed on them, and
// their bf16 conversion (the reference's casts) is directly the A operand
// of dV += (P keep)^T dO and dK += dS^T Q (dO and Q read with
// ldmatrix.trans). So P and dS never go through shared memory and a tile
// needs one barrier; shared-memory reads are ~0.56 ldmatrix a product.
// Under dropout the four keys of one Philox call lie on four lanes' rows,
// so those four lanes make the four calls their 16 probabilities need,
// one each, and trade words with three shuffles (fragment_keep_t in
// flash_common.cuh): one call per four probabilities, every word used,
// when L % 4 == 0. One block owns a key tile: no atomics, dK and dV are
// deterministic. Ragged edges as the forward's (cp.async zero fill, masks
// only on edge tiles, element loads when d % 8 != 0); the head dim is
// padded to 64 or 128. At D = 64 without dropout the registers are capped
// for three blocks an SM (a few bytes spill), which measured faster than
// two; 67 KB of shared memory at D = 64, 133 KB at D = 128.
//
// flash_dq_mma_kernel (dQ at bf16; replaces _dq_kernel there). Three
// products (S, dP, dS K), 6 L^2 D flops a head, against 10 L D bytes (q,
// k, v, dO read, dq written, bf16) and 8 L of lse and delta: 303 flops a
// byte at L = 512, D = 64, just above the 295 flop/byte ridge, so the
// tensor cores bound it. The forward's
// layout, as queries are the fragment rows here too: grid (B*H,
// ceil(L/64)) over query tiles, 4 warps of 16 rows whose Q and dO
// fragments stay in registers as the A operands of S = Q K^T and dP =
// dO V^T; K/V tiles of 64 keys stream through a two-stage cp.async ring
// (the TPU kernel's sequential grid axis is this loop, up to the diagonal
// tile when causal). P = exp(S - lse) in the log2 domain, the masks only
// on edge tiles, the dropout bits of fragment_keep (queries as rows: one
// Philox call per four probabilities when L % 4 == 0); dS = P (dP
// keep/(1-p) - delta) is rounded to bf16 where the reference casts it and
// becomes, in registers, the A operand of dQ += dS K, with K read a second
// time through ldmatrix.trans: dS never goes through shared memory and a
// tile needs one barrier. One block owns a query tile: no atomics. Ragged
// edges as the forward's; 48 KB of shared memory at D = 64.
//
// flash_dq_kernel and flash_dkv_kernel (fp32) stay on the FMA pipes for
// now (the forward runs 3xTF32 on the tensor cores, flash_attention.cu
// says why that keeps the fp32 gates; these two are next, ROADMAP): dQ is
// three products, dK/dV four, against some 24 L D bytes a head; operations
// bound both. Both use the old fp32 forward's layout: 128 threads, thread
// (ty, tx) owns rows ty + 8i and score columns tx + 16j of a 64 x 64 tile;
// S and dP come out of one loop over the head dim. dQ: grid (B*H,
// ceil(L/64)) over Q tiles; Q, dO, lse and delta stay resident and K/V
// tiles stream through; dS goes through shared memory for dS K. dK/dV:
// grid over K tiles; K, V resident, Q/dO tiles stream, from the diagonal
// on when causal; P and dS go through shared memory and are read by
// columns (rows padded by one float) for the two transposed products. Rows
// past L load lse = 1e30 and dO = 0 and store nothing. Shared memory is
// 83-100 KB at D = 64 and 149-166 KB at D = 128, opted into with
// cudaFuncSetAttribute.
#include <cstdint>

#include "dtype.cuh"
#include "flash_common.cuh"
#include "philox.cuh"
#include "tensor_core.cuh"

namespace {

template <int DP>
struct BwdTile {
    static constexpr int stride = DP + 1;      // floats per Q/dO/K/V row
    static constexpr int p_stride = kBK + 1;   // floats per P/dS row
    static constexpr int mat = kBQ * stride;
    static constexpr int p = kBQ * p_stride;
    static constexpr size_t dq_bytes = sizeof(float) * (4 * mat + p);
    static constexpr size_t dkv_bytes = sizeof(float) * (4 * mat + 2 * p);
};

struct Strides {
    int64_t b, h, l;   // elements; the head dim is contiguous
};

// 64 rows from row0 of one head of `src` into a padded fp32 shared tile,
// zero past L and past d.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int64_t base, int64_t sl, int row0,
                                          int L, int d) {
    for (int i = threadIdx.x; i < kBQ * DP; i += kThreads) {
        const int r = i / DP, c = i % DP, row = row0 + r;
        dst[r * BwdTile<DP>::stride + c] =
            (row < L && c < d) ? src[base + row * sl + c] : 0.f;
    }
}

// The thread's fragments of P (dropped) and dS for one tile pair: query
// rows q0 + ty + 8i against keys k0 + tx + 16j.
template <int DP, bool kDrop>
__device__ __forceinline__ void tile_p_ds(
    const float* sq, const float* sdo, const float* sk, const float* sv,
    const float (&lse)[kRows], const float (&delta)[kRows],
    const float* bias_row, int bh, int q0, int k0, int L, float scale,
    int causal, const DropoutArgs& drop, float (&p)[kRows][kCols],
    float (&ds)[kRows][kCols]) {
    constexpr int stride = BwdTile<DP>::stride;
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
        float kc[kCols], vc[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
            kc[j] = sk[(tx + 16 * j) * stride + c];
            vc[j] = sv[(tx + 16 * j) * stride + c];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const float qv = sq[(ty + 8 * i) * stride + c];
            const float gv = sdo[(ty + 8 * i) * stride + c];
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                s[i][j] = fmaf(qv, kc[j], s[i][j]);
                dp[i][j] = fmaf(gv, vc[j], dp[i][j]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int qr = q0 + ty + 8 * i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
            const int kcol = k0 + tx + 16 * j;
            const float x =
                masked_score(s[i][j], scale, bias_row, kcol, qr, L, causal);
            const float pv = expf(x - lse[i]);
            float pd = pv, dpv = dp[i][j];
            if (kDrop) {
                const float ks = keep_scale(drop, prob_index(bh, qr, kcol, L));
                pd *= ks;
                dpv *= ks;
            }
            p[i][j] = pd;
            ds[i][j] = pv * (dpv - delta[i]);
        }
    }
}

// q, k, v and dq (fp32) share strides `s`; dO has `gs`. lse, delta:
// (B*H, L) fp32.
template <int DP, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ bias, float* __restrict__ dq, int L,
                int d, int H, Strides s, Strides gs, float scale, int causal,
                DropoutArgs drop) {
    using Tl = BwdTile<DP>;
    constexpr int kOut = DP / 16;
    extern __shared__ float smem[];
    float* sq = smem;
    float* sdo = sq + Tl::mat;
    float* sk = sdo + Tl::mat;
    float* sv = sk + Tl::mat;
    float* sds = sv + Tl::mat;

    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int q0 = blockIdx.y * kBQ;
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    const int64_t base = b * s.b + h * s.h;
    const int64_t gbase = b * gs.b + h * gs.h;
    const float* bias_row =
        bias != nullptr ? bias + static_cast<int64_t>(b) * L : nullptr;

    load_tile<DP>(sq, q, base, s.l, q0, L, d);
    load_tile<DP>(sdo, dout, gbase, gs.l, q0, L, d);
    float lse_r[kRows], delta_r[kRows], acc[kRows][kOut];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int qr = q0 + ty + 8 * i;
        const int64_t at = static_cast<int64_t>(bh) * L + qr;
        lse_r[i] = qr < L ? lse[at] : kLseEmpty;
        delta_r[i] = qr < L ? delta[at] : 0.f;
#pragma unroll
        for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
    }

    int n_tiles = (L + kBK - 1) / kBK;
    if (causal) n_tiles = min(n_tiles, (min(q0 + kBQ, L) - 1) / kBK + 1);
    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * kBK;
        __syncthreads();   // the previous tile's readers are done
        load_tile<DP>(sk, k, base, s.l, k0, L, d);
        load_tile<DP>(sv, v, base, s.l, k0, L, d);
        __syncthreads();

        float p[kRows][kCols], ds[kRows][kCols];
        tile_p_ds<DP, kDrop>(sq, sdo, sk, sv, lse_r, delta_r, bias_row, bh,
                             q0, k0, L, scale, causal, drop, p, ds);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j)
                sds[(ty + 8 * i) * Tl::p_stride + tx + 16 * j] = ds[i][j];
        __syncthreads();

#pragma unroll 4
        for (int kk = 0; kk < kBK; ++kk) {
            float kv[kOut];
#pragma unroll
            for (int c = 0; c < kOut; ++c)
                kv[c] = sk[kk * Tl::stride + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const float dsv = sds[(ty + 8 * i) * Tl::p_stride + kk];
#pragma unroll
                for (int c = 0; c < kOut; ++c)
                    acc[i][c] = fmaf(dsv, kv[c], acc[i][c]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int qr = q0 + ty + 8 * i;
        if (qr >= L) continue;
#pragma unroll
        for (int c = 0; c < kOut; ++c) {
            const int col = tx + 16 * c;
            if (col < d)
                dq[base + qr * s.l + col] = acc[i][c] * scale;
        }
    }
}

// q, k, v, dk and dv (fp32) share strides `s`; dO has `gs`.
template <int DP, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ bias, float* __restrict__ dk,
                 float* __restrict__ dv, int L, int d, int H, Strides s,
                 Strides gs, float scale, int causal, DropoutArgs drop) {
    using Tl = BwdTile<DP>;
    constexpr int kOut = DP / 16;
    extern __shared__ float smem[];
    float* sq = smem;
    float* sdo = sq + Tl::mat;
    float* sk = sdo + Tl::mat;
    float* sv = sk + Tl::mat;
    float* sp = sv + Tl::mat;
    float* sds = sp + Tl::p;

    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int k0 = blockIdx.y * kBK;
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    const int64_t base = b * s.b + h * s.h;
    const int64_t gbase = b * gs.b + h * gs.h;
    const float* bias_row =
        bias != nullptr ? bias + static_cast<int64_t>(b) * L : nullptr;

    load_tile<DP>(sk, k, base, s.l, k0, L, d);
    load_tile<DP>(sv, v, base, s.l, k0, L, d);
    // the thread owns keys k0 + ty + 8i and output columns tx + 16c
    float acc_k[kRows][kOut], acc_v[kRows][kOut];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kOut; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

    const int n_tiles = (L + kBQ - 1) / kBQ;
    // causal: query tiles above the diagonal see none of these keys
    for (int t = causal ? k0 / kBQ : 0; t < n_tiles; ++t) {
        const int q0 = t * kBQ;
        __syncthreads();   // the previous tile's readers are done
        load_tile<DP>(sq, q, base, s.l, q0, L, d);
        load_tile<DP>(sdo, dout, gbase, gs.l, q0, L, d);
        __syncthreads();

        float lse_r[kRows], delta_r[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const int qr = q0 + ty + 8 * i;
            const int64_t at = static_cast<int64_t>(bh) * L + qr;
            lse_r[i] = qr < L ? lse[at] : kLseEmpty;
            delta_r[i] = qr < L ? delta[at] : 0.f;
        }
        float p[kRows][kCols], ds[kRows][kCols];
        tile_p_ds<DP, kDrop>(sq, sdo, sk, sv, lse_r, delta_r, bias_row, bh,
                             q0, k0, L, scale, causal, drop, p, ds);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                const int at = (ty + 8 * i) * Tl::p_stride + tx + 16 * j;
                sp[at] = p[i][j];
                sds[at] = ds[i][j];
            }
        __syncthreads();

#pragma unroll 2
        for (int qq = 0; qq < kBQ; ++qq) {
            float gv[kOut], qv[kOut];
#pragma unroll
            for (int c = 0; c < kOut; ++c) {
                gv[c] = sdo[qq * Tl::stride + tx + 16 * c];
                qv[c] = sq[qq * Tl::stride + tx + 16 * c];
            }
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const float pv = sp[qq * Tl::p_stride + ty + 8 * i];
                const float dsv = sds[qq * Tl::p_stride + ty + 8 * i];
#pragma unroll
                for (int c = 0; c < kOut; ++c) {
                    acc_v[i][c] = fmaf(pv, gv[c], acc_v[i][c]);
                    acc_k[i][c] = fmaf(dsv, qv[c], acc_k[i][c]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int kr = k0 + ty + 8 * i;
        if (kr >= L) continue;
#pragma unroll
        for (int c = 0; c < kOut; ++c) {
            const int col = tx + 16 * c;
            if (col < d) {
                dk[base + kr * s.l + col] = acc_k[i][c] * scale;
                dv[base + kr * s.l + col] = acc_v[i][c];
            }
        }
    }
}

// dK/dV at bf16 on the tensor cores, keys as the fragment rows. q, k, v,
// dk and dv share strides `s`, dO has `gs`; `vec` / `gvec`: their rows are
// whole 16-byte chunks. 4 warps; warp w owns keys 16 w .. 16 w + 15 of the
// block's 64 against each 64-query tile: S^T = K Q^T and dP^T = V dO^T as
// fp32 fragments, then P^T and dS^T, converted in registers, are the A
// operands of dV += P^T dO and dK += dS^T Q (dO and Q read with
// ldmatrix.trans): no trip through shared memory.
constexpr int kDkvStages = 3;

template <int DP, bool kDrop>
__global__ void __launch_bounds__(kThreads, DP == 64 && !kDrop ? 3 : 1)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ bias, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int L, int d, int H, Strides s,
                     Strides gs, float scale, int causal, int vec, int gvec,
                     DropoutArgs drop) {
    constexpr int kTile = kBQ * DP;     // elements of a Q/dO/K/V tile
    constexpr int kSteps = DP / 16;     // k-steps of S^T and dP^T
    constexpr int kQN = kBQ / 8;        // n-tiles of S^T over the queries
    constexpr int kOutN = DP / 8;       // n-tiles of dK and dV
    static_assert(kBK == 16 * (kThreads / 32), "a warp owns 16 keys");
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* sk = reinterpret_cast<bf16*>(smem_raw);
    bf16* sv = sk + kTile;
    bf16* sq = sv + kTile;                  // kDkvStages stages
    bf16* sdo = sq + kDkvStages * kTile;    // kDkvStages stages
    float* slse = reinterpret_cast<float*>(sdo + kDkvStages * kTile);
    float* sdelta = slse + kDkvStages * kBQ;

    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int k0 = blockIdx.y * kBK;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int kr = k0 + 16 * warp + g;   // the lane's keys: kr and kr + 8
    const int64_t base = b * s.b + h * s.h;
    const int64_t gbase = b * gs.b + h * gs.h;
    const int64_t stat = static_cast<int64_t>(bh) * L;
    const float scale2 = scale * kLog2e;
    // the key-padding bias of the lane's two keys, log2 domain
    float kb2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
        kb2[i] = bias != nullptr && kr + 8 * i < L
                     ? bias[static_cast<int64_t>(b) * L + kr + 8 * i] * kLog2e
                     : 0.f;

    // causal: query tiles above the diagonal see none of these keys
    const int t0 = causal ? k0 / kBQ : 0;
    const int n_tiles = (L + kBQ - 1) / kBQ;
    // query tile t (Q, dO, lse, delta) into stage (t - t0) % kDkvStages, as
    // one commit group (empty past the last tile, so that every iteration
    // waits for the same count)
    const auto load_queries = [&](int t) {
        if (t < n_tiles) {
            const int st = (t - t0) % kDkvStages, q0 = t * kBQ;
            load_rows<kBQ, DP, kThreads>(sq + st * kTile, q, base, s.l, q0, L,
                                         d, vec);
            load_rows<kBQ, DP, kThreads>(sdo + st * kTile, dout, gbase, gs.l,
                                         q0, L, d, gvec);
            const int i = threadIdx.x & (kBQ - 1);
            const float* src = threadIdx.x < kBQ ? lse : delta;
            float* dst = (threadIdx.x < kBQ ? slse : sdelta) + st * kBQ + i;
            const bool ok = q0 + i < L;
            cp_async4(dst, ok ? src + stat + q0 + i : src, ok);
        }
        cp_async_commit();
    };
    static_assert(kThreads == 2 * kBQ, "a thread copies one lse or delta");

    load_rows<kBK, DP, kThreads>(sk, k, base, s.l, k0, L, d, vec);
    load_rows<kBK, DP, kThreads>(sv, v, base, s.l, k0, L, d, vec);
    // K and V join the first query tile's group
#pragma unroll
    for (int i = 0; i < kDkvStages - 1; ++i) load_queries(t0 + i);

    float acc_k[kOutN][4], acc_v[kOutN][4];
#pragma unroll
    for (int n = 0; n < kOutN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

    for (int t = t0; t < n_tiles; ++t) {
        const int q0 = t * kBQ;
        const int st = (t - t0) % kDkvStages;
        cp_async_wait<kDkvStages - 2>();   // tile t is in shared memory ...
        __syncthreads();   // ... for every thread, and tile t - 1's stage is
        load_queries(t + kDkvStages - 1);  // free for the tile 2 ahead
        const bf16* sqt = sq + st * kTile;
        const bf16* sdot = sdo + st * kTile;
        const float* slt = slse + st * kBQ;
        const float* sdt = sdelta + st * kBQ;

        // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries a warp
        float sc[kQN][4], dp[kQN][4];
#pragma unroll
        for (int n = 0; n < kQN; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
            uint32_t ka[4], va[4];
            const int at = swz<DP>(16 * warp + (lane & 7) +
                                       ((lane >> 3) & 1) * 8,
                                   kk * 16 + (lane >> 4) * 8);
            ldmatrix_x4(ka, sk + at);
            ldmatrix_x4(va, sv + at);
#pragma unroll
            for (int np = 0; np < kQN / 2; ++np) {
                uint32_t qb[4], gb[4];
                const int qat = swz<DP>(np * 16 + (lane & 7) + (lane >> 4) * 8,
                                        kk * 16 + ((lane >> 3) & 1) * 8);
                ldmatrix_x4(qb, sqt + qat);
                ldmatrix_x4(gb, sdot + qat);
                mma_bf16(sc[2 * np], ka, qb[0], qb[1]);
                mma_bf16(sc[2 * np + 1], ka, qb[2], qb[3]);
                mma_bf16(dp[2 * np], va, gb[0], gb[1]);
                mma_bf16(dp[2 * np + 1], va, gb[2], gb[3]);
            }
        }

        // P^T = exp(S^T - lse) and dS^T = P^T (dP^T keep/(1-p) - delta),
        // in place of S^T and dP^T; only a key tile reaching past L or a
        // tile above the diagonal needs the masks
        const bool edge = k0 + kBK > L || (causal && k0 + 16 * warp + 15 > q0);
#pragma unroll
        for (int n = 0; n < kQN; ++n) {
            const int qi = 8 * n + 2 * t4;   // query in the tile: qi, qi + 1
            const int qc = q0 + qi;
            const float2 lq = *reinterpret_cast<const float2*>(slt + qi);
            const float2 dq = *reinterpret_cast<const float2*>(sdt + qi);
            // a query past L has lse = 1e30, so its P is 0
            const float lse2[2] = {(qc < L ? lq.x : kLseEmpty) * kLog2e,
                                   (qc + 1 < L ? lq.y : kLseEmpty) * kLog2e};
            const float dl[2] = {dq.x, dq.y};
            float ks[4];
            if (kDrop) fragment_keep_t(drop, bh, kr, qc, L, lane, ks);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = fmaf(sc[n][e], scale2, kb2[e >> 1]);
                if (edge) {
                    const int key = kr + 8 * (e >> 1), qq = qc + (e & 1);
                    if (key >= L || (causal && key > qq))
                        x = __int_as_float(0xff800000);
                }
                const float p = ex2(x - lse2[e & 1]);
                const float dpe = kDrop ? dp[n][e] * ks[e] : dp[n][e];
                sc[n][e] = kDrop ? p * ks[e] : p;
                dp[n][e] = p * (dpe - dl[e & 1]);
            }
        }

        // dV += (P keep)^T dO and dK += dS^T Q: the fragments, rounded to
        // bf16 (the reference's casts), are the A operands
#pragma unroll
        for (int kq = 0; kq < kBQ / 16; ++kq) {
            uint32_t pa[4], da[4];
            pa[0] = pack_bf16(sc[2 * kq][0], sc[2 * kq][1]);
            pa[1] = pack_bf16(sc[2 * kq][2], sc[2 * kq][3]);
            pa[2] = pack_bf16(sc[2 * kq + 1][0], sc[2 * kq + 1][1]);
            pa[3] = pack_bf16(sc[2 * kq + 1][2], sc[2 * kq + 1][3]);
            da[0] = pack_bf16(dp[2 * kq][0], dp[2 * kq][1]);
            da[1] = pack_bf16(dp[2 * kq][2], dp[2 * kq][3]);
            da[2] = pack_bf16(dp[2 * kq + 1][0], dp[2 * kq + 1][1]);
            da[3] = pack_bf16(dp[2 * kq + 1][2], dp[2 * kq + 1][3]);
#pragma unroll
            for (int np = 0; np < kOutN / 2; ++np) {
                uint32_t gb[4], qb[4];
                const int at = swz<DP>(
                    kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                    np * 16 + (lane >> 4) * 8);
                ldmatrix_x4_trans(gb, sdot + at);
                ldmatrix_x4_trans(qb, sqt + at);
                mma_bf16(acc_v[2 * np], pa, gb[0], gb[1]);
                mma_bf16(acc_v[2 * np + 1], pa, gb[2], gb[3]);
                mma_bf16(acc_k[2 * np], da, qb[0], qb[1]);
                mma_bf16(acc_k[2 * np + 1], da, qb[2], qb[3]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int key = kr + 8 * i;
        if (key >= L) continue;
        bf16* dkrow = dk + base + key * s.l;
        bf16* dvrow = dv + base + key * s.l;
#pragma unroll
        for (int n = 0; n < kOutN; ++n) {
            const int col = 8 * n + 2 * t4;
            const float k0v = acc_k[n][2 * i] * scale;
            const float k1v = acc_k[n][2 * i + 1] * scale;
            const float v0v = acc_v[n][2 * i], v1v = acc_v[n][2 * i + 1];
            if (vec) {
                if (col < d) {
                    *reinterpret_cast<uint32_t*>(dkrow + col) =
                        pack_bf16(k0v, k1v);
                    *reinterpret_cast<uint32_t*>(dvrow + col) =
                        pack_bf16(v0v, v1v);
                }
            } else {
                if (col < d) {
                    dkrow[col] = __float2bfloat16_rn(k0v);
                    dvrow[col] = __float2bfloat16_rn(v0v);
                }
                if (col + 1 < d) {
                    dkrow[col + 1] = __float2bfloat16_rn(k1v);
                    dvrow[col + 1] = __float2bfloat16_rn(v1v);
                }
            }
        }
    }
}

// dQ at bf16 on the tensor cores, queries as the fragment rows. q, k, v
// and dq share strides `s`, dO has `gs`; `vec` / `gvec`: their rows are
// whole 16-byte chunks. 4 warps; warp w owns query rows 16 w .. 16 w + 15
// of the block's 64, with its Q and dO fragments in registers, against
// each 64-key K/V tile of a two-stage cp.async ring: S = Q K^T and dP =
// dO V^T as fp32 fragments, then dS, converted in registers, is the A
// operand of dQ += dS K (K read again with ldmatrix.trans): dS never goes
// through shared memory.
constexpr int kDqStages = 2;

template <int DP, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ bias, bf16* __restrict__ dq,
                    int L, int d, int H, Strides s, Strides gs, float scale,
                    int causal, int vec, int gvec, DropoutArgs drop) {
    constexpr int kTile = kBK * DP;     // elements of a Q/dO/K/V tile
    constexpr int kSteps = DP / 16;     // k-steps of S and dP
    constexpr int kKeyN = kBK / 8;      // n-tiles of S over the keys
    constexpr int kOutN = DP / 8;       // n-tiles of dQ
    static_assert(kBQ == 16 * (kThreads / 32), "a warp owns 16 rows");
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* sq = reinterpret_cast<bf16*>(smem_raw);
    bf16* sdo = sq + kTile;
    bf16* sk = sdo + kTile;                 // kDqStages stages
    bf16* sv = sk + kDqStages * kTile;      // kDqStages stages

    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int q0 = blockIdx.y * kBQ;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = 16 * warp;           // the warp's first row in the tile
    const int qr = q0 + r0 + g;         // the lane's rows: qr and qr + 8
    const int64_t base = b * s.b + h * s.h;
    const int64_t gbase = b * gs.b + h * gs.h;
    const int64_t stat = static_cast<int64_t>(bh) * L;
    const float* bias_row =
        bias != nullptr ? bias + static_cast<int64_t>(b) * L : nullptr;
    const float scale2 = scale * kLog2e;

    int n_tiles = (L + kBK - 1) / kBK;
    if (causal) n_tiles = min(n_tiles, (min(q0 + kBQ, L) - 1) / kBK + 1);

    // K/V tile t into stage t % kDqStages, as one commit group (empty past
    // the last tile, so that every iteration waits for the same count)
    const auto load_keys = [&](int t) {
        if (t < n_tiles) {
            const int at = (t % kDqStages) * kTile;
            load_rows<kBK, DP, kThreads>(sk + at, k, base, s.l, t * kBK, L,
                                         d, vec);
            load_rows<kBK, DP, kThreads>(sv + at, v, base, s.l, t * kBK, L,
                                         d, vec);
        }
        cp_async_commit();
    };
    load_rows<kBQ, DP, kThreads>(sq, q, base, s.l, q0, L, d, vec);
    load_rows<kBQ, DP, kThreads>(sdo, dout, gbase, gs.l, q0, L, d, gvec);
    cp_async_commit();
#pragma unroll
    for (int t = 0; t < kDqStages - 1; ++t) load_keys(t);

    // the lane's two rows' lse (log2 domain) and delta; a row past L has
    // lse = 1e30, so its P is 0
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = qr + 8 * i;
        lse2[i] = (row < L ? lse[stat + row] : kLseEmpty) * kLog2e;
        dl[i] = row < L ? delta[stat + row] : 0.f;
    }

    cp_async_wait<kDqStages - 1>();
    __syncthreads();
    uint32_t qf[kSteps][4], gf[kSteps][4];   // Q and dO, A fragments
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
        const int at = swz<DP>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                               st * 16 + (lane >> 4) * 8);
        ldmatrix_x4(qf[st], sq + at);
        ldmatrix_x4(gf[st], sdo + at);
    }
    float acc[kOutN][4];
#pragma unroll
    for (int n = 0; n < kOutN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * kBK;
        cp_async_wait<kDqStages - 2>();   // tile t is in shared memory ...
        __syncthreads();   // ... for every thread, and tile t - 1's stage is
        load_keys(t + kDqStages - 1);    // free for the next tile
        const bf16* skt = sk + (t % kDqStages) * kTile;
        const bf16* svt = sv + (t % kDqStages) * kTile;

        // S = Q K^T and dP = dO V^T: keys 16np .. 16np + 15 as n-tiles
        // 2np, 2np + 1; K and V read at the same addresses
        float sc[kKeyN][4], dp[kKeyN][4];
#pragma unroll
        for (int n = 0; n < kKeyN; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int st = 0; st < kSteps; ++st)
#pragma unroll
            for (int np = 0; np < kKeyN / 2; ++np) {
                uint32_t kb[4], vb[4];
                const int at = swz<DP>(np * 16 + (lane & 7) + (lane >> 4) * 8,
                                       st * 16 + ((lane >> 3) & 1) * 8);
                ldmatrix_x4(kb, skt + at);
                ldmatrix_x4(vb, svt + at);
                mma_bf16(sc[2 * np], qf[st], kb[0], kb[1]);
                mma_bf16(sc[2 * np + 1], qf[st], kb[2], kb[3]);
                mma_bf16(dp[2 * np], gf[st], vb[0], vb[1]);
                mma_bf16(dp[2 * np + 1], gf[st], vb[2], vb[3]);
            }

        // P = exp(S - lse) and dS = P (dP keep/(1-p) - delta), in place of
        // S; only a tile reaching past L or above the warp's diagonal needs
        // the masks
        const bool edge =
            k0 + kBK > L || (causal && k0 + kBK - 1 > q0 + r0);
#pragma unroll
        for (int n = 0; n < kKeyN; ++n) {
            const int kc = k0 + 8 * n + 2 * t4;
            fragment_scores(sc[n], scale2, bias_row, kc, qr, L, causal, edge);
            float ks[4];
            if (kDrop) fragment_keep(drop, bh, qr, kc, L, lane, ks);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = ex2(sc[n][e] - lse2[e >> 1]);
                const float dpe = kDrop ? dp[n][e] * ks[e] : dp[n][e];
                sc[n][e] = p * (dpe - dl[e >> 1]);
            }
        }

        // dQ += dS K: dS's fragments, rounded to bf16 (the reference's
        // cast), are the A operand, two n-tiles (16 keys) a k-step
#pragma unroll
        for (int kq = 0; kq < kBK / 16; ++kq) {
            uint32_t da[4];
            da[0] = pack_bf16(sc[2 * kq][0], sc[2 * kq][1]);
            da[1] = pack_bf16(sc[2 * kq][2], sc[2 * kq][3]);
            da[2] = pack_bf16(sc[2 * kq + 1][0], sc[2 * kq + 1][1]);
            da[3] = pack_bf16(sc[2 * kq + 1][2], sc[2 * kq + 1][3]);
#pragma unroll
            for (int np = 0; np < kOutN / 2; ++np) {
                uint32_t kb[4];
                ldmatrix_x4_trans(kb, skt + swz<DP>(
                    kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                    np * 16 + (lane >> 4) * 8));
                mma_bf16(acc[2 * np], da, kb[0], kb[1]);
                mma_bf16(acc[2 * np + 1], da, kb[2], kb[3]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = qr + 8 * i;
        if (row >= L) continue;
        bf16* dqrow = dq + base + row * s.l;
#pragma unroll
        for (int n = 0; n < kOutN; ++n) {
            const int col = 8 * n + 2 * t4;
            const float v0 = acc[n][2 * i] * scale;
            const float v1 = acc[n][2 * i + 1] * scale;
            if (vec) {
                if (col < d)
                    *reinterpret_cast<uint32_t*>(dqrow + col) =
                        pack_bf16(v0, v1);
            } else {
                if (col < d) dqrow[col] = __float2bfloat16_rn(v0);
                if (col + 1 < d) dqrow[col + 1] = __float2bfloat16_rn(v1);
            }
        }
    }
}

// q, k, v, dout, dq, dk, dv point at elements of the call's dtype
struct BwdArgs {
    const void *q, *k, *v, *dout;
    const float *lse, *delta, *bias;
    void *dq, *dk, *dv;
    int64_t bh;
    int L, d, H;
    Strides s, gs;
    float scale;
    int causal;
    DropoutArgs drop;
    cudaStream_t stream;
};

// above 48 KB a block's shared memory must be opted into; idempotent, so a
// race between two first callers is harmless
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes, bool* configured) {
    if (*configured) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e == cudaSuccess) *configured = true;
    return e;
}

template <int DP, bool kDrop>
int launch_dq(const BwdArgs& a) {
    static bool configured = false;
    const cudaError_t e = allow_shared(flash_dq_kernel<DP, kDrop>,
                                       BwdTile<DP>::dq_bytes, &configured);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(static_cast<unsigned>(a.bh),
                    static_cast<unsigned>((a.L + kBQ - 1) / kBQ));
    flash_dq_kernel<DP, kDrop>
        <<<grid, kThreads, BwdTile<DP>::dq_bytes, a.stream>>>(
            static_cast<const float*>(a.q), static_cast<const float*>(a.k),
            static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
            a.lse, a.delta, a.bias, static_cast<float*>(a.dq), a.L, a.d, a.H,
            a.s, a.gs, a.scale, a.causal, a.drop);
    return static_cast<int>(cudaGetLastError());
}

template <int DP, bool kDrop>
int launch_dkv(const BwdArgs& a) {
    static bool configured = false;
    const cudaError_t e = allow_shared(flash_dkv_kernel<DP, kDrop>,
                                       BwdTile<DP>::dkv_bytes, &configured);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(static_cast<unsigned>(a.bh),
                    static_cast<unsigned>((a.L + kBK - 1) / kBK));
    flash_dkv_kernel<DP, kDrop>
        <<<grid, kThreads, BwdTile<DP>::dkv_bytes, a.stream>>>(
            static_cast<const float*>(a.q), static_cast<const float*>(a.k),
            static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
            a.lse, a.delta, a.bias, static_cast<float*>(a.dk),
            static_cast<float*>(a.dv), a.L, a.d, a.H, a.s, a.gs, a.scale,
            a.causal, a.drop);
    return static_cast<int>(cudaGetLastError());
}

template <int DP, bool kDrop>
int launch_dq_mma(const BwdArgs& a) {
    // Q, dO, kDqStages stages of K and of V (bf16)
    constexpr size_t bytes = sizeof(bf16) * (2 + 2 * kDqStages) * kBK * DP;
    static bool configured = false;
    const cudaError_t e = allow_shared(flash_dq_mma_kernel<DP, kDrop>, bytes,
                                       &configured);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t strides[3] = {a.s.b, a.s.h, a.s.l};
    const int64_t gstrides[3] = {a.gs.b, a.gs.h, a.gs.l};
    const int vec = chunks_of_16<bf16>(a.d, strides, {a.q, a.k, a.v, a.dq});
    const int gvec = chunks_of_16<bf16>(a.d, gstrides, {a.dout});
    const dim3 grid(static_cast<unsigned>(a.bh),
                    static_cast<unsigned>((a.L + kBQ - 1) / kBQ));
    flash_dq_mma_kernel<DP, kDrop><<<grid, kThreads, bytes, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        a.lse, a.delta, a.bias, static_cast<bf16*>(a.dq), a.L, a.d, a.H, a.s,
        a.gs, a.scale, a.causal, vec, gvec, a.drop);
    return static_cast<int>(cudaGetLastError());
}

template <int DP, bool kDrop>
int launch_dkv_mma(const BwdArgs& a) {
    // K, V, kDkvStages stages of Q and dO (bf16) and of lse and delta (fp32)
    constexpr size_t bytes =
        sizeof(bf16) * (2 + 2 * kDkvStages) * kBQ * DP +
        sizeof(float) * 2 * kDkvStages * kBQ;
    static bool configured = false;
    const cudaError_t e = allow_shared(flash_dkv_mma_kernel<DP, kDrop>,
                                       bytes, &configured);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t strides[3] = {a.s.b, a.s.h, a.s.l};
    const int64_t gstrides[3] = {a.gs.b, a.gs.h, a.gs.l};
    const int vec =
        chunks_of_16<bf16>(a.d, strides, {a.q, a.k, a.v, a.dk, a.dv});
    const int gvec = chunks_of_16<bf16>(a.d, gstrides, {a.dout});
    const dim3 grid(static_cast<unsigned>(a.bh),
                    static_cast<unsigned>((a.L + kBK - 1) / kBK));
    flash_dkv_mma_kernel<DP, kDrop><<<grid, kThreads, bytes, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        a.lse, a.delta, a.bias, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.L, a.d, a.H, a.s, a.gs, a.scale, a.causal,
        vec, gvec, a.drop);
    return static_cast<int>(cudaGetLastError());
}

// one kernel at one padded head dim: bf16 on the tensor cores (`kMma`),
// fp32 on the FMA pipes
template <bool kMma, bool kDkv, int DP>
int launch_one(const BwdArgs& a) {
    const bool dropout = a.drop.scale != 1.f;
    if constexpr (kMma && kDkv)
        return dropout ? launch_dkv_mma<DP, true>(a)
                       : launch_dkv_mma<DP, false>(a);
    else if constexpr (kMma)
        return dropout ? launch_dq_mma<DP, true>(a)
                       : launch_dq_mma<DP, false>(a);
    else if constexpr (kDkv)
        return dropout ? launch_dkv<DP, true>(a) : launch_dkv<DP, false>(a);
    else
        return dropout ? launch_dq<DP, true>(a) : launch_dq<DP, false>(a);
}

// the head dim padded to 32 (FMA only), 64 or 128
template <bool kMma, bool kDkv>
int dispatch_dim(const BwdArgs& a) {
    if constexpr (!kMma)
        if (a.d <= 32) return launch_one<false, kDkv, 32>(a);
    if (a.d <= 64) return launch_one<kMma, kDkv, 64>(a);
    if (a.d <= 128) return launch_one<kMma, kDkv, 128>(a);
    return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kDkv>
int dispatch(const BwdArgs& a, int dtype) {
    if (a.bh <= 0 || a.bh > 0x7fffffff || a.L <= 0 ||
        (a.L + kBQ - 1) / kBQ > 65535 || a.d <= 0 || a.H <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == kF32) return dispatch_dim<false, kDkv>(a);
    if (dtype == kBF16) return dispatch_dim<true, kDkv>(a);
    return static_cast<int>(cudaErrorInvalidValue);
}

BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  const void* bias, void* dq, void* dk, void* dv, int64_t bh,
                  int64_t L, int64_t d, int64_t H, const int64_t* strides,
                  float scale, int causal, uint64_t seed, uint64_t offset,
                  uint32_t threshold, float drop_scale, void* stream) {
    const auto f = [](const void* p) { return static_cast<const float*>(p); };
    return BwdArgs{q, k, v, dout, f(lse), f(delta), f(bias),
                   dq, dk, dv, bh, static_cast<int>(L),
                   static_cast<int>(d), static_cast<int>(H),
                   Strides{strides[0], strides[1], strides[2]},
                   Strides{strides[3], strides[4], strides[5]}, scale, causal,
                   DropoutArgs{seed, offset, threshold, drop_scale},
                   static_cast<cudaStream_t>(stream)};
}

}  // namespace

// q, k, v, dq: (B, H, L, D), fp32 (dtype kF32) or bf16 (kBF16), with
// shared strides (sb, sh, sl); dO, in the same dtype, with its own (gsb,
// gsh, gsl); every head dim contiguous; bh = B * H. lse, delta: (B*H, L)
// contiguous fp32. bias: (B, L) contiguous fp32 or null.
// D <= 128. Dropout is on iff drop_scale != 1. Returns cudaGetLastError()
// after the launch.
extern "C" int ptt_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dq,
    int64_t bh, int64_t L, int64_t d, int64_t H, int64_t sb, int64_t sh,
    int64_t sl, int64_t gsb, int64_t gsh, int64_t gsl, float scale,
    int causal, uint64_t seed, uint64_t offset, uint32_t threshold,
    float drop_scale, int dtype, void* stream) {
    if (L > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t strides[6] = {sb, sh, sl, gsb, gsh, gsl};
    return dispatch<false>(make_args(q, k, v, dout, lse, delta, bias, dq,
                                     nullptr, nullptr, bh, L, d, H, strides,
                                     scale, causal, seed, offset, threshold,
                                     drop_scale, stream),
                           dtype);
}

// As ptt_flash_attention_dq, writing dk and dv (strides of q, k, v).
extern "C" int ptt_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dk, void* dv,
    int64_t bh, int64_t L, int64_t d, int64_t H, int64_t sb, int64_t sh,
    int64_t sl, int64_t gsb, int64_t gsh, int64_t gsl, float scale,
    int causal, uint64_t seed, uint64_t offset, uint32_t threshold,
    float drop_scale, int dtype, void* stream) {
    if (L > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t strides[6] = {sb, sh, sl, gsb, gsh, gsl};
    return dispatch<true>(make_args(q, k, v, dout, lse, delta, bias, nullptr,
                                    dk, dv, bh, L, d, H, strides, scale,
                                    causal, seed, offset, threshold,
                                    drop_scale, stream),
                          dtype);
}
