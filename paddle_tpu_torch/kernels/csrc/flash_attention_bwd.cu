// Flash attention backward, fp32, bf16 or fp16: dQ, and dK/dV, from (q, k,
// v, dO, lse, delta) with delta = rowsum(dO * O). Neither stores an (L, L)
// matrix: each rebuilds P = exp(S - lse) tile by tile, with
//   dP = dO V^T (times keep / (1 - p) under dropout),
//   dS = P * (dP - delta),
//   dQ = scale * dS K,   dK = scale * dS^T Q,   dV = (P * keep/(1-p))^T dO.
//
// Replaces: paddle_tpu/kernels/flash_attention.py, _dq_kernel (the dQ
// kernels) and _dkv_kernel (the dK/dV kernels), both launched by
// _flash_backward. S is rebuilt as the forward built it, by the same
// function (fragment_scores in flash_common.cuh: dot * scale, then + the
// key-padding bias, in natural units; -inf above the causal diagonal and
// past L), and P = exp(S - lse) is one ex2 of (S - lse) * log2(e), S - lse
// exact next to the forward's large biases. The dropout mask comes from
// philox.cuh keyed on the element (bh, query row, key column), so both
// kernels see the forward's bits although they walk the matrix in other
// orders. A row whose every key was -inf has lse = 1e30: its P is 0 and all
// its gradients are 0, never NaN. The bias gets no gradient. dQ and dK are
// scaled once at the end, as the reference scales them. One block owns a
// query tile (dQ) or a key tile (dK/dV): no atomics, every result is
// deterministic.
//
// Four kernels, all on the tensor cores: mma.sync m16n8k16 at bf16 and fp16
// (one template, flash_*_mma_kernel<T>), 3xTF32 m16n8k8 at fp32. Grid (B*H,
// ceil(L/64)), 4 warps of 16 fragment rows: in dQ the rows are queries, as in
// the forward, and K/V tiles of 64 keys stream through a two-stage cp.async
// ring (the TPU kernel's sequential grid axis is this loop, up to the diagonal
// tile when causal); in dK/dV the rows are keys, K and V stay resident and Q,
// dO, lse and delta tiles stream through a ring from the diagonal on when
// causal. S (S^T) and dP (dP^T) come out of the tensor cores as fp32
// fragments, P and dS are formed on them, and the fragments are directly the A
// operands of the next products (dQ += dS K; dV += P^T dO, dK += dS^T Q): P
// and dS never go through shared memory and a tile needs one barrier. Under
// dropout each lane makes one Philox call per four probabilities when
// L % 4 == 0 (fragment_keep with queries as rows, fragment_keep_t with keys
// as rows).
// Ragged edges as the forward's (cp.async zero fill, masks only on edge tiles,
// element loads when a row is not whole 16-byte chunks); rows past L load lse
// = 1e30 and store nothing; the head dim is padded to 64 or 128.
//
// At bf16 q/k/v/dO are read as bf16 (their products are exact in fp32) and
// lse, delta and every accumulator stay fp32; P (dropped) and dS are
// rounded to bf16 before the dV, dQ and dK products, where the reference
// casts them to the input dtype (flash_attention.py:254, :316, :319);
// dq/dk/dv are stored in bf16. fp16 alike: a dS past 65504 (a scaled loss's
// gradient) rounds to inf there, as the reference's cast does, and a loss
// scaler then skips the step.
//
// flash_dkv_mma_kernel (dK/dV at bf16). Bound on the H100: four products
// (S, dP, P^T dO, dS^T Q), 8 L^2 D flops a head, against 12 L D bytes (q,
// k, v, dO read, dk, dv written, bf16) and 8 L of lse and delta: 340 flops
// a byte at L = 512, D = 64, above the 295 flop/byte ridge, so the tensor
// cores bound it. Bf16 tiles with the XOR swizzle of tensor_core.cuh; K's
// and V's A fragments and Q's and dO's B fragments by ldmatrix, dO and Q
// again with ldmatrix.trans for the two transposed products, ~0.56
// ldmatrix a product; a three-stage ring. At D = 64 without dropout the
// registers are capped for three blocks an SM (a few bytes spill), which
// measured faster than two; 67 KB of shared memory at D = 64, 133 KB at
// D = 128.
//
// flash_dq_mma_kernel (dQ at bf16). Three products (S, dP, dS K), 6 L^2 D
// flops a head, against 10 L D bytes and 8 L of lse and delta: 303 flops a
// byte at L = 512, D = 64, just above the ridge, so the tensor cores bound
// it. Q's and dO's A fragments stay in registers; K is read a second time
// through ldmatrix.trans for dS K. 48 KB of shared memory at D = 64.
//
// At fp32, flash_dq_tf32_kernel and flash_dkv_tf32_kernel. dQ is 6 L^2 D
// flops a head against 20 L D bytes (fp32) and 8 L: 154 flops a byte at
// L = 512, D = 64; dK/dV 8 L^2 D against 24 L D and 8 L: 170. Both are above
// the 148 flop/byte ridge of the TF32 tensor cores (495 TFLOP/s over 3.35
// TB/s), so operations bound them, and on the FMA pipes (67 TFLOP/s) they
// would take 7x that bound. The fp32 gates (dq, dk, dv within 1e-3 of each
// gradient's max; P rebuilt from the forward's lse) rule out a single TF32
// product, which would move a score by ~2^-11 |s| and P with it, so every
// product is 3xTF32 (mma_3xtf32 in tensor_core.cuh; the fp32 forward's
// note in flash_attention.cu says why that keeps fp32's accuracy;
// tests/test_torch_tf32x3.py emulates all five products against the gate).
// Their tiles are the fp32 forward's: fp32 rows padded to 68 or 132 floats
// (f32_stride), ldmatrix for the fragments read along a row and 32-bit
// loads for those read down a column, all free of bank conflicts, and
// every fragment split into hi/lo in registers as it is loaded. No split
// fragment stays resident, as that would leave no registers: Q's and dO's
// (dQ), K's and V's (dK/dV) A fragments are read again and split for every
// tile.
// - flash_dq_tf32_kernel: Q and dO resident in shared memory. S = Q K^T
//   and dP = dO V^T take K's and V's B fragments by ldmatrix; dS, an
//   accumulator fragment, is the A operand of dQ += dS K with its keys
//   permuted inside each k8 block (tensor_core.cuh), so K's B fragment is
//   read down a column, as V's is in the forward's P.V. 102 KB of shared
//   memory at D = 64 (two blocks an SM), 198 KB at D = 128.
// - flash_dkv_tf32_kernel: S^T = K Q^T and dP^T = V dO^T take Q's and dO's
//   B fragments by ldmatrix; P^T and dS^T are the A operands of dV += P^T dO
//   and dK += dS^T Q, dO and Q read down a column. The two fp32
//   accumulators take 4 D registers a thread, so a query tile is 64 rows
//   only at D = 64 without dropout, else 32 (dkv_tf32_rows says why); a
//   two-stage ring; 103 KB of shared memory at D = 64 (69 KB under
//   dropout), 133 KB at D = 128.
#include <cstdint>
#include <type_traits>

#include "dtype.cuh"
#include "flash_common.cuh"
#include "philox.cuh"
#include "tensor_core.cuh"

namespace {

struct Strides {
    int64_t b, h, l;   // elements; the head dim is contiguous
};

// dK/dV at bf16 on the tensor cores, keys as the fragment rows. q, k, v,
// dk and dv share strides `s`, dO has `gs`; `vec` / `gvec`: their rows are
// whole 16-byte chunks. 4 warps; warp w owns keys 16 w .. 16 w + 15 of the
// block's 64 against each 64-query tile: S^T = K Q^T and dP^T = V dO^T as
// fp32 fragments, then P^T and dS^T, converted in registers, are the A
// operands of dV += P^T dO and dK += dS^T Q (dO and Q read with
// ldmatrix.trans): no trip through shared memory.
constexpr int kDkvStages = 3;

template <typename T, int DP, bool kDrop>
__global__ void __launch_bounds__(kThreads, DP == 64 && !kDrop ? 3 : 1)
flash_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ bias, T* __restrict__ dk,
                     T* __restrict__ dv, int L, int d, int H, Strides s,
                     Strides gs, float scale, int causal, int vec, int gvec,
                     DropoutArgs drop) {
    constexpr int kTile = kBQ * DP;     // elements of a Q/dO/K/V tile
    constexpr int kSteps = DP / 16;     // k-steps of S^T and dP^T
    constexpr int kQN = kBQ / 8;        // n-tiles of S^T over the queries
    constexpr int kOutN = DP / 8;       // n-tiles of dK and dV
    static_assert(kBK == 16 * (kThreads / 32), "a warp owns 16 keys");
    extern __shared__ __align__(128) unsigned char smem_raw[];
    T* sk = reinterpret_cast<T*>(smem_raw);
    T* sv = sk + kTile;
    T* sq = sv + kTile;                  // kDkvStages stages
    T* sdo = sq + kDkvStages * kTile;    // kDkvStages stages
    float* slse = reinterpret_cast<float*>(sdo + kDkvStages * kTile);
    float* sdelta = slse + kDkvStages * kBQ;

    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    [[maybe_unused]] const int mbh = mask_bh(drop, b, h, bh);   // the mask's row
    const int k0 = blockIdx.y * kBK;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int kr = k0 + 16 * warp + g;   // the lane's keys: kr and kr + 8
    const int64_t base = b * s.b + h * s.h;
    const int64_t gbase = b * gs.b + h * gs.h;
    const int64_t stat = static_cast<int64_t>(bh) * L;
    // the key-padding bias of the lane's two keys
    float kb[2];
    key_bias(bias != nullptr ? bias + static_cast<int64_t>(b) * L : nullptr,
             kr, 8, L, kb);

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
        const T* sqt = sq + st * kTile;
        const T* sdot = sdo + st * kTile;
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
                mma_16816<T>(sc[2 * np], ka, qb[0], qb[1]);
                mma_16816<T>(sc[2 * np + 1], ka, qb[2], qb[3]);
                mma_16816<T>(dp[2 * np], va, gb[0], gb[1]);
                mma_16816<T>(dp[2 * np + 1], va, gb[2], gb[3]);
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
            const float lq2[2] = {qc < L ? lq.x : kLseEmpty,
                                  qc + 1 < L ? lq.y : kLseEmpty};
            const float dl[2] = {dq.x, dq.y};
            float ks[4];
            if (kDrop) fragment_keep_t(drop, mbh, kr, qc, L, lane, ks);
            fragment_scores<true>(sc[n], scale, kb, kr, qc, L, causal,
                                  edge);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = ex2((sc[n][e] - lq2[e & 1]) * kLog2e);
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
            pa[0] = pack16<T>(sc[2 * kq][0], sc[2 * kq][1]);
            pa[1] = pack16<T>(sc[2 * kq][2], sc[2 * kq][3]);
            pa[2] = pack16<T>(sc[2 * kq + 1][0], sc[2 * kq + 1][1]);
            pa[3] = pack16<T>(sc[2 * kq + 1][2], sc[2 * kq + 1][3]);
            da[0] = pack16<T>(dp[2 * kq][0], dp[2 * kq][1]);
            da[1] = pack16<T>(dp[2 * kq][2], dp[2 * kq][3]);
            da[2] = pack16<T>(dp[2 * kq + 1][0], dp[2 * kq + 1][1]);
            da[3] = pack16<T>(dp[2 * kq + 1][2], dp[2 * kq + 1][3]);
#pragma unroll
            for (int np = 0; np < kOutN / 2; ++np) {
                uint32_t gb[4], qb[4];
                const int at = swz<DP>(
                    kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                    np * 16 + (lane >> 4) * 8);
                ldmatrix_x4_trans(gb, sdot + at);
                ldmatrix_x4_trans(qb, sqt + at);
                mma_16816<T>(acc_v[2 * np], pa, gb[0], gb[1]);
                mma_16816<T>(acc_v[2 * np + 1], pa, gb[2], gb[3]);
                mma_16816<T>(acc_k[2 * np], da, qb[0], qb[1]);
                mma_16816<T>(acc_k[2 * np + 1], da, qb[2], qb[3]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int key = kr + 8 * i;
        if (key >= L) continue;
        T* dkrow = dk + base + key * s.l;
        T* dvrow = dv + base + key * s.l;
#pragma unroll
        for (int n = 0; n < kOutN; ++n) {
            const int col = 8 * n + 2 * t4;
            const float k0v = acc_k[n][2 * i] * scale;
            const float k1v = acc_k[n][2 * i + 1] * scale;
            const float v0v = acc_v[n][2 * i], v1v = acc_v[n][2 * i + 1];
            if (vec) {
                if (col < d) {
                    *reinterpret_cast<uint32_t*>(dkrow + col) =
                        pack16<T>(k0v, k1v);
                    *reinterpret_cast<uint32_t*>(dvrow + col) =
                        pack16<T>(v0v, v1v);
                }
            } else {
                if (col < d) {
                    dkrow[col] = from_f32<T>(k0v);
                    dvrow[col] = from_f32<T>(v0v);
                }
                if (col + 1 < d) {
                    dkrow[col + 1] = from_f32<T>(k1v);
                    dvrow[col + 1] = from_f32<T>(v1v);
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

template <typename T, int DP, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ bias, T* __restrict__ dq,
                    int L, int d, int H, Strides s, Strides gs, float scale,
                    int causal, int vec, int gvec, DropoutArgs drop) {
    constexpr int kTile = kBK * DP;     // elements of a Q/dO/K/V tile
    constexpr int kSteps = DP / 16;     // k-steps of S and dP
    constexpr int kKeyN = kBK / 8;      // n-tiles of S over the keys
    constexpr int kOutN = DP / 8;       // n-tiles of dQ
    static_assert(kBQ == 16 * (kThreads / 32), "a warp owns 16 rows");
    extern __shared__ __align__(128) unsigned char smem_raw[];
    T* sq = reinterpret_cast<T*>(smem_raw);
    T* sdo = sq + kTile;
    T* sk = sdo + kTile;                 // kDqStages stages
    T* sv = sk + kDqStages * kTile;      // kDqStages stages

    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    [[maybe_unused]] const int mbh = mask_bh(drop, b, h, bh);   // the mask's row
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

    // the lane's two rows' lse and delta; a row past L has lse = 1e30, so
    // its P is 0
    float lr[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = qr + 8 * i;
        lr[i] = row < L ? lse[stat + row] : kLseEmpty;
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
        const T* skt = sk + (t % kDqStages) * kTile;
        const T* svt = sv + (t % kDqStages) * kTile;

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
                mma_16816<T>(sc[2 * np], qf[st], kb[0], kb[1]);
                mma_16816<T>(sc[2 * np + 1], qf[st], kb[2], kb[3]);
                mma_16816<T>(dp[2 * np], gf[st], vb[0], vb[1]);
                mma_16816<T>(dp[2 * np + 1], gf[st], vb[2], vb[3]);
            }

        // P = exp(S - lse) and dS = P (dP keep/(1-p) - delta), in place of
        // S; only a tile reaching past L or above the warp's diagonal needs
        // the masks
        const bool edge =
            k0 + kBK > L || (causal && k0 + kBK - 1 > q0 + r0);
#pragma unroll
        for (int n = 0; n < kKeyN; ++n) {
            const int kc = k0 + 8 * n + 2 * t4;
            float kb[2];
            key_bias(bias_row, kc, 1, L, kb);
            fragment_scores<false>(sc[n], scale, kb, qr, kc, L, causal,
                                   edge);
            float ks[4];
            if (kDrop) fragment_keep(drop, mbh, qr, kc, L, lane, ks);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = ex2((sc[n][e] - lr[e >> 1]) * kLog2e);
                const float dpe = kDrop ? dp[n][e] * ks[e] : dp[n][e];
                sc[n][e] = p * (dpe - dl[e >> 1]);
            }
        }

        // dQ += dS K: dS's fragments, rounded to bf16 (the reference's
        // cast), are the A operand, two n-tiles (16 keys) a k-step
#pragma unroll
        for (int kq = 0; kq < kBK / 16; ++kq) {
            uint32_t da[4];
            da[0] = pack16<T>(sc[2 * kq][0], sc[2 * kq][1]);
            da[1] = pack16<T>(sc[2 * kq][2], sc[2 * kq][3]);
            da[2] = pack16<T>(sc[2 * kq + 1][0], sc[2 * kq + 1][1]);
            da[3] = pack16<T>(sc[2 * kq + 1][2], sc[2 * kq + 1][3]);
#pragma unroll
            for (int np = 0; np < kOutN / 2; ++np) {
                uint32_t kb[4];
                ldmatrix_x4_trans(kb, skt + swz<DP>(
                    kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                    np * 16 + (lane >> 4) * 8));
                mma_16816<T>(acc[2 * np], da, kb[0], kb[1]);
                mma_16816<T>(acc[2 * np + 1], da, kb[2], kb[3]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = qr + 8 * i;
        if (row >= L) continue;
        T* dqrow = dq + base + row * s.l;
#pragma unroll
        for (int n = 0; n < kOutN; ++n) {
            const int col = 8 * n + 2 * t4;
            const float v0 = acc[n][2 * i] * scale;
            const float v1 = acc[n][2 * i + 1] * scale;
            if (vec) {
                if (col < d)
                    *reinterpret_cast<uint32_t*>(dqrow + col) =
                        pack16<T>(v0, v1);
            } else {
                if (col < d) dqrow[col] = from_f32<T>(v0);
                if (col + 1 < d) dqrow[col + 1] = from_f32<T>(v1);
            }
        }
    }
}


// dQ at fp32 on the tensor cores (3xTF32), queries as the fragment rows.
// q, k, v and dq share strides `s`, dO has `gs`; `vec` / `gvec`: their rows
// are whole 16-byte chunks (chunks_of_16<float>). 4 warps; warp w owns
// query rows 16 w .. 16 w + 15 of the block's 64 against each 64-key K/V
// tile of a kDqStages-deep cp.async ring. The registers are capped for two
// blocks an SM, as many as its shared memory holds at DP = 64: ptxas would
// otherwise take fewer and starve the Philox work under dropout (PERF.md).
template <int DP, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
flash_dq_tf32_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ bias, float* __restrict__ dq,
                     int L, int d, int H, Strides s, Strides gs, float scale,
                     int causal, int vec, int gvec, DropoutArgs drop) {
    constexpr int kS = f32_stride(DP);  // floats a shared row
    constexpr int kTile = kBK * kS;     // floats of a Q/dO/K/V tile
    constexpr int kSteps = DP / 8;      // k-steps of S and dP
    constexpr int kKeyN = kBK / 8;      // n-tiles of S over the keys
    constexpr int kOutN = DP / 8;       // n-tiles of dQ
    static_assert(kBQ == kBK && kBQ == 16 * (kThreads / 32),
                  "a warp owns 16 rows");
    extern __shared__ __align__(128) unsigned char smem_raw[];
    float* sq = reinterpret_cast<float*>(smem_raw);
    float* sdo = sq + kTile;
    float* sk = sdo + kTile;                // kDqStages stages
    float* sv = sk + kDqStages * kTile;     // kDqStages stages

    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    [[maybe_unused]] const int mbh = mask_bh(drop, b, h, bh);   // the mask's row
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

    int n_tiles = (L + kBK - 1) / kBK;
    if (causal) n_tiles = min(n_tiles, (min(q0 + kBQ, L) - 1) / kBK + 1);

    // K/V tile t into stage t % kDqStages, as one commit group (empty past
    // the last tile, so that every iteration waits for the same count)
    const auto load_keys = [&](int t) {
        if (t < n_tiles) {
            const int at = (t % kDqStages) * kTile;
            load_rows_f32<kBK, DP, kThreads>(sk + at, k, base, s.l, t * kBK,
                                             L, d, vec);
            load_rows_f32<kBK, DP, kThreads>(sv + at, v, base, s.l, t * kBK,
                                             L, d, vec);
        }
        cp_async_commit();
    };
    load_rows_f32<kBQ, DP, kThreads>(sq, q, base, s.l, q0, L, d, vec);
    load_rows_f32<kBQ, DP, kThreads>(sdo, dout, gbase, gs.l, q0, L, d, gvec);
    cp_async_commit();
#pragma unroll
    for (int t = 0; t < kDqStages - 1; ++t) load_keys(t);

    // the lane's two rows' lse and delta; a row past L has lse = 1e30, so
    // its P is 0
    float lr[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = qr + 8 * i;
        lr[i] = row < L ? lse[stat + row] : kLseEmpty;
        dl[i] = row < L ? delta[stat + row] : 0.f;
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
        const float* skt = sk + (t % kDqStages) * kTile;
        const float* svt = sv + (t % kDqStages) * kTile;

        // S = Q K^T and dP = dO V^T, 3xTF32: keys 8n .. 8n + 7 as n-tile n
        float sc[kKeyN][4], dp[kKeyN][4];
#pragma unroll
        for (int n = 0; n < kKeyN; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
            uint32_t ah[4], al[4], bh_[kKeyN][2], bl[kKeyN][2];
            a_frag_tf32(sq, kS, r0, 8 * st, ah, al);
            b_frags_tf32<kKeyN>(skt, kS, 8 * st, bh_, bl);
            mma_3xtf32<kKeyN>(sc, ah, al, bh_, bl);
            a_frag_tf32(sdo, kS, r0, 8 * st, ah, al);
            b_frags_tf32<kKeyN>(svt, kS, 8 * st, bh_, bl);
            mma_3xtf32<kKeyN>(dp, ah, al, bh_, bl);
        }

        // P = exp(S - lse) and dS = P (dP keep/(1-p) - delta), in place of
        // S; only a tile reaching past L or above the warp's diagonal needs
        // the masks
        const bool edge =
            k0 + kBK > L || (causal && k0 + kBK - 1 > q0 + r0);
#pragma unroll
        for (int n = 0; n < kKeyN; ++n) {
            const int kc = k0 + 8 * n + 2 * t4;
            float kb[2];
            key_bias(bias_row, kc, 1, L, kb);
            fragment_scores<false>(sc[n], scale, kb, qr, kc, L, causal,
                                   edge);
            float ks[4];
            if (kDrop) fragment_keep(drop, mbh, qr, kc, L, lane, ks);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = ex2((sc[n][e] - lr[e >> 1]) * kLog2e);
                const float dpe = kDrop ? dp[n][e] * ks[e] : dp[n][e];
                sc[n][e] = p * (dpe - dl[e >> 1]);
            }
        }

        // dQ += dS K, 3xTF32, one k-step per n-tile j of dS (keys 8j ..
        // 8j + 7) with its keys permuted, K's B fragment read down a column;
        // eight output n-tiles at a time
#pragma unroll
        for (int j = 0; j < kKeyN; ++j) {
            uint32_t ah[4], al[4];
            c_as_a_tf32(sc[j], ah, al);
#pragma unroll
            for (int n0 = 0; n0 < kOutN; n0 += 8) {
                uint32_t kh[8][2], kl[8][2];
                b_frags_col_tf32<8>(skt, kS, 8 * j, 8 * n0, kh, kl);
                mma_3xtf32<8>(acc + n0, ah, al, kh, kl);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = qr + 8 * i;
        if (row >= L) continue;
        float* dqrow = dq + base + row * s.l;
#pragma unroll
        for (int n = 0; n < kOutN; ++n) {
            const int col = 8 * n + 2 * t4;
            const float v0 = acc[n][2 * i] * scale;
            const float v1 = acc[n][2 * i + 1] * scale;
            if (vec) {
                if (col < d)
                    *reinterpret_cast<float2*>(dqrow + col) =
                        make_float2(v0, v1);
            } else {
                if (col < d) dqrow[col] = v0;
                if (col + 1 < d) dqrow[col + 1] = v1;
            }
        }
    }
}

// dK/dV at fp32 on the tensor cores (3xTF32), keys as the fragment rows.
// Strides as flash_dq_tf32_kernel's. 4 warps; warp w owns keys 16 w .. 16 w
// + 15 of the block's 64 against each tile of dkv_tf32_rows queries of a
// kDkvTf32Stages-deep cp.async ring.
constexpr int kDkvTf32Stages = 2;

// Queries a tile: the two fp32 accumulators take 4 DP registers a thread,
// S^T and dP^T 16 a query; 64 queries only at DP = 64 without dropout. At
// 64 queries under dropout the Philox work finds no registers left beside
// them and takes most of the kernel's time (PERF.md).
__host__ __device__ constexpr int dkv_tf32_rows(int DP, bool drop) {
    return DP <= 64 && !drop ? 64 : 32;
}

template <int DP, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_dkv_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ bias, float* __restrict__ dk,
                      float* __restrict__ dv, int L, int d, int H, Strides s,
                      Strides gs, float scale, int causal, int vec, int gvec,
                      DropoutArgs drop) {
    constexpr int kS = f32_stride(DP);     // floats a shared row
    constexpr int kQT = dkv_tf32_rows(DP, kDrop);   // queries a tile
    constexpr int kKTile = kBK * kS;       // floats of a K or V tile
    constexpr int kQTile = kQT * kS;       // floats of a Q or dO tile
    constexpr int kSteps = DP / 8;         // k-steps of S^T and dP^T
    constexpr int kQN = kQT / 8;           // n-tiles of S^T over the queries
    constexpr int kOutN = DP / 8;          // n-tiles of dK and dV
    static_assert(kBK == 16 * (kThreads / 32), "a warp owns 16 keys");
    static_assert(kBK % kQT == 0 && 2 * kQT <= kThreads,
                  "causal tiles start at k0; a thread copies one statistic");
    extern __shared__ __align__(128) unsigned char smem_raw[];
    float* sk = reinterpret_cast<float*>(smem_raw);
    float* sv = sk + kKTile;
    float* sq = sv + kKTile;                      // kDkvTf32Stages stages
    float* sdo = sq + kDkvTf32Stages * kQTile;    // kDkvTf32Stages stages
    float* slse = sdo + kDkvTf32Stages * kQTile;  // kDkvTf32Stages stages
    float* sdelta = slse + kDkvTf32Stages * kQT;  // kDkvTf32Stages stages

    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    [[maybe_unused]] const int mbh = mask_bh(drop, b, h, bh);   // the mask's row
    const int k0 = blockIdx.y * kBK;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int t4 = lane & 3;
    const int r0 = 16 * warp;            // the warp's first key in the tile
    const int kr = k0 + r0 + (lane >> 2);   // the lane's keys: kr, kr + 8
    const int64_t base = b * s.b + h * s.h;
    const int64_t gbase = b * gs.b + h * gs.h;
    const int64_t stat = static_cast<int64_t>(bh) * L;
    // the key-padding bias of the lane's two keys
    float kb[2];
    key_bias(bias != nullptr ? bias + static_cast<int64_t>(b) * L : nullptr,
             kr, 8, L, kb);

    // causal: query tiles above the diagonal see none of these keys
    const int t0 = causal ? k0 / kQT : 0;
    const int n_tiles = (L + kQT - 1) / kQT;
    // query tile t (Q, dO, lse, delta) into stage (t - t0) % kDkvTf32Stages,
    // as one commit group (empty past the last tile, so that every
    // iteration waits for the same count)
    const auto load_queries = [&](int t) {
        if (t < n_tiles) {
            const int st = (t - t0) % kDkvTf32Stages, q0 = t * kQT;
            load_rows_f32<kQT, DP, kThreads>(sq + st * kQTile, q, base, s.l,
                                             q0, L, d, vec);
            load_rows_f32<kQT, DP, kThreads>(sdo + st * kQTile, dout, gbase,
                                             gs.l, q0, L, d, gvec);
            if (threadIdx.x < 2 * kQT) {
                const int i = threadIdx.x % kQT;
                const bool is_lse = threadIdx.x < kQT;
                const bool ok = q0 + i < L;
                const float* src = is_lse ? lse : delta;
                cp_async4((is_lse ? slse : sdelta) + st * kQT + i,
                          ok ? src + stat + q0 + i : src, ok);
            }
        }
        cp_async_commit();
    };

    load_rows_f32<kBK, DP, kThreads>(sk, k, base, s.l, k0, L, d, vec);
    load_rows_f32<kBK, DP, kThreads>(sv, v, base, s.l, k0, L, d, vec);
    // K and V join the first query tile's group
#pragma unroll
    for (int i = 0; i < kDkvTf32Stages - 1; ++i) load_queries(t0 + i);

    float acc_k[kOutN][4], acc_v[kOutN][4];
#pragma unroll
    for (int n = 0; n < kOutN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

    for (int t = t0; t < n_tiles; ++t) {
        const int q0 = t * kQT;
        const int st = (t - t0) % kDkvTf32Stages;
        cp_async_wait<kDkvTf32Stages - 2>();   // tile t is in shared memory
        __syncthreads();   // for every thread, and tile t - 1's stage is free
        load_queries(t + kDkvTf32Stages - 1);
        const float* sqt = sq + st * kQTile;
        const float* sdot = sdo + st * kQTile;
        const float* slt = slse + st * kQT;
        const float* sdt = sdelta + st * kQT;

        // S^T = K Q^T and dP^T = V dO^T, 3xTF32: queries 8n .. 8n + 7 as
        // n-tile n
        float sc[kQN][4], dp[kQN][4];
#pragma unroll
        for (int n = 0; n < kQN; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
            uint32_t ah[4], al[4], bh_[kQN][2], bl[kQN][2];
            a_frag_tf32(sk, kS, r0, 8 * kk, ah, al);
            b_frags_tf32<kQN>(sqt, kS, 8 * kk, bh_, bl);
            mma_3xtf32<kQN>(sc, ah, al, bh_, bl);
            a_frag_tf32(sv, kS, r0, 8 * kk, ah, al);
            b_frags_tf32<kQN>(sdot, kS, 8 * kk, bh_, bl);
            mma_3xtf32<kQN>(dp, ah, al, bh_, bl);
        }

        // P^T = exp(S^T - lse) and dS^T = P^T (dP^T keep/(1-p) - delta),
        // in place of S^T and dP^T; only a key tile reaching past L or a
        // tile above the diagonal needs the masks
        const bool edge = k0 + kBK > L || (causal && k0 + r0 + 15 > q0);
#pragma unroll
        for (int n = 0; n < kQN; ++n) {
            const int qi = 8 * n + 2 * t4;   // query in the tile: qi, qi + 1
            const int qc = q0 + qi;
            const float2 lq = *reinterpret_cast<const float2*>(slt + qi);
            const float2 dq = *reinterpret_cast<const float2*>(sdt + qi);
            // a query past L has lse = 1e30, so its P is 0
            const float lq2[2] = {qc < L ? lq.x : kLseEmpty,
                                  qc + 1 < L ? lq.y : kLseEmpty};
            const float dl[2] = {dq.x, dq.y};
            float ks[4];
            if (kDrop) fragment_keep_t(drop, mbh, kr, qc, L, lane, ks);
            fragment_scores<true>(sc[n], scale, kb, kr, qc, L, causal,
                                  edge);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = ex2((sc[n][e] - lq2[e & 1]) * kLog2e);
                const float dpe = kDrop ? dp[n][e] * ks[e] : dp[n][e];
                sc[n][e] = kDrop ? p * ks[e] : p;
                dp[n][e] = p * (dpe - dl[e & 1]);
            }
        }

        // dV += (P keep)^T dO and dK += dS^T Q, 3xTF32, one k-step per
        // n-tile j (queries 8j .. 8j + 7) with its queries permuted, dO's
        // and Q's B fragments read down a column; eight output n-tiles at a
        // time
#pragma unroll
        for (int j = 0; j < kQN; ++j) {
            uint32_t ph[4], pl[4], dh[4], dlo[4];
            c_as_a_tf32(sc[j], ph, pl);
            c_as_a_tf32(dp[j], dh, dlo);
#pragma unroll
            for (int n0 = 0; n0 < kOutN; n0 += 8) {
                uint32_t bh_[8][2], bl[8][2];
                b_frags_col_tf32<8>(sdot, kS, 8 * j, 8 * n0, bh_, bl);
                mma_3xtf32<8>(acc_v + n0, ph, pl, bh_, bl);
                b_frags_col_tf32<8>(sqt, kS, 8 * j, 8 * n0, bh_, bl);
                mma_3xtf32<8>(acc_k + n0, dh, dlo, bh_, bl);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int key = kr + 8 * i;
        if (key >= L) continue;
        float* dkrow = dk + base + key * s.l;
        float* dvrow = dv + base + key * s.l;
#pragma unroll
        for (int n = 0; n < kOutN; ++n) {
            const int col = 8 * n + 2 * t4;
            const float k0v = acc_k[n][2 * i] * scale;
            const float k1v = acc_k[n][2 * i + 1] * scale;
            const float v0v = acc_v[n][2 * i], v1v = acc_v[n][2 * i + 1];
            if (vec) {
                if (col < d) {
                    *reinterpret_cast<float2*>(dkrow + col) =
                        make_float2(k0v, k1v);
                    *reinterpret_cast<float2*>(dvrow + col) =
                        make_float2(v0v, v1v);
                }
            } else {
                if (col < d) {
                    dkrow[col] = k0v;
                    dvrow[col] = v0v;
                }
                if (col + 1 < d) {
                    dkrow[col + 1] = k1v;
                    dvrow[col + 1] = v1v;
                }
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

// The dQ kernel of element type T (bf16: mma.sync m16n8k16; fp32: 3xTF32)
// at padded head dim DP
template <typename T, int DP, bool kDrop>
int launch_dq(const BwdArgs& a) {
    constexpr bool kF32 = std::is_same_v<T, float>;
    // Q, dO, kDqStages stages of K and of V: bf16 rows, or fp32 rows padded
    // to f32_stride
    constexpr size_t bytes =
        sizeof(T) * (2 + 2 * kDqStages) * kBK * (kF32 ? f32_stride(DP) : DP);
    const auto kernel = [] {
        if constexpr (kF32)
            return flash_dq_tf32_kernel<DP, kDrop>;
        else
            return flash_dq_mma_kernel<T, DP, kDrop>;
    }();
    static bool configured = false;
    const cudaError_t e = allow_shared(kernel, bytes, &configured);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t strides[3] = {a.s.b, a.s.h, a.s.l};
    const int64_t gstrides[3] = {a.gs.b, a.gs.h, a.gs.l};
    const int vec = chunks_of_16<T>(a.d, strides, {a.q, a.k, a.v, a.dq});
    const int gvec = chunks_of_16<T>(a.d, gstrides, {a.dout});
    const dim3 grid(static_cast<unsigned>(a.bh),
                    static_cast<unsigned>((a.L + kBQ - 1) / kBQ));
    kernel<<<grid, kThreads, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
        a.delta, a.bias, static_cast<T*>(a.dq), a.L, a.d, a.H, a.s, a.gs,
        a.scale, a.causal, vec, gvec, a.drop);
    return static_cast<int>(cudaGetLastError());
}

// The dK/dV kernel of element type T, as launch_dq
template <typename T, int DP, bool kDrop>
int launch_dkv(const BwdArgs& a) {
    constexpr bool kF32 = std::is_same_v<T, float>;
    // K, V, and the ring's stages of Q and dO (T) and of lse and delta
    // (fp32): bf16 rows of kBQ queries, or fp32 rows of dkv_tf32_rows
    // queries padded to f32_stride
    constexpr int stages = kF32 ? kDkvTf32Stages : kDkvStages;
    constexpr int rows = kF32 ? dkv_tf32_rows(DP, kDrop) : kBQ;
    constexpr size_t bytes =
        sizeof(T) * (2 * kBK + 2 * stages * rows) *
            (kF32 ? f32_stride(DP) : DP) +
        sizeof(float) * 2 * stages * rows;
    const auto kernel = [] {
        if constexpr (kF32)
            return flash_dkv_tf32_kernel<DP, kDrop>;
        else
            return flash_dkv_mma_kernel<T, DP, kDrop>;
    }();
    static bool configured = false;
    const cudaError_t e = allow_shared(kernel, bytes, &configured);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t strides[3] = {a.s.b, a.s.h, a.s.l};
    const int64_t gstrides[3] = {a.gs.b, a.gs.h, a.gs.l};
    const int vec =
        chunks_of_16<T>(a.d, strides, {a.q, a.k, a.v, a.dk, a.dv});
    const int gvec = chunks_of_16<T>(a.d, gstrides, {a.dout});
    const dim3 grid(static_cast<unsigned>(a.bh),
                    static_cast<unsigned>((a.L + kBK - 1) / kBK));
    kernel<<<grid, kThreads, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
        a.delta, a.bias, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.L,
        a.d, a.H, a.s, a.gs, a.scale, a.causal, vec, gvec, a.drop);
    return static_cast<int>(cudaGetLastError());
}

// one kernel of element type T at one padded head dim
template <typename T, bool kDkv, int DP>
int launch_one(const BwdArgs& a) {
    const bool dropout = a.drop.scale != 1.f;
    if constexpr (kDkv)
        return dropout ? launch_dkv<T, DP, true>(a)
                       : launch_dkv<T, DP, false>(a);
    else
        return dropout ? launch_dq<T, DP, true>(a)
                       : launch_dq<T, DP, false>(a);
}

// the head dim padded to 64 or 128
template <typename T, bool kDkv>
int dispatch_dim(const BwdArgs& a) {
    if (a.d <= 64) return launch_one<T, kDkv, 64>(a);
    if (a.d <= 128) return launch_one<T, kDkv, 128>(a);
    return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kDkv>
int dispatch(const BwdArgs& a, int dtype) {
    if (a.bh <= 0 || a.bh > 0x7fffffff || a.L <= 0 ||
        (a.L + kBQ - 1) / kBQ > 65535 || a.d <= 0 || a.H <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == kF32) return dispatch_dim<float, kDkv>(a);
    if (dtype == kBF16) return dispatch_dim<bf16, kDkv>(a);
    if (dtype == kF16) return dispatch_dim<f16, kDkv>(a);
    return static_cast<int>(cudaErrorInvalidValue);
}

BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  const void* bias, void* dq, void* dk, void* dv, int64_t bh,
                  int64_t L, int64_t d, int64_t H, const int64_t* strides,
                  float scale, int causal, uint64_t seed, uint64_t offset,
                  uint32_t threshold, float drop_scale, int mask_heads,
                  int mask_head0, void* stream) {
    const auto f = [](const void* p) { return static_cast<const float*>(p); };
    return BwdArgs{q, k, v, dout, f(lse), f(delta), f(bias),
                   dq, dk, dv, bh, static_cast<int>(L),
                   static_cast<int>(d), static_cast<int>(H),
                   Strides{strides[0], strides[1], strides[2]},
                   Strides{strides[3], strides[4], strides[5]}, scale, causal,
                   DropoutArgs{seed, offset, threshold, drop_scale,
                               mask_heads, mask_head0},
                   static_cast<cudaStream_t>(stream)};
}

}  // namespace

// q, k, v, dq: (B, H, L, D), fp32 (dtype kF32), bf16 (kBF16) or fp16 (kF16),
// with shared strides (sb, sh, sl); dO, in the same dtype, with its own (gsb,
// gsh, gsl); every head dim contiguous; bh = B * H. lse, delta: (B*H, L)
// contiguous fp32. bias: (B, L) contiguous fp32 or null. D <= 128. Dropout is
// on iff drop_scale != 1; mask_heads / mask_head0 as in DropoutArgs
// (philox.cuh). Returns cudaGetLastError() after the launch.
extern "C" int ptt_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dq,
    int64_t bh, int64_t L, int64_t d, int64_t H, int64_t sb, int64_t sh,
    int64_t sl, int64_t gsb, int64_t gsh, int64_t gsl, float scale,
    int causal, uint64_t seed, uint64_t offset, uint32_t threshold,
    float drop_scale, int mask_heads, int mask_head0, int dtype,
    void* stream) {
    if (L > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t strides[6] = {sb, sh, sl, gsb, gsh, gsl};
    return dispatch<false>(make_args(q, k, v, dout, lse, delta, bias, dq,
                                     nullptr, nullptr, bh, L, d, H, strides,
                                     scale, causal, seed, offset, threshold,
                                     drop_scale, mask_heads, mask_head0,
                                     stream),
                           dtype);
}

// As ptt_flash_attention_dq, writing dk and dv (strides of q, k, v).
extern "C" int ptt_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dk, void* dv,
    int64_t bh, int64_t L, int64_t d, int64_t H, int64_t sb, int64_t sh,
    int64_t sl, int64_t gsb, int64_t gsh, int64_t gsl, float scale,
    int causal, uint64_t seed, uint64_t offset, uint32_t threshold,
    float drop_scale, int mask_heads, int mask_head0, int dtype,
    void* stream) {
    if (L > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t strides[6] = {sb, sh, sl, gsb, gsh, gsl};
    return dispatch<true>(make_args(q, k, v, dout, lse, delta, bias, nullptr,
                                    dk, dv, bh, L, d, H, strides, scale,
                                    causal, seed, offset, threshold,
                                    drop_scale, mask_heads, mask_head0,
                                    stream),
                          dtype);
}
