// Flash attention forward, fp32, bf16 or fp16: o = softmax(q k^T * scale +
// bias) v,
// plus the per-row logsumexp.
//
// Replaces: paddle_tpu/kernels/flash_attention.py, _fwd_kernel (launched
// by _flash_forward). Same semantics: scores are dot * scale, then the
// (B, Lk) additive key-padding bias, then the causal mask at absolute
// positions (-inf); the running max starts at NEG_INF = -1e30;
// o = acc / max(l, 1e-30); lse = m + log(l), or LSE_EMPTY = 1e30 for a row
// whose every key is -inf (o is then 0). Dropout falls on the normalised
// probabilities: l sums the undropped p, the P.V product takes
// p * keep / (1 - p), with the mask of philox.cuh keyed on the element
// (bh, query row, key column) so that the backward kernels, which tile
// the matrix the other way, regenerate the same bits. At bf16 the scores,
// the softmax statistics and the output accumulate in fp32 as on the TPU's
// MXU; P (dropped, unnormalised) is rounded to bf16 before the P.V
// product, where the reference casts it to v's dtype; o is stored in bf16
// and lse in fp32. fp16 is the same kernel with the f16 product and
// conversions (P rounds to fp16, and a P or an o past 65504 would round to
// inf, as the reference's cast does).
//
// Two kernels, both on the tensor cores: flash_fwd_mma_kernel<T> for the
// 16-bit types, flash_fwd_tf32_kernel for fp32.
//
// flash_fwd_mma_kernel (bf16; fp16 alike). Bound on the H100: 4 L^2 D flops a
// head against 8 L D bytes (q, k, v read, o written, bf16), so at L = 512, D =
// 64 it does 256 flops a byte: below the 295 flop/byte ridge of the bf16
// tensor cores (989 TFLOP/s over 3.35 TB/s), so HBM bounds it, and only just;
// either way the products must run on the tensor cores and q, k, v must be
// read about once. So every product is a tensor-core mma.sync (m16n8k16, fp32
// accumulators), and K/V tiles of 64 keys stream from HBM (or L2) through a
// two-stage cp.async ring, the next tile in flight while this one computes. 4
// warps; each owns kMT m-tiles of 16 query rows, and its Q fragments stay in
// registers for the whole row. Each K/V fragment loaded with ldmatrix serves
// the warp's kMT m-tiles, so at D <= 64 without dropout a warp takes two (128
// rows a block), which halves shared-memory reads per product; with dropout or
// at D = 128 one (64 rows), which leaves registers for the Philox work and the
// wider accumulator. S = Q K^T comes out as fp32 fragments; the online softmax
// runs on them in natural units, on scores rounded as the reference rounds
// them (fragment_scores in flash_common.cuh says why: the log2 domain put lse
// 2^-10 off next to a -1e4 key bias), a probability one FFMA and one ex2
// (exp_offset, row_lse), and without a key bias the scale taken into that FFMA
// (fwd_scores; one instantiation with a bias and one without, the latter bit
// for bit the same softmax at D = 64, one multiply a score cheaper); a row's
// max over a 4-lane quad, the masks only on a tile that reaches past L or
// above the diagonal, the output rescaled only when a row's max moved; P is
// converted in registers into the A operand of P.V (V read with
// ldmatrix.trans), never through shared memory; l sums per lane and is reduced
// once at the end. Tiles are bf16 rows with an XOR swizzle of their 16-byte
// chunks (tensor_core.cuh), which keeps ldmatrix free of bank conflicts.
// Ragged edges stay inside the kernel: cp.async fills rows past L and columns
// past d with zeros, keys past L score -inf, rows past L are not stored; the
// head dim is padded to 64 or 128. When d, the strides or a pointer is not
// whole 16-byte chunks (d % 8 != 0), the same kernel loads element by element
// into the same layout. Under dropout each lane makes one Philox call per four
// probabilities and uses all four words (fragment_keep in flash_common.cuh:
// the two lanes of a quad pair share their calls through one shuffle) when L %
// 4 == 0, else a call per probability. It reaches ~17 % of its bound, ~1.8x
// the library's forward (PERF.md): wgmma with TMA is the next step.
//
// flash_fwd_tf32_kernel (fp32). 4 L^2 D flops against 16 L D bytes, 128
// flops a byte at L = 512: just under the 148 flop/byte ridge of the TF32
// tensor cores (495 TFLOP/s over 3.35 TB/s), so at their peak HBM would
// bound it, and the FMA pipes (67 TFLOP/s) are far from either. The fp32
// gates (1e-4 on o and lse) rule out plain TF32, whose single product is
// off by up to 2^-10 of |a b| and moves o and lse past 1e-4 on
// unit-normal inputs (tests/test_torch_tf32x3.py); but 3xTF32 keeps them:
// each fp32 operand is split into hi = tf32(x) and lo = tf32(x - hi), and
// a b is a_lo b_hi + a_hi b_lo + a_hi b_hi, three TF32 tensor-core
// products whose error is ~2^-21 of |a b|, close to fp32's own 2^-24
// rounding (CUTLASS's OpMultiplyAddFastF32; tests/test_torch_tf32x3.py
// emulates it against the gate). So both products, Q K^T and P.V, run as
// mma.sync m16n8k8 tf32 triples (tensor_core.cuh), issued term by term
// across the n-tiles so that no product waits on the one before. Their
// rate bounds the kernel (PERF.md). Otherwise the bf16 kernel's design at
// one m-tile a warp: grid (B*H, ceil(L/64)), 4 warps of 16 query rows,
// K/V tiles of 64 keys through a two-stage cp.async ring, the online
// softmax on the accumulator fragments, the masks only on edge tiles, the
// dropout bits of fragment_keep. What differs at fp32:
// - tiles are fp32 rows padded to 68 (or 132) floats, whose stride is 4
//   mod 32 words, so ldmatrix (b16, so an 8 x 4 fp32 block is one 8 x 8
//   matrix) loads Q's A and K's B fragments and plain 32-bit loads read
//   V's B fragments down a column, all without bank conflicts;
// - P's accumulator fragment becomes the A operand of P.V with its keys
//   permuted within each k8 block (tensor_core.cuh), without a shuffle;
// - every fragment is split into hi/lo in registers as it is loaded, Q's
//   once at D = 64 and every tile at D = 128 (registers).
// Ragged edges as the bf16 kernel's: cp.async zero fill, element loads
// when d % 4 != 0 or a stride or pointer is not whole 16-byte chunks, D
// padded to 64 or 128.
#include <cstdint>

#include "dtype.cuh"
#include "flash_common.cuh"
#include "philox.cuh"
#include "tensor_core.cuh"

namespace {

// depth of the forward's cp.async ring: the K/V tile computed and one in
// flight behind it (a third stage measured no faster: PERF.md)
constexpr int kFwdStages = 2;

// q, k, v, o: bf16 with shared strides (sb, sh, sl) in elements, head dim
// contiguous; bias (B, L) fp32, null iff !kBias; lse (B*H, L) fp32 or
// null. `vec`: every row of q, k, v, o is whole 16-byte chunks
// (chunks_of_16). Each of the 4 warps owns kMT m-tiles of 16 query rows: a
// block takes 64 kMT rows. Without a key bias (!kBias) the scale moves into
// the exponent (fwd_scores in flash_common.cuh).
template <typename T, int DP, int kMT, bool kDrop, bool kBias>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const float* __restrict__ bias, T* __restrict__ o,
                     float* __restrict__ lse, int L, int d, int H,
                     int64_t sb, int64_t sh, int64_t sl, float scale,
                     int causal, int vec, DropoutArgs drop) {
    constexpr int kRowsB = 16 * kMT * (kThreads / 32);   // rows a block
    constexpr int kKTile = kBK * DP;  // elements of a K or V tile
    constexpr int kSteps = DP / 16;   // k-steps of Q K^T over the head dim
    constexpr int kOutN = DP / 8;     // n-tiles of the output
    constexpr int kKeyN = kBK / 8;    // n-tiles of a score tile
    extern __shared__ __align__(128) unsigned char smem_raw[];
    T* sq = reinterpret_cast<T*>(smem_raw);
    T* sk = sq + kRowsB * DP;      // kFwdStages stages
    T* sv = sk + kFwdStages * kKTile; // kFwdStages stages

    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    [[maybe_unused]] const int mbh = mask_bh(drop, b, h, bh);   // the mask's row
    const int q0 = blockIdx.y * kRowsB;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = warp * 16 * kMT;   // the warp's first row in the tile
    const int64_t base = static_cast<int64_t>(b) * sb +
                         static_cast<int64_t>(h) * sh;
    const float* bias_row =
        kBias ? bias + static_cast<int64_t>(b) * L : nullptr;
    const float xscale = fwd_exp_scale<kBias>(scale);

    int n_tiles = (L + kBK - 1) / kBK;
    if (causal) n_tiles = min(n_tiles, (min(q0 + kRowsB, L) - 1) / kBK + 1);

    // K/V tile t into stage t % kFwdStages, as one commit group (empty past
    // the last tile, so that every iteration waits for the same count)
    const auto load_keys = [&](int t) {
        if (t < n_tiles) {
            const int at = (t % kFwdStages) * kKTile;
            load_rows<kBK, DP, kThreads>(sk + at, k, base, sl, t * kBK, L, d,
                                         vec);
            load_rows<kBK, DP, kThreads>(sv + at, v, base, sl, t * kBK, L, d,
                                         vec);
        }
        cp_async_commit();
    };
    load_rows<kRowsB, DP, kThreads>(sq, q, base, sl, q0, L, d, vec);
    cp_async_commit();
#pragma unroll
    for (int t = 0; t < kFwdStages - 1; ++t) load_keys(t);

    // the warp's Q fragments, in registers for the whole row; m-tile mt
    // holds rows r0 + 16 mt + g (the lane's "qr") and qr + 8
    cp_async_wait<kFwdStages - 1>();
    __syncthreads();
    uint32_t qf[kMT][kSteps][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int s = 0; s < kSteps; ++s)
            ldmatrix_x4(qf[mt][s],
                        sq + swz<DP>(r0 + 16 * mt + (lane & 7) +
                                         ((lane >> 3) & 1) * 8,
                                     s * 16 + (lane >> 4) * 8));
    float m[kMT][2], l[kMT][2];   // m quad-uniform; l this lane's part of
                                  // the row sums
    float acc[kMT][kOutN][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
        m[mt][0] = m[mt][1] = kNegInf;
        l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
        for (int n = 0; n < kOutN; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    }

    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * kBK;
        cp_async_wait<kFwdStages - 2>();   // tile t is in shared memory ...
        __syncthreads();   // ... for every thread, and tile t - 1's stage is
        load_keys(t + kFwdStages - 1);   // free for the next tile
        const T* skt = sk + (t % kFwdStages) * kKTile;
        const T* svt = sv + (t % kFwdStages) * kKTile;

        // S = Q K^T: keys 16np .. 16np + 15 as n-tiles 2np, 2np + 1; each K
        // fragment serves the warp's kMT m-tiles
        float sc[kMT][kKeyN][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int n = 0; n < kKeyN; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) sc[mt][n][e] = 0.f;
#pragma unroll
        for (int s = 0; s < kSteps; ++s)
#pragma unroll
            for (int np = 0; np < kKeyN / 2; ++np) {
                uint32_t kb[4];
                ldmatrix_x4(kb, skt + swz<DP>(np * 16 + (lane & 7) +
                                                  (lane >> 4) * 8,
                                              s * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt) {
                    mma_16816<T>(sc[mt][2 * np], qf[mt][s], kb[0], kb[1]);
                    mma_16816<T>(sc[mt][2 * np + 1], qf[mt][s], kb[2], kb[3]);
                }
            }

        // online softmax on the fragments in natural units; only a tile
        // that reaches past L or above the warp's diagonal needs the masks
        const bool edge =
            k0 + kBK > L || (causal && k0 + kBK - 1 > q0 + r0);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
            const int qr = q0 + r0 + 16 * mt + g;
            float mx[2] = {kNegInf, kNegInf};
#pragma unroll
            for (int n = 0; n < kKeyN; ++n) {
                fwd_scores<kBias>(sc[mt][n], scale, bias_row, qr,
                                  k0 + 8 * n + 2 * t4, L, causal, edge);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    mx[e >> 1] = fmaxf(mx[e >> 1], sc[mt][n][e]);
            }
            float corr[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const float m_new = fmaxf(
                    m[mt][i], fwd_row_max<kBias>(quad_max(mx[i]), scale));
                corr[i] = ex2(exp_offset(m[mt][i]) - exp_offset(m_new));
                m[mt][i] = m_new;
                l[mt][i] *= corr[i];
            }
            if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
                for (int n = 0; n < kOutN; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[mt][n][e] *= corr[e >> 1];
            }
            const float ml[2] = {exp_offset(m[mt][0]), exp_offset(m[mt][1])};
#pragma unroll
            for (int n = 0; n < kKeyN; ++n) {
                float ks[4];
                if (kDrop)
                    fragment_keep(drop, mbh, qr, k0 + 8 * n + 2 * t4, L, lane,
                                  ks);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float p =
                        ex2(fmaf(sc[mt][n][e], xscale, -ml[e >> 1]));
                    l[mt][e >> 1] += p;   // the undropped sum normalises o
                    sc[mt][n][e] = kDrop ? p * ks[e] : p;
                }
            }
        }

        // O += P V: P's fragments, rounded to bf16, are the A operand; each
        // V fragment serves the warp's kMT m-tiles
#pragma unroll
        for (int s = 0; s < kBK / 16; ++s) {
            uint32_t pa[kMT][4];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
                pa[mt][0] = pack16<T>(sc[mt][2 * s][0], sc[mt][2 * s][1]);
                pa[mt][1] = pack16<T>(sc[mt][2 * s][2], sc[mt][2 * s][3]);
                pa[mt][2] = pack16<T>(sc[mt][2 * s + 1][0],
                                      sc[mt][2 * s + 1][1]);
                pa[mt][3] = pack16<T>(sc[mt][2 * s + 1][2],
                                      sc[mt][2 * s + 1][3]);
            }
#pragma unroll
            for (int np = 0; np < kOutN / 2; ++np) {
                uint32_t vb[4];
                const int vat = swz<DP>(
                    s * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                    np * 16 + (lane >> 4) * 8);
                ldmatrix_x4_trans(vb, svt + vat);
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt) {
                    mma_16816<T>(acc[mt][2 * np], pa[mt], vb[0], vb[1]);
                    mma_16816<T>(acc[mt][2 * np + 1], pa[mt], vb[2], vb[3]);
                }
            }
        }
    }

#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int row = q0 + r0 + 16 * mt + g + 8 * i;
            const float li = quad_sum(l[mt][i]);
            if (row >= L) continue;
            const float denom = fmaxf(li, 1e-30f);
            T* orow = o + base + row * sl;
#pragma unroll
            for (int n = 0; n < kOutN; ++n) {
                const int col = 8 * n + 2 * t4;
                const float v0 = acc[mt][n][2 * i] / denom;
                const float v1 = acc[mt][n][2 * i + 1] / denom;
                if (vec) {
                    if (col < d)
                        *reinterpret_cast<uint32_t*>(orow + col) =
                            pack16<T>(v0, v1);
                } else {
                    if (col < d) orow[col] = from_f32<T>(v0);
                    if (col + 1 < d) orow[col + 1] = from_f32<T>(v1);
                }
            }
            if (lse != nullptr && t4 == 0)
                lse[static_cast<int64_t>(bh) * L + row] =
                    li > 0.f ? row_lse(m[mt][i], denom) : kLseEmpty;
        }
}

template <typename T, int DP, int kMT, bool kDrop, bool kBias>
int launch_mma(const T* q, const T* k, const T* v,
               const float* bias, T* o, float* lse, int64_t bh, int L,
               int d, int H, int64_t sb, int64_t sh, int64_t sl, float scale,
               int causal, const DropoutArgs& drop, cudaStream_t stream) {
    constexpr int rows = 16 * kMT * (kThreads / 32);
    // Q, kFwdStages stages of K and of V
    constexpr size_t bytes = sizeof(T) * (rows + 2 * kFwdStages * kBK) * DP;
    static bool configured = false;
    if (!configured) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_fwd_mma_kernel<T, DP, kMT, kDrop, kBias>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes));
        if (e != cudaSuccess) return static_cast<int>(e);
        configured = true;
    }
    const int64_t strides[3] = {sb, sh, sl};
    const int vec = chunks_of_16<T>(d, strides, {q, k, v, o});
    const dim3 grid(static_cast<unsigned>(bh),
                    static_cast<unsigned>((L + rows - 1) / rows));
    flash_fwd_mma_kernel<T, DP, kMT, kDrop, kBias>
        <<<grid, kThreads, bytes, stream>>>(
        q, k, v, bias, o, lse, L, d, H, sb, sh, sl, scale, causal, vec, drop);
    return static_cast<int>(cudaGetLastError());
}

// bf16 or fp16 (T) on the tensor cores: the head dim padded to 64 or 128
template <typename T, bool kBias>
int dispatch_mma(const void* q, const void* k, const void* v,
                 const float* bias, void* o, float* lse, int64_t bh, int L,
                 int d, int H, int64_t sb, int64_t sh, int64_t sl,
                 float scale, int causal, const DropoutArgs& drop,
                 cudaStream_t st) {
    const auto qp = static_cast<const T*>(q);
    const auto kp = static_cast<const T*>(k);
    const auto vp = static_cast<const T*>(v);
    const auto op = static_cast<T*>(o);
    const bool dropout = drop.scale != 1.f;
    // D <= 64: two m-tiles a warp (128 rows a block) halve the K/V fragment
    // loads per product; under dropout one m-tile, whose registers leave
    // room for the Philox work (PERF.md)
    if (d <= 64)
        return dropout ? launch_mma<T, 64, 1, true, kBias>(
                             qp, kp, vp, bias, op, lse, bh, L, d, H, sb, sh,
                             sl, scale, causal, drop, st)
                       : launch_mma<T, 64, 2, false, kBias>(
                             qp, kp, vp, bias, op, lse, bh, L, d, H, sb, sh,
                             sl, scale, causal, drop, st);
    if (d <= 128)
        return dropout ? launch_mma<T, 128, 1, true, kBias>(
                             qp, kp, vp, bias, op, lse, bh, L, d, H, sb, sh,
                             sl, scale, causal, drop, st)
                       : launch_mma<T, 128, 1, false, kBias>(
                             qp, kp, vp, bias, op, lse, bh, L, d, H, sb, sh,
                             sl, scale, causal, drop, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// q, k, v, o: fp32 with shared strides (sb, sh, sl) in elements, head dim
// contiguous; bias (B, L) fp32 or null; lse (B*H, L) fp32 or null. `vec`:
// every row of q, k, v, o is whole 16-byte chunks (chunks_of_16<float>).
// Each of the 4 warps owns 16 query rows: a block takes 64. Every product
// is 3xTF32 (mma_3xtf32): the K, V and P fragments are split into hi/lo in
// registers as they are loaded; Q's at D = 64 once, and held, at D = 128
// every tile from shared memory, as holding them would leave no registers.
// bias and kBias as the bf16 kernel's.
template <int DP, bool kDrop, bool kBias>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ bias, float* __restrict__ o,
                      float* __restrict__ lse, int L, int d, int H,
                      int64_t sb, int64_t sh, int64_t sl, float scale,
                      int causal, int vec, DropoutArgs drop) {
    constexpr int kS = f32_stride(DP);  // floats a shared row
    constexpr int kKTile = kBK * kS;    // floats of a K or V tile
    constexpr int kSteps = DP / 8;      // k-steps of Q K^T over the head dim
    constexpr int kOutN = DP / 8;       // n-tiles of the output
    constexpr int kKeyN = kBK / 8;      // n-tiles of a score tile
    constexpr bool kQHeld = DP <= 64;   // Q's hi/lo fragments in registers
    static_assert(kBQ == 16 * (kThreads / 32), "a warp owns 16 rows");
    extern __shared__ __align__(128) unsigned char smem_raw[];
    float* sq = reinterpret_cast<float*>(smem_raw);
    float* sk = sq + kBQ * kS;              // kFwdStages stages
    float* sv = sk + kFwdStages * kKTile;   // kFwdStages stages

    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    [[maybe_unused]] const int mbh = mask_bh(drop, b, h, bh);   // the mask's row
    const int q0 = blockIdx.y * kBQ;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = warp * 16;          // the warp's first row in the tile
    const int qr = q0 + r0 + g;        // the lane's rows: qr and qr + 8
    const int64_t base = static_cast<int64_t>(b) * sb +
                         static_cast<int64_t>(h) * sh;
    const float* bias_row =
        kBias ? bias + static_cast<int64_t>(b) * L : nullptr;
    const float xscale = fwd_exp_scale<kBias>(scale);

    int n_tiles = (L + kBK - 1) / kBK;
    if (causal) n_tiles = min(n_tiles, (min(q0 + kBQ, L) - 1) / kBK + 1);

    // K/V tile t into stage t % kFwdStages, as one commit group (empty past
    // the last tile, so that every iteration waits for the same count)
    const auto load_keys = [&](int t) {
        if (t < n_tiles) {
            const int at = (t % kFwdStages) * kKTile;
            load_rows_f32<kBK, DP, kThreads>(sk + at, k, base, sl, t * kBK, L,
                                             d, vec);
            load_rows_f32<kBK, DP, kThreads>(sv + at, v, base, sl, t * kBK, L,
                                             d, vec);
        }
        cp_async_commit();
    };
    load_rows_f32<kBQ, DP, kThreads>(sq, q, base, sl, q0, L, d, vec);
    cp_async_commit();
#pragma unroll
    for (int t = 0; t < kFwdStages - 1; ++t) load_keys(t);

    // Q's A fragment of k-step s: head columns 8s .. 8s + 7
    cp_async_wait<kFwdStages - 1>();
    __syncthreads();
    uint32_t qhi[kQHeld ? kSteps : 1][4], qlo[kQHeld ? kSteps : 1][4];
    if constexpr (kQHeld) {
#pragma unroll
        for (int s = 0; s < kSteps; ++s)
            a_frag_tf32(sq, kS, r0, 8 * s, qhi[s], qlo[s]);
    }
    float m[2] = {kNegInf, kNegInf};   // natural units, quad-uniform
    float l[2] = {0.f, 0.f};           // this lane's part of the row sums
    float acc[kOutN][4];
#pragma unroll
    for (int n = 0; n < kOutN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * kBK;
        cp_async_wait<kFwdStages - 2>();   // tile t is in shared memory ...
        __syncthreads();   // ... for every thread, and tile t - 1's stage is
        load_keys(t + kFwdStages - 1);   // free for the next tile
        const float* skt = sk + (t % kFwdStages) * kKTile;
        const float* svt = sv + (t % kFwdStages) * kKTile;

        // S = Q K^T: keys 8n .. 8n + 7 as n-tile n
        float sc[kKeyN][4];
#pragma unroll
        for (int n = 0; n < kKeyN; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
            uint32_t ah[4], al[4];
            if constexpr (kQHeld) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    ah[i] = qhi[s][i];
                    al[i] = qlo[s][i];
                }
            } else {
                a_frag_tf32(sq, kS, r0, 8 * s, ah, al);
            }
            uint32_t kh[kKeyN][2], kl[kKeyN][2];
            b_frags_tf32<kKeyN>(skt, kS, 8 * s, kh, kl);
            mma_3xtf32<kKeyN>(sc, ah, al, kh, kl);
        }

        // online softmax on the fragments in natural units, as the bf16
        // kernel's; only a tile that reaches past L or above the warp's
        // diagonal needs the masks
        const bool edge =
            k0 + kBK > L || (causal && k0 + kBK - 1 > q0 + r0);
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int n = 0; n < kKeyN; ++n) {
            fwd_scores<kBias>(sc[n], scale, bias_row, qr, k0 + 8 * n + 2 * t4,
                              L, causal, edge);
#pragma unroll
            for (int e = 0; e < 4; ++e)
                mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
        }
        float corr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float m_new =
                fmaxf(m[i], fwd_row_max<kBias>(quad_max(mx[i]), scale));
            corr[i] = ex2(exp_offset(m[i]) - exp_offset(m_new));
            m[i] = m_new;
            l[i] *= corr[i];
        }
        if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
            for (int n = 0; n < kOutN; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
        }
        const float ml[2] = {exp_offset(m[0]), exp_offset(m[1])};
#pragma unroll
        for (int n = 0; n < kKeyN; ++n) {
            float ks[4];
            if (kDrop)
                fragment_keep(drop, mbh, qr, k0 + 8 * n + 2 * t4, L, lane, ks);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = ex2(fmaf(sc[n][e], xscale, -ml[e >> 1]));
                l[e >> 1] += p;   // the undropped sum normalises o
                sc[n][e] = kDrop ? p * ks[e] : p;
            }
        }

        // O += P V, 3xTF32, one k-step per n-tile j of P (keys 8j .. 8j +
        // 7) with its keys permuted: A = (c0, c2, c1, c3) takes key 2t as
        // column t and key 2t + 1 as column t + 4, so B's rows t and t + 4
        // are V's rows 8j + 2t and 8j + 2t + 1, read down a column; eight
        // output n-tiles at a time
#pragma unroll
        for (int j = 0; j < kKeyN; ++j) {
            uint32_t ph[4], pl[4];
            c_as_a_tf32(sc[j], ph, pl);
#pragma unroll
            for (int n0 = 0; n0 < kOutN; n0 += 8) {
                uint32_t vh[8][2], vl[8][2];
                b_frags_col_tf32<8>(svt, kS, 8 * j, 8 * n0, vh, vl);
                mma_3xtf32<8>(acc + n0, ph, pl, vh, vl);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = qr + 8 * i;
        const float li = quad_sum(l[i]);
        if (row >= L) continue;
        const float denom = fmaxf(li, 1e-30f);
        float* orow = o + base + row * sl;
#pragma unroll
        for (int n = 0; n < kOutN; ++n) {
            const int col = 8 * n + 2 * t4;
            const float v0 = acc[n][2 * i] / denom;
            const float v1 = acc[n][2 * i + 1] / denom;
            if (vec) {
                if (col < d)
                    *reinterpret_cast<float2*>(orow + col) =
                        make_float2(v0, v1);
            } else {
                if (col < d) orow[col] = v0;
                if (col + 1 < d) orow[col + 1] = v1;
            }
        }
        if (lse != nullptr && t4 == 0)
            lse[static_cast<int64_t>(bh) * L + row] =
                li > 0.f ? row_lse(m[i], denom) : kLseEmpty;
    }
}

template <int DP, bool kDrop, bool kBias>
int launch_tf32(const float* q, const float* k, const float* v,
                const float* bias, float* o, float* lse, int64_t bh, int L,
                int d, int H, int64_t sb, int64_t sh, int64_t sl, float scale,
                int causal, const DropoutArgs& drop, cudaStream_t stream) {
    // Q, kFwdStages stages of K and of V
    constexpr size_t bytes =
        sizeof(float) * (kBQ + 2 * kFwdStages * kBK) * f32_stride(DP);
    static bool configured = false;
    if (!configured) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_fwd_tf32_kernel<DP, kDrop, kBias>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes));
        if (e != cudaSuccess) return static_cast<int>(e);
        configured = true;
    }
    const int64_t strides[3] = {sb, sh, sl};
    const int vec = chunks_of_16<float>(d, strides, {q, k, v, o});
    const dim3 grid(static_cast<unsigned>(bh),
                    static_cast<unsigned>((L + kBQ - 1) / kBQ));
    flash_fwd_tf32_kernel<DP, kDrop, kBias>
        <<<grid, kThreads, bytes, stream>>>(
        q, k, v, bias, o, lse, L, d, H, sb, sh, sl, scale, causal, vec, drop);
    return static_cast<int>(cudaGetLastError());
}

// fp32 on the tensor cores (3xTF32): the head dim padded to 64 or 128
template <bool kBias>
int dispatch_tf32(const void* q, const void* k, const void* v,
                  const float* bias, void* o, float* lse, int64_t bh, int L,
                  int d, int H, int64_t sb, int64_t sh, int64_t sl,
                  float scale, int causal, const DropoutArgs& drop,
                  cudaStream_t st) {
    const auto qp = static_cast<const float*>(q);
    const auto kp = static_cast<const float*>(k);
    const auto vp = static_cast<const float*>(v);
    const auto op = static_cast<float*>(o);
    const bool dropout = drop.scale != 1.f;
    if (d <= 64)
        return dropout ? launch_tf32<64, true, kBias>(
                             qp, kp, vp, bias, op, lse, bh, L, d, H, sb, sh,
                             sl, scale, causal, drop, st)
                       : launch_tf32<64, false, kBias>(
                             qp, kp, vp, bias, op, lse, bh, L, d, H, sb, sh,
                             sl, scale, causal, drop, st);
    if (d <= 128)
        return dropout ? launch_tf32<128, true, kBias>(
                             qp, kp, vp, bias, op, lse, bh, L, d, H, sb, sh,
                             sl, scale, causal, drop, st)
                       : launch_tf32<128, false, kBias>(
                             qp, kp, vp, bias, op, lse, bh, L, d, H, sb, sh,
                             sl, scale, causal, drop, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o: (B, H, L, D), fp32 (dtype kF32), bf16 (kBF16) or fp16 (kF16),
// with shared strides (sb, sh, sl) and a contiguous head dim; bh = B * H.
// bias: (B, L) contiguous fp32 or null. lse: (B*H, L) contiguous fp32 or null.
// D <= 128. Dropout is on iff drop_scale != 1; mask_heads / mask_head0 as in
// DropoutArgs (philox.cuh). Returns cudaGetLastError() after the launch.
extern "C" int ptt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* o, void* lse, int64_t bh,
                                       int64_t L, int64_t d, int64_t H,
                                       int64_t sb, int64_t sh, int64_t sl,
                                       float scale, int causal,
                                       uint64_t seed, uint64_t offset,
                                       uint32_t threshold, float drop_scale,
                                       int mask_heads, int mask_head0,
                                       int dtype, void* stream) {
    if (bh <= 0 || bh > 0x7fffffff || L <= 0 || (L + kBQ - 1) / kBQ > 65535 ||
        d <= 0 || H <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto bp = static_cast<const float*>(bias);
    const auto lp = static_cast<float*>(lse);
    const auto st = static_cast<cudaStream_t>(stream);
    const int Li = static_cast<int>(L), di = static_cast<int>(d),
              Hi = static_cast<int>(H);
    const DropoutArgs drop{seed, offset, threshold, drop_scale,
                           mask_heads, mask_head0};
    if (dtype != kF32 && dtype != kBF16 && dtype != kF16)
        return static_cast<int>(cudaErrorInvalidValue);
    // one instantiation with a key bias and one without (fwd_scores)
    const auto dispatch =
        dtype == kF32    ? (bp ? dispatch_tf32<true> : dispatch_tf32<false>)
        : dtype == kBF16 ? (bp ? dispatch_mma<bf16, true>
                               : dispatch_mma<bf16, false>)
                         : (bp ? dispatch_mma<f16, true>
                               : dispatch_mma<f16, false>);
    return dispatch(q, k, v, bp, o, lp, bh, Li, di, Hi, sb, sh, sl, scale,
                    causal, drop, st);
}
