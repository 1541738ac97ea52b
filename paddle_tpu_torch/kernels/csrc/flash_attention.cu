// Flash attention forward, fp32 or bf16: o = softmax(q k^T * scale + bias) v,
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
// and lse in fp32.
//
// Two kernels, one per dtype.
//
// flash_fwd_mma_kernel (bf16). Bound on the H100: 4 L^2 D flops a head
// against 8 L D bytes (q, k, v read, o written, bf16), so at L = 512,
// D = 64 it does 256 flops a byte: below the 295 flop/byte ridge of the
// bf16 tensor cores (989 TFLOP/s over 3.35 TB/s), so HBM bounds it, and
// only just; either way the products must run on the tensor cores and q,
// k, v must be read about once. So every product is a tensor-core
// mma.sync (m16n8k16, fp32 accumulators), and K/V tiles of 64 keys stream
// from HBM (or L2) through a two-stage cp.async ring, the next tile in
// flight while this one computes. 4 warps; each owns kMT m-tiles of 16
// query rows, and its Q fragments stay in registers for the whole row.
// Each K/V fragment loaded with ldmatrix serves the warp's kMT m-tiles, so
// at D <= 64 without dropout a warp takes two (128 rows a block), which
// halves shared-memory reads per product; with dropout or at D = 128 one
// (64 rows), which leaves registers for the Philox work and the wider
// accumulator. S = Q K^T comes out as fp32 fragments; the online softmax
// runs on them in the log2 domain (one FFMA and one ex2 a score), a row's
// max over a 4-lane quad, the masks only on a tile that reaches past L or
// above the diagonal, the output rescaled only when a row's max moved; P
// is converted in registers into the A operand of P.V (V read with
// ldmatrix.trans), never through shared memory; l sums per lane and is
// reduced once at the end. Tiles are bf16 rows with an XOR swizzle of
// their 16-byte chunks (tensor_core.cuh), which keeps ldmatrix free of
// bank conflicts. Ragged edges stay inside the kernel: cp.async fills
// rows past L and columns past d with zeros, keys past L score -inf, rows
// past L are not stored; the head dim is padded to 64 or 128. When d, the
// strides or a pointer is not whole 16-byte chunks (d % 8 != 0), the same
// kernel loads element by element into the same layout. Under dropout
// each lane makes one Philox call per four probabilities and uses all
// four words (fragment_keep in flash_common.cuh: the two lanes of a quad
// pair share their calls through one shuffle) when L % 4 == 0, else a call
// per probability. It reaches ~17 % of its bound, ~1.85x the library's
// forward (PERF.md): wgmma with TMA is the next step.
//
// flash_fwd_kernel (fp32). Tensor cores at fp32 would be TF32, which the
// fp32 gates forbid, so this one stays on the FMA pipes: 4 L^2 D flops
// against 16 L D bytes, 128 flops a byte, above the 20 flop/byte ridge of
// fp32 CUDA cores (67 TFLOP/s), so operations bound it. Grid (B*H,
// ceil(L/64)); each block keeps a 64-row Q tile in shared memory and walks
// 64-key K/V tiles through shared memory (the sequential grid axis of the
// TPU kernel becomes this loop). 128 threads: thread (ty, tx) owns query
// rows ty + 8i (i < 8) and score columns tx + 16j (j < 4), so a row's max
// and sum are 16-lane shuffles; the P tile goes through shared memory for
// the P.V product, where the thread owns output columns tx + 16c. Q and K
// rows are padded by one float so the column-wise reads do not collide on
// banks. Keys past L are -inf, rows past L are computed and not stored,
// and the head dim is zero-padded to 32, 64 or 128. With dropout a
// thread's four score columns lie 16 apart, so it uses one word of each
// Philox call.
#include <cstdint>

#include "dtype.cuh"
#include "flash_common.cuh"
#include "philox.cuh"
#include "tensor_core.cuh"

namespace {

template <int DP>
struct Tile {
    static constexpr int qk_stride = DP + 1;   // floats per Q/K smem row
    static constexpr int p_stride = kBK + 1;   // floats per P smem row
    static constexpr int q = kBQ * qk_stride;
    static constexpr int k = kBK * qk_stride;
    static constexpr int v = kBK * DP;
    static constexpr int p = kBQ * p_stride;
    static constexpr size_t bytes = sizeof(float) * (q + k + v + p);
};

// q, k, v, o (element type T) share strides (sb, sh, sl) in elements; the
// head dim is contiguous. bias: (B, L) fp32 or null. lse: (B*H, L) fp32 or
// null.
template <int DP, bool kDrop, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ o, float* __restrict__ lse, int L, int d,
                 int H, int64_t sb, int64_t sh, int64_t sl, float scale,
                 int causal, DropoutArgs drop) {
    using Tl = Tile<DP>;
    constexpr int kOut = DP / 16;  // output columns per thread
    extern __shared__ float smem[];
    float* sq = smem;
    float* sk = sq + Tl::q;
    float* sv = sk + Tl::k;
    float* sp = sv + Tl::v;

    const int bh = blockIdx.x;
    const int b = bh / H;
    const int h = bh % H;
    const int q0 = blockIdx.y * kBQ;
    const int tid = threadIdx.x;
    const int ty = tid >> 4;
    const int tx = tid & 15;
    const int64_t base = static_cast<int64_t>(b) * sb +
                         static_cast<int64_t>(h) * sh;
    const float* bias_row =
        bias != nullptr ? bias + static_cast<int64_t>(b) * L : nullptr;

    for (int i = tid; i < kBQ * DP; i += kThreads) {
        const int r = i / DP, c = i % DP, qr = q0 + r;
        sq[r * Tl::qk_stride + c] =
            (qr < L && c < d) ? to_f32(q[base + qr * sl + c]) : 0.f;
    }

    float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        m[i] = kNegInf;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
    }

    int n_tiles = (L + kBK - 1) / kBK;
    if (causal) n_tiles = min(n_tiles, (min(q0 + kBQ, L) - 1) / kBK + 1);

    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * kBK;
        __syncthreads();  // the previous tile's readers are done
        for (int i = tid; i < kBK * DP; i += kThreads) {
            const int r = i / DP, c = i % DP, kr = k0 + r;
            const bool in = kr < L && c < d;
            sk[r * Tl::qk_stride + c] =
                in ? to_f32(k[base + kr * sl + c]) : 0.f;
            sv[r * DP + c] = in ? to_f32(v[base + kr * sl + c]) : 0.f;
        }
        __syncthreads();

        float s[kRows][kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int c = 0; c < DP; ++c) {
            float kc[kCols];
#pragma unroll
            for (int j = 0; j < kCols; ++j)
                kc[j] = sk[(tx + 16 * j) * Tl::qk_stride + c];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const float qv = sq[(ty + 8 * i) * Tl::qk_stride + c];
#pragma unroll
                for (int j = 0; j < kCols; ++j)
                    s[i][j] = fmaf(qv, kc[j], s[i][j]);
            }
        }

#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const int qr = q0 + ty + 8 * i;
            float row_max = kNegInf;
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                const float x = masked_score(s[i][j], scale, bias_row,
                                             k0 + tx + 16 * j, qr, L, causal);
                s[i][j] = x;
                row_max = fmaxf(row_max, x);
            }
            const float m_new = fmaxf(m[i], max16(row_max));
            const float corr = expf(m[i] - m_new);
            float row_sum = 0.f;
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                const float p = expf(s[i][j] - m_new);
                row_sum += p;    // the undropped sum normalises o
                float pd = p;
                if (kDrop)
                    pd *= keep_scale(
                        drop, prob_index(bh, qr, k0 + tx + 16 * j, L));
                // the P.V product takes P in v's dtype
                sp[(ty + 8 * i) * Tl::p_stride + tx + 16 * j] =
                    round_to<T>(pd);
            }
            l[i] = l[i] * corr + sum16(row_sum);
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < kOut; ++c) acc[i][c] *= corr;
        }
        __syncthreads();

#pragma unroll 4
        for (int kk = 0; kk < kBK; ++kk) {
            float vc[kOut];
#pragma unroll
            for (int c = 0; c < kOut; ++c) vc[c] = sv[kk * DP + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const float p = sp[(ty + 8 * i) * Tl::p_stride + kk];
#pragma unroll
                for (int c = 0; c < kOut; ++c)
                    acc[i][c] = fmaf(p, vc[c], acc[i][c]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int qr = q0 + ty + 8 * i;
        if (qr >= L) continue;
        const float denom = fmaxf(l[i], 1e-30f);
        T* orow = o + base + qr * sl;
#pragma unroll
        for (int c = 0; c < kOut; ++c) {
            const int col = tx + 16 * c;
            if (col < d) orow[col] = from_f32<T>(acc[i][c] / denom);
        }
        if (lse != nullptr && tx == 0)
            lse[static_cast<int64_t>(bh) * L + qr] =
                l[i] > 0.f ? m[i] + logf(denom) : kLseEmpty;
    }
}

// depth of the forward's cp.async ring: the K/V tile computed and one in
// flight behind it (a third stage measured no faster: PERF.md)
constexpr int kFwdStages = 2;

// q, k, v, o: bf16 with shared strides (sb, sh, sl) in elements, head dim
// contiguous; bias (B, L) fp32 or null; lse (B*H, L) fp32 or null. `vec`:
// every row of q, k, v, o is whole 16-byte chunks (chunks_of_16). Each of
// the 4 warps owns kMT m-tiles of 16 query rows: a block takes 64 kMT rows.
template <int DP, int kMT, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ bias, bf16* __restrict__ o,
                     float* __restrict__ lse, int L, int d, int H,
                     int64_t sb, int64_t sh, int64_t sl, float scale,
                     int causal, int vec, DropoutArgs drop) {
    constexpr int kRowsB = 16 * kMT * (kThreads / 32);   // rows a block
    constexpr int kKTile = kBK * DP;  // elements of a K or V tile
    constexpr int kSteps = DP / 16;   // k-steps of Q K^T over the head dim
    constexpr int kOutN = DP / 8;     // n-tiles of the output
    constexpr int kKeyN = kBK / 8;    // n-tiles of a score tile
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* sq = reinterpret_cast<bf16*>(smem_raw);
    bf16* sk = sq + kRowsB * DP;      // kFwdStages stages
    bf16* sv = sk + kFwdStages * kKTile; // kFwdStages stages

    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int q0 = blockIdx.y * kRowsB;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = warp * 16 * kMT;   // the warp's first row in the tile
    const int64_t base = static_cast<int64_t>(b) * sb +
                         static_cast<int64_t>(h) * sh;
    const float* bias_row =
        bias != nullptr ? bias + static_cast<int64_t>(b) * L : nullptr;
    const float scale2 = scale * kLog2e;

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
    float m[kMT][2], l[kMT][2];   // m in the log2 domain and quad-uniform;
                                  // l this lane's part of the row sums
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
        const bf16* skt = sk + (t % kFwdStages) * kKTile;
        const bf16* svt = sv + (t % kFwdStages) * kKTile;

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
                    mma_bf16(sc[mt][2 * np], qf[mt][s], kb[0], kb[1]);
                    mma_bf16(sc[mt][2 * np + 1], qf[mt][s], kb[2], kb[3]);
                }
            }

        // online softmax on the fragments, in the log2 domain; only a tile
        // that reaches past L or above the warp's diagonal needs the masks
        const bool edge =
            k0 + kBK > L || (causal && k0 + kBK - 1 > q0 + r0);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
            const int qr = q0 + r0 + 16 * mt + g;
            float mx[2] = {kNegInf, kNegInf};
#pragma unroll
            for (int n = 0; n < kKeyN; ++n) {
                fragment_scores(sc[mt][n], scale2, bias_row,
                                k0 + 8 * n + 2 * t4, qr, L, causal, edge);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    mx[e >> 1] = fmaxf(mx[e >> 1], sc[mt][n][e]);
            }
            float corr[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const float m_new = fmaxf(m[mt][i], quad_max(mx[i]));
                corr[i] = ex2(m[mt][i] - m_new);
                m[mt][i] = m_new;
                l[mt][i] *= corr[i];
            }
            if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
                for (int n = 0; n < kOutN; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[mt][n][e] *= corr[e >> 1];
            }
#pragma unroll
            for (int n = 0; n < kKeyN; ++n) {
                float ks[4];
                if (kDrop)
                    fragment_keep(drop, bh, qr, k0 + 8 * n + 2 * t4, L, lane,
                                  ks);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float p = ex2(sc[mt][n][e] - m[mt][e >> 1]);
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
                pa[mt][0] = pack_bf16(sc[mt][2 * s][0], sc[mt][2 * s][1]);
                pa[mt][1] = pack_bf16(sc[mt][2 * s][2], sc[mt][2 * s][3]);
                pa[mt][2] = pack_bf16(sc[mt][2 * s + 1][0],
                                      sc[mt][2 * s + 1][1]);
                pa[mt][3] = pack_bf16(sc[mt][2 * s + 1][2],
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
                    mma_bf16(acc[mt][2 * np], pa[mt], vb[0], vb[1]);
                    mma_bf16(acc[mt][2 * np + 1], pa[mt], vb[2], vb[3]);
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
            bf16* orow = o + base + row * sl;
#pragma unroll
            for (int n = 0; n < kOutN; ++n) {
                const int col = 8 * n + 2 * t4;
                const float v0 = acc[mt][n][2 * i] / denom;
                const float v1 = acc[mt][n][2 * i + 1] / denom;
                if (vec) {
                    if (col < d)
                        *reinterpret_cast<uint32_t*>(orow + col) =
                            pack_bf16(v0, v1);
                } else {
                    if (col < d) orow[col] = __float2bfloat16_rn(v0);
                    if (col + 1 < d) orow[col + 1] = __float2bfloat16_rn(v1);
                }
            }
            if (lse != nullptr && t4 == 0)
                lse[static_cast<int64_t>(bh) * L + row] =
                    li > 0.f ? m[mt][i] * kLn2 + logf(denom) : kLseEmpty;
        }
}

template <int DP, int kMT, bool kDrop>
int launch_mma(const bf16* q, const bf16* k, const bf16* v,
               const float* bias, bf16* o, float* lse, int64_t bh, int L,
               int d, int H, int64_t sb, int64_t sh, int64_t sl, float scale,
               int causal, const DropoutArgs& drop, cudaStream_t stream) {
    constexpr int rows = 16 * kMT * (kThreads / 32);
    // Q, kFwdStages stages of K and of V
    constexpr size_t bytes = sizeof(bf16) * (rows + 2 * kFwdStages * kBK) * DP;
    static bool configured = false;
    if (!configured) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_fwd_mma_kernel<DP, kMT, kDrop>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes));
        if (e != cudaSuccess) return static_cast<int>(e);
        configured = true;
    }
    const int64_t strides[3] = {sb, sh, sl};
    const int vec = chunks_of_16(d, strides, {q, k, v, o});
    const dim3 grid(static_cast<unsigned>(bh),
                    static_cast<unsigned>((L + rows - 1) / rows));
    flash_fwd_mma_kernel<DP, kMT, kDrop><<<grid, kThreads, bytes, stream>>>(
        q, k, v, bias, o, lse, L, d, H, sb, sh, sl, scale, causal, vec, drop);
    return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores: the head dim padded to 64 or 128
int dispatch_mma(const void* q, const void* k, const void* v,
                 const float* bias, void* o, float* lse, int64_t bh, int L,
                 int d, int H, int64_t sb, int64_t sh, int64_t sl,
                 float scale, int causal, const DropoutArgs& drop,
                 cudaStream_t st) {
    const auto qp = static_cast<const bf16*>(q);
    const auto kp = static_cast<const bf16*>(k);
    const auto vp = static_cast<const bf16*>(v);
    const auto op = static_cast<bf16*>(o);
    const bool dropout = drop.scale != 1.f;
    // D <= 64: two m-tiles a warp (128 rows a block) halve the K/V fragment
    // loads per product; under dropout one m-tile, whose registers leave
    // room for the Philox work (PERF.md)
    if (d <= 64)
        return dropout ? launch_mma<64, 1, true>(qp, kp, vp, bias, op, lse, bh,
                                                 L, d, H, sb, sh, sl, scale,
                                                 causal, drop, st)
                       : launch_mma<64, 2, false>(qp, kp, vp, bias, op, lse,
                                                  bh, L, d, H, sb, sh, sl,
                                                  scale, causal, drop, st);
    if (d <= 128)
        return dropout ? launch_mma<128, 1, true>(qp, kp, vp, bias, op, lse,
                                                  bh, L, d, H, sb, sh, sl,
                                                  scale, causal, drop, st)
                       : launch_mma<128, 1, false>(qp, kp, vp, bias, op, lse,
                                                   bh, L, d, H, sb, sh, sl,
                                                   scale, causal, drop, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

template <int DP, bool kDrop, typename T>
int launch(const T* q, const T* k, const T* v, const float* bias, T* o,
           float* lse, int64_t bh, int L, int d, int H, int64_t sb,
           int64_t sh, int64_t sl, float scale, int causal,
           const DropoutArgs& drop, cudaStream_t stream) {
    // above 48 KB a block's shared memory must be opted into; idempotent,
    // so a race between two first callers is harmless
    static bool configured = false;
    if (!configured) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_fwd_kernel<DP, kDrop, T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(Tile<DP>::bytes));
        if (e != cudaSuccess) return static_cast<int>(e);
        configured = true;
    }
    const dim3 grid(static_cast<unsigned>(bh),
                    static_cast<unsigned>((L + kBQ - 1) / kBQ));
    flash_fwd_kernel<DP, kDrop, T>
        <<<grid, kThreads, Tile<DP>::bytes, stream>>>(
            q, k, v, bias, o, lse, L, d, H, sb, sh, sl, scale, causal, drop);
    return static_cast<int>(cudaGetLastError());
}

template <int DP, typename T, typename... Args>
int launch_for(bool dropout, const T* q, Args... args) {
    return dropout ? launch<DP, true, T>(q, args...)
                   : launch<DP, false, T>(q, args...);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const float* bias,
             void* o, float* lse, int64_t bh, int L, int d, int H, int64_t sb,
             int64_t sh, int64_t sl, float scale, int causal,
             const DropoutArgs& drop, cudaStream_t st) {
    const auto qp = static_cast<const T*>(q);
    const auto kp = static_cast<const T*>(k);
    const auto vp = static_cast<const T*>(v);
    const auto op = static_cast<T*>(o);
    const bool dropout = drop.scale != 1.f;
    if (d <= 32)
        return launch_for<32>(dropout, qp, kp, vp, bias, op, lse, bh, L, d, H,
                              sb, sh, sl, scale, causal, drop, st);
    if (d <= 64)
        return launch_for<64>(dropout, qp, kp, vp, bias, op, lse, bh, L, d, H,
                              sb, sh, sl, scale, causal, drop, st);
    if (d <= 128)
        return launch_for<128>(dropout, qp, kp, vp, bias, op, lse, bh, L, d,
                               H, sb, sh, sl, scale, causal, drop, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o: (B, H, L, D), fp32 (dtype kF32) or bf16 (kBF16), with shared
// strides (sb, sh, sl) and a contiguous head dim; bh = B * H. bias: (B, L)
// contiguous fp32 or null. lse: (B*H, L) contiguous fp32 or null. D <= 128.
// Dropout is on iff drop_scale != 1. Returns cudaGetLastError() after the
// launch.
extern "C" int ptt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* o, void* lse, int64_t bh,
                                       int64_t L, int64_t d, int64_t H,
                                       int64_t sb, int64_t sh, int64_t sl,
                                       float scale, int causal,
                                       uint64_t seed, uint64_t offset,
                                       uint32_t threshold, float drop_scale,
                                       int dtype, void* stream) {
    if (bh <= 0 || bh > 0x7fffffff || L <= 0 || (L + kBQ - 1) / kBQ > 65535 ||
        d <= 0 || H <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto bp = static_cast<const float*>(bias);
    const auto lp = static_cast<float*>(lse);
    const auto st = static_cast<cudaStream_t>(stream);
    const int Li = static_cast<int>(L), di = static_cast<int>(d),
              Hi = static_cast<int>(H);
    const DropoutArgs drop{seed, offset, threshold, drop_scale};
    if (dtype == kF32)
        return dispatch<float>(q, k, v, bp, o, lp, bh, Li, di, Hi, sb, sh, sl,
                               scale, causal, drop, st);
    if (dtype == kBF16)
        return dispatch_mma(q, k, v, bp, o, lp, bh, Li, di, Hi, sb, sh, sl,
                            scale, causal, drop, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
