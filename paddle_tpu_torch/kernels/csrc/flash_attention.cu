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
// the matrix the other way, regenerate the same bits. At bf16, q/k/v are
// read as bf16 and every product of two bf16 values is exact in fp32, so
// the scores, the softmax statistics and the output accumulate in fp32 as
// on the TPU's MXU; P (dropped, unnormalised) is rounded to bf16 before the
// P.V product, where the reference casts it to v's dtype; o is stored in
// bf16 and lse in fp32.
//
// Bound on the H100: operations. 4 * L^2 * D flops a head against
// 16 * L * D bytes, so at L = 512 about 128 flops a byte, above the
// 20 flop/byte ridge of fp32 CUDA cores (67 TFLOP/s over 3.35 TB/s); at
// bf16 the bound is the tensor cores' 989 TFLOP/s, which these FMA loops
// cannot approach. This version runs on the fp32 FMA pipes at both dtypes
// (bf16 tiles are widened to fp32 in shared memory); tensor cores
// (mma/wgmma), TMA and a load/compute pipeline are later work.
//
// Design: grid (B*H, ceil(L/64)); each block keeps a 64-row Q tile in
// shared memory and walks 64-key K/V tiles through shared memory (the
// sequential grid axis of the TPU kernel becomes this loop). 128 threads:
// thread (ty, tx) owns query rows ty + 8i (i < 8) and score columns
// tx + 16j (j < 4), so a row's max and sum are 16-lane shuffles; the P
// tile goes through shared memory for the P.V product, where the thread
// owns output columns tx + 16c. Q and K rows are padded by one float so
// the column-wise reads do not collide on banks. Keys past L are -inf
// (no L % block rule), rows past L are computed and not stored, and the
// head dim is zero-padded to 32, 64 or 128. With dropout a thread's four
// score columns lie 16 apart, so it uses one word of each Philox call: the
// generator then costs about as much as the products (PERF.md).
#include <cstdint>

#include "dtype.cuh"
#include "flash_common.cuh"
#include "philox.cuh"

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
        return dispatch<__nv_bfloat16>(q, k, v, bp, o, lp, bh, Li, di, Hi, sb,
                                       sh, sl, scale, causal, drop, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
