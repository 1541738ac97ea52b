// Flash attention forward, fp32: o = softmax(q k^T * scale + bias) v, plus
// the per-row logsumexp.
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
// the matrix the other way, regenerate the same bits.
//
// Bound on the H100: operations. 4 * L^2 * D flops a head against
// 16 * L * D bytes, so at L = 512 about 128 flops a byte, above the
// 20 flop/byte ridge of fp32 CUDA cores (67 TFLOP/s over 3.35 TB/s). This
// first version runs on the fp32 FMA pipes; tensor cores (mma/wgmma in
// TF32 or bf16), TMA and a load/compute pipeline are later work.
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

// q, k, v, o share strides (sb, sh, sl) in elements; the head dim is
// contiguous. bias: (B, L) or null. lse: (B*H, L) or null.
template <int DP, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ o, float* __restrict__ lse, int L, int d,
                 int H, int64_t sb, int64_t sh, int64_t sl, float scale,
                 int causal, DropoutArgs drop) {
    using T = Tile<DP>;
    constexpr int kOut = DP / 16;  // output columns per thread
    extern __shared__ float smem[];
    float* sq = smem;
    float* sk = sq + T::q;
    float* sv = sk + T::k;
    float* sp = sv + T::v;

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
        sq[r * T::qk_stride + c] =
            (qr < L && c < d) ? q[base + qr * sl + c] : 0.f;
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
            sk[r * T::qk_stride + c] = in ? k[base + kr * sl + c] : 0.f;
            sv[r * DP + c] = in ? v[base + kr * sl + c] : 0.f;
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
                kc[j] = sk[(tx + 16 * j) * T::qk_stride + c];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const float qv = sq[(ty + 8 * i) * T::qk_stride + c];
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
                sp[(ty + 8 * i) * T::p_stride + tx + 16 * j] = pd;
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
                const float p = sp[(ty + 8 * i) * T::p_stride + kk];
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
        float* orow = o + base + qr * sl;
#pragma unroll
        for (int c = 0; c < kOut; ++c) {
            const int col = tx + 16 * c;
            if (col < d) orow[col] = acc[i][c] / denom;
        }
        if (lse != nullptr && tx == 0)
            lse[static_cast<int64_t>(bh) * L + qr] =
                l[i] > 0.f ? m[i] + logf(denom) : kLseEmpty;
    }
}

template <int DP, bool kDrop>
int launch(const float* q, const float* k, const float* v, const float* bias,
           float* o, float* lse, int64_t bh, int L, int d, int H, int64_t sb,
           int64_t sh, int64_t sl, float scale, int causal,
           const DropoutArgs& drop, cudaStream_t stream) {
    // above 48 KB a block's shared memory must be opted into; idempotent,
    // so a race between two first callers is harmless
    static bool configured = false;
    if (!configured) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_fwd_kernel<DP, kDrop>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(Tile<DP>::bytes));
        if (e != cudaSuccess) return static_cast<int>(e);
        configured = true;
    }
    const dim3 grid(static_cast<unsigned>(bh),
                    static_cast<unsigned>((L + kBQ - 1) / kBQ));
    flash_fwd_kernel<DP, kDrop><<<grid, kThreads, Tile<DP>::bytes, stream>>>(
        q, k, v, bias, o, lse, L, d, H, sb, sh, sl, scale, causal, drop);
    return static_cast<int>(cudaGetLastError());
}

template <int DP, typename... Args>
int launch_for(bool dropout, Args... args) {
    return dropout ? launch<DP, true>(args...) : launch<DP, false>(args...);
}

}  // namespace

// q, k, v, o: (B, H, L, D) fp32 with shared strides (sb, sh, sl) and a
// contiguous head dim; bh = B * H. bias: (B, L) contiguous fp32 or null.
// lse: (B*H, L) contiguous fp32 or null. D <= 128. Dropout is on iff
// drop_scale != 1. Returns cudaGetLastError() after the launch.
extern "C" int ptt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* o, void* lse, int64_t bh,
                                       int64_t L, int64_t d, int64_t H,
                                       int64_t sb, int64_t sh, int64_t sl,
                                       float scale, int causal,
                                       uint64_t seed, uint64_t offset,
                                       uint32_t threshold, float drop_scale,
                                       void* stream) {
    if (bh <= 0 || bh > 0x7fffffff || L <= 0 || (L + kBQ - 1) / kBQ > 65535 ||
        d <= 0 || H <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto qp = static_cast<const float*>(q);
    const auto kp = static_cast<const float*>(k);
    const auto vp = static_cast<const float*>(v);
    const auto bp = static_cast<const float*>(bias);
    const auto op = static_cast<float*>(o);
    const auto lp = static_cast<float*>(lse);
    const auto st = static_cast<cudaStream_t>(stream);
    const int Li = static_cast<int>(L), di = static_cast<int>(d),
              Hi = static_cast<int>(H);
    const DropoutArgs drop{seed, offset, threshold, drop_scale};
    const bool dropout = drop_scale != 1.f;
    if (d <= 32)
        return launch_for<32>(dropout, qp, kp, vp, bp, op, lp, bh, Li, di, Hi,
                              sb, sh, sl, scale, causal, drop, st);
    if (d <= 64)
        return launch_for<64>(dropout, qp, kp, vp, bp, op, lp, bh, Li, di, Hi,
                              sb, sh, sl, scale, causal, drop, st);
    if (d <= 128)
        return launch_for<128>(dropout, qp, kp, vp, bp, op, lp, bh, Li, di,
                               Hi, sb, sh, sl, scale, causal, drop, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
