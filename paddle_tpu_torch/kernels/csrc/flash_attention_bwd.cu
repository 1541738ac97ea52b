// Flash attention backward, fp32: dQ, and dK/dV, from (q, k, v, dO, lse,
// delta) with delta = rowsum(dO * O). Neither stores an (L, L) matrix:
// each rebuilds P = exp(S - lse) tile by tile, with
//   dP = dO V^T (times keep / (1 - p) under dropout),
//   dS = P * (dP - delta),
//   dQ = scale * dS K,   dK = scale * dS^T Q,   dV = (P * keep/(1-p))^T dO.
//
// Replaces: paddle_tpu/kernels/flash_attention.py, _dq_kernel and
// _dkv_kernel (both launched by _flash_backward). S is rebuilt by
// masked_score exactly as the forward built it (scale, key-padding bias,
// -inf above the causal diagonal and past L), and the dropout mask by philox.cuh from
// the element (bh, query row, key column), so both kernels see the
// forward's bits although they walk the matrix in other orders. A row
// whose every key was -inf has lse = 1e30: its P is exp(-inf) = 0 and all
// its gradients are 0, never NaN. The bias gets no gradient.
//
// Bound on the H100: operations. dQ is three products (S, dP, dS K),
// 6 L^2 D flops a head; dK/dV four (S, dP, P^T dO, dS^T Q), 8 L^2 D;
// against some 24 L D bytes a head each.
//
// Design: both use the forward's layout: 128 threads, thread (ty, tx) owns
// rows ty + 8i and score columns tx + 16j of a 64 x 64 tile; S and dP come
// out of one loop over the head dim. dQ: grid (B*H, ceil(L/64)) over Q
// tiles; Q, dO, lse and delta stay resident and K/V tiles stream through
// (the TPU kernel's sequential grid axis is this loop); dS goes through
// shared memory for dS K. dK/dV: grid over K tiles; K, V resident, Q/dO
// tiles stream, from the diagonal on when causal; P and dS go through
// shared memory and are read by columns (rows padded by one float) for
// the two transposed products. One block owns a K tile, so no atomics.
// Rows past L load lse = 1e30 and dO = 0 and store nothing. Shared memory
// is 83-100 KB at D = 64 and 149-166 KB at D = 128, opted into with
// cudaFuncSetAttribute.
#include <cstdint>

#include "flash_common.cuh"
#include "philox.cuh"

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

// 64 rows from row0 of one head of `src` into a padded shared tile, zero
// past L and past d.
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

// q, k, v and dq share strides `s`; dO has `gs`. lse, delta: (B*H, L).
template <int DP, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ bias, float* __restrict__ dq, int L,
                int d, int H, Strides s, Strides gs, float scale, int causal,
                DropoutArgs drop) {
    using T = BwdTile<DP>;
    constexpr int kOut = DP / 16;
    extern __shared__ float smem[];
    float* sq = smem;
    float* sdo = sq + T::mat;
    float* sk = sdo + T::mat;
    float* sv = sk + T::mat;
    float* sds = sv + T::mat;

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
                sds[(ty + 8 * i) * T::p_stride + tx + 16 * j] = ds[i][j];
        __syncthreads();

#pragma unroll 4
        for (int kk = 0; kk < kBK; ++kk) {
            float kv[kOut];
#pragma unroll
            for (int c = 0; c < kOut; ++c)
                kv[c] = sk[kk * T::stride + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const float dsv = sds[(ty + 8 * i) * T::p_stride + kk];
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
            if (col < d) dq[base + qr * s.l + col] = acc[i][c] * scale;
        }
    }
}

// q, k, v, dk and dv share strides `s`; dO has `gs`.
template <int DP, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ bias, float* __restrict__ dk,
                 float* __restrict__ dv, int L, int d, int H, Strides s,
                 Strides gs, float scale, int causal, DropoutArgs drop) {
    using T = BwdTile<DP>;
    constexpr int kOut = DP / 16;
    extern __shared__ float smem[];
    float* sq = smem;
    float* sdo = sq + T::mat;
    float* sk = sdo + T::mat;
    float* sv = sk + T::mat;
    float* sp = sv + T::mat;
    float* sds = sp + T::p;

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
                const int at = (ty + 8 * i) * T::p_stride + tx + 16 * j;
                sp[at] = p[i][j];
                sds[at] = ds[i][j];
            }
        __syncthreads();

#pragma unroll 2
        for (int qq = 0; qq < kBQ; ++qq) {
            float gv[kOut], qv[kOut];
#pragma unroll
            for (int c = 0; c < kOut; ++c) {
                gv[c] = sdo[qq * T::stride + tx + 16 * c];
                qv[c] = sq[qq * T::stride + tx + 16 * c];
            }
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const float pv = sp[qq * T::p_stride + ty + 8 * i];
                const float dsv = sds[qq * T::p_stride + ty + 8 * i];
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

struct BwdArgs {
    const float *q, *k, *v, *dout, *lse, *delta, *bias;
    float *dq, *dk, *dv;
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
            a.q, a.k, a.v, a.dout, a.lse, a.delta, a.bias, a.dq, a.L, a.d,
            a.H, a.s, a.gs, a.scale, a.causal, a.drop);
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
            a.q, a.k, a.v, a.dout, a.lse, a.delta, a.bias, a.dk, a.dv, a.L,
            a.d, a.H, a.s, a.gs, a.scale, a.causal, a.drop);
    return static_cast<int>(cudaGetLastError());
}

template <bool kDkv, int DP>
int launch_one(const BwdArgs& a) {
    const bool dropout = a.drop.scale != 1.f;
    if constexpr (kDkv)
        return dropout ? launch_dkv<DP, true>(a) : launch_dkv<DP, false>(a);
    else
        return dropout ? launch_dq<DP, true>(a) : launch_dq<DP, false>(a);
}

template <bool kDkv>
int dispatch(const BwdArgs& a) {
    if (a.bh <= 0 || a.bh > 0x7fffffff || a.L <= 0 ||
        (a.L + kBQ - 1) / kBQ > 65535 || a.d <= 0 || a.H <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (a.d <= 32) return launch_one<kDkv, 32>(a);
    if (a.d <= 64) return launch_one<kDkv, 64>(a);
    if (a.d <= 128) return launch_one<kDkv, 128>(a);
    return static_cast<int>(cudaErrorInvalidValue);
}

BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  const void* bias, void* dq, void* dk, void* dv, int64_t bh,
                  int64_t L, int64_t d, int64_t H, const int64_t* strides,
                  float scale, int causal, uint64_t seed, uint64_t offset,
                  uint32_t threshold, float drop_scale, void* stream) {
    const auto f = [](const void* p) { return static_cast<const float*>(p); };
    const auto m = [](void* p) { return static_cast<float*>(p); };
    return BwdArgs{f(q), f(k), f(v), f(dout), f(lse), f(delta), f(bias),
                   m(dq), m(dk), m(dv), bh, static_cast<int>(L),
                   static_cast<int>(d), static_cast<int>(H),
                   Strides{strides[0], strides[1], strides[2]},
                   Strides{strides[3], strides[4], strides[5]}, scale, causal,
                   DropoutArgs{seed, offset, threshold, drop_scale},
                   static_cast<cudaStream_t>(stream)};
}

}  // namespace

// q, k, v, dq: (B, H, L, D) fp32 with shared strides (sb, sh, sl); dO with
// its own (gsb, gsh, gsl); every head dim contiguous; bh = B * H. lse,
// delta: (B*H, L) contiguous fp32. bias: (B, L) contiguous fp32 or null.
// D <= 128. Dropout is on iff drop_scale != 1. Returns cudaGetLastError()
// after the launch.
extern "C" int ptt_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dq,
    int64_t bh, int64_t L, int64_t d, int64_t H, int64_t sb, int64_t sh,
    int64_t sl, int64_t gsb, int64_t gsh, int64_t gsl, float scale,
    int causal, uint64_t seed, uint64_t offset, uint32_t threshold,
    float drop_scale, void* stream) {
    if (L > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t strides[6] = {sb, sh, sl, gsb, gsh, gsl};
    return dispatch<false>(make_args(q, k, v, dout, lse, delta, bias, dq,
                                     nullptr, nullptr, bh, L, d, H, strides,
                                     scale, causal, seed, offset, threshold,
                                     drop_scale, stream));
}

// As ptt_flash_attention_dq, writing dk and dv (strides of q, k, v).
extern "C" int ptt_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dk, void* dv,
    int64_t bh, int64_t L, int64_t d, int64_t H, int64_t sb, int64_t sh,
    int64_t sl, int64_t gsb, int64_t gsh, int64_t gsl, float scale,
    int causal, uint64_t seed, uint64_t offset, uint32_t threshold,
    float drop_scale, void* stream) {
    if (L > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t strides[6] = {sb, sh, sl, gsb, gsh, gsl};
    return dispatch<true>(make_args(q, k, v, dout, lse, delta, bias, nullptr,
                                    dk, dv, bh, L, d, H, strides, scale,
                                    causal, seed, offset, threshold,
                                    drop_scale, stream));
}
