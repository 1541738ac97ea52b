// The three element types the kernels take, fp32, bf16 and fp16, and how a
// kernel reads and writes them. Whatever the element type, arithmetic is fp32:
// a value is widened on load and rounded (to nearest even, as torch's and
// JAX's casts round) on store. round_to<T> is the round trip a value makes
// where the reference casts it to the input dtype before a product.
#pragma once

#include <cstdint>
#include <initializer_list>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// what the C entry points take to pick the instantiation
enum ElemType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}
// past 65504 (the largest fp16) a value rounds to inf, as torch's and
// JAX's casts round it
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
    return __float2half_rn(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
    return to_f32(from_f32<T>(v));
}

// N elements moved by one load or store instruction
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
    T v[N];
};

// A row kernel's thread takes G neighbouring columns a step, starting at a
// multiple of G. kVec: 16-byte accesses (G = 4 fp32, 8 bf16 or fp16), which
// the caller allows only when the row width is a multiple of G and every
// pointer is 16-byte aligned. Otherwise G = 4 and the accesses are element
// by element, with the columns past d read as 0 and not written.
template <typename T, bool kVec>
struct RowIO {
    static constexpr int G = kVec ? 16 / static_cast<int>(sizeof(T)) : 4;

    static __device__ __forceinline__ bool in(int64_t c0, int e, int64_t d) {
        return kVec || c0 + e < d;
    }

    template <typename U>
    static __device__ __forceinline__ void load(const U* __restrict__ p,
                                                int64_t c0, int64_t d,
                                                float (&v)[G]) {
        if constexpr (kVec) {
            constexpr int per = 16 / static_cast<int>(sizeof(U));
            static_assert(G % per == 0, "a step is whole 16-byte packs");
#pragma unroll
            for (int q = 0; q < G / per; ++q) {
                const Pack<U, per> pk =
                    reinterpret_cast<const Pack<U, per>*>(p + c0)[q];
#pragma unroll
                for (int e = 0; e < per; ++e) v[q * per + e] = to_f32(pk.v[e]);
            }
        } else {
#pragma unroll
            for (int e = 0; e < G; ++e)
                v[e] = c0 + e < d ? to_f32(p[c0 + e]) : 0.f;
        }
    }

    template <typename U>
    static __device__ __forceinline__ void store(U* __restrict__ p,
                                                 int64_t c0, int64_t d,
                                                 const float (&v)[G]) {
        if constexpr (kVec) {
            constexpr int per = 16 / static_cast<int>(sizeof(U));
            static_assert(G % per == 0, "a step is whole 16-byte packs");
#pragma unroll
            for (int q = 0; q < G / per; ++q) {
                Pack<U, per> pk;
#pragma unroll
                for (int e = 0; e < per; ++e)
                    pk.v[e] = from_f32<U>(v[q * per + e]);
                reinterpret_cast<Pack<U, per>*>(p + c0)[q] = pk;
            }
        } else {
#pragma unroll
            for (int e = 0; e < G; ++e)
                if (c0 + e < d) p[c0 + e] = from_f32<U>(v[e]);
        }
    }
};

// Whether a row kernel may take 16-byte accesses: d a multiple of the
// pack's width and every (non-null) pointer 16-byte aligned.
template <typename T>
inline bool rows_vectorise(int64_t d,
                           std::initializer_list<const void*> ptrs) {
    if (d % (16 / static_cast<int64_t>(sizeof(T))) != 0) return false;
    for (const void* p : ptrs)
        if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
    return true;
}
