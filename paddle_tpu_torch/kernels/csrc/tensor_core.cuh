// What the bf16 tensor-core kernels share: the m16n8k16 product with fp32
// accumulation (mma.sync), fragment loads from shared memory (ldmatrix,
// plain and transposed), 16- and 4-byte asynchronous copies from global to
// shared memory (cp.async with commit/wait groups), and the XOR swizzle of
// bf16 tile rows.
//
// Fragment layout of mma.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), lane = 4 * g + t (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), 4 registers of two bf16: a0 (row g, cols 2t,
//     2t+1), a1 (row g+8, cols 2t..), a2 (row g, cols 8+2t..), a3 (row g+8,
//     cols 8+2t..);
//   B (16 x 8), 2 registers: b0 (rows 2t, 2t+1 of column g), b1 (rows 8+2t..);
//   C/D (16 x 8, fp32), 4 floats: c0, c1 (row g, cols 2t, 2t+1), c2, c3
//     (row g+8, cols 2t, 2t+1).
// A C fragment of scores is therefore, two n-tiles at a time, the A
// fragment of the next product: no trip through shared memory.
//
// Hopper's full tensor-core rate needs wgmma with TMA; these kernels take
// mma.sync, which runs on the same tensor cores at a lower rate, with
// cp.async (PERF.md says why).
#pragma once

#include <cstdint>
#include <initializer_list>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

using bf16 = __nv_bfloat16;


__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without waiting; with `valid` false nothing is
// read (src may be any mapped address) and the 16 bytes are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, as cp_async16
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 4 : 0));
}

// close the group of copies issued since the last commit
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, which lands in r[i] as the A/B fragment layout above
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}

// the same four matrices, each transposed on the way
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}

// d += a b on the tensor cores: bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to nearest even into one bf16 pair, `lo` in the
// low half: the order of an A fragment's and of memory's columns
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// Element offset of (row, col) in a shared tile of bf16 rows W wide (W a
// multiple of 64, so a row is at least eight 16-byte chunks): the chunk
// index is XORed with row % 8, so the eight row addresses of one ldmatrix
// matrix (one chunk column of eight rows) fall in eight different bank
// groups, and a 16-byte cp.async stays one chunk.
template <int W>
__device__ __forceinline__ int swz(int row, int col) {
    static_assert(W % 64 == 0, "rows of whole 8-chunk groups");
    return row * W + ((((col >> 3) ^ (row & 7)) << 3) | (col & 7));
}

// Rows row0 .. row0 + R - 1 of one head (`src + base`, row stride `sl`
// elements, head dim contiguous) into a swizzled R x W shared tile, by NT
// threads; rows past L and columns past d are zero. `vec`: 16-byte
// cp.async (the caller allows it only when d, the strides and the pointer
// are whole 16-byte chunks); else element loads and stores, synchronous,
// into the same layout.
template <int R, int W, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int64_t base, int64_t sl, int row0,
                                          int L, int d, bool vec) {
    if (vec) {
        constexpr int kChunks = W / 8;
        for (int i = threadIdx.x; i < R * kChunks; i += NT) {
            const int r = i / kChunks, c = (i % kChunks) * 8, row = row0 + r;
            const bool ok = row < L && c < d;
            cp_async16(dst + swz<W>(r, c),
                       ok ? src + base + row * sl + c : src, ok);
        }
    } else {
        for (int i = threadIdx.x; i < R * W; i += NT) {
            const int r = i / W, c = i % W, row = row0 + r;
            dst[swz<W>(r, c)] = (row < L && c < d)
                                    ? src[base + row * sl + c]
                                    : __float2bfloat16_rn(0.f);
        }
    }
}

// Whether a bf16 tensor's rows may move in 16-byte chunks: d, the three
// strides (batch, head, row) and every pointer whole chunks of 8 elements.
inline bool chunks_of_16(int64_t d, const int64_t (&strides)[3],
                         std::initializer_list<const void*> ptrs) {
    for (const int64_t st : strides)
        if (st % 8 != 0) return false;
    return rows_vectorise<bf16>(d, ptrs);
}
