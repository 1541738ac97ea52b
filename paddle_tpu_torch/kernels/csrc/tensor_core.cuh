// What the tensor-core kernels share: the m16n8k16 bf16 and fp16 products and
// the m16n8k8 TF32 product with fp32 accumulation (mma.sync), the split of an
// fp32 value into two TF32 terms for the 3xTF32 product, fragment loads from
// shared memory (ldmatrix, plain and transposed; the split tf32 fragments of
// padded fp32 tiles, and an accumulator as the next A operand), 16- and 4-byte
// asynchronous copies from global to shared memory (cp.async with commit/wait
// groups), the XOR swizzle of 16-bit tile rows and the padded stride of fp32
// tile rows. The fp16 product and pack are the bf16 ones' twins: ldmatrix, the
// fragment layouts and the swizzle are those of any 16-bit type, so one kernel
// template serves both (mma_16816<T>, pack16<T>).
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
// mma.m16n8k8 with .tf32 operands ("Matrix fragments for mma.m16n8k8"):
//   A (16 x 8), 4 registers of one tf32: a0 (row g, col t), a1 (row g+8,
//     col t), a2 (row g, col t+4), a3 (row g+8, col t+4);
//   B (8 x 8), 2 registers: b0 (row t, col g), b1 (row t+4, col g);
//   C/D as m16n8k16's.
// Here the C layout (cols 2t, 2t+1) is not the A layout (cols t, t+4), so a
// C fragment of scores is the A operand of the next product only with its
// k-index permuted: A = (c0, c2, c1, c3) takes key 2t as column t and key
// 2t+1 as column t+4, and B must then take the same keys in its rows t and
// t+4. A sum over keys does not depend on their order.
//
// Hopper's full tensor-core rate needs wgmma with TMA; these kernels take
// mma.sync, which runs on the same tensor cores at a lower rate, with
// cp.async (PERF.md says why).
#pragma once

#include <cstdint>
#include <initializer_list>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "dtype.cuh"

using bf16 = __nv_bfloat16;
using f16 = __half;


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

// d += a b on the tensor cores: fp16 operands, fp32 accumulator
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the m16n8k16 product of the 16-bit type T (bf16 or fp16)
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
    static_assert(std::is_same_v<T, bf16> || std::is_same_v<T, f16>,
                  "a 16-bit tensor-core type");
    if constexpr (std::is_same_v<T, bf16>)
        mma_bf16(d, a, b0, b1);
    else
        mma_f16(d, a, b0, b1);
}

// d += a b on the tensor cores: tf32 operands (fp32 bit patterns whose low
// 13 mantissa bits are zero), fp32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo + (a remainder below 2^-22 |x|): hi = tf32(x) and lo =
// tf32(x - hi), each rounded to nearest with ties away from zero (x - hi is
// exact in fp32). The 3xTF32 product (CUTLASS's OpMultiplyAddFastF32)
// a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi drops a_lo b_lo and the
// remainders, ~2^-21 of |a b|, against fp32's own 2^-24 rounding; a single
// TF32 product is off by up to 2^-10.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
    const float rest = x - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// split_tf32 of four fp32 bit patterns (an ldmatrix'ed fragment)
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), hi[i], lo[i]);
}

// d[n] += a b[n] for N n-tiles at close to fp32 accuracy on the TF32
// tensor cores: three products each, the small terms first (lo hi, hi lo,
// then hi hi), issued term by term across the N accumulators, so that no
// product waits on the one before it
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[N][2],
                                           const uint32_t (&b_lo)[N][2]) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(d[n], a_lo, b_hi[n][0], b_hi[n][1]);
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(d[n], a_hi, b_lo[n][0], b_lo[n][1]);
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(d[n], a_hi, b_hi[n][0], b_hi[n][1]);
}

// The tf32 fragments of fp32 tiles in shared memory (rows of `stride`
// floats, f32_stride below), each split into hi/lo as it is loaded. An 8 x 4
// fp32 block is one 8 x 8 b16 matrix of ldmatrix: lane 4g + t receives
// element (g, t).
//
// A (16 x 8): rows row0 .. row0 + 15, columns col0 .. col0 + 7; the four
// 8 x 4 blocks (rows 0-7 | 8-15) x (columns 0-3 | 4-7) of one ldmatrix are
// a0 .. a3.
__device__ __forceinline__ void a_frag_tf32(const float* tile, int stride,
                                            int row0, int col0,
                                            uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
    const int lane = threadIdx.x & 31;
    uint32_t r[4];
    ldmatrix_x4(r, tile +
                       (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * stride +
                       col0 + (lane >> 4) * 4);
    split_tf32(r, hi, lo);
}

// B (8 x 8) of N n-tiles whose n index runs along the tile's rows (n-tile n:
// rows 8n .. 8n + 7) and whose k index along columns col0 .. col0 + 7: b0 /
// b1 of n-tiles 2np, 2np + 1 are the 8 x 4 blocks (rows 0-7 | 8-15 of the
// pair) x (columns 0-3 | 4-7) of one ldmatrix.
template <int N>
__device__ __forceinline__ void b_frags_tf32(const float* tile, int stride,
                                             int col0, uint32_t (&hi)[N][2],
                                             uint32_t (&lo)[N][2]) {
    static_assert(N % 2 == 0, "n-tiles in pairs");
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int np = 0; np < N / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, tile +
                           (np * 16 + (lane & 7) + (lane >> 4) * 8) * stride +
                           col0 + ((lane >> 3) & 1) * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
            split_tf32(__uint_as_float(r[i]), hi[2 * np + (i >> 1)][i & 1],
                       lo[2 * np + (i >> 1)][i & 1]);
    }
}

// B of N n-tiles whose k index runs DOWN the tile's rows row0 .. row0 + 7,
// in the order a C fragment taken as A (c_as_a_tf32) gives them: B's rows t
// and t + 4 are tile rows row0 + 2t and row0 + 2t + 1; n-tile n is columns
// col0 + 8n .. + 7, read at column g. Plain 32-bit loads.
template <int N>
__device__ __forceinline__ void b_frags_col_tf32(const float* tile,
                                                 int stride, int row0,
                                                 int col0,
                                                 uint32_t (&hi)[N][2],
                                                 uint32_t (&lo)[N][2]) {
    const int lane = threadIdx.x & 31;
    const float* p = tile + (row0 + 2 * (lane & 3)) * stride + col0 +
                     (lane >> 2);
#pragma unroll
    for (int n = 0; n < N; ++n) {
        split_tf32(p[8 * n], hi[n][0], lo[n][0]);
        split_tf32(p[stride + 8 * n], hi[n][1], lo[n][1]);
    }
}

// An fp32 accumulator fragment (16 x 8) as the A operand of the next
// m16n8k8 product, split: (c0, c2, c1, c3), its columns permuted inside the
// k8 block as the header says, so B must come from b_frags_col_tf32.
__device__ __forceinline__ void c_as_a_tf32(const float (&c)[4],
                                            uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
    split_tf32(c[0], hi[0], lo[0]);
    split_tf32(c[2], hi[1], lo[1]);
    split_tf32(c[1], hi[2], lo[2]);
    split_tf32(c[3], hi[3], lo[3]);
}

// two fp32 values rounded to nearest even into one bf16 pair, `lo` in the
// low half: the order of an A fragment's and of memory's columns
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// as pack_bf16, into one fp16 pair (past 65504 a value becomes inf, as a
// cast to fp16 makes it)
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// two fp32 values into one pair of the 16-bit type T
template <typename T>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
    if constexpr (std::is_same_v<T, bf16>)
        return pack_bf16(lo, hi);
    else
        return pack_f16(lo, hi);
}

// Element offset of (row, col) in a shared tile of 16-bit rows W wide (W a
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
template <int R, int W, int NT, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int64_t base,
                                          int64_t sl, int row0, int L, int d,
                                          bool vec) {
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
                                    : from_f32<T>(0.f);
        }
    }
}

// Floats a shared fp32 tile row of W (a multiple of 32) takes: W + 4, so
// that a row is whole 16-byte chunks and eight rows at one column fall in
// eight different 4-bank groups (the stride is 4 mod 32 words). Then the
// ldmatrix loads of tf32 A and B fragments (an 8 x 4 fp32 block is one
// 8 x 8 b16 matrix: lane 4g + t receives element (g, t)) and the 32-bit
// loads of a B fragment read down a column (rows 2t and 2t + 1 of column
// g) are free of bank conflicts.
__host__ __device__ constexpr int f32_stride(int W) { return W + 4; }

// As load_rows, for fp32 rows into an R x f32_stride(W) tile without a
// swizzle. `vec`: 16-byte cp.async (rows whole 4-float chunks,
// chunks_of_16<float>).
template <int R, int W, int NT>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int64_t base, int64_t sl,
                                              int row0, int L, int d,
                                              bool vec) {
    constexpr int S = f32_stride(W);
    if (vec) {
        constexpr int kChunks = W / 4;
        for (int i = threadIdx.x; i < R * kChunks; i += NT) {
            const int r = i / kChunks, c = (i % kChunks) * 4, row = row0 + r;
            const bool ok = row < L && c < d;
            cp_async16(dst + r * S + c, ok ? src + base + row * sl + c : src,
                       ok);
        }
    } else {
        for (int i = threadIdx.x; i < R * W; i += NT) {
            const int r = i / W, c = i % W, row = row0 + r;
            dst[r * S + c] =
                (row < L && c < d) ? src[base + row * sl + c] : 0.f;
        }
    }
}

// Whether a tensor of T's rows may move in 16-byte chunks: d, the three
// strides (batch, head, row) and every pointer whole chunks of 16 / sizeof(T)
// elements.
template <typename T>
inline bool chunks_of_16(int64_t d, const int64_t (&strides)[3],
                         std::initializer_list<const void*> ptrs) {
    for (const int64_t st : strides)
        if (st % (16 / static_cast<int64_t>(sizeof(T))) != 0) return false;
    return rows_vectorise<T>(d, ptrs);
}
