// Counter-based dropout masks: Philox4x32-10, written out.
//
// Replaces: paddle_tpu/kernels/_common.py, tile_keep_scale (a device helper
// of the flash-attention and dropout+add+LayerNorm kernels, no launch of
// its own). The TPU helper seeds the hardware PRNG per tile; here the mask
// is keyed on the ELEMENT, so kernels that tile a matrix differently (the
// attention forward, dQ and dK/dV) regenerate the same bit for the same
// element and no mask is ever stored:
//
//   key     = the 64-bit seed (low word, high word)
//   counter = (i / 4 low, i / 4 high, offset low, offset high)
//   element i takes word i % 4 of the four output words
//
// with i the element's linear index in its tensor and `offset` the number
// of the dropout call. The decision rule is the reference's: keep where
// the word >= min(int(p * 2^32), 2^32 - 1), kept values scaled by
// 1 / (1 - p). kernels/philox.py computes the same bits with torch integer
// ops, which is why the rounds are spelled out here and cuRAND is not used.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

struct PhiloxWords {
    uint32_t w[4];
};

// One of the ten rounds, with that round's key (k0, k1).
__device__ __forceinline__ void philox_round(uint32_t& c0, uint32_t& c1,
                                             uint32_t& c2, uint32_t& c3,
                                             uint32_t k0, uint32_t k1) {
    constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
}

constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ PhiloxWords philox4x32_10(uint64_t seed,
                                                     uint64_t offset,
                                                     uint64_t index4) {
    uint32_t k0 = static_cast<uint32_t>(seed);
    uint32_t k1 = static_cast<uint32_t>(seed >> 32);
    uint32_t c0 = static_cast<uint32_t>(index4);
    uint32_t c1 = static_cast<uint32_t>(index4 >> 32);
    uint32_t c2 = static_cast<uint32_t>(offset);
    uint32_t c3 = static_cast<uint32_t>(offset >> 32);
#pragma unroll
    for (int round = 0; round < 10; ++round) {
        philox_round(c0, c1, c2, c3, k0, k1);
        k0 += kPhiloxW0;
        k1 += kPhiloxW1;
    }
    return PhiloxWords{{c0, c1, c2, c3}};
}

// The keys of the ten rounds (the seed's words plus r times the Weyl
// constants in round r), the same for every call of a launch. A kernel
// that makes many calls takes them computed on the host, as a kernel
// argument: each round's key is then an operand in the constant bank, and
// not two additions a round in every call.
struct PhiloxKeys {
    uint32_t k0[10];
    uint32_t k1[10];
};

inline PhiloxKeys philox_keys(uint64_t seed) {
    PhiloxKeys keys;
    uint32_t k0 = static_cast<uint32_t>(seed);
    uint32_t k1 = static_cast<uint32_t>(seed >> 32);
    for (int round = 0; round < 10; ++round) {
        keys.k0[round] = k0;
        keys.k1[round] = k1;
        k0 += kPhiloxW0;
        k1 += kPhiloxW1;
    }
    return keys;
}

// The same bits as philox4x32_10(seed, offset, index4), from the keys of
// philox_keys(seed).
__device__ __forceinline__ PhiloxWords philox4x32_10(const PhiloxKeys& keys,
                                                     uint64_t offset,
                                                     uint64_t index4) {
    uint32_t c0 = static_cast<uint32_t>(index4);
    uint32_t c1 = static_cast<uint32_t>(index4 >> 32);
    uint32_t c2 = static_cast<uint32_t>(offset);
    uint32_t c3 = static_cast<uint32_t>(offset >> 32);
#pragma unroll
    for (int round = 0; round < 10; ++round)
        philox_round(c0, c1, c2, c3, keys.k0[round], keys.k1[round]);
    return PhiloxWords{{c0, c1, c2, c3}};
}

// What every dropout kernel is handed: p > 0 iff `scale` != 1.
struct DropoutArgs {
    uint64_t seed;
    uint64_t offset;
    uint32_t threshold;   // min(int(p * 2^32), 2^32 - 1)
    float scale;          // 1 / (1 - p)
};

// DropoutArgs with the key schedule computed on the host (dropout on iff
// `scale` != 1), for kernels that make many Philox calls a thread.
struct DropoutKeys {
    PhiloxKeys keys;
    uint64_t offset;
    uint32_t threshold;
    float scale;
};

inline DropoutKeys dropout_keys(const DropoutArgs& drop) {
    return DropoutKeys{philox_keys(drop.seed), drop.offset, drop.threshold,
                       drop.scale};
}

// Word `lane` (0..3) of `r`, by selects: indexing a register array with a
// run-time value would put it in local memory.
__device__ __forceinline__ uint32_t philox_word(const PhiloxWords& r,
                                                uint32_t lane) {
    const uint32_t lo = (lane & 1) ? r.w[1] : r.w[0];
    const uint32_t hi = (lane & 1) ? r.w[3] : r.w[2];
    return (lane & 2) ? hi : lo;
}
