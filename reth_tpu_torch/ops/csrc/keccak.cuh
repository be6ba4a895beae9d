// keccak-f[1600] for Hopper (sm_90a): the permutation every kernel of the
// state commitment shares (keccak.cu, fused_level.cu).
//
// Replaces the TPU formulation in the JAX package (ops/keccak_pallas.py
// _keccak_kernel and ops/keccak_jax.py keccak_f1600_jax), which split each
// 64-bit lane into u32 lo/hi halves for the TPU's 32-bit vector unit and laid
// the batch across 256-lane tiles. On Hopper each thread owns one message:
// the 25 lanes are native uint64_t values in registers, and a 64-bit rotate
// by a constant compiles to two funnel shifts (SHF). The 24 rounds are fully
// unrolled, so every rotation amount and lane index is a compile-time
// constant and the state never leaves registers; the round constants live
// in __constant__ memory.
//
// Bound: integer issue. One permutation is a fixed count of LOP3/SHF
// instructions (chip_smoke.py counts them in the compiled SASS: 4,723
// integer instructions in keccak256_absorb_kernel with CUDA 12.8) against
// the SMs' 32-bit integer rate (64 per clock per SM); a message of B rate
// blocks costs B permutations and moves only its own bytes, so the kernels
// that use this header are operation-bound, not memory-bound.

#pragma once

#include <cstdint>

#define KECCAK_RATE 136
#define KECCAK_RATE_LANES 17

__constant__ uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

__device__ __forceinline__ uint64_t keccak_rotl(uint64_t x, int r) {
    return (x << r) | (x >> (64 - r));
}

// One keccak-f[1600] permutation in place. Lane index is x + 5*y (FIPS-202).
// RoundUnroll rounds are unrolled per loop trip (24: all of them). Within a
// round every lane index and rotation is a compile-time constant either way;
// a rolled loop trades a few loop instructions per round for a ~24x smaller
// body, which warps at different points of the permutation share in the
// instruction caches.
template <int RoundUnroll = 24>
__device__ __forceinline__ void keccak_f1600(uint64_t a[25]) {
#pragma unroll (RoundUnroll)
    for (int round = 0; round < 24; ++round) {
        // theta
        uint64_t c[5], d[5];
#pragma unroll
        for (int x = 0; x < 5; ++x)
            c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
        for (int x = 0; x < 5; ++x)
            d[x] = c[(x + 4) % 5] ^ keccak_rotl(c[(x + 1) % 5], 1);
#pragma unroll
        for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];
        // rho + pi: b[y + 5*((2x + 3y) % 5)] = rotl(a[x + 5y], r[x][y])
        uint64_t b[25];
        b[0] = a[0];
        b[1] = keccak_rotl(a[6], 44);
        b[2] = keccak_rotl(a[12], 43);
        b[3] = keccak_rotl(a[18], 21);
        b[4] = keccak_rotl(a[24], 14);
        b[5] = keccak_rotl(a[3], 28);
        b[6] = keccak_rotl(a[9], 20);
        b[7] = keccak_rotl(a[10], 3);
        b[8] = keccak_rotl(a[16], 45);
        b[9] = keccak_rotl(a[22], 61);
        b[10] = keccak_rotl(a[1], 1);
        b[11] = keccak_rotl(a[7], 6);
        b[12] = keccak_rotl(a[13], 25);
        b[13] = keccak_rotl(a[19], 8);
        b[14] = keccak_rotl(a[20], 18);
        b[15] = keccak_rotl(a[4], 27);
        b[16] = keccak_rotl(a[5], 36);
        b[17] = keccak_rotl(a[11], 10);
        b[18] = keccak_rotl(a[17], 15);
        b[19] = keccak_rotl(a[23], 56);
        b[20] = keccak_rotl(a[2], 62);
        b[21] = keccak_rotl(a[8], 55);
        b[22] = keccak_rotl(a[14], 39);
        b[23] = keccak_rotl(a[15], 41);
        b[24] = keccak_rotl(a[21], 2);
        // chi
#pragma unroll
        for (int y = 0; y < 25; y += 5) {
#pragma unroll
            for (int x = 0; x < 5; ++x)
                a[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
        }
        // iota
        a[0] ^= KECCAK_RC[round];
    }
}

// XOR one 136-byte rate block (17 little-endian lanes) into the state and
// permute.
__device__ __forceinline__ void keccak_absorb_block(uint64_t s[25], const uint64_t blk[17]) {
#pragma unroll
    for (int j = 0; j < KECCAK_RATE_LANES; ++j) s[j] ^= blk[j];
    keccak_f1600(s);
}

// Threads per block for keccak256_absorb (one thread per message): enough warps in
// flight per SM to hide the byte gathers, few enough registers per thread
// (the 25-lane state plus the rho/pi temporaries) to keep several blocks
// resident.
#define KECCAK_THREADS 128
