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
// integer instructions in keccak256_absorb_unstaged_kernel with CUDA 12.8) against
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

// 64-bit rotate left by a runtime amount r (0-63): two 32-bit funnel shifts
// after swapping the halves when r >= 32.
__device__ __forceinline__ uint64_t keccak_rotl_var(uint64_t v, uint32_t r) {
    const uint32_t a = (uint32_t)v, b = (uint32_t)(v >> 32);
    const bool swap = r & 32;
    const uint32_t lo = swap ? b : a, hi = swap ? a : b;
    return (uint64_t)__funnelshift_l(lo, hi, r) << 32 | __funnelshift_l(hi, lo, r);
}

// keccak-f[1600] with one state spread over the first five lanes of an
// 8-lane group, for launches too narrow to fill the card with one thread per
// message: a thread's permutation is a serial chain of about 4,700 integer
// instructions, and five lanes split it (each about a fifth of the ALU work
// plus two exchanges per round).
//
// Lane x (0-4) holds column x of the state, words x, x+5, x+10, x+15, x+20,
// as col[0..4]. Theta's column parity is then the lane's own; the lanes
// exchange through a per-group scratch of KECCAK_LANES5_SCRATCH words in
// shared memory, under __syncwarp(mask):
//   - the five parities C[x] (scratch words 25-29), read back as C[x-1] and
//     C[x+1];
//   - after rho, each lane writes its five words at their pi destinations in
//     b's layout (word y of lane x to b[y + 5 * ((2x + 3y) % 5)], scratch
//     words 0-24); chi then reads b's columns x, x+1 and x+2.
// Iota is lane 0's. The lane's rotation amounts and the shared-memory
// addresses it writes and reads are computed once, by the constructor, into
// registers (32-bit addresses in the shared window, read and written with
// ld/st.shared and immediate row offsets): col[] is only ever indexed by
// compile-time constants, so the state stays in registers. Two barriers a
// round suffice: a round's pi writes come after the next theta barrier,
// which every lane passes only after its chi reads.
//
// Scratch of 35 words per group (not 30): a warp's four groups then start
// 3 bank pairs apart, so both the pi writes (stride 5) and the chi reads
// (consecutive) of its 20 lanes touch each 8-byte bank pair at most twice.
#define KECCAK_LANES5_SCRATCH 35

typedef uint32_t keccak_smem_t;  // an address in the shared window

__device__ __forceinline__ keccak_smem_t keccak_smem(const void* p) {
    return (keccak_smem_t)__cvta_generic_to_shared(p);
}

template <int Off>
__device__ __forceinline__ uint64_t keccak_lds(keccak_smem_t a) {
    uint64_t v;
    asm volatile("ld.shared.u64 %0, [%1+%2];" : "=l"(v) : "r"(a), "n"(Off) : "memory");
    return v;
}

__device__ __forceinline__ void keccak_sts(keccak_smem_t a, uint64_t v) {
    asm volatile("st.shared.u64 [%0], %1;" ::"r"(a), "l"(v) : "memory");
}

struct KeccakLanes5 {
    unsigned mask;                    // the group's five lanes in the warp
    uint32_t rot[5];                  // rho amount of word x + 5y
    keccak_smem_t pi[5];              // pi target of word x + 5y
    keccak_smem_t b0, b1, b2;         // b's columns x, x+1, x+2 (row 0)
    keccak_smem_t par, par_m, par_p;  // the parities C[x], C[x-1], C[x+1]
    bool iota;                        // lane 0

    // x: the lane within its group (0-4); group_lane0: lane of the warp
    // where the group starts (a multiple of 8).
    __device__ __forceinline__ KeccakLanes5(uint64_t* scratch, int x, int group_lane0)
        : mask(0x1Fu << group_lane0), iota(x == 0) {
        // rho amounts of words x + 5y, six bits per x
        constexpr uint32_t RHO[5] = {
            0u | 1u << 6 | 62u << 12 | 28u << 18 | 27u << 24,
            36u | 44u << 6 | 6u << 12 | 55u << 18 | 20u << 24,
            3u | 10u << 6 | 43u << 12 | 25u << 18 | 39u << 24,
            41u | 45u << 6 | 15u << 12 | 21u << 18 | 8u << 24,
            18u | 2u << 6 | 61u << 12 | 56u << 18 | 14u << 24,
        };
        const keccak_smem_t sc = keccak_smem(scratch);
#pragma unroll
        for (int y = 0; y < 5; ++y) {
            rot[y] = (RHO[y] >> (6 * x)) & 63;
            pi[y] = sc + 8 * (y + 5 * ((2 * x + 3 * y) % 5));
        }
        const int x1 = x < 4 ? x + 1 : x - 4, x2 = x < 3 ? x + 2 : x - 3, xm = x > 0 ? x - 1 : 4;
        b0 = sc + 8 * x;
        b1 = sc + 8 * x1;
        b2 = sc + 8 * x2;
        par = sc + 8 * (25 + x);
        par_m = sc + 8 * (25 + xm);
        par_p = sc + 8 * (25 + x1);
    }

    // chi of b's row Y for this lane's column
    template <int Y>
    __device__ __forceinline__ uint64_t chi() const {
        return keccak_lds<40 * Y>(b0) ^ (~keccak_lds<40 * Y>(b1) & keccak_lds<40 * Y>(b2));
    }

    template <int RoundUnroll = 4>
    __device__ __forceinline__ void permute(uint64_t col[5]) const {
#pragma unroll (RoundUnroll)
        for (int round = 0; round < 24; ++round) {
            // theta
            keccak_sts(par, col[0] ^ col[1] ^ col[2] ^ col[3] ^ col[4]);
            __syncwarp(mask);
            const uint64_t d = keccak_lds<0>(par_m) ^ keccak_rotl(keccak_lds<0>(par_p), 1);
            // rho + pi
#pragma unroll
            for (int y = 0; y < 5; ++y) keccak_sts(pi[y], keccak_rotl_var(col[y] ^ d, rot[y]));
            __syncwarp(mask);
            // chi (row y of columns x, x+1, x+2), iota
            col[0] = chi<0>();
            col[1] = chi<1>();
            col[2] = chi<2>();
            col[3] = chi<3>();
            col[4] = chi<4>();
            if (iota) col[0] ^= KECCAK_RC[round];
        }
    }
};

// XOR one 136-byte rate block (17 little-endian lanes) into the state and
// permute.
__device__ __forceinline__ void keccak_absorb_block(uint64_t s[25], const uint64_t blk[17]) {
#pragma unroll
    for (int j = 0; j < KECCAK_RATE_LANES; ++j) s[j] ^= blk[j];
    keccak_f1600(s);
}

// Threads per block for keccak256_absorb_unstaged (one thread per message): enough warps in
// flight per SM to hide the byte gathers, few enough registers per thread
// (the 25-lane state plus the rho/pi temporaries) to keep several blocks
// resident.
#define KECCAK_THREADS 128
