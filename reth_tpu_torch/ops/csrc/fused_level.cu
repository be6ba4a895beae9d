// Kernels 2 and 3: one trie level hashed against the resident digest buffer;
// kernel 4 (subtrie_levels, at the end): up to k dependent levels in one
// persistent launch, each level through the same row assembly, a narrow
// level with five lanes to a row (the five-lane tiles below); and the
// mesh's digest exchange (exchange_slots, before the host entry points),
// which copies a level's digests between the members' replicas, and its
// first design, the debug entry exchange_slots_warp_row.
//
// packed_level replaces the JAX package's ops/fused_commit.py _packed_level
// (an XLA program): gather each PACKED row's RLP bytes from the level's
// concatenated bytes, XOR keccak padding (0x01 at the row length, 0x80 at
// the last byte of the row's last rate block, so a 135-byte row gets 0x81),
// splice 32-byte child digests from the buffer at the row's holes (after the
// padding, as the reference does), absorb, and write the digest into the
// row's slot.
//
// branch_level replaces _branch_level (fused_commit.py): build each BITMAP
// branch row's whole RLP from its 16-bit state mask (f8 <len> or f9 <len:2>
// header, a0 + 32-byte child digest or 80 per nibble, 80 empty value; an f8
// row's byte 2 is its first marker), splice the children, then XOR the
// padding, absorb and scatter as above.
//
// The reference materialises every level as an (n, L) u8 tensor padded to
// batch tiers with junk rows aimed at dummy slot 0, with int32 indices. Here
// the wrapper passes the exact row count (no padding rows, no junk holes),
// every flat index is 64-bit, and holes (children) come sorted by row with a
// per-row start index (CSR).
//
// Bound. Each row costs one keccak-f[1600] per rate block, a fixed count of
// integer instructions (keccak.cuh); the bytes moved (row bytes, indices, 32
// per child digest read and per digest written) are far below that, so a
// large launch is bound by integer issue. A small launch (a few hundred rows
// on a few of the 132 SMs) cannot beat its one-warp floor: the serial chain
// of its longest row's permutations in one warp.
//
// What the first design (one thread per row building its row in a private
// array) lost, and what this one does instead:
//   - The branch row was a uint64_t[68] indexed at runtime byte positions,
//     so it lived in a 544-byte local-memory frame, and every byte of every
//     child digest was a separate 64-bit load-modify-store there, each
//     digest byte read from global memory on its own. Now a block of
//     LEVEL_ROWS rows assembles its rows in shared memory, lane-major (lane
//     q of row t at word q * LEVEL_ROWS + t, so a half-warp's 64-bit
//     accesses hit 16 distinct bank pairs whatever lane each thread
//     touches). The branch skeleton (header, markers, value byte) is
//     streamed out as whole 8-byte lanes, and each digest lands as four
//     funnel-shifted lanes plus two masked edge lanes.
//   - Child digests are staged per block: the children of a block's rows are
//     one contiguous CSR range, copied with 16-byte cp.async by the whole
//     block, neighbouring threads on neighbouring chunks. The branch block
//     builds its skeletons while those copies are in flight.
//   - The packed row was read one byte per global load behind a bounds test,
//     uncoalesced, and every hole was rescanned for every rate block. Now
//     each thread reads its row as aligned 8-byte words and builds its
//     lanes with funnel shifts, all of a rate block's words loaded before
//     any lane is stored (the one word that runs past the end of flat is
//     read up to it, so flat needs no slack). A row is built and absorbed a
//     window of LEVEL_WINDOW rate blocks at a time, and each hole is spliced
//     into every window it overlaps: once for a row of up to four blocks,
//     which is every row of the main path (a longer row, such as a leaf
//     with a long value, takes as many windows as it needs). Staging the
//     block's byte span of flat in shared memory first was measured no
//     faster at the largest launch than these direct loads, and was left out.
//   - Absorption reads 17 lanes per rate block at compile-time lane indices,
//     so the state stays in registers: no stack frame, no spills (ptxas -v;
//     chip_smoke.py enforces it).
//   - The permutation runs LEVEL_ROUND_UNROLL rounds per loop trip instead
//     of 24 unrolled: the blocks an SM holds are at different points of it,
//     and the rolled body (a sixth of the size) shares the instruction
//     caches better; it measured about 5 % faster at the largest launches.
//
// All reads of the buffer are of slots written by earlier (deeper) levels,
// and every row writes its own slot, so rows of one launch never race.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "keccak.cuh"

// Rows per block (one thread each); rate blocks of a row held in shared
// memory at once (a branch row has at most four); dynamic shared memory per
// block: the rows' windows plus a staging area of 32 bytes per row, so that
// three blocks fit an SM (64 rows per block, or two blocks of 128, did worse
// at the largest branch launch: the SM count does not divide the blocks).
constexpr int LEVEL_ROWS = 128;
constexpr int LEVEL_WINDOW = 4;
constexpr int LEVEL_SMEM = LEVEL_ROWS * (LEVEL_WINDOW * KECCAK_RATE + 32);
constexpr int LEVEL_ROUND_UNROLL = 4;

static_assert(LEVEL_ROWS % 32 == 0, "whole warps per block");
static_assert(LEVEL_SMEM % 16 == 0, "16-byte staging");

// Staged CSR entries (32-byte digest + 4-byte tag) a block can hold: they sit
// at the top of shared memory, above the rows' windows, so they are copied
// before the rows are even counted.
constexpr int LEVEL_ENTRY_CAP = (LEVEL_SMEM - LEVEL_ROWS * LEVEL_WINDOW * KECCAK_RATE) / 36;

// 16-byte asynchronous copy global -> shared.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The index within the block of the branch row this thread is to build.
// Each thread passes its row's rate-block count nb (0 past the end of the
// level). When the block's rows differ in block count they are grouped by
// it, so that a warp's rows need the same number of permutations: one
// 2-block row no longer holds 31 1-block rows of its warp through a second
// permutation.
__device__ __forceinline__ int block_order(int nb) {
    constexpr int W = LEVEL_ROWS / 32;
    __shared__ int s_cnt[W][LEVEL_WINDOW + 1];  // rows of each block count, per warp
    __shared__ short s_row[LEVEL_ROWS];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    unsigned same = 0;  // lanes of this warp whose row has this row's nb
#pragma unroll
    for (int k = 0; k <= LEVEL_WINDOW; ++k) {
        const unsigned b = __ballot_sync(~0u, nb == k);
        if (lane == 0) s_cnt[warp][k] = __popc(b);
        if (nb == k) same = b;
    }
    __syncthreads();
    // rows of smaller nb; of this nb in earlier warps
    int below = 0, before = 0, nb_min = LEVEL_WINDOW, nb_max = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
#pragma unroll
        for (int k = 0; k <= LEVEL_WINDOW; ++k) {
            const int c = s_cnt[w][k];
            if (c && k > nb_max) nb_max = k;
            if (c && k && k < nb_min) nb_min = k;  // rows past the end do not count
            below += k < nb ? c : 0;
            before += k == nb && w < warp ? c : 0;
        }
    }
    if (nb_min >= nb_max) return t;  // the same for the whole block
    s_row[below + before + __popc(same & ((1u << lane) - 1))] = (short)t;
    __syncthreads();
    return s_row[t];
}

// The first LEVEL_ENTRY_CAP of CSR entries [e0, e0 + total), staged at the
// top of shared memory: the digest of each (buffer slot in src) as two
// 16-byte copies spread over the block, and its 4-byte tag (a hole's byte
// offset, a child's nibble) beside them, so that nothing after the block's
// barrier waits on global memory. The constructor loads the slots and tags
// of the block's first pass into registers; copy() issues the copies, so
// that work in between overlaps those loads.
struct EntryStage {
    uint8_t* stage;
    int count;
    int64_t e0;
    int64_t src0;
    int32_t tag0;

    __device__ __forceinline__ EntryStage(uint8_t* smem, int64_t first, int64_t total,
                                          const int64_t* __restrict__ src,
                                          const int32_t* __restrict__ tag)
        : count((int)(total < LEVEL_ENTRY_CAP ? total : LEVEL_ENTRY_CAP)), e0(first) {
        stage = smem + ((LEVEL_SMEM - 36 * count) & ~15);
        const int t = threadIdx.x;
        src0 = t < 2 * count ? src[e0 + (t >> 1)] : 0;
        tag0 = t < count ? tag[e0 + t] : 0;
    }

    __device__ __forceinline__ void copy(const int64_t* __restrict__ src,
                                         const int32_t* __restrict__ tag,
                                         const uint8_t* buf) const {
        const int t = threadIdx.x;
        int32_t* tags = (int32_t*)(stage + 32 * count);
        if (t < 2 * count) cp_async16(stage + 16 * t, buf + src0 * 32 + 16 * (t & 1));
        for (int q = t + LEVEL_ROWS; q < 2 * count; q += LEVEL_ROWS)
            cp_async16(stage + 16 * q, buf + src[e0 + (q >> 1)] * 32 + 16 * (q & 1));
        if (t < count) tags[t] = tag0;
        for (int q = t + LEVEL_ROWS; q < count; q += LEVEL_ROWS) tags[q] = tag[e0 + q];
    }

    // Entry e's digest and tag: from the stage when it was staged, else from
    // global memory (digests 16-byte aligned in both).
    __device__ __forceinline__ int load(const int64_t* __restrict__ src,
                                        const int32_t* __restrict__ tag,
                                        const uint8_t* buf, int64_t e,
                                        uint64_t d[4]) const {
        const bool staged = e - e0 < count;
        const ulonglong2* p =
            (const ulonglong2*)(staged ? stage + 32 * (e - e0) : buf + src[e] * 32);
        const ulonglong2 a = p[0], b = p[1];
        d[0] = a.x;
        d[1] = a.y;
        d[2] = b.x;
        d[3] = b.y;
        return staged ? ((const int32_t*)(stage + 32 * count))[e - e0] : tag[e];
    }
};

// Overwrite bytes [at, at + 32) of a window of nl lanes with a digest; reg is
// the window's lane 0 (lanes S words apart: LEVEL_ROWS in the one-thread
// tiles). `at` may lie before the window (a hole that began in the previous
// one); bytes outside the window are dropped (past the row's last rate block
// the reference never hashes them).
template <int S>
__device__ __forceinline__ void splice_digest(uint64_t* reg, int nl, int at, const uint64_t d[4]) {
    const int a = at >> 3, sh = 8 * (at & 7);  // a < 0 before the window
    const auto in = [nl](int q) { return (unsigned)q < (unsigned)nl; };
    if (sh == 0) {
#pragma unroll
        for (int w = 0; w < 4; ++w)
            if (in(a + w)) reg[(a + w) * S] = d[w];
        return;
    }
    const uint64_t keep = (1ULL << sh) - 1;  // bytes of lane a before `at`
    if (in(a)) reg[a * S] = (reg[a * S] & keep) | (d[0] << sh);
#pragma unroll
    for (int w = 1; w < 4; ++w)
        if (in(a + w)) reg[(a + w) * S] = (d[w - 1] >> (64 - sh)) | (d[w] << sh);
    if (in(a + 4))
        reg[(a + 4) * S] = (reg[(a + 4) * S] & ~keep) | (d[3] >> (64 - sh));
}

// Absorb nb rate blocks from shared memory into the state, which stays in
// registers (lane indices are compile-time constants).
__device__ __forceinline__ void absorb_blocks(uint64_t s[25], const uint64_t* reg, int nb) {
    for (int k = 0; k < nb; ++k) {
        const uint64_t* blk = reg + k * KECCAK_RATE_LANES * LEVEL_ROWS;
#pragma unroll
        for (int j = 0; j < KECCAK_RATE_LANES; ++j) s[j] ^= blk[j * LEVEL_ROWS];
        keccak_f1600<LEVEL_ROUND_UNROLL>(s);
    }
}

__device__ __forceinline__ void store_digest(uint8_t* buf, int64_t slot,
                                             const uint64_t s[25]) {
    ulonglong2* dst = (ulonglong2*)(buf + slot * 32);
    dst[0] = make_ulonglong2(s[0], s[1]);
    dst[1] = make_ulonglong2(s[2], s[3]);
}

// The bytes [w, end) of the aligned word at w that runs past `end`, the
// rest zero: nothing past the end of flat is read.
__device__ __forceinline__ uint64_t load_tail(const uint64_t* w, const uint8_t* end) {
    const uint8_t* b = (const uint8_t*)w;
    uint64_t v = 0;
    for (int k = 0; b + k < end; ++k) v |= (uint64_t)b[k] << (8 * k);
    return v;
}

// -- tile layouts ---------------------------------------------------------------
//
// One-thread tiles (the level kernels, and subtrie_levels' wide steps): a
// block of LEVEL_ROWS rows, one thread building and absorbing each.
//
// Five-lane tiles (subtrie_levels' narrow steps): a step of few rows leaves
// most of the card idle, and one thread per row cannot go below its longest
// row's permutations at one thread's pace (the one-warp floor, about 4.8 us
// a permutation). These tiles give each row an 8-lane group: lane x = 0
// builds the row with the same code as the one-thread tiles, and lanes 0-4
// absorb it with KeccakLanes5 (keccak.cuh), lane x taking rate-block words
// j = x (mod 5). A 128-thread block takes LANES5_ROWS = 16 rows. Build and
// absorb meet under __syncwarp, so a row's windows need no block barrier and
// rows of different lengths run on independently; the block barrier is the
// one after the digests are staged. Lanes 0-3 store digest words 0-3.
constexpr int LANES5_GROUP = 8;
constexpr int LANES5_ROWS = LEVEL_ROWS / LANES5_GROUP;
// Words between a row's lanes: 21 = 5 (mod 16), so the 20 lanes of a warp's
// four rows reading lanes x + 5y of their rows touch each 8-byte bank pair
// at most twice.
constexpr int LANES5_STRIDE = 21;
constexpr int LANES5_ROW_WORDS = LEVEL_WINDOW * KECCAK_RATE_LANES * LANES5_STRIDE;
static_assert(LANES5_ROWS <= LANES5_STRIDE, "a row's lanes interleave with the tile's rows");
static_assert(8 * (LANES5_ROW_WORDS + LANES5_ROWS * KECCAK_LANES5_SCRATCH) + 36 * LEVEL_ENTRY_CAP +
                      16 <= LEVEL_SMEM,
              "rows, scratch and staged entries fit the level kernels' shared memory");

// The permutation of the row's group (r: the row within the tile), its
// scratch above the rows' windows. The lane is read from %laneid by a
// volatile asm, so the compiler cannot hoist the permutation's registers
// (rotation amounts, shared addresses) out of a row's window loop, where
// they would stay live across the row assembly: hoisted, they took
// subtrie_levels_kernel to its 168-register cap with spills; read here, it
// needs 158 (chip_smoke.py's ptxas check).
__device__ __forceinline__ KeccakLanes5 lanes5_perm(uint8_t* smem, int r) {
    unsigned lane;
    asm volatile("mov.u32 %0, %%laneid;" : "=r"(lane));
    return KeccakLanes5((uint64_t*)smem + LANES5_ROW_WORDS + r * KECCAK_LANES5_SCRATCH,
                        lane & (LANES5_GROUP - 1), lane & ~(LANES5_GROUP - 1u));
}

// Absorb nb rate blocks (lanes LANES5_STRIDE words apart from reg) into the
// column state of lane x (0-4) of row r's group: the group meets under
// __syncwarp before (lane 0's assembled lanes are stored) and after (the next
// window may overwrite them).
__device__ __forceinline__ void absorb_lanes5(uint64_t col[5], const uint64_t* reg, int nb, int x,
                                              uint8_t* smem, int r) {
    const KeccakLanes5 perm = lanes5_perm(smem, r);
    __syncwarp(perm.mask);
    for (int k = 0; k < nb; ++k) {
        const uint64_t* blk = reg + (k * KECCAK_RATE_LANES + x) * LANES5_STRIDE;
#pragma unroll
        for (int y = 0; y < 4; ++y)
            if (x + 5 * y < KECCAK_RATE_LANES) col[y] ^= blk[5 * y * LANES5_STRIDE];
        perm.permute<LEVEL_ROUND_UNROLL>(col);
    }
    __syncwarp(perm.mask);
}

// Rows [i0, i0 + LEVEL_ROWS) of one PACKED level (the rows below n), built
// by the block's threads in smem (LEVEL_SMEM bytes); with Lanes5, rows
// [i0, i0 + LANES5_ROWS) in the five-lane layout. Every thread of the
// block calls it; threads past n return from it only after its last barrier.
template <bool Lanes5>
__device__ __forceinline__ void packed_tile(
    const uint8_t* __restrict__ flat, int64_t flat_len, const int64_t* __restrict__ row_off,
    const int32_t* __restrict__ row_len, const int64_t* __restrict__ slots,
    const int64_t* __restrict__ hole_start, const int32_t* __restrict__ hole_off,
    const int64_t* __restrict__ hole_src, uint8_t* buf, int64_t n, int64_t i0, uint8_t* smem) {
    constexpr int ROWS = Lanes5 ? LANES5_ROWS : LEVEL_ROWS;  // rows per tile
    constexpr int S = Lanes5 ? LANES5_STRIDE : LEVEL_ROWS;   // words between a row's lanes
    const int t = threadIdx.x;
    const int r = Lanes5 ? t / LANES5_GROUP : t, x = Lanes5 ? t % LANES5_GROUP : 0;
    const int64_t last = i0 + ROWS < n ? i0 + ROWS : n;
    // every load that needs nothing else is issued before the barrier, so
    // that their latencies overlap
    const int64_t i = i0 + r;
    const bool active = i < n && x < 5, assembles = active && x == 0;
    const int64_t off = assembles ? row_off[i] : 0;
    const int len = active ? row_len[i] : 0;
    const int64_t h0 = assembles ? hole_start[i] : 0, h1 = assembles ? hole_start[i + 1] : 0;
    const int64_t slot = active ? slots[i] : 0;
    const int nb = len / KECCAK_RATE + 1;
    const int64_t h_lo = hole_start[i0];
    const EntryStage holes(smem, h_lo, hole_start[last] - h_lo, hole_src, hole_off);
    holes.copy(hole_src, hole_off, buf);
    cp_async_wait_all();
    __syncthreads();
    if (!active) return;

    uint64_t* reg = (uint64_t*)smem + r;
    const uint8_t* src = flat + off;
    const uint8_t* end = flat + flat_len;
    const int mis = (int)((uintptr_t)src & 7), sh = 8 * mis;
    const uint64_t* wp = (const uint64_t*)(src - mis);
    // the aligned word that runs past the end of flat, if the row reaches
    // it: read once, up to the end (only the last row of flat can)
    const uint64_t* wtail = (const uint64_t*)((uintptr_t)end & ~(uintptr_t)7);
    const uint64_t tail = assembles && src + len > (const uint8_t*)wtail ? load_tail(wtail, end) : 0;
    uint64_t s[Lanes5 ? 5 : 25];
#pragma unroll
    for (int j = 0; j < (Lanes5 ? 5 : 25); ++j) s[j] = 0;
    for (int k0 = 0; k0 < nb; k0 += LEVEL_WINDOW) {
        const int kn = nb - k0 < LEVEL_WINDOW ? nb - k0 : LEVEL_WINDOW;
        if (assembles) {
            // lane q is row bytes [8q, 8q + 8): the top of word q and the
            // bottom of word q + 1; a word is read only if it holds a byte
            // of the row. Each rate block's 18 words are loaded before any
            // lane is stored, so the loads are in flight together.
            uint64_t w[KECCAK_RATE_LANES + 1];
            for (int k = 0; k < kn; ++k) {
                const int kb = k0 + k;
#pragma unroll
                for (int j = 0; j <= KECCAK_RATE_LANES; ++j) {
                    const int q = kb * KECCAK_RATE_LANES + j;
                    const uint64_t* a = wp + q;
                    w[j] = 8 * q - mis < len ? (a < wtail ? *a : tail) : 0;
                }
#pragma unroll
                for (int j = 0; j < KECCAK_RATE_LANES; ++j) {
                    const int q = kb * KECCAK_RATE_LANES + j, p = 8 * q;
                    uint64_t lane = sh ? (w[j] >> sh) | (w[j + 1] << (64 - sh)) : w[j];
                    if (p + 8 > len) lane &= len > p ? (1ULL << (8 * (len - p))) - 1 : 0;
                    // multi-rate padding, XOR as in the reference
                    if (len >= p && len < p + 8) lane ^= 1ULL << (8 * (len - p));
                    if (j == KECCAK_RATE_LANES - 1 && kb == nb - 1) lane ^= 0x80ULL << 56;
                    reg[(k * KECCAK_RATE_LANES + j) * S] = lane;
                }
            }
            for (int64_t h = h0; h < h1; ++h) {
                uint64_t d[4];
                const int at = holes.load(hole_src, hole_off, buf, h, d);
                splice_digest<S>(reg, kn * KECCAK_RATE_LANES, at - k0 * KECCAK_RATE, d);
            }
        }
        if constexpr (Lanes5)
            absorb_lanes5(s, reg, kn, x, smem, r);
        else
            absorb_blocks(s, reg, kn);
    }
    if constexpr (Lanes5) {
        if (x < 4) ((uint64_t*)(buf + slot * 32))[x] = s[0];
    } else {
        store_digest(buf, slot, s);
    }
}

// Rows [i0, i0 + LEVEL_ROWS) of one BITMAP level, as packed_tile (with
// Lanes5, LANES5_ROWS rows in the five-lane layout).
template <bool Lanes5>
__device__ __forceinline__ void branch_tile(
    const int32_t* __restrict__ masks, const int64_t* __restrict__ slots,
    const int64_t* __restrict__ ch_start, const int32_t* __restrict__ ch_nib,
    const int64_t* __restrict__ ch_src, uint8_t* buf, int64_t n, int64_t i0, uint8_t* smem) {
    constexpr int ROWS = Lanes5 ? LANES5_ROWS : LEVEL_ROWS;  // rows per tile
    constexpr int S = Lanes5 ? LANES5_STRIDE : LEVEL_ROWS;   // words between a row's lanes
    const int t = threadIdx.x;
    const int x = Lanes5 ? t % LANES5_GROUP : 0;
    const int64_t last = i0 + ROWS < n ? i0 + ROWS : n;
    int64_t i = i0 + (Lanes5 ? t / LANES5_GROUP : t), c0, c1, slot;
    uint32_t mask;
    int payload, hl, total, nb;
    const auto load_row = [&] {
        const bool active = i < n && x < 5;
        mask = active ? (uint32_t)masks[i] & 0xFFFF : 0;
        c0 = active ? ch_start[i] : 0;
        c1 = active ? ch_start[i + 1] : 0;
        slot = active ? slots[i] : 0;
        payload = 16 + 32 * __popc(mask) + 1;  // child refs + empty value byte
        hl = payload > 0xFF ? 3 : 2;
        total = hl + payload;  // at most 532 bytes: four rate blocks
        nb = active ? total / KECCAK_RATE + 1 : 0;
    };
    load_row();
    const int64_t c_lo = ch_start[i0];
    const EntryStage kids(smem, c_lo, ch_start[last] - c_lo, ch_src, ch_nib);
    if constexpr (!Lanes5) {
        const int r = block_order(nb);
        if (r != t) {  // this thread builds another row of the block
            i = i0 + r;
            load_row();
        }
    }
    const int nl = nb * KECCAK_RATE_LANES;

    // the rows' skeletons are written while the child digests are copied
    kids.copy(ch_src, ch_nib, buf);
    uint64_t* reg = (uint64_t*)smem + (Lanes5 ? t / LANES5_GROUP : t);
    if (i < n && x == 0) {
        // stream header, markers and value byte out as whole lanes, leaving
        // zeros where the digests go; for f8 rows the first marker lands on
        // byte 2, as in the reference
        uint64_t acc = hl == 3 ? 0xF9ULL | (uint64_t)(payload >> 8) << 8 |
                                     (uint64_t)(payload & 0xFF) << 16
                               : 0xF8ULL | (uint64_t)payload << 8;
        int p = hl;
        for (int nib = 0; nib <= 16; ++nib) {  // nibble 16: the empty value
            const bool has = nib < 16 && ((mask >> nib) & 1);
            acc |= (uint64_t)(has ? 0xA0 : 0x80) << (8 * (p & 7));
            if ((++p & 7) == 0) {
                reg[((p >> 3) - 1) * S] = acc;
                acc = 0;
            }
            if (has) {  // 32 zero bytes: the rest of this lane, 3 lanes, the
                        // start of the next
                const int q = p >> 3;
                reg[q * S] = acc;
                reg[(q + 1) * S] = 0;
                reg[(q + 2) * S] = 0;
                reg[(q + 3) * S] = 0;
                acc = 0;
                p += 32;
            }
        }
        int q = p >> 3;  // p == total
        if (p & 7) reg[q++ * S] = acc;
        for (; q < nl; ++q) reg[q * S] = 0;
    }
    cp_async_wait_all();
    __syncthreads();
    if (i >= n || x >= 5) return;

    if (x == 0) {
        for (int64_t c = c0; c < c1; ++c) {
            uint64_t d[4];
            const int nib = kids.load(ch_src, ch_nib, buf, c, d) & 15;
            // marker position of `nib` + 1: one byte per earlier nibble plus
            // 32 per earlier present one
            const int at = hl + nib + 32 * __popc(mask & ((1u << nib) - 1)) + 1;
            splice_digest<S>(reg, nl, at, d);
        }
        reg[(total >> 3) * S] ^= 1ULL << (8 * (total & 7));
        reg[(nl - 1) * S] ^= 0x80ULL << 56;
    }
    uint64_t s[Lanes5 ? 5 : 25];
#pragma unroll
    for (int j = 0; j < (Lanes5 ? 5 : 25); ++j) s[j] = 0;
    if constexpr (Lanes5) {
        absorb_lanes5(s, reg, nb, x, smem, t / LANES5_GROUP);
        if (x < 4) ((uint64_t*)(buf + slot * 32))[x] = s[0];
    } else {
        absorb_blocks(s, reg, nb);
        store_digest(buf, slot, s);
    }
}

__global__ void __launch_bounds__(LEVEL_ROWS)
packed_level_kernel(const uint8_t* __restrict__ flat, int64_t flat_len,
                    const int64_t* __restrict__ row_off, const int32_t* __restrict__ row_len,
                    const int64_t* __restrict__ slots, const int64_t* __restrict__ hole_start,
                    const int32_t* __restrict__ hole_off, const int64_t* __restrict__ hole_src,
                    uint8_t* buf, int64_t n) {
    extern __shared__ __align__(16) uint8_t smem[];
    packed_tile<false>(flat, flat_len, row_off, row_len, slots, hole_start, hole_off, hole_src,
                       buf, n, (int64_t)blockIdx.x * LEVEL_ROWS, smem);
}

__global__ void __launch_bounds__(LEVEL_ROWS)
branch_level_kernel(const int32_t* __restrict__ masks, const int64_t* __restrict__ slots,
                    const int64_t* __restrict__ ch_start, const int32_t* __restrict__ ch_nib,
                    const int64_t* __restrict__ ch_src, uint8_t* buf, int64_t n) {
    extern __shared__ __align__(16) uint8_t smem[];
    branch_tile<false>(masks, slots, ch_start, ch_nib, ch_src, buf, n,
                       (int64_t)blockIdx.x * LEVEL_ROWS, smem);
}

// subtrie_levels replaces the JAX package's ops/fused_commit.py
// _subtrie_program (a lax.fori_loop over up to k staged levels in one XLA
// dispatch, the digest buffer as the loop's carry). One launch runs a chunk
// of dependent levels, deepest first: step s + 1 splices digests that step s
// wrote. It is one persistent, cooperative launch of as many blocks as the
// card holds at once (or fewer, when no step needs that many tiles); each
// step runs its level's tiles strided over the grid, and a grid barrier
// separates the steps.
//
// Each step takes one of two paths, by its row count n:
//   - narrow, 8 n <= the co-resident threads (n <= lanes5_rows, the
//     co-resident blocks x LANES5_ROWS: 6,336 rows on an H100 at 396
//     blocks): the five-lane tiles, 16 rows a block, one pass of the grid.
//     Such a step holds fewer threads than the card has, so one thread per
//     row would leave the card idle while its rows ran at one thread's pace
//     (their one-warp floor); five lanes a row split that serial chain.
//   - wide: the one-thread tiles, 128 rows a block. Rows then fill the
//     card's warps, and splitting a permutation over five lanes would only
//     add its exchanges to the same integer work.
// The bound is drawn from the card's co-resident threads, not placed by
// measurement, and it is not where the two paths' times cross. A five-lane
// permutation takes more than half a thread's (chip_smoke.py times both in
// isolation) and a block's groups do not run fully in parallel, so five
// lanes gain on steps of a few rows and on steps of multi-block rows, break
// even on tens to hundreds of one-block rows, and lose on steps of
// thousands of one-block rows, whose 16-row tiles also widen the grid that
// every barrier waits for. chip_smoke.py times each step of its timed
// chunks on both paths (subtrie_levels_one_thread below).
//
// The levels' arrays lie in two staged buffers, bytes (u8: packed rows,
// branch masks) and indices (idx); a table of STEP_W int64 per step, staged
// in idx too, says where (byte offsets into the buffer) and how many rows:
constexpr int STEP_W = 10;  // _PARAM_W in fused_commit.py
enum StepField {
    STEP_KIND,       // 0 packed, 1 branch
    STEP_ROWS,       // n
    STEP_BYTES,      // u8 offset of flat (packed) or of the i32 masks (branch)
    STEP_BYTES_LEN,  // flat_len (packed)
    STEP_ROW_OFF,    // idx offsets of the per-row and CSR arrays, as the
    STEP_ROW_LEN,    // level kernels take them (row_off / row_len packed only)
    STEP_SLOTS,
    STEP_START,      // hole_start / ch_start
    STEP_TAG,        // hole_off / ch_nib
    STEP_SRC,        // hole_src / ch_src
};
//
// Coherence: a step reads digests that other blocks wrote in an earlier step
// of the same launch. The grid barrier orders those writes before the
// reads, but only for coherent loads, so buf is read without __restrict__
// (no non-coherent LDG.CONSTANT; chip_smoke.py checks the SASS) and staged
// with cp.async.cg, which reads through L2. The staged buffers and the step
// table are read-only for the whole launch.
//
// Bound: the sum over steps of each level's bound (they cannot overlap), plus
// one grid barrier per step. Three blocks per SM (the launch bound) keep 396
// blocks co-resident.
__global__ void __launch_bounds__(LEVEL_ROWS, 3)
subtrie_levels_kernel(const uint8_t* __restrict__ u8, const uint8_t* __restrict__ idx,
                      const int64_t* __restrict__ steps, int n_steps, int64_t lanes5_rows,
                      uint8_t* buf) {
    extern __shared__ __align__(16) uint8_t smem[];
    for (int s = 0; s < n_steps; ++s) {
        const int64_t* p = steps + (int64_t)s * STEP_W;
        const int64_t n = p[STEP_ROWS];
        const bool packed = p[STEP_KIND] == 0, lanes5 = n <= lanes5_rows;
        const int tile = lanes5 ? LANES5_ROWS : LEVEL_ROWS;
        const int64_t* slots = (const int64_t*)(idx + p[STEP_SLOTS]);
        const int64_t* start = (const int64_t*)(idx + p[STEP_START]);
        const int32_t* tag = (const int32_t*)(idx + p[STEP_TAG]);
        const int64_t* src = (const int64_t*)(idx + p[STEP_SRC]);
        for (int64_t i0 = (int64_t)blockIdx.x * tile; i0 < n; i0 += (int64_t)gridDim.x * tile) {
            if (packed && lanes5)
                packed_tile<true>(u8 + p[STEP_BYTES], p[STEP_BYTES_LEN],
                                  (const int64_t*)(idx + p[STEP_ROW_OFF]),
                                  (const int32_t*)(idx + p[STEP_ROW_LEN]), slots, start, tag, src,
                                  buf, n, i0, smem);
            else if (packed)
                packed_tile<false>(u8 + p[STEP_BYTES], p[STEP_BYTES_LEN],
                                   (const int64_t*)(idx + p[STEP_ROW_OFF]),
                                   (const int32_t*)(idx + p[STEP_ROW_LEN]), slots, start, tag, src,
                                   buf, n, i0, smem);
            else if (lanes5)
                branch_tile<true>((const int32_t*)(u8 + p[STEP_BYTES]), slots, start, tag, src, buf,
                                  n, i0, smem);
            else
                branch_tile<false>((const int32_t*)(u8 + p[STEP_BYTES]), slots, start, tag, src,
                                   buf, n, i0, smem);
            __syncthreads();  // the next tile restages this block's shared memory
        }
        if (s + 1 < n_steps) cooperative_groups::this_grid().sync();
    }
}

// Debug entry, launched only by chip_smoke.py to time one permutation in
// isolation: `perms` dependent keccak-f[1600] permutations of one state by
// one thread (lanes5 == 0, the one-thread tiles' permutation) or by one
// five-lane group (KeccakLanes5), launched as one block of LANES5_GROUP
// threads; the final state's 25 words go to out, so the two must agree.
__global__ void keccak_perm_probe_kernel(uint64_t* out, int perms, int lanes5) {
    __shared__ uint64_t scratch[KECCAK_LANES5_SCRATCH];
    const int x = threadIdx.x;
    if (lanes5 && x < 5) {
        const KeccakLanes5 perm(scratch, x, 0);
        uint64_t col[5];
#pragma unroll
        for (int y = 0; y < 5; ++y) col[y] = (x + 5 * y + 1) * 0x9E3779B97F4A7C15ULL;
        for (int k = 0; k < perms; ++k) perm.permute<LEVEL_ROUND_UNROLL>(col);
#pragma unroll
        for (int y = 0; y < 5; ++y) out[x + 5 * y] = col[y];
    } else if (!lanes5 && x == 0) {
        uint64_t st[25];
#pragma unroll
        for (int j = 0; j < 25; ++j) st[j] = (j + 1) * 0x9E3779B97F4A7C15ULL;
        for (int k = 0; k < perms; ++k) keccak_f1600<LEVEL_ROUND_UNROLL>(st);
#pragma unroll
        for (int j = 0; j < 25; ++j) out[j] = st[j];
    }
}

// exchange_slots: the mesh's digest exchange (ops/fused_commit.py
// FusedMeshEngine / SubtrieMeshEngine). It replaces no TPU kernel: it is the
// counterpart of the all-gather XLA inserts after each level's scatter into
// the reference's replicated digest buffer (ops/fused_commit.py
// FusedMeshEngine, _subtrie_program(mesh=)). Each member of a mesh hashes its
// own row range of a level into its own replica of the (S, 32) buffer; this
// kernel then copies the 32-byte row at each of the level's slots from the
// replica of the member that wrote it (the range in `bounds` holding the row)
// into every other replica.
//
// Bound: bytes, 8 (slot) + 32 read + 32 written to each other replica, per
// row, far below any instruction limit. The kernel runs right after the
// level kernels wrote its rows, so the rows are usually L2-resident and a
// launch can beat the HBM bound.
//
// What held the first design back (kept below as the debug entry
// exchange_slots_warp_row, timed beside this one by chip_smoke.py): it gave
// a warp to each row, lane l moving 16-byte half l & 1 to destination l >> 1,
// so only 2(m-1) of 32 lanes worked (4 at three replicas), and each warp made
// two dependent loads (the slot, then the owner's row) for 32 bytes. The
// main path's largest launch (167,548 rows) was some 20 waves of resident
// warps, each waiting out two memory latencies: latency-bound, at a quarter
// of its bytes bound. This design:
//   - one thread per (row, 16-byte half), 16 rows a warp; a row's two halves
//     are neighbouring threads, so a row is one aligned 32-byte sector, and
//     a warp over consecutive slots reads and writes 512 contiguous bytes;
//     each thread stores its half into the m-1 other replicas back to back;
//   - a launch larger than one wave of resident blocks at a row a thread
//     takes EXCHANGE_RIF rows a thread, a grid's pass apart: each thread
//     issues its slot loads for all of them, then all their owner loads,
//     then the stores, EXCHANGE_RIF independent load chains where the first
//     design had one a warp. The grid is sized from the rows and capped at
//     one wave, so the largest launch runs in about one wave. A launch that
//     one wave covers takes a row a thread (the R = 1 instance): there the
//     four-row body, its unrolled chains mostly empty, only lengthens the
//     launch, and the main path's median launch (164 rows) sits at the
//     launch floor, where the first design already was;
//   - the owner of a row is the count of bounds[1..15] at or below it (the
//     bounds rise and the entries past bounds[members] repeat the row
//     count), compile-time indices into parameter space, no branch;
//   - slots and the owner's row are read through the non-coherent path
//     (__ldg): no location is both read and written in one launch, since the
//     level's slots are distinct and at each slot the owner's replica is only
//     read and the others only written.
// The replicas and bounds are passed by value (__grid_constant__, so the
// owner's runtime index reads kernel parameter space, no local copy). On one
// card the replicas share its memory; across cards the launching card
// reaches the others' replicas by peer access (exchange_enable_peers), which
// has not run: the machines this was measured on hold one card.
constexpr int EXCHANGE_MAX_MEMBERS = 16;
constexpr int EXCHANGE_THREADS = 128;  // threads a block: 64 rows a pass
constexpr int EXCHANGE_RIF = 4;        // rows in flight a thread, above one wave
constexpr int EXCHANGE_WARP_ROWS = 8;  // the warp-a-row entry: rows (warps) a block

struct ExchangeArgs {
    uint8_t* bufs[EXCHANGE_MAX_MEMBERS];
    // member j wrote rows [bounds[j], bounds[j+1]); the entries past
    // bounds[members] repeat it (the launch's row count)
    int64_t bounds[EXCHANGE_MAX_MEMBERS + 1];
    int members;
};

// R rows a thread (1 or EXCHANGE_RIF), a pass of the grid apart.
template <int R>
__global__ void __launch_bounds__(EXCHANGE_THREADS)
    exchange_slots_kernel(const __grid_constant__ ExchangeArgs a,
                          const int64_t* __restrict__ slots, int64_t n) {
    const int64_t half = threadIdx.x & 1;
    const int64_t pass = (int64_t)gridDim.x * (EXCHANGE_THREADS / 2);
    for (int64_t row0 = ((int64_t)blockIdx.x * EXCHANGE_THREADS + threadIdx.x) >> 1; row0 < n;
         row0 += R * pass) {
        int64_t off[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int64_t row = row0 + r * pass;
            off[r] = row < n ? __ldg((const long long*)slots + row) * 32 + 16 * half : -1;
        }
        int owner[R];
        uint4 v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int64_t row = row0 + r * pass;
            owner[r] = 0;
#pragma unroll
            for (int j = 1; j < EXCHANGE_MAX_MEMBERS; ++j) owner[r] += row >= a.bounds[j];
            v[r] = off[r] >= 0 ? __ldg((const uint4*)(a.bufs[owner[r]] + off[r]))
                               : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            if (off[r] < 0) break;  // rows past the end come last
            for (int d = 0; d < a.members - 1; ++d) {
                const int k = d < owner[r] ? d : d + 1;
                *(uint4*)(a.bufs[k] + off[r]) = v[r];
            }
        }
    }
}

// Debug entry exchange_slots_warp_row (chip_smoke.py and the card tests
// only, no main path): the first design, one warp a row, lane l moving
// 16-byte chunk l & 1 to destination l >> 1 (16 destinations a pass), every
// lane loading its chunk from the owner (the loads of a chunk broadcast
// within the warp).
__global__ void __launch_bounds__(32 * EXCHANGE_WARP_ROWS)
    exchange_slots_warp_row_kernel(const __grid_constant__ ExchangeArgs a,
                                   const int64_t* __restrict__ slots, int64_t n) {
    const int64_t row = (int64_t)blockIdx.x * EXCHANGE_WARP_ROWS + (threadIdx.x >> 5);
    if (row >= n) return;
    const int lane = threadIdx.x & 31;
    int owner = 0;
    while (owner + 1 < a.members && row >= a.bounds[owner + 1]) ++owner;
    const int64_t off = slots[row] * 32 + 16 * (lane & 1);
    const uint4 v = *(const uint4*)(a.bufs[owner] + off);
    for (int d = lane >> 1; d < a.members - 1; d += 16) {
        const int k = d < owner ? d : d + 1;
        *(uint4*)(a.bufs[k] + off) = v;
    }
}

// Once per kernel: allow its dynamic shared memory (above the 48 KB default).
template <typename K>
static int allow_smem(K kernel, bool& done) {
    if (done) return 0;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, LEVEL_SMEM);
    done = err == cudaSuccess;
    return (int)err;
}

extern "C" int packed_level(const void* flat, int64_t flat_len, const void* row_off,
                            const void* row_len, const void* slots, const void* hole_start,
                            const void* hole_off, const void* hole_src, void* buf, int64_t n,
                            void* stream) {
    static bool ready = false;
    if (n <= 0) return 0;
    if (const int err = allow_smem(packed_level_kernel, ready)) return err;
    const int64_t grid = (n + LEVEL_ROWS - 1) / LEVEL_ROWS;
    packed_level_kernel<<<(unsigned)grid, LEVEL_ROWS, LEVEL_SMEM, (cudaStream_t)stream>>>(
        (const uint8_t*)flat, flat_len, (const int64_t*)row_off, (const int32_t*)row_len,
        (const int64_t*)slots, (const int64_t*)hole_start, (const int32_t*)hole_off,
        (const int64_t*)hole_src, (uint8_t*)buf, n);
    return (int)cudaGetLastError();
}

extern "C" int branch_level(const void* masks, const void* slots, const void* ch_start,
                            const void* ch_nib, const void* ch_src, void* buf, int64_t n,
                            void* stream) {
    static bool ready = false;
    if (n <= 0) return 0;
    if (const int err = allow_smem(branch_level_kernel, ready)) return err;
    const int64_t grid = (n + LEVEL_ROWS - 1) / LEVEL_ROWS;
    branch_level_kernel<<<(unsigned)grid, LEVEL_ROWS, LEVEL_SMEM, (cudaStream_t)stream>>>(
        (const int32_t*)masks, (const int64_t*)slots, (const int64_t*)ch_start,
        (const int32_t*)ch_nib, (const int64_t*)ch_src, (uint8_t*)buf, n);
    return (int)cudaGetLastError();
}

// Blocks of subtrie_levels_kernel the current card holds at once (its
// occupancy at LEVEL_SMEM bytes of dynamic shared memory times the SMs): the
// most a cooperative launch may have. Negative: minus a CUDA error.
extern "C" int subtrie_levels_resident(void) {
    static bool ready = false;
    static int resident = 0;
    if (resident) return resident;
    if (const int err = allow_smem(subtrie_levels_kernel, ready)) return -err;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, subtrie_levels_kernel,
                                                            LEVEL_ROWS, LEVEL_SMEM);
    if (err != cudaSuccess) return -(int)err;
    resident = per_sm * sms;
    return resident ? resident : -(int)cudaErrorCooperativeLaunchTooLarge;
}

// The largest step that takes the five-lane path on this card: the
// co-resident blocks times LANES5_ROWS (8 lanes a row fill the co-resident
// threads). Negative: minus a CUDA error.
extern "C" int64_t subtrie_levels_lanes5_rows(void) {
    const int resident = subtrie_levels_resident();
    return resident < 0 ? resident : (int64_t)resident * LANES5_ROWS;
}

// One chunk of n_steps levels (the step table `steps`, n_steps x STEP_W
// int64 in device memory); rows (host memory) holds each step's row count,
// from which the grid is sized: the most tiles any step needs on its own
// path, at most the co-resident blocks. Steps of at most lanes5_rows rows
// take the five-lane path.
static int launch_subtrie_levels(const void* u8, const void* idx, const void* steps,
                                 int n_steps, const int64_t* rows, int64_t lanes5_rows,
                                 void* buf, void* stream) {
    if (n_steps <= 0) return 0;
    const int resident = subtrie_levels_resident();
    if (resident < 0) return -resident;
    int64_t tiles = 0;
    for (int s = 0; s < n_steps; ++s) {
        const int tile = rows[s] <= lanes5_rows ? LANES5_ROWS : LEVEL_ROWS;
        const int64_t need = (rows[s] + tile - 1) / tile;
        tiles = need > tiles ? need : tiles;
    }
    if (tiles <= 0) return 0;
    const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
    const uint8_t* a_u8 = (const uint8_t*)u8;
    const uint8_t* a_idx = (const uint8_t*)idx;
    const int64_t* a_steps = (const int64_t*)steps;
    uint8_t* a_buf = (uint8_t*)buf;
    void* args[] = {&a_u8, &a_idx, &a_steps, &n_steps, &lanes5_rows, &a_buf};
    const cudaError_t err =
        cudaLaunchCooperativeKernel((const void*)subtrie_levels_kernel, dim3(grid),
                                    dim3(LEVEL_ROWS), args, LEVEL_SMEM, (cudaStream_t)stream);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

extern "C" int subtrie_levels(const void* u8, const void* idx, const void* steps, int n_steps,
                              const int64_t* rows, void* buf, void* stream) {
    const int64_t lanes5_rows = subtrie_levels_lanes5_rows();
    if (lanes5_rows < 0) return (int)-lanes5_rows;
    return launch_subtrie_levels(u8, idx, steps, n_steps, rows, lanes5_rows, buf, stream);
}

// Debug entry (chip_smoke.py only): the same launch with every step on the
// one-thread path, so that each step's two paths are timed side by side.
extern "C" int subtrie_levels_one_thread(const void* u8, const void* idx, const void* steps,
                                         int n_steps, const int64_t* rows, void* buf,
                                         void* stream) {
    return launch_subtrie_levels(u8, idx, steps, n_steps, rows, 0, buf, stream);
}

// The permutation debug entry above (chip_smoke.py only): out holds 25 uint64 on the card.
extern "C" int keccak_perm_probe(void* out, int perms, int lanes5, void* stream) {
    keccak_perm_probe_kernel<<<1, LANES5_GROUP, 0, (cudaStream_t)stream>>>((uint64_t*)out, perms,
                                                                           lanes5);
    return (int)cudaGetLastError();
}

// The exchange's arguments by value: bufs holds `members` replica pointers
// and bounds members + 1 row boundaries, both in host memory.
static ExchangeArgs exchange_args(void* const* bufs, const int64_t* bounds, int members) {
    ExchangeArgs a = {};
    for (int j = 0; j < members; ++j) {
        a.bufs[j] = (uint8_t*)bufs[j];
        a.bounds[j] = bounds[j];
    }
    for (int j = members; j <= EXCHANGE_MAX_MEMBERS; ++j) a.bounds[j] = bounds[members];
    a.members = members;
    return a;
}

// Blocks of exchange_slots_kernel<R> the current card holds at once (its
// occupancy times the SMs), by card; negative: minus a CUDA error.
template <int R>
static int64_t exchange_wave(void) {
    constexpr int CARDS = 64;
    static int64_t wave[CARDS] = {};
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return -(int64_t)err;
    if (dev < CARDS && wave[dev]) return wave[dev];
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, exchange_slots_kernel<R>,
                                                            EXCHANGE_THREADS, 0);
    if (err != cudaSuccess) return -(int64_t)err;
    const int64_t w = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
    if (dev < CARDS) wave[dev] = w;
    return w;
}

// The mesh's digest exchange (exchange_slots_kernel above); slots (n int64)
// lies on the launching card. A row a thread where one wave of resident
// blocks covers the rows, else EXCHANGE_RIF rows a thread on at most one
// wave.
extern "C" int exchange_slots(void* const* bufs, const int64_t* bounds, int members,
                              const void* slots, int64_t n, void* stream) {
    if (n <= 0 || members <= 1) return 0;
    if (members > EXCHANGE_MAX_MEMBERS) return (int)cudaErrorInvalidValue;
    constexpr int64_t ROWS = EXCHANGE_THREADS / 2;  // a block's rows a pass
    const int64_t wave1 = exchange_wave<1>();
    if (wave1 < 0) return (int)-wave1;
    const ExchangeArgs a = exchange_args(bufs, bounds, members);
    const int64_t need = (n + ROWS - 1) / ROWS;
    if (need <= wave1) {
        exchange_slots_kernel<1><<<(unsigned)need, EXCHANGE_THREADS, 0, (cudaStream_t)stream>>>(
            a, (const int64_t*)slots, n);
    } else {
        const int64_t wave = exchange_wave<EXCHANGE_RIF>();
        if (wave < 0) return (int)-wave;
        const int64_t need_r = (n + ROWS * EXCHANGE_RIF - 1) / (ROWS * EXCHANGE_RIF);
        exchange_slots_kernel<EXCHANGE_RIF>
            <<<(unsigned)(need_r < wave ? need_r : wave), EXCHANGE_THREADS, 0,
               (cudaStream_t)stream>>>(a, (const int64_t*)slots, n);
    }
    return (int)cudaGetLastError();
}

// The first design's entry (exchange_slots_warp_row_kernel; chip_smoke.py and
// the card tests only), with exchange_slots' arguments.
extern "C" int exchange_slots_warp_row(void* const* bufs, const int64_t* bounds, int members,
                                       const void* slots, int64_t n, void* stream) {
    if (n <= 0 || members <= 1) return 0;
    if (members > EXCHANGE_MAX_MEMBERS) return (int)cudaErrorInvalidValue;
    const int64_t grid = (n + EXCHANGE_WARP_ROWS - 1) / EXCHANGE_WARP_ROWS;
    exchange_slots_warp_row_kernel<<<(unsigned)grid, 32 * EXCHANGE_WARP_ROWS, 0,
                                     (cudaStream_t)stream>>>(
        exchange_args(bufs, bounds, members), (const int64_t*)slots, n);
    return (int)cudaGetLastError();
}

// Peer access between every pair of distinct cards in `devices` (n of
// them), so that an exchange launched on one card reaches the replicas on
// the others. Cards already enabled are skipped; the current card is kept.
extern "C" int exchange_enable_peers(const int* devices, int n) {
    int current = 0;
    cudaError_t err = cudaGetDevice(&current);
    for (int i = 0; err == cudaSuccess && i < n; ++i) {
        for (int j = 0; err == cudaSuccess && j < n; ++j) {
            if (devices[i] == devices[j]) continue;
            int ok = 0;
            err = cudaDeviceCanAccessPeer(&ok, devices[i], devices[j]);
            if (err != cudaSuccess) break;
            if (!ok) {
                err = cudaErrorPeerAccessUnsupported;
                break;
            }
            err = cudaSetDevice(devices[i]);
            if (err != cudaSuccess) break;
            err = cudaDeviceEnablePeerAccess(devices[j], 0);
            if (err == cudaErrorPeerAccessAlreadyEnabled) {
                cudaGetLastError();  // clear it: the pair is enabled
                err = cudaSuccess;
            }
        }
    }
    cudaSetDevice(current);
    return (int)err;
}
