// Kernel 1: keccak256_absorb — batched Keccak-256 over pre-padded messages
// with a per-message block count (the masked multi-block absorb).
//
// Replaces, from the JAX package:
//   - ops/keccak_pallas.py _keccak_kernel (launched by keccak256_pallas_wordsT),
//     the repo's only Pallas kernel: one 136-byte rate block, 24 rounds on
//     u32 lo/hi lane pairs, 32-byte squeeze, batch tiled 256 lanes wide.
//     With blocks == 1 and every count == 1 this kernel computes exactly what
//     that kernel computes: the same absorb of the same 34 words, the same
//     permutation, the same (N, 8) u32 output words [lo0,hi0,...,lo3,hi3]
//     (ops/keccak_jax.py _squeeze256), which on a little-endian card is the
//     first four lanes stored as uint64_t.
//   - ops/keccak_jax.py masked_absorb_words (the XLA masked absorb): message
//     i absorbs blocks 0..counts[i]-1 and never touches the zero blocks after
//     them.
//
// Layout: words is (n, blocks*34) u32 row-major, exactly the (N, 34) rows the
// reference wrapper takes; 34 u32 words are 17 uint64_t lanes. counts is
// (n,) int32, out is (n, 8) u32 = (n, 4) uint64_t.
//
// Bound: integer issue. Each message of c live blocks costs c permutations
// (keccak.cuh: 4,723 integer instructions each in the one-thread kernel's
// SASS, which chip_smoke.py counts on keccak256_absorb_unstaged_kernel) and
// moves only its own c * 136 bytes, its count and its digest, so a launch
// is bound by the SMs' integer rate, and a narrow one by its one-warp floor
// (its longest row's permutations in one warp).
//
// Design. One thread per message runs the permutation, its state in
// registers (keccak.cuh). The first design (kept below as the debug entry
// keccak256_absorb_unstaged, which the port never calls) did only that: each
// thread read its own row, 17 8-byte loads per rate block with the 32 rows
// of a warp 136 * B bytes apart (32 sectors per load instruction), a warp
// ran as many permutations as its longest row, and the grid was n / 128
// blocks whatever n. This one adds:
//   - Rows staged in shared memory by coalesced copies. The block's threads
//     copy its rows' live rate blocks (blocks 0..counts[i]-1, never the zero
//     blocks of the row's padded width: KeccakDevice's block_tier=4 bucket
//     is 4 blocks wide and almost all its rows are 1 block) with cp.async,
//     neighbouring threads on neighbouring 16-byte chunks of a row. Rows are
//     136 * B bytes apart, so a row may start 8 bytes off a 16-byte boundary
//     (odd rows at odd B, or every row when words does); its slot in shared
//     memory is then entered 8 bytes in, so that source and destination
//     agree modulo 16, and the row's first or last 8 bytes go as one 8-byte
//     copy. A row takes ABSORB_WINDOW rate blocks at a time; a longer one
//     absorbs window by window, the block copying each window in turn.
//     Slots are ABSORB_SLOT = 280 bytes (35 lanes, 3 modulo 16) apart, so a
//     half-warp's 8-byte reads of lane j of 16 rows fall on distinct bank
//     pairs, up to the one-lane shift of an 8-byte entry (at most 2 rows on
//     a bank pair).
//   - Warp-uniform block counts. The block orders its rows by count, a
//     counting sort in shared memory over the counts 0..B, and thread t
//     takes the t-th row of that order, so the 32 rows of a warp share one
//     count except where two counts meet; no warp runs a 5-block row's
//     permutations for 31 rows of 1-3 blocks. The digests go back to their
//     own rows through shared memory, as one coalesced copy of the block's.
//   - A grid sized for even work per SM: a launch of at most 132 x 128 rows
//     takes ceil(n / 132) rows a block (whole warps, at least 32), so a
//     narrow launch spreads over every SM; a wider one takes rows a block so
//     that its blocks fill whole passes of the blocks the card holds at once
//     (equal waves).
//   - A rolled permutation: ABSORB_ROUND_UNROLL rounds per loop trip, and
//     one permutation body however many blocks a window holds. With all 24
//     rounds unrolled (the first design's) this kernel measured slower than
//     the first design at every launch chip_smoke.py times, probably
//     because the blocks of an SM run different windows and phases of the
//     sort and copies, and a body a sixth of the size shares the
//     instruction caches better (as in fused_level.cu).
// Lane groups (several threads per message) are left out: on this card five
// lanes a row only gain on launches of tens of rows (subtrie_levels'
// measurements), and this kernel's launches are thousands.

#include <cuda_runtime.h>

#include "keccak.cuh"

constexpr int ABSORB_ROWS = 128;                              // most rows (threads) a block
constexpr int ABSORB_WINDOW = 2;                              // rate blocks of a row staged at once
constexpr int ABSORB_SLOT = ABSORB_WINDOW * KECCAK_RATE + 8;  // bytes of a row's slot
constexpr int ABSORB_ROUND_UNROLL = 4;                        // permutation rounds per loop trip
// Widest rows the kernel takes (wider ones: cudaErrorInvalidValue): its sort
// keeps one counter per block count in shared memory.
constexpr int ABSORB_MAX_BLOCKS = 32768;

static_assert(ABSORB_ROWS % 32 == 0, "whole warps per block");
static_assert(ABSORB_SLOT % 8 == 0 && (ABSORB_SLOT / 8) % 2 == 1,
              "slots an odd number of lanes apart (bank pairs)");

// 16-byte chunks (16-byte aligned spans) that m rate blocks starting at an
// 8-byte boundary can touch.
__host__ __device__ constexpr int absorb_chunks(int m) { return (m * KECCAK_RATE + 8 + 15) / 16; }

// The block's shared memory: its sort (one counter per block count 0..B, the
// count of each of its rows, its rows in order of count, the largest
// count), then, 16-byte aligned, one slot of ABSORB_SLOT bytes per row.
__host__ __device__ constexpr int64_t absorb_sort_bytes(int32_t blocks, int rows) {
    return ((int64_t)(blocks + 1 + 2 * rows + 1) * 4 + 15) & ~(int64_t)15;
}
__host__ __device__ constexpr int64_t absorb_smem_bytes(int32_t blocks, int rows) {
    return absorb_sort_bytes(blocks, rows) + (int64_t)rows * ABSORB_SLOT;
}

// 16- and 8-byte asynchronous copies global -> shared, and the wait for all.
__device__ __forceinline__ void absorb_cp16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void absorb_cp8(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void absorb_cp_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Bytes into slot `pos` where a copy from `src` starts, so that the two
// agree modulo 16 (the slots area is 16-byte aligned; both are 8-aligned).
__device__ __forceinline__ int absorb_phase(const uint8_t* src, int pos) {
    return (int)(((uintptr_t)src ^ (uintptr_t)(pos * ABSORB_SLOT)) & 8);
}

// Copy window k0 (rate blocks k0 .. k0 + ABSORB_WINDOW - 1) of the block's
// rows into their slots: the rows at positions [start(k0 + m),
// start(k0 + m + 1)) of the order have m live blocks in it (m < W), those
// from start(k0 + W) on W. The block's threads take the (row, chunk) pairs
// of those groups in turn, row by row, so neighbouring threads copy
// neighbouring chunks of a row.
__device__ __forceinline__ void absorb_stage(const uint8_t* __restrict__ words, int64_t stride,
                                             int64_t i0, const int* order, const int* first,
                                             int max_count, int rows, int k0, uint8_t* slots) {
    constexpr int W = ABSORB_WINDOW;
    const auto start = [&](int k) { return k > max_count ? rows : first[k]; };
    int g_lo[W], g_units[W];
    int units = 0;
#pragma unroll
    for (int g = 0; g < W; ++g) {
        const int lo = start(k0 + g + 1), hi = g + 1 < W ? start(k0 + g + 2) : rows;
        g_lo[g] = lo;
        g_units[g] = (hi - lo) * absorb_chunks(g + 1);
        units += g_units[g];
    }
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
        int v = u, m = 0, pos = 0, j = 0;  // m: the group's live blocks, once found
#pragma unroll
        for (int g = 0; g < W; ++g) {
            if (m) continue;
            if (g == W - 1 || v < g_units[g]) {
                m = g + 1;
                pos = g_lo[g] + v / absorb_chunks(g + 1);
                j = v % absorb_chunks(g + 1);
            } else {
                v -= g_units[g];
            }
        }
        const uint8_t* src = words + (i0 + order[pos]) * stride + (int64_t)k0 * KECCAK_RATE;
        uint8_t* dst = slots + pos * ABSORB_SLOT + absorb_phase(src, pos);
        const uintptr_t s0 = (uintptr_t)src, s1 = s0 + (uintptr_t)(m * KECCAK_RATE);
        const uintptr_t a = (s0 & ~(uintptr_t)15) + 16 * (uintptr_t)j;
        const uintptr_t lo = a > s0 ? a : s0, hi = a + 16 < s1 ? a + 16 : s1;
        if (hi > lo) {
            if (hi - lo == 16)
                absorb_cp16(dst + (lo - s0), (const void*)lo);
            else
                absorb_cp8(dst + (lo - s0), (const void*)lo);
        }
    }
}

__global__ void __launch_bounds__(ABSORB_ROWS)
keccak256_absorb_kernel(const uint8_t* __restrict__ words, const int32_t* __restrict__ counts,
                        uint64_t* __restrict__ out, int64_t n, int32_t blocks) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int R = blockDim.x, t = threadIdx.x;
    int* first = (int*)smem;              // rows of each count, then its first position
    int* row_count = first + blocks + 1;  // each row's count
    int* order = row_count + R;           // the block's rows in order of count
    int* max_count = order + R;
    uint8_t* slots = smem + absorb_sort_bytes(blocks, R);
    const int64_t i0 = (int64_t)blockIdx.x * R;
    const int rows = (int)(n - i0 < R ? n - i0 : R);
    const int64_t stride = (int64_t)blocks * KECCAK_RATE;

    // counting sort of the block's rows by count
    int c = 0;
    if (t < rows) {
        c = counts[i0 + t];
        c = c < 0 ? 0 : (c > blocks ? blocks : c);
    }
    for (int k = t; k <= blocks; k += R) first[k] = 0;
    if (t == 0) *max_count = 0;
    __syncthreads();
    int rank = 0;
    if (t < rows) {
        rank = atomicAdd(&first[c], 1);
        atomicMax(max_count, c);
        row_count[t] = c;
    }
    __syncthreads();
    const int max_count_v = *max_count;
    if (t == 0) {  // counters -> first positions, over the counts present
        int pos = 0;
        for (int k = 0; k <= max_count_v; ++k) {
            const int h = first[k];
            first[k] = pos;
            pos += h;
        }
    }
    __syncthreads();
    if (t < rows) order[first[c] + rank] = t;
    __syncthreads();

    // thread t absorbs the t-th row of the order
    const int row = t < rows ? order[t] : 0;
    const int nb = t < rows ? row_count[row] : 0;
    const uint8_t* src = words + (i0 + row) * stride;
    uint64_t s[25];
#pragma unroll
    for (int j = 0; j < 25; ++j) s[j] = 0;
    for (int k0 = 0; k0 < max_count_v; k0 += ABSORB_WINDOW) {
        absorb_stage(words, stride, i0, order, first, max_count_v, rows, k0, slots);
        absorb_cp_wait();
        __syncthreads();
        if (nb > k0) {
            const int m = nb - k0 < ABSORB_WINDOW ? nb - k0 : ABSORB_WINDOW;
            const uint8_t* at = src + (int64_t)k0 * KECCAK_RATE;
            const uint64_t* lanes =
                (const uint64_t*)(slots + t * ABSORB_SLOT + absorb_phase(at, t));
#pragma unroll 1
            for (int k = 0; k < m; ++k, lanes += KECCAK_RATE_LANES) {
#pragma unroll
                for (int j = 0; j < KECCAK_RATE_LANES; ++j) s[j] ^= lanes[j];
                keccak_f1600<ABSORB_ROUND_UNROLL>(s);
            }
        }
        __syncthreads();  // the next window overwrites the slots
    }

    // digests back to their rows, then out as one coalesced copy
    if (t < rows) {
        ulonglong2* d = (ulonglong2*)(slots + row * 32);
        d[0] = make_ulonglong2(s[0], s[1]);
        d[1] = make_ulonglong2(s[2], s[3]);
    }
    __syncthreads();
    const ulonglong2* staged = (const ulonglong2*)slots;
    ulonglong2* dst = (ulonglong2*)(out + i0 * 4);
    for (int q = t; q < 2 * rows; q += R) dst[q] = staged[q];
}

// The first design, kept as a debug entry (keccak256_absorb_unstaged below,
// which chip_smoke.py times beside the kernel above and on whose SASS it
// counts one permutation's integer instructions; the port never calls it):
// one thread per message reading its own row from global memory, 128-thread
// blocks, ceil(n / 128) of them.
__global__ void __launch_bounds__(KECCAK_THREADS)
keccak256_absorb_unstaged_kernel(const uint64_t* __restrict__ words,
                                 const int32_t* __restrict__ counts,
                                 uint64_t* __restrict__ out, int64_t n, int32_t blocks) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint64_t* w = words + i * (int64_t)blocks * KECCAK_RATE_LANES;
    int nb = counts[i];
    if (nb > blocks) nb = blocks;
    uint64_t s[25];
#pragma unroll
    for (int j = 0; j < 25; ++j) s[j] = 0;
    for (int k = 0; k < nb; ++k) {
        uint64_t blk[KECCAK_RATE_LANES];
#pragma unroll
        for (int j = 0; j < KECCAK_RATE_LANES; ++j) blk[j] = w[k * KECCAK_RATE_LANES + j];
        keccak_absorb_block(s, blk);
    }
    uint64_t* o = out + i * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = s[j];
}

// -- host entry points --------------------------------------------------------

// Once per width: allow the kernel's dynamic shared memory above the 48 KB
// default (only rows of thousands of blocks need it).
static int absorb_allow_smem(int64_t bytes) {
    static int64_t allowed = 48 * 1024;
    if (bytes <= allowed) return 0;
    const cudaError_t err = cudaFuncSetAttribute(
        keccak256_absorb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) allowed = bytes;
    return (int)err;
}

// Rows per block of a launch of n rows B blocks wide (a multiple of 32, at
// most ABSORB_ROWS); negative: minus a CUDA error. At most 132 x 128 rows
// (one full block per SM): ceil(n / SMs) rows a block, so that every SM
// takes a share. More: the card's co-resident blocks at ABSORB_ROWS rows
// make one pass; the launch takes ceil(n / pass) passes, and its rows are
// dealt evenly over the blocks of those passes.
extern "C" int keccak256_absorb_rows_per_block(int64_t n, int32_t blocks) {
    static int sms = 0;
    static int32_t occ_blocks = -1;
    static int per_sm = 0;
    if (n <= 0) return ABSORB_ROWS;
    if (blocks <= 0 || blocks > ABSORB_MAX_BLOCKS) return -(int)cudaErrorInvalidValue;
    if (!sms) {
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return -(int)err;
    }
    const auto whole_warps = [](int64_t r) { return (int)((r + 31) / 32 * 32); };
    if (n <= (int64_t)sms * ABSORB_ROWS) {
        const int r = whole_warps((n + sms - 1) / sms);
        return r < 32 ? 32 : r;
    }
    if (occ_blocks != blocks) {
        const int64_t bytes = absorb_smem_bytes(blocks, ABSORB_ROWS);
        if (const int err = absorb_allow_smem(bytes)) return -err;
        const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, keccak256_absorb_kernel, ABSORB_ROWS, (size_t)bytes);
        if (err != cudaSuccess) return -(int)err;
        if (per_sm <= 0) return -(int)cudaErrorInvalidConfiguration;
        occ_blocks = blocks;
    }
    const int64_t pass = (int64_t)sms * per_sm;  // blocks at once
    const int64_t waves = (n + pass * ABSORB_ROWS - 1) / (pass * ABSORB_ROWS);
    const int r = whole_warps((n + waves * pass - 1) / (waves * pass));
    return r < ABSORB_ROWS ? r : ABSORB_ROWS;
}

extern "C" int keccak256_absorb(const void* words, const void* counts, void* out,
                                int64_t n, int32_t blocks, void* stream) {
    if (n <= 0) return 0;
    const int rows = keccak256_absorb_rows_per_block(n, blocks);
    if (rows < 0) return -rows;
    const int64_t bytes = absorb_smem_bytes(blocks, rows);
    if (const int err = absorb_allow_smem(bytes)) return err;
    const int64_t grid = (n + rows - 1) / rows;
    keccak256_absorb_kernel<<<(unsigned)grid, rows, (size_t)bytes, (cudaStream_t)stream>>>(
        (const uint8_t*)words, (const int32_t*)counts, (uint64_t*)out, n, blocks);
    return (int)cudaGetLastError();
}

// The debug entry above (chip_smoke.py and the card's tests only).
extern "C" int keccak256_absorb_unstaged(const void* words, const void* counts, void* out,
                                         int64_t n, int32_t blocks, void* stream) {
    if (n <= 0) return 0;
    const int64_t grid = (n + KECCAK_THREADS - 1) / KECCAK_THREADS;
    keccak256_absorb_unstaged_kernel<<<(unsigned)grid, KECCAK_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)words, (const int32_t*)counts, (uint64_t*)out, n, blocks);
    return (int)cudaGetLastError();
}
