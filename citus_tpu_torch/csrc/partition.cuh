// Stable partition building blocks of the repartition kernel
// (partition_pack.cu, B7): an exclusive scan of int64 counts over many
// blocks, and one stable counting pass that places every row by a small
// "digit" (a destination) at its global position, rows of one digit in
// input order.
//
// A counting pass runs in three launches over tiles of PT_TILE rows,
// one tile per block:
//   1. pt_tile_hist: each tile counts its rows per digit in shared
//      memory and writes hist[digit * n_tiles + tile];
//   2. pt_scan (three kernels): the exclusive scan of hist, digit-major,
//      so hist[d * n_tiles + t] becomes the position of tile t's first
//      row of digit d among all rows ordered by (digit, input order);
//   3. pt_tile_scatter: each tile walks its rows again in input order,
//      PT_THREADS rows a round: a row's rank among the round's rows of
//      its digit comes from __match_any_sync within its warp and from
//      the counts of the warps before it, and a running count per digit
//      carries from round to round.  Emit(i, digit, position) receives
//      each row's global position.
// Nothing here sorts by comparison, searches or calls a library: every
// row is read twice (histogram and scatter) and written once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PT_THREADS 256
#define PT_WARPS (PT_THREADS / 32)
#define PT_ITEMS 8
#define PT_TILE (PT_THREADS * PT_ITEMS)
//: digits of one counting pass (the scatter keeps [PT_WARPS + 1] counts
//: per digit in shared memory: 36 KB at 1,024 digits)
#define PT_MAX_DIGITS 1024

static inline int64_t pt_tiles(int64_t n) { return (n + PT_TILE - 1) / PT_TILE; }

// exclusive scan of one value per thread over the block; *total gets
// the block's sum.  Every thread of the block must call it.
__device__ inline int64_t pt_block_excl_scan(int64_t v, int64_t* total) {
    __shared__ int64_t s_warp[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = (blockDim.x + 31) >> 5;
    int64_t x = v;
    for (int o = 1; o < 32; o <<= 1) {
        const int64_t y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int64_t w = lane < n_warps ? s_warp[lane] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            const int64_t y = __shfl_up_sync(0xffffffffu, w, o);
            if (lane >= o) w += y;
        }
        s_warp[lane] = w;
    }
    __syncthreads();
    const int64_t excl = (warp > 0 ? s_warp[warp - 1] : 0) + x - v;
    *total = s_warp[n_warps - 1];
    __syncthreads();
    return excl;
}

// ---- exclusive scan of n int64 values, in place allowed ----------------

__global__ void pt_scan_reduce(const int64_t* in, int64_t n, int64_t* bsum) {
    const int64_t base = (int64_t)blockIdx.x * PT_TILE + (int64_t)threadIdx.x * PT_ITEMS;
    int64_t s = 0;
    for (int k = 0; k < PT_ITEMS; ++k) {
        const int64_t i = base + k;
        if (i < n) s += in[i];
    }
    int64_t total;
    pt_block_excl_scan(s, &total);
    if (threadIdx.x == 0) bsum[blockIdx.x] = total;
}

// one block: exclusive scan of the tile sums in place; *total (if not
// null) gets the sum of everything
__global__ void pt_scan_top(int64_t* bsum, int64_t nb, int64_t* total) {
    int64_t carry = 0;
    for (int64_t base = 0; base < nb; base += blockDim.x) {
        const int64_t i = base + threadIdx.x;
        const int64_t v = i < nb ? bsum[i] : 0;
        int64_t chunk;
        const int64_t e = pt_block_excl_scan(v, &chunk);
        if (i < nb) bsum[i] = carry + e;
        carry += chunk;
    }
    if (threadIdx.x == 0 && total != nullptr) *total = carry;
}

__global__ void pt_scan_down(const int64_t* in, int64_t n, const int64_t* bsum,
                             int64_t* out) {
    const int64_t base = (int64_t)blockIdx.x * PT_TILE + (int64_t)threadIdx.x * PT_ITEMS;
    int64_t v[PT_ITEMS];
    int64_t s = 0;
    for (int k = 0; k < PT_ITEMS; ++k) {
        const int64_t i = base + k;
        v[k] = i < n ? in[i] : 0;
        s += v[k];
    }
    int64_t total;
    int64_t run = bsum[blockIdx.x] + pt_block_excl_scan(s, &total);
    for (int k = 0; k < PT_ITEMS; ++k) {
        const int64_t i = base + k;
        if (i < n) out[i] = run;
        run += v[k];
    }
}

// out[i] = in[0] + ... + in[i - 1]; *total (if not null) = the sum of all
// n.  bsum: pt_tiles(n) int64 of scratch.  -> the first CUDA error.
static inline int pt_scan(const int64_t* in, int64_t* out, int64_t n,
                          int64_t* bsum, int64_t* total, cudaStream_t s) {
    const int64_t nb = pt_tiles(n);
    if (nb > 0) {
        pt_scan_reduce<<<(unsigned)nb, PT_THREADS, 0, s>>>(in, n, bsum);
        pt_scan_top<<<1, 1024, 0, s>>>(bsum, nb, total);
        pt_scan_down<<<(unsigned)nb, PT_THREADS, 0, s>>>(in, n, bsum, out);
    } else if (total != nullptr) {
        cudaMemsetAsync(total, 0, sizeof(int64_t), s);
    }
    return (int)cudaGetLastError();
}

// ---- one stable counting pass -------------------------------------------

// hist[d * n_tiles + tile] = rows of the tile whose digit is d
template <class Digit>
__global__ void pt_tile_hist(int64_t n, int n_digits, Digit digit, int64_t* hist) {
    __shared__ int counts[PT_MAX_DIGITS];
    for (int d = threadIdx.x; d < n_digits; d += blockDim.x) counts[d] = 0;
    __syncthreads();
    const int64_t base = (int64_t)blockIdx.x * PT_TILE;
    for (int k = 0; k < PT_ITEMS; ++k) {
        const int64_t i = base + (int64_t)k * PT_THREADS + threadIdx.x;
        if (i < n) atomicAdd(&counts[digit(i)], 1);
    }
    __syncthreads();
    for (int d = threadIdx.x; d < n_digits; d += blockDim.x)
        hist[(int64_t)d * gridDim.x + blockIdx.x] = counts[d];
}

// offs: the exclusive scan of pt_tile_hist's counts.  Calls
// emit(i, d, position) once per row, position counted over all rows
// ordered by (digit, input order).
template <class Digit, class Emit>
__global__ void pt_tile_scatter(int64_t n, int n_digits, Digit digit,
                                const int64_t* offs, Emit emit) {
    __shared__ int64_t running[PT_MAX_DIGITS];
    __shared__ int warp_counts[PT_WARPS][PT_MAX_DIGITS];
    for (int d = threadIdx.x; d < n_digits; d += blockDim.x) {
        running[d] = offs[(int64_t)d * gridDim.x + blockIdx.x];
        for (int w = 0; w < PT_WARPS; ++w) warp_counts[w][d] = 0;
    }
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned lt = (1u << lane) - 1u;
    const int64_t base = (int64_t)blockIdx.x * PT_TILE;
    for (int k = 0; k < PT_ITEMS; ++k) {
        const int64_t i = base + (int64_t)k * PT_THREADS + threadIdx.x;
        const bool live = i < n;
        const int d = live ? digit(i) : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const bool leader = (peers & lt) == 0;
        if (live && leader) warp_counts[warp][d] = __popc(peers);
        __syncthreads();
        if (live) {
            int64_t pos = running[d] + __popc(peers & lt);
            for (int w = 0; w < warp; ++w) pos += warp_counts[w][d];
            emit(i, d, pos);
        }
        __syncthreads();
        if (live && leader) {
            atomicAdd((unsigned long long*)&running[d], (unsigned long long)__popc(peers));
            warp_counts[warp][d] = 0;
        }
        __syncthreads();
    }
}

// the histogram, its scan and the scatter of one pass over n rows.
// hist: n_digits * pt_tiles(n) int64, bsum: pt_tiles(n_digits *
// pt_tiles(n)) int64 of scratch; on return hist holds the scanned
// offsets: the rows of digit d start at hist[d * pt_tiles(n)] (or, for
// n = 0, nowhere).
template <class Digit, class Emit>
static inline int pt_counting_pass(int64_t n, int n_digits, Digit digit, Emit emit,
                                   int64_t* hist, int64_t* bsum, cudaStream_t s) {
    const int64_t nt = pt_tiles(n);
    if (nt == 0) return 0;
    pt_tile_hist<<<(unsigned)nt, PT_THREADS, 0, s>>>(n, n_digits, digit, hist);
    int err = pt_scan(hist, hist, (int64_t)n_digits * nt, bsum, nullptr, s);
    if (err != 0) return err;
    pt_tile_scatter<<<(unsigned)nt, PT_THREADS, 0, s>>>(n, n_digits, digit, hist, emit);
    return (int)cudaGetLastError();
}
