// The host-compilable half of the fold (fold.cuh): the plan of its
// block-private shared-memory table, and the lane arithmetic of its
// warp-aggregated updates.  Everything here is plain C++ as well as
// CUDA, so tests/test_torch_fold_plan.py compiles it with g++ and holds
// it against a model on the CPU.
//
// The table.  A block folds into a private table of every op's registers
// for the queries it serves (8-byte slots for count/sum/min/max and the
// rows counter, 4-byte HLL registers, 8-byte sketch counts and values,
// each op's region 8-aligned), merged into the registers at its end.
// When the registers of all Q queries fit the opt-in shared-memory limit
// one table serves them all; when only some do, the launch folds the
// queries in chunks of q_chunk, one chunk per blockIdx.y, every chunk of
// one launch walking the same rows; when not even one query's registers
// fit, the rows update the registers with global atomics.
//
// Warp segments.  The lanes of a warp whose rows fold into the same
// register form a segment (their `peers` mask, from __match_any_sync).
// A value reduces over a segment by a tree over the lanes' ranks within
// it: at step k (width w = 2^k) the lane of rank r, with r a multiple of
// 2w and r + w < size, combines the value of the lane of rank r + w, so
// after ceil(log2(size)) steps the segment's lowest lane (rank 0) holds
// the reduction.  The source lanes of each step are computed once per
// segment, when a first value needs them (seg_sources); every lane of
// the warp shuffles at every step, so the shuffles take the full mask
// whatever the segments are.

#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#ifndef __host__
#define __host__
#define __device__
#endif
#endif

#define FP_HD __host__ __device__ inline

// the largest number of reduction steps: a segment of 32 lanes
#define SEG_MAX_STEPS 5

FP_HD int fp_popc(unsigned m) {
#ifdef __CUDA_ARCH__
    return __popc(m);
#else
    return __builtin_popcount(m);
#endif
}

// the position of set bit n (0-based, from bit 0) of m; n < popc(m)
FP_HD int nth_set_bit(unsigned m, int n) {
    int pos = 0;
    for (int w = 16; w >= 1; w >>= 1) {
        const int c = fp_popc(m & ((1u << w) - 1u));
        if (n >= c) {
            n -= c;
            m >>= w;
            pos += w;
        }
    }
    return pos;
}

// steps of a tree reduction over segments of at most max_size lanes
FP_HD int seg_steps(int max_size) {
    int s = 0;
    while ((1 << s) < max_size) ++s;
    return s;
}

struct WarpSeg {
    unsigned peers;             // the lanes of this lane's segment
    int rank;                   // this lane's rank among them
    int size;
    int steps;                  // warp-uniform: for the warp's largest segment
    int src[SEG_MAX_STEPS];     // the lane whose value step k reads
};

FP_HD WarpSeg warp_seg(unsigned peers, int lane, int steps) {
    WarpSeg s;
    s.peers = peers;
    s.rank = fp_popc(peers & ((1u << lane) - 1u));
    s.size = fp_popc(peers);
    s.steps = steps;
    return s;
}

// the source lanes of every step of segment s, for the lane `lane`
FP_HD void seg_sources(WarpSeg& s, int lane) {
#pragma unroll
    for (int k = 0; k < SEG_MAX_STEPS; ++k) {
        const int r = s.rank + (1 << k);
        s.src[k] = (k < s.steps && r < s.size) ? nth_set_bit(s.peers, r) : lane;
    }
}

// whether this lane combines the value it reads at step k
FP_HD bool seg_takes(const WarpSeg& s, int k) {
    return (s.rank & ((2 << k) - 1)) == 0 && s.rank + (1 << k) < s.size;
}

// The shared table of q queries: byte offsets of every op's region in
// op_soff[0..n_ops) (op_soff[n_ops]: the rows counter's), -> its bytes.
// kind_bytes[o] is 4 for an HLL op, 8 otherwise; m[o] its registers
// per group.
FP_HD int64_t fold_table_bytes(int n_ops, const int* kind_bytes, const int* m,
                               int64_t n_groups, int64_t q, bool rows,
                               int64_t* op_soff) {
    int64_t bytes = 0;
    for (int o = 0; o < n_ops; ++o) {
        if (op_soff != nullptr) op_soff[o] = bytes;
        bytes += q * n_groups * m[o] * kind_bytes[o];
        bytes = (bytes + 7) & ~(int64_t)7;
    }
    if (op_soff != nullptr) op_soff[n_ops] = bytes;
    if (rows) bytes += q * n_groups * 8;
    return bytes;
}

// Queries per chunk of the shared table for n_q queries under `limit`
// bytes: n_q when every query fits, else the fewest chunks whose tables
// fit, balanced (ceil(n_q / chunks)); 0 when one query's registers do
// not fit (global atomics).  The launch takes ceil(n_q / q_chunk) chunks.
FP_HD int fold_query_chunk(int n_ops, const int* kind_bytes, const int* m,
                           int64_t n_groups, int n_q, bool rows,
                           int64_t limit) {
    if (n_q < 1) return 0;
    int fit = 0;
    for (int q = 1; q <= n_q; ++q) {
        if (fold_table_bytes(n_ops, kind_bytes, m, n_groups, q, rows, nullptr) > limit)
            break;
        fit = q;
    }
    if (fit == 0) return 0;
    const int chunks = (n_q + fit - 1) / fit;
    return (n_q + chunks - 1) / chunks;
}
