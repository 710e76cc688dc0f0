// scan_agg_fold: one batch of the scan -> filter -> partial-aggregate
// hot loop, folded into running per-group registers, in one launch.
//
// Replaces: the reduction and the running merge of the JAX package's
// fused worker, citus_tpu/ops/scan_agg.py:43 build_worker_fn (scalar and
// direct modes) and :277 build_fused_worker_fn, jitted under the
// executor's `jit_fused` slot, with the scalar-mode sketch registers of
// :84-155 (hll, ddsk, topk, topkv; B1-sketch).  The filter and the argument expressions
// stay plain tensor code in this slice (planner/bound.py compile_expr);
// the kernel takes their results.
//
// What it computes, for rows with mask[i] set:
//   gid  = sum_k clip((key_k - lo_k) // step_k + 1, 0) * stride_k, with a
//          NULL key coding 0, clamped to [0, G-1]   (scan_agg.py:189-206)
//   ok   = mask & valid(arg)
//   acc[op][gid] (+)= value cast to the accumulator type, for count(*),
//          count, sum, min, max; rows[gid] += 1 in direct mode;
//   scalar mode's sketch registers (G = 1): hll[b] = max(hll[b], rho),
//          ddsk[b] += 1, topk[b] += 1, topkv[b] = max(topkv[b], value),
//          b the row's bucket (sketch.cuh, bit-identical to
//          planner/aggregates.py).
// int64 sums wrap in two's complement as XLA's do (the float64 shadow
// sum of the planner detects overflow); float min/max propagate NaN as
// jnp.minimum does; groups that see no row keep their sentinels.
//
// What bounds it on an H100: memory.  Each row is read once -- the mask,
// the key and argument columns with their validity bytes (about 51 B a
// row for TPC-H Q1, bench.py Q1_BYTES_PER_ROW) -- against 3.35 TB/s;
// the arithmetic per row is a few integer operations and one atomic per
// partial op.  The design serves that bound with one pass over the
// inputs, a block-private group table in shared memory while every op's
// registers fit (8 B a plain slot; a sketch plan's registers are ~33 KB:
// 512 B of HLL, 16 KB of DDSketch counts, 8 + 8 KB of top-k; merged into
// the registers with one atomic per non-empty slot at the end of the
// block), global atomics otherwise, and no intermediate written to device
// memory.  A sketch row also pays a splitmix64 hash or a float64 log, and
// every row lands on one of 128 HLL registers: the sketch fold is bound by
// shared-memory atomic contention, not bytes.  Warp-level pre-aggregation
// and 16-byte vector loads are later work.  The kernels and the launcher
// live in fold.cuh, shared with the batched fold.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"

// Launches one fold of `p` on `stream`.  *regime is set to 1 for the
// shared-memory table, 0 for global atomics.  Returns the CUDA error of
// the launch (0 = cudaSuccess); the kernel runs asynchronously.
extern "C" int scan_agg_fold_launch(const SafParams* p, void* stream, int* regime) {
    return launch_fold(p, 1, stream, regime);
}

extern "C" int scan_agg_fold_params_size(void) { return (int)sizeof(SafParams); }
