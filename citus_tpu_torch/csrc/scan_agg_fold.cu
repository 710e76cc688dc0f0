// scan_agg_fold: one batch of the scan -> filter -> partial-aggregate
// hot loop, folded into running per-group registers, in one launch.
//
// Replaces: the reduction and the running merge of the JAX package's
// fused worker, citus_tpu/ops/scan_agg.py:43 build_worker_fn (scalar and
// direct modes) and :277 build_fused_worker_fn, jitted under the
// executor's `jit_fused` slot.  The filter and the argument expressions
// stay plain tensor code in this slice (planner/bound.py compile_expr);
// the kernel takes their results.
//
// What it computes, for rows with mask[i] set:
//   gid  = sum_k clip((key_k - lo_k) // step_k + 1, 0) * stride_k, with a
//          NULL key coding 0, clamped to [0, G-1]   (scan_agg.py:189-206)
//   ok   = mask & valid(arg)
//   acc[op][gid] (+)= value cast to the accumulator type, for count(*),
//          count, sum, min, max; rows[gid] += 1 in direct mode.
// int64 sums wrap in two's complement as XLA's do (the float64 shadow
// sum of the planner detects overflow); float min/max propagate NaN as
// jnp.minimum does; groups that see no row keep their sentinels.
//
// What bounds it on an H100: memory.  Each row is read once -- the mask,
// the key and argument columns with their validity bytes (about 51 B a
// row for TPC-H Q1, bench.py Q1_BYTES_PER_ROW) -- against 3.35 TB/s;
// the arithmetic per row is a few integer operations and one atomic per
// partial op.  The design serves that bound with one pass over the
// inputs, a block-private group table in shared memory when
// G * (ops + 1) * 8 B fits (merged into the registers with one atomic per
// non-empty slot at the end of the block), global atomics otherwise, and
// no intermediate written to device memory.  Warp-level pre-aggregation
// and 16-byte vector loads are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"

// ------------------------------------------------------------ kernels

// shared-memory regime: a block-private [slots][G] table of 8-byte slots
__global__ void fold_shared(const SafParams p) {
    extern __shared__ unsigned long long table[];
    const int64_t G = p.n_groups;
    const int n_slots = p.n_ops + (p.rows != nullptr ? 1 : 0);
    for (int64_t t = threadIdx.x; t < G * n_slots; t += blockDim.x) {
        int s = (int)(t / G);
        table[t] = s < p.n_ops ? identity_bits(p.op_kind[s], p.op_dtype[s]) : 0ull;
    }
    __syncthreads();
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < p.n; i += step) {
        if (!p.mask[i]) continue;
        int64_t g = group_of(p, i);
        for (int o = 0; o < p.n_ops; ++o) {
            if (p.op_kind[o] != SAF_COUNT_STAR && !is_valid(p.args[p.op_arg[o]], i)) continue;
            fold_row(p, o, &table[(int64_t)o * G + g], i);
        }
        if (p.rows != nullptr) atomicAdd(&table[(int64_t)p.n_ops * G + g], 1ull);
    }
    __syncthreads();
    for (int64_t t = threadIdx.x; t < G * n_slots; t += blockDim.x) {
        int s = (int)(t / G);
        int64_t g = t - (int64_t)s * G;
        if (s == p.n_ops) {
            if (table[t] != 0ull) atomicAdd((unsigned long long*)p.rows + g, table[t]);
            continue;
        }
        unsigned long long id = identity_bits(p.op_kind[s], p.op_dtype[s]);
        unsigned long long v = table[t];
        if (op_width(p, s) == 4) { v &= 0xffffffffull; id &= 0xffffffffull; }
        if (v != id) merge_slot(p, s, g, &table[t]);
    }
}

// global regime: every valid row updates the registers directly
__global__ void fold_global(const SafParams p) {
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < p.n; i += step) {
        if (!p.mask[i]) continue;
        int64_t g = group_of(p, i);
        for (int o = 0; o < p.n_ops; ++o) {
            if (p.op_kind[o] != SAF_COUNT_STAR && !is_valid(p.args[p.op_arg[o]], i)) continue;
            int w = op_width(p, o);
            fold_row(p, o, (char*)p.acc[o] + g * w, i);
        }
        if (p.rows != nullptr) atomicAdd((unsigned long long*)p.rows + g, 1ull);
    }
}

// ------------------------------------------------------------ launch

static const int kThreads = 256;

// Launches one fold of `p` on `stream`.  *regime is set to 1 for the
// shared-memory table, 0 for global atomics.  Returns the CUDA error of
// the launch (0 = cudaSuccess); the kernel runs asynchronously.
extern "C" int scan_agg_fold_launch(const SafParams* p, void* stream, int* regime) {
    if (p->n <= 0) { *regime = -1; return 0; }
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, smem_optin = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const int n_slots = p->n_ops + (p->rows != nullptr ? 1 : 0);
    const long long table_bytes = (long long)p->n_groups * n_slots * 8;
    const long long want_blocks = (p->n + kThreads - 1) / kThreads;
    cudaStream_t s = (cudaStream_t)stream;
    if (table_bytes <= smem_optin) {
        int bytes = (int)table_bytes;
        err = cudaFuncSetAttribute(fold_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return (int)err;
        int per_sm = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fold_shared, kThreads, bytes);
        if (err != cudaSuccess) return (int)err;
        if (per_sm < 1) per_sm = 1;
        long long blocks = (long long)sms * per_sm;
        if (blocks > want_blocks) blocks = want_blocks;
        *regime = 1;
        fold_shared<<<(unsigned)blocks, kThreads, bytes, s>>>(*p);
    } else {
        long long blocks = (long long)sms * 8;
        if (blocks > want_blocks) blocks = want_blocks;
        *regime = 0;
        fold_global<<<(unsigned)blocks, kThreads, 0, s>>>(*p);
    }
    return (int)cudaGetLastError();
}

extern "C" int scan_agg_fold_params_size(void) { return (int)sizeof(SafParams); }
