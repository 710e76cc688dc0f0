// scan_agg_fold_batched: the fold of scan_agg_fold.cu for Q queries of one
// plan family over ONE shared scan batch, in one launch.
//
// Replaces: the JAX package's `batched:jit_fused` slot,
// citus_tpu/executor/megabatch.py:343-353 -- jax.vmap of the fused worker
// (citus_tpu/ops/scan_agg.py:277 build_fused_worker_fn) over a leading
// query axis, with the data columns broadcast and the registers and $N
// parameters mapped.  Here the per-query part arrives as masks: each
// query's filter, with its own parameters, is evaluated by the batched
// predicate kernel (filter_mask_batched) into row q of a bool [Q, N]
// mask.  The group keys and aggregate arguments reference no parameter,
// so they are computed once and shared by every query.
//
// What it computes, for every query q and row i with masks[q][i] set:
//   g = the row's group id as in scan_agg_fold (computed once per row),
//   acc[op][q * G + g] (+)= the op's argument, and rows[q * G + g] += 1 in
//   direct mode; registers are [Q, G] per op (scalar mode: G = 1).
// That is scan_agg_fold over a virtual group space of Q * G groups in
// which a row lands in up to Q of them, so both regimes carry over: a
// block-private shared-memory table of Q * G * (ops + 1) 8-byte slots
// while it fits the opt-in limit (TPC-H Q1 at Q = 32: 12 groups, 16 ops
// and rows = 52,224 B, past the 48 KB default, so the launcher raises the
// kernel's dynamic shared-memory limit), global atomics otherwise.
//
// What bounds it on an H100: memory, as for one query -- the shared key
// and argument columns are read once whatever Q is (the Q passes over a
// row re-read its argument bytes from L1), plus Q * N mask bytes and the
// registers -- against 3.35 TB/s, until Q * (ops + 1) atomics a row make
// shared-memory atomics the limit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"

// fold row i, already known to pass query q's mask, into slot index gq of
// a table whose op o region starts at base(o)
__device__ __forceinline__ void fold_query_row(const SafParams& p, int64_t i, int64_t gq,
                                               unsigned long long* table, int64_t QG) {
    for (int o = 0; o < p.n_ops; ++o) {
        if (p.op_kind[o] != SAF_COUNT_STAR && !is_valid(p.args[p.op_arg[o]], i)) continue;
        fold_row(p, o, &table[(int64_t)o * QG + gq], i);
    }
    if (p.rows != nullptr) atomicAdd(&table[(int64_t)p.n_ops * QG + gq], 1ull);
}

// shared-memory regime: a block-private [slots][Q * G] table of 8-byte slots
__global__ void fold_shared_q(const SafParams p, const int n_q) {
    extern __shared__ unsigned long long table[];
    const int64_t G = p.n_groups;
    const int64_t QG = (int64_t)n_q * G;
    const int n_slots = p.n_ops + (p.rows != nullptr ? 1 : 0);
    for (int64_t t = threadIdx.x; t < QG * n_slots; t += blockDim.x) {
        int s = (int)(t / QG);
        table[t] = s < p.n_ops ? identity_bits(p.op_kind[s], p.op_dtype[s]) : 0ull;
    }
    __syncthreads();
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < p.n; i += step) {
        int64_t g = -1;
        for (int q = 0; q < n_q; ++q) {
            if (!p.mask[(int64_t)q * p.n + i]) continue;
            if (g < 0) g = group_of(p, i);
            fold_query_row(p, i, (int64_t)q * G + g, table, QG);
        }
    }
    __syncthreads();
    for (int64_t t = threadIdx.x; t < QG * n_slots; t += blockDim.x) {
        int s = (int)(t / QG);
        int64_t gq = t - (int64_t)s * QG;
        if (s == p.n_ops) {
            if (table[t] != 0ull) atomicAdd((unsigned long long*)p.rows + gq, table[t]);
            continue;
        }
        unsigned long long id = identity_bits(p.op_kind[s], p.op_dtype[s]);
        unsigned long long v = table[t];
        if (op_width(p, s) == 4) { v &= 0xffffffffull; id &= 0xffffffffull; }
        if (v != id) merge_slot(p, s, gq, &table[t]);
    }
}

// global regime: every (query, valid row) updates the registers directly
__global__ void fold_global_q(const SafParams p, const int n_q) {
    const int64_t G = p.n_groups;
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < p.n; i += step) {
        int64_t g = -1;
        for (int q = 0; q < n_q; ++q) {
            if (!p.mask[(int64_t)q * p.n + i]) continue;
            if (g < 0) g = group_of(p, i);
            const int64_t gq = (int64_t)q * G + g;
            for (int o = 0; o < p.n_ops; ++o) {
                if (p.op_kind[o] != SAF_COUNT_STAR && !is_valid(p.args[p.op_arg[o]], i)) continue;
                fold_row(p, o, (char*)p.acc[o] + gq * op_width(p, o), i);
            }
            if (p.rows != nullptr) atomicAdd((unsigned long long*)p.rows + gq, 1ull);
        }
    }
}

static const int kThreads = 256;

// Launches one batched fold of `p` for `n_q` queries on `stream`: p->mask
// points at the [n_q, n] masks, every p->acc[o] and p->rows at [n_q, G]
// registers.  *regime is set to 1 for the shared-memory table, 0 for
// global atomics.  Returns the CUDA error of the launch (0 = cudaSuccess);
// the kernel runs asynchronously.
extern "C" int scan_agg_fold_batched_launch(const SafParams* p, int n_q, void* stream,
                                            int* regime) {
    if (p->n <= 0 || n_q <= 0) { *regime = -1; return 0; }
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, smem_optin = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const int n_slots = p->n_ops + (p->rows != nullptr ? 1 : 0);
    const long long table_bytes = (long long)n_q * p->n_groups * n_slots * 8;
    const long long want_blocks = (p->n + kThreads - 1) / kThreads;
    cudaStream_t s = (cudaStream_t)stream;
    if (table_bytes <= smem_optin) {
        int bytes = (int)table_bytes;
        err = cudaFuncSetAttribute(fold_shared_q, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return (int)err;
        int per_sm = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fold_shared_q, kThreads, bytes);
        if (err != cudaSuccess) return (int)err;
        if (per_sm < 1) per_sm = 1;
        long long blocks = (long long)sms * per_sm;
        if (blocks > want_blocks) blocks = want_blocks;
        *regime = 1;
        fold_shared_q<<<(unsigned)blocks, kThreads, bytes, s>>>(*p, n_q);
    } else {
        long long blocks = (long long)sms * 8;
        if (blocks > want_blocks) blocks = want_blocks;
        *regime = 0;
        fold_global_q<<<(unsigned)blocks, kThreads, 0, s>>>(*p, n_q);
    }
    return (int)cudaGetLastError();
}

extern "C" int scan_agg_fold_batched_params_size(void) { return (int)sizeof(SafParams); }
