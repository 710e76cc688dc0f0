// The fold of one scan batch into running registers, shared by the port's
// fold kernels: scan_agg_fold.cu (one query) and scan_agg_fold_batched.cu
// (Q queries over one batch).  It holds the parameter block, the group id
// of a row, the fold of one row into one op's register (count/sum/min/max
// and the sketch registers), both regimes' kernels and their launcher.
// The layout of SafParams is mirrored by ctypes in
// citus_tpu_torch/ops/scan_agg_fold.py (_Params); change both together.
//
// Registers.  Op o's register for query q and group g is element
// (q * G + g) * M_o + j of acc[o]: M_o = 1 for count/sum/min/max, and for
// the sketch ops (scalar mode only, G = 1) M = 128 int32 HLL registers
// (max of rho), 2048 int64 DDSketch counts, 1024 int64 top-k counts and
// 1024 int64 top-k values (max value per bucket, INT64_MIN when empty);
// j is the row's bucket (sketch.cuh).
//
// Regimes.  While every op's registers for all Q * G groups fit the
// opt-in shared-memory limit (a byte count: 8-byte slots for
// count/sum/min/max and the rows counter, 4-byte HLL registers, 8-byte
// sketch counts and values), each block folds into a private table in
// shared memory and merges its non-identity slots into the registers
// with one global atomic each at the end; past the limit every row
// updates the registers with global atomics.  One launch per batch either
// way, whatever mix of plain and sketch ops the plan has.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "atomics.cuh"
#include "columns.cuh"
#include "sketch.cuh"

#define SAF_MAX_KEYS 8
#define SAF_MAX_ARGS 32
#define SAF_MAX_OPS 32

// sketch op kinds (after atomics.cuh's count_star/count/sum/min/max)
#define SAF_HLL 5
#define SAF_DDSK 6
#define SAF_TOPK 7
#define SAF_TOPKV 8

struct SafParams {
    int64_t n;
    int64_t n_groups;
    const uint8_t* mask;    // [n] bool ([n_q, n] batched)
    int32_t n_keys;
    int32_t n_args;
    int32_t n_ops;
    int32_t pad;
    SafCol keys[SAF_MAX_KEYS];
    int64_t key_lo[SAF_MAX_KEYS];
    int64_t key_step[SAF_MAX_KEYS];
    int64_t key_stride[SAF_MAX_KEYS];
    SafCol args[SAF_MAX_ARGS];
    int32_t op_kind[SAF_MAX_OPS];
    int32_t op_arg[SAF_MAX_OPS];
    int32_t op_dtype[SAF_MAX_OPS];   // accumulator dtype
    int32_t op_m[SAF_MAX_OPS];       // registers per group (1, or the sketch's M)
    int64_t op_soff[SAF_MAX_OPS + 1];  // shared-table byte offsets (set by the launcher)
    void* acc[SAF_MAX_OPS];          // [n_q * G * M] each
    long long* rows;                 // [n_q * G] int64, or null (scalar mode)
};

__host__ __device__ __forceinline__ bool is_sketch(int kind) { return kind >= SAF_HLL; }

// bytes of one shared-table element of an op of `kind`
__host__ __device__ __forceinline__ int shared_elem_bytes(int kind) {
    return kind == SAF_HLL ? 4 : 8;
}

// the identity of a slot, as its 8 raw bytes (the first 4 for 4-byte types)
__device__ __forceinline__ unsigned long long identity_bits(int kind, int dtype) {
    if (kind == SAF_TOPKV) return 0x8000000000000000ull;
    if (kind == SAF_MIN || kind == SAF_MAX) {
        bool mn = kind == SAF_MIN;
        switch (dtype) {
            case SAF_I32: return (unsigned long long)(unsigned int)(mn ? 0x7fffffff : 0x80000000u);
            case SAF_I64: return mn ? 0x7fffffffffffffffull : 0x8000000000000000ull;
            case SAF_F32: return mn ? 0x7f800000ull : 0xff800000ull;  // +-inf
            default: return mn ? 0x7ff0000000000000ull : 0xfff0000000000000ull;
        }
    }
    return 0ull;
}

__device__ __forceinline__ int op_width(const SafParams& p, int o) {
    int k = p.op_kind[o];
    if (k == SAF_COUNT_STAR || k == SAF_COUNT) return 8;
    int dt = p.op_dtype[o];
    return (dt == SAF_I32 || dt == SAF_F32) ? 4 : 8;
}

// fold valid row `i` of op `o` into register `gq` of the region at
// `base`: a plain op's slot is `plain_stride` bytes wide (8 in the shared
// table, the accumulator's width in the registers), a sketch op's region
// holds M registers per group in its own type
__device__ __forceinline__ void fold_op(const SafParams& p, int o, char* base, int64_t gq,
                                        int plain_stride, int64_t i) {
    const int kind = p.op_kind[o];
    if (!is_sketch(kind)) {
        fold_value(kind, p.op_dtype[o], base + gq * plain_stride, p.args[p.op_arg[o]], i);
        return;
    }
    const SafCol& a = p.args[p.op_arg[o]];
    const int64_t at = gq * (int64_t)p.op_m[o];
    if (kind == SAF_HLL) {
        long long bits = (a.dtype == SAF_F32 || a.dtype == SAF_F64)
                             ? __double_as_longlong(load_f64(a, i)) : load_i64(a, i);
        int b, rho;
        hll_bucket_rho(bits, &b, &rho);
        atomicMax((int*)base + at + b, rho);
    } else if (kind == SAF_DDSK) {
        atomicAdd((unsigned long long*)base + at + ddsk_bucket(load_f64(a, i)), 1ull);
    } else if (kind == SAF_TOPK) {
        atomicAdd((unsigned long long*)base + at + topk_bucket(load_i64(a, i)), 1ull);
    } else {
        long long v = load_i64(a, i);
        atomicMax((long long*)base + at + topk_bucket(v), v);
    }
}

// merge one reduced shared-memory element `t` of op `o` into its register
__device__ __forceinline__ void merge_elem(const SafParams& p, int o, int64_t t, const char* region) {
    const int kind = p.op_kind[o];
    if (kind == SAF_HLL) {
        int v = ((const int*)region)[t];
        if (v != 0) atomicMax((int*)p.acc[o] + t, v);
        return;
    }
    const unsigned long long s = ((const unsigned long long*)region)[t];
    if (kind == SAF_DDSK || kind == SAF_TOPK || kind == SAF_COUNT_STAR || kind == SAF_COUNT) {
        if (s != 0ull) atomicAdd((unsigned long long*)p.acc[o] + t, s);
        return;
    }
    if (kind == SAF_TOPKV) {
        if (s != 0x8000000000000000ull) atomicMax((long long*)p.acc[o] + t, (long long)s);
        return;
    }
    const int dt = p.op_dtype[o];
    unsigned long long id = identity_bits(kind, dt), v = s;
    if (op_width(p, o) == 4) { v &= 0xffffffffull; id &= 0xffffffffull; }
    if (v == id) return;
    switch (dt) {
        case SAF_I64: combine_i64(kind, (long long*)p.acc[o] + t, (long long)s); break;
        case SAF_I32: combine_i32(kind, (int*)p.acc[o] + t, *(const int*)&s); break;
        case SAF_F32: combine_f32(kind, (float*)p.acc[o] + t, *(const float*)&s); break;
        default: combine_f64(kind, (double*)p.acc[o] + t, *(const double*)&s); break;
    }
}

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
    int64_t q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
    return q;
}

__device__ __forceinline__ int64_t group_of(const SafParams& p, int64_t i) {
    // unsigned arithmetic: wraps like the reference's int64 lanes
    unsigned long long gid = 0;
    for (int k = 0; k < p.n_keys; ++k) {
        const SafCol& c = p.keys[k];
        long long code = 0;
        if (is_valid(c, i)) {
            long long d = (long long)((unsigned long long)load_i64(c, i)
                                      - (unsigned long long)p.key_lo[k]);
            code = floor_div(d, p.key_step[k]) + 1;
            if (code < 0) code = 0;
        }
        gid += (unsigned long long)code * (unsigned long long)p.key_stride[k];
    }
    long long g = (long long)gid;
    if (g < 0) g = 0;
    if (g > p.n_groups - 1) g = p.n_groups - 1;
    return g;
}

// fold row i, known to pass query q's mask, into register gq of every op
__device__ __forceinline__ void fold_query_row(const SafParams& p, int64_t i, int64_t gq,
                                               char* table, bool shared) {
    for (int o = 0; o < p.n_ops; ++o) {
        if (p.op_kind[o] != SAF_COUNT_STAR && !is_valid(p.args[p.op_arg[o]], i)) continue;
        if (shared) fold_op(p, o, table + p.op_soff[o], gq, 8, i);
        else fold_op(p, o, (char*)p.acc[o], gq, op_width(p, o), i);
    }
    if (p.rows != nullptr) {
        unsigned long long* r = shared ? (unsigned long long*)(table + p.op_soff[p.n_ops])
                                       : (unsigned long long*)p.rows;
        atomicAdd(r + gq, 1ull);
    }
}

// shared-memory regime: a block-private table of every op's registers
// for the n_q * G groups
__global__ void fold_shared_q(const SafParams p, const int n_q) {
    extern __shared__ __align__(8) char table[];
    const int64_t G = p.n_groups;
    const int64_t QG = (int64_t)n_q * G;
    for (int o = 0; o < p.n_ops; ++o) {
        const int kind = p.op_kind[o];
        const int64_t count = QG * p.op_m[o];
        char* region = table + p.op_soff[o];
        if (kind == SAF_HLL) {
            for (int64_t t = threadIdx.x; t < count; t += blockDim.x) ((int*)region)[t] = 0;
            continue;
        }
        const unsigned long long id = identity_bits(kind, p.op_dtype[o]);
        for (int64_t t = threadIdx.x; t < count; t += blockDim.x)
            ((unsigned long long*)region)[t] = id;
    }
    if (p.rows != nullptr) {
        unsigned long long* r = (unsigned long long*)(table + p.op_soff[p.n_ops]);
        for (int64_t t = threadIdx.x; t < QG; t += blockDim.x) r[t] = 0ull;
    }
    __syncthreads();
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < p.n; i += step) {
        int64_t g = -1;
        for (int q = 0; q < n_q; ++q) {
            if (!p.mask[(int64_t)q * p.n + i]) continue;
            if (g < 0) g = group_of(p, i);
            fold_query_row(p, i, (int64_t)q * G + g, table, true);
        }
    }
    __syncthreads();
    for (int o = 0; o < p.n_ops; ++o) {
        const int64_t count = QG * p.op_m[o];
        for (int64_t t = threadIdx.x; t < count; t += blockDim.x)
            merge_elem(p, o, t, table + p.op_soff[o]);
    }
    if (p.rows != nullptr) {
        const unsigned long long* r = (const unsigned long long*)(table + p.op_soff[p.n_ops]);
        for (int64_t t = threadIdx.x; t < QG; t += blockDim.x)
            if (r[t] != 0ull) atomicAdd((unsigned long long*)p.rows + t, r[t]);
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
            fold_query_row(p, i, (int64_t)q * G + g, nullptr, false);
        }
    }
}

static const int kFoldThreads = 256;

// Launches one fold of `p0` for `n_q` queries on `stream`: p0->mask points
// at the [n_q, n] masks, every p0->acc[o] at [n_q * G * M_o] registers and
// p0->rows at [n_q * G] (or null).  *regime is set to 1 for the
// shared-memory table, 0 for global atomics.  Returns the CUDA error of
// the launch (0 = cudaSuccess); the kernel runs asynchronously.
static int launch_fold(const SafParams* p0, int n_q, void* stream, int* regime) {
    if (p0->n <= 0 || n_q <= 0) { *regime = -1; return 0; }
    SafParams p = *p0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, smem_optin = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const long long QG = (long long)n_q * p.n_groups;
    long long table_bytes = 0;
    bool sketches = false;
    for (int o = 0; o < p.n_ops; ++o) {
        p.op_soff[o] = table_bytes;
        table_bytes += QG * p.op_m[o] * shared_elem_bytes(p.op_kind[o]);
        table_bytes = (table_bytes + 7) & ~7ll;
        sketches = sketches || is_sketch(p.op_kind[o]);
    }
    p.op_soff[p.n_ops] = table_bytes;
    if (p.rows != nullptr) table_bytes += QG * 8;
    const long long want_blocks = (p.n + kFoldThreads - 1) / kFoldThreads;
    cudaStream_t s = (cudaStream_t)stream;
    if (table_bytes <= smem_optin) {
        int bytes = (int)table_bytes;
        err = cudaFuncSetAttribute(fold_shared_q, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return (int)err;
        int per_sm = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fold_shared_q, kFoldThreads, bytes);
        if (err != cudaSuccess) return (int)err;
        if (per_sm < 1) per_sm = 1;
        // a sketch table's end-of-block merge costs thousands of global
        // atomics per block: fewer, longer blocks
        if (sketches && per_sm > 2) per_sm = 2;
        long long blocks = (long long)sms * per_sm;
        if (blocks > want_blocks) blocks = want_blocks;
        *regime = 1;
        fold_shared_q<<<(unsigned)blocks, kFoldThreads, bytes, s>>>(p, n_q);
    } else {
        long long blocks = (long long)sms * 8;
        if (blocks > want_blocks) blocks = want_blocks;
        *regime = 0;
        fold_global_q<<<(unsigned)blocks, kFoldThreads, 0, s>>>(p, n_q);
    }
    return (int)cudaGetLastError();
}
