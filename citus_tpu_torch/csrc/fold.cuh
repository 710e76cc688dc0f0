// The fold of one row into running per-group registers, shared by the
// port's fold kernels (scan_agg_fold.cu, one query; scan_agg_fold_batched.cu,
// Q queries over one batch): the parameter block, the group id of a row,
// the identity of an empty register and the merge of a block-private
// shared-memory slot into its register.  The layout of SafParams is
// mirrored by ctypes in citus_tpu_torch/ops/scan_agg_fold.py (_Params);
// change both together.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "atomics.cuh"
#include "columns.cuh"

#define SAF_MAX_KEYS 8
#define SAF_MAX_ARGS 32
#define SAF_MAX_OPS 32

struct SafParams {
    int64_t n;
    int64_t n_groups;
    const uint8_t* mask;    // [n] bool
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
    void* acc[SAF_MAX_OPS];          // [G] each
    long long* rows;                 // [G] int64, or null (scalar mode)
};

// the identity of a slot, as its 8 raw bytes (the first 4 for 4-byte types)
__device__ __forceinline__ unsigned long long identity_bits(int kind, int dtype) {
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

// fold one valid row of op `o` into the 8-byte slot at `slot`
__device__ __forceinline__ void fold_row(const SafParams& p, int o, void* slot, int64_t i) {
    fold_value(p.op_kind[o], p.op_dtype[o], slot, p.args[p.op_arg[o]], i);
}

__device__ __forceinline__ int op_width(const SafParams& p, int o) {
    int k = p.op_kind[o];
    if (k == SAF_COUNT_STAR || k == SAF_COUNT) return 8;
    int dt = p.op_dtype[o];
    return (dt == SAF_I32 || dt == SAF_F32) ? 4 : 8;
}

// merge one reduced shared-memory slot into the global register
__device__ __forceinline__ void merge_slot(const SafParams& p, int o, int64_t g,
                                           const unsigned long long* s) {
    int kind = p.op_kind[o];
    int dt = p.op_dtype[o];
    if (kind == SAF_COUNT_STAR || kind == SAF_COUNT) {
        atomicAdd((unsigned long long*)p.acc[o] + g, *s);
        return;
    }
    switch (dt) {
        case SAF_I64: combine_i64(kind, (long long*)p.acc[o] + g, *(const long long*)s); break;
        case SAF_I32: combine_i32(kind, (int*)p.acc[o] + g, *(const int*)s); break;
        case SAF_F32: combine_f32(kind, (float*)p.acc[o] + g, *(const float*)s); break;
        default: combine_f64(kind, (double*)p.acc[o] + g, *(const double*)s); break;
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
