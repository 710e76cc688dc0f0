// Operands of the port's fold kernels.  SafVal is one value of a row as
// the generated row source (ops/expr_codegen.py generate_fold_row) gives
// it to the fold and insert kernels (fold.cuh, hash_probe.cuh); SafCol is
// a column of entries that hash_agg_merge.cu reads: one value vector with
// an optional validity vector, either of them [n] or a broadcast [1]
// constant.  The layout of SafCol is mirrored by ctypes in
// citus_tpu_torch/ops/hash_agg_merge.py (_Col); change both together.

#pragma once

#include <stdint.h>

// value dtypes
#define SAF_U8 0   // bool or uint8
#define SAF_I32 1
#define SAF_I64 2
#define SAF_F32 3
#define SAF_F64 4

struct SafCol {
    const void* data;       // [n] or [1] values
    const uint8_t* valid;   // [n] or [1] bool, or null = all valid
    int64_t data_stride;    // 1, or 0 for a broadcast constant
    int64_t valid_stride;
    int32_t dtype;
    int32_t pad;
};

// One value of a row: an integer or bool in `i`, a float (a float32
// widened exactly) in `d`.  val_i64 / val_f64 / val_f32 read it as an
// accumulator type with C's casts, as a load of its column would.
struct SafVal {
    long long i;
    double d;
    bool is_float;
};

__host__ __device__ __forceinline__ SafVal saf_val(bool v) { return SafVal{(long long)v, 0.0, false}; }
__host__ __device__ __forceinline__ SafVal saf_val(int32_t v) { return SafVal{(long long)v, 0.0, false}; }
__host__ __device__ __forceinline__ SafVal saf_val(int64_t v) { return SafVal{(long long)v, 0.0, false}; }
__host__ __device__ __forceinline__ SafVal saf_val(float v) { return SafVal{0, (double)v, true}; }
__host__ __device__ __forceinline__ SafVal saf_val(double v) { return SafVal{0, v, true}; }

__device__ __forceinline__ long long val_i64(const SafVal& v) {
    return v.is_float ? (long long)v.d : v.i;
}

__device__ __forceinline__ double val_f64(const SafVal& v) {
    return v.is_float ? v.d : (double)v.i;
}

__device__ __forceinline__ float val_f32(const SafVal& v) {
    return v.is_float ? (float)v.d : (float)v.i;
}

// entry i of column c
__device__ __forceinline__ SafVal col_val(const SafCol& c, int64_t i) {
    int64_t j = i * c.data_stride;
    switch (c.dtype) {
        case SAF_U8: return saf_val((int32_t)((const uint8_t*)c.data)[j]);
        case SAF_I32: return saf_val(((const int32_t*)c.data)[j]);
        case SAF_I64: return saf_val((int64_t)((const long long*)c.data)[j]);
        case SAF_F32: return saf_val(((const float*)c.data)[j]);
        default: return saf_val(((const double*)c.data)[j]);
    }
}

__device__ __forceinline__ bool is_valid(const SafCol& c, int64_t i) {
    return c.valid == nullptr || c.valid[i * c.valid_stride] != 0;
}
