// Column inputs of the port's fold kernels (scan_agg_fold.cu,
// hash_agg_insert.cu): one value vector with an optional validity
// vector, either of them [n] or a broadcast [1] constant.  The layout of
// SafCol is mirrored by ctypes in citus_tpu_torch/ops/scan_agg_fold.py
// (_Col); change both together.

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

__device__ __forceinline__ long long load_i64(const SafCol& c, int64_t i) {
    int64_t j = i * c.data_stride;
    switch (c.dtype) {
        case SAF_U8: return (long long)((const uint8_t*)c.data)[j];
        case SAF_I32: return (long long)((const int32_t*)c.data)[j];
        case SAF_I64: return ((const long long*)c.data)[j];
        case SAF_F32: return (long long)((const float*)c.data)[j];
        default: return (long long)((const double*)c.data)[j];
    }
}

__device__ __forceinline__ double load_f64(const SafCol& c, int64_t i) {
    int64_t j = i * c.data_stride;
    switch (c.dtype) {
        case SAF_U8: return (double)((const uint8_t*)c.data)[j];
        case SAF_I32: return (double)((const int32_t*)c.data)[j];
        case SAF_I64: return (double)((const long long*)c.data)[j];
        case SAF_F32: return (double)((const float*)c.data)[j];
        default: return ((const double*)c.data)[j];
    }
}

__device__ __forceinline__ float load_f32(const SafCol& c, int64_t i) {
    int64_t j = i * c.data_stride;
    switch (c.dtype) {
        case SAF_U8: return (float)((const uint8_t*)c.data)[j];
        case SAF_I32: return (float)((const int32_t*)c.data)[j];
        case SAF_I64: return (float)((const long long*)c.data)[j];
        case SAF_F32: return ((const float*)c.data)[j];
        default: return (float)((const double*)c.data)[j];
    }
}

__device__ __forceinline__ bool is_valid(const SafCol& c, int64_t i) {
    return c.valid == nullptr || c.valid[i * c.valid_stride] != 0;
}
