// Atomic folds of one operand into a register, shared by the port's
// fold kernels (scan_agg_fold.cu, hash_agg_insert.cu): count/sum/min/max
// by accumulator type.  int64 sums wrap in two's complement as XLA's do;
// float min/max propagate NaN as jnp.minimum / jnp.maximum do.

#pragma once

#include <stdint.h>

#include "columns.cuh"

// partial-op kinds
#define SAF_COUNT_STAR 0
#define SAF_COUNT 1
#define SAF_SUM 2
#define SAF_MIN 3
#define SAF_MAX 4

// float min/max that propagate NaN: once a slot holds NaN it stays NaN,
// and a NaN update always lands
__device__ __forceinline__ void atomic_min_f64(double* p, double v) {
    unsigned long long* a = (unsigned long long*)p;
    unsigned long long old = *a, assumed;
    do {
        assumed = old;
        double cur = __longlong_as_double((long long)assumed);
        if (cur != cur) return;
        if (!(v != v) && !(v < cur)) return;
        old = atomicCAS(a, assumed, (unsigned long long)__double_as_longlong(v));
    } while (old != assumed);
}

__device__ __forceinline__ void atomic_max_f64(double* p, double v) {
    unsigned long long* a = (unsigned long long*)p;
    unsigned long long old = *a, assumed;
    do {
        assumed = old;
        double cur = __longlong_as_double((long long)assumed);
        if (cur != cur) return;
        if (!(v != v) && !(v > cur)) return;
        old = atomicCAS(a, assumed, (unsigned long long)__double_as_longlong(v));
    } while (old != assumed);
}

__device__ __forceinline__ void atomic_min_f32(float* p, float v) {
    unsigned int* a = (unsigned int*)p;
    unsigned int old = *a, assumed;
    do {
        assumed = old;
        float cur = __uint_as_float(assumed);
        if (cur != cur) return;
        if (!(v != v) && !(v < cur)) return;
        old = atomicCAS(a, assumed, __float_as_uint(v));
    } while (old != assumed);
}

__device__ __forceinline__ void atomic_max_f32(float* p, float v) {
    unsigned int* a = (unsigned int*)p;
    unsigned int old = *a, assumed;
    do {
        assumed = old;
        float cur = __uint_as_float(assumed);
        if (cur != cur) return;
        if (!(v != v) && !(v > cur)) return;
        old = atomicCAS(a, assumed, __float_as_uint(v));
    } while (old != assumed);
}

// min/max/add of one operand into a register, by accumulator type
__device__ __forceinline__ void combine_i64(int kind, long long* p, long long v) {
    if (kind == SAF_MIN) atomicMin(p, v);
    else if (kind == SAF_MAX) atomicMax(p, v);
    else atomicAdd((unsigned long long*)p, (unsigned long long)v);
}

__device__ __forceinline__ void combine_i32(int kind, int* p, int v) {
    if (kind == SAF_MIN) atomicMin(p, v);
    else if (kind == SAF_MAX) atomicMax(p, v);
    else atomicAdd(p, v);
}

__device__ __forceinline__ void combine_f64(int kind, double* p, double v) {
    if (kind == SAF_MIN) atomic_min_f64(p, v);
    else if (kind == SAF_MAX) atomic_max_f64(p, v);
    else atomicAdd(p, v);
}

__device__ __forceinline__ void combine_f32(int kind, float* p, float v) {
    if (kind == SAF_MIN) atomic_min_f32(p, v);
    else if (kind == SAF_MAX) atomic_max_f32(p, v);
    else atomicAdd(p, v);
}

// fold one valid row `i` of column `a` into the register at `slot` of an
// op of `kind` with accumulator dtype `dt` (8-byte count registers)
__device__ __forceinline__ void fold_value(int kind, int dt, void* slot,
                                           const SafCol& a, int64_t i) {
    if (kind == SAF_COUNT_STAR || kind == SAF_COUNT) {
        atomicAdd((unsigned long long*)slot, 1ull);
        return;
    }
    switch (dt) {
        case SAF_I64: combine_i64(kind, (long long*)slot, load_i64(a, i)); break;
        case SAF_I32: combine_i32(kind, (int*)slot, (int)load_i64(a, i)); break;
        case SAF_F32: combine_f32(kind, (float*)slot, load_f32(a, i)); break;
        default: combine_f64(kind, (double*)slot, load_f64(a, i)); break;
    }
}
