// Shared helpers of the predicate kernels that ops/expr_codegen.py
// generates from a bound expression tree.
//
// A generated source includes this header and defines, for row i,
//     FmRow fm_load(const FmParams& p, int64_t i)       the row's columns
//     bool fm_eval(p, const FmRow& r, prm, pvl)         the predicate under
//                                                       one set of parameters
//     bool fm_predicate(const FmParams& p, int64_t i)   one query
//     void fm_batched_row(p, const FmBatch& b, int64_t i)  Q queries
// and (under __CUDACC__) the kernels that write out[i] = row_mask[i] &&
// fm_predicate(p, i) and, for Q queries at once, out[q][i], with their C
// launchers.  The helpers below are __host__ __device__, so the same
// predicate also compiles with a host C++ compiler: the tests hold it
// against the JAX package on the CPU through that route.
//
// Integer arithmetic goes through unsigned types: signed overflow is
// undefined in C++ but wraps in numpy and XLA.  Float comparisons follow
// IEEE 754 in both.  Build without fast-math and without contracting a
// multiply and an add into one FMA (nvcc --fmad=false, g++
// -ffp-contract=off), so every float operation rounds on its own.

#pragma once

#include <math.h>
#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

#define FM_HD __host__ __device__ inline

#define FM_MAX_COLS 64
#define FM_MAX_PARAMS 64
#define FM_MAX_TABLES 16

// The layout is mirrored by ctypes in citus_tpu_torch/ops/filter_mask.py
// (_FmParams); change both together.
struct FmParams {
    int64_t n;
    const uint8_t* row_mask;             // [n] bool, or null = every row
    uint8_t* out;                        // [n] bool
    const void* cols[FM_MAX_COLS];       // [n] values of the column's dtype
    const uint8_t* valids[FM_MAX_COLS];  // [n] bool, or null = all valid
    const uint8_t* tables[FM_MAX_TABLES];  // dictionary-mask tables
    int64_t table_len[FM_MAX_TABLES];
    // parameter values: integers sign-extended to int64, floats as the
    // bits of their float64 value
    int64_t params[FM_MAX_PARAMS];
    uint8_t param_valid[FM_MAX_PARAMS];
};

// The parameters of Q queries of one predicate family, for the batched
// kernel: row q of params / param_valid holds query q's values in the
// parameter block's encoding.  Mirrored by ctypes in
// citus_tpu_torch/ops/filter_mask.py (_FmBatch); change both together.
struct FmBatch {
    int64_t n_q;
    int64_t n_params;              // the row stride of params / param_valid
    const int64_t* params;         // [n_q, n_params]
    const uint8_t* param_valid;    // [n_q, n_params]
    uint8_t* out;                  // [n_q, n] bool
};

FM_HD double fm_f64(uint64_t bits) {
    union { uint64_t u; double d; } x;
    x.u = bits;
    return x.d;
}

FM_HD float fm_f32(uint32_t bits) {
    union { uint32_t u; float f; } x;
    x.u = bits;
    return x.f;
}

FM_HD bool fm_valid(const uint8_t* v, int64_t i) { return v == nullptr || v[i] != 0; }

// wrapping int32 / int64 arithmetic
FM_HD int32_t fm_add32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
FM_HD int32_t fm_sub32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }
FM_HD int32_t fm_mul32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a * (uint32_t)b); }
FM_HD int32_t fm_neg32(int32_t a) { return (int32_t)(0u - (uint32_t)a); }
FM_HD int64_t fm_add64(int64_t a, int64_t b) { return (int64_t)((uint64_t)a + (uint64_t)b); }
FM_HD int64_t fm_sub64(int64_t a, int64_t b) { return (int64_t)((uint64_t)a - (uint64_t)b); }
FM_HD int64_t fm_mul64(int64_t a, int64_t b) { return (int64_t)((uint64_t)a * (uint64_t)b); }
FM_HD int64_t fm_neg64(int64_t a) { return (int64_t)(0ull - (uint64_t)a); }

FM_HD int32_t fm_sign32(int32_t a) { return (int32_t)((a > 0) - (a < 0)); }
FM_HD int64_t fm_sign64(int64_t a) { return (int64_t)((a > 0) - (a < 0)); }
FM_HD int32_t fm_abs32(int32_t a) { return a < 0 ? fm_neg32(a) : a; }
FM_HD int64_t fm_abs64(int64_t a) { return a < 0 ? fm_neg64(a) : a; }

// floor division (numpy's //), as SQL's truncating division uses it:
// sign(a) * sign(b) * (|a| // |b or 1|).  The divisor is never 0 and
// never -1 there, so no quotient overflows
FM_HD int32_t fm_floordiv32(int32_t a, int32_t b) {
    int32_t q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
    return q;
}

FM_HD int64_t fm_floordiv64(int64_t a, int64_t b) {
    int64_t q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
    return q;
}

// float -> integer conversion as XLA does it (and the card's cvt.rzi):
// truncation, saturating at the type's bounds, NaN -> 0.  (numpy and
// PyTorch on the CPU give the type's minimum for NaN and out-of-range
// values instead.)
FM_HD int64_t fm_f2i64(double x) {
    if (x != x) return 0;
    if (x >= 9223372036854775808.0) return (int64_t)9223372036854775807LL;
    if (x < -9223372036854775808.0) return (int64_t)(-9223372036854775807LL - 1);
    return (int64_t)x;
}

FM_HD int32_t fm_f2i32(double x) {
    if (x != x) return 0;
    if (x >= 2147483648.0) return (int32_t)2147483647;
    if (x <= -2147483649.0) return (int32_t)(-2147483647 - 1);
    return (int32_t)x;
}
