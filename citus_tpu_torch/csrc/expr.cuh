// Shared helpers of the kernels that ops/expr_codegen.py generates from
// bound expression trees: the predicate kernels (generate_predicate) and
// the row sources of the fold and hash-insert kernels (generate_fold_row:
// a plan's WHERE, group keys and aggregate arguments, see fold.cuh).
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
    // dictionary tables: bool masks as uint8, remaps as int32, lookups
    // as int64 (the generated source casts each to its own type)
    const void* tables[FM_MAX_TABLES];
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

// numpy's % on integers (the result takes the divisor's sign)
FM_HD int32_t fm_floormod32(int32_t a, int32_t b) {
    return fm_sub32(a, fm_mul32(fm_floordiv32(a, b), b));
}

FM_HD int64_t fm_floormod64(int64_t a, int64_t b) {
    return fm_sub64(a, fm_mul64(fm_floordiv64(a, b), b));
}

// ---- civil date math on days since 1970-01-01 (proleptic Gregorian),
// the reference's civil_from_days / days_from_civil (Hinnant's
// algorithms), every division a floor division as numpy's //.  Days
// come from int32 dates or from int64 microseconds // 86,400,000,000,
// so no intermediate here can overflow int64.

#define FM_US_DAY 86400000000LL

struct FmCivil {
    int64_t y, m, d;
};

FM_HD FmCivil fm_civil_from_days(int64_t z) {
    z = z + 719468;
    const int64_t era = fm_floordiv64(z, 146097);
    const int64_t doe = z - era * 146097;
    const int64_t yoe = fm_floordiv64(doe - fm_floordiv64(doe, 1460)
                                      + fm_floordiv64(doe, 36524)
                                      - fm_floordiv64(doe, 146096), 365);
    const int64_t doy = doe - (365 * yoe + fm_floordiv64(yoe, 4)
                               - fm_floordiv64(yoe, 100));
    const int64_t mp = fm_floordiv64(5 * doy + 2, 153);
    FmCivil c;
    c.d = doy - fm_floordiv64(153 * mp + 2, 5) + 1;
    c.m = mp + (mp < 10 ? 3 : -9);
    c.y = yoe + era * 400 + (c.m <= 2 ? 1 : 0);
    return c;
}

FM_HD int64_t fm_days_from_civil(int64_t y, int64_t m, int64_t d) {
    y = y - (m <= 2 ? 1 : 0);
    const int64_t era = fm_floordiv64(y, 400);
    const int64_t yoe = y - era * 400;
    const int64_t doy = fm_floordiv64(153 * (m + (m > 2 ? -3 : 9)) + 2, 5) + d - 1;
    const int64_t doe = yoe * 365 + fm_floordiv64(yoe, 4) - fm_floordiv64(yoe, 100) + doy;
    return era * 146097 + doe - 719468;
}

// EXTRACT of a calendar field from a day number: 0 year, 1 month,
// 2 quarter, 3 day, 4 doy (the reference's run_extract)
FM_HD int64_t fm_extract_civil(int64_t days, int field) {
    const FmCivil c = fm_civil_from_days(days);
    switch (field) {
        case 0: return c.y;
        case 1: return c.m;
        case 2: return fm_floordiv64(c.m - 1, 3) + 1;
        case 3: return c.d;
        default: return days - fm_days_from_civil(c.y, 1, 1) + 1;
    }
}

// date_trunc to a calendar unit: 0 month, 1 quarter, 2 year -> the day
// number of the unit's first day (run_trunc_civil)
FM_HD int64_t fm_trunc_civil(int64_t days, int unit) {
    const FmCivil c = fm_civil_from_days(days);
    int64_t m = c.m;
    if (unit == 2) m = 1;
    else if (unit == 1) m = fm_floordiv64(m - 1, 3) * 3 + 1;
    return fm_days_from_civil(c.y, m, 1);
}

// day number + N months with the day of month clamped to the target
// month's length (PostgreSQL's timestamp_pl_interval; run_add_months)
FM_HD int64_t fm_add_months(int64_t days, int64_t months) {
    const FmCivil c = fm_civil_from_days(days);
    const int64_t mt = (c.m - 1) + months;
    const int64_t y = c.y + fm_floordiv64(mt, 12);
    const int64_t m = fm_floormod64(mt, 12) + 1;
    const int64_t nm_y = y + (m == 12 ? 1 : 0);
    const int64_t nm_m = m == 12 ? 1 : m + 1;
    const int64_t len = fm_days_from_civil(nm_y, nm_m, 1) - fm_days_from_civil(y, m, 1);
    return fm_days_from_civil(y, m, c.d < len ? c.d : len);
}
