// Shared helpers of the kernels that ops/expr_codegen.py generates from
// bound expression trees: the predicate kernels (generate_predicate) and
// the row sources of the fold and hash-insert kernels (generate_fold_row:
// a plan's WHERE, group keys and aggregate arguments, see fold.cuh).
//
// A generated predicate source includes this header and defines
//     FmRows, fm_load_rows(p, r0, rs)         the columns of thread g's
//                                             FM_ROWS rows from r0
//     FmRow fm_row(rs, k)                     row r0 + k of them
//     bool fm_eval(p, const FmRow& r, prm, pvl)  the predicate under one
//                                             set of parameters
//     void fm_rows(p, g)                      thread g's rows of one
//                                             query: out[i] = row_mask[i]
//                                             && the predicate
//     void fm_batched_rows(p, b, g)           thread g's rows of Q
//                                             queries: out[q][i], the
//                                             columns loaded once
// and (under __CUDACC__) the kernels that run every chunk, with their C
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
#include <string.h>

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

// ---- several rows a thread (the predicate kernels) ------------------------
//
// Thread g takes R consecutive rows, r0 = g * R on (R = FM_ROWS of the
// generated source, at most 8).  Where the R rows are whole and a run's
// address allows, a column's R values are read as 16-byte vectors (fewer
// for a narrow run) and each 1-byte mask (a column's validity, the row
// mask, the output) as one R-byte vector, so neighbouring threads read
// and write neighbouring vectors; the parameters of a query are read
// once for the R rows, and its R output bytes are built in one word.  A view at an odd offset or the short last thread
// moves its rows one by one in the same code.

// A aligned bytes at src into w[0 .. A / 4) (A = 4, 8 or 16)
template <int A>
FM_HD void fm_ldv(const void* src, uint32_t* w) {
#ifdef __CUDA_ARCH__
    if (A == 16) {
        const uint4 v = *(const uint4*)src;
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if (A == 8) {
        const uint2 v = *(const uint2*)src;
        w[0] = v.x; w[1] = v.y;
    } else {
        w[0] = *(const uint32_t*)src;
    }
#else
    memcpy(w, src, A);
#endif
}

FM_HD bool fm_aligned(const void* a, int bytes) {
    return ((uintptr_t)a & (uintptr_t)(bytes - 1)) == 0;
}

// R values of T, or R bytes, as 32-bit words
template <class T, int R>
union FmLane {
    uint32_t w[(R * sizeof(T) + 3) / 4];
    T v[R];
};

// the R bytes at m (R-aligned, R = 4 or 8) as bits
template <int R>
FM_HD uint32_t fm_byte_bits(const uint8_t* m) {
    FmLane<uint8_t, R> u;
    fm_ldv<R>(m, u.w);
    uint32_t b = 0;
#pragma unroll
    for (int k = 0; k < R; ++k)
        if (u.v[k] != 0) b |= 1u << k;
    return b;
}

// bit k: row r0 + k is below n and its byte of m is not 0 (m null: every
// such row)
template <int R>
FM_HD uint32_t fm_keep(const uint8_t* m, int64_t r0, int64_t n) {
    if (R >= 4 && r0 + R <= n && m != nullptr && fm_aligned(m + r0, R))
        return fm_byte_bits<R>(m + r0);
    uint32_t b = 0;
#pragma unroll
    for (int k = 0; k < R; ++k)
        if (r0 + k < n && (m == nullptr || m[r0 + k] != 0)) b |= 1u << k;
    return b;
}

// thread g's rows of a column: out[k] = row r0 + k (0 past n), and bit k
// of *bits set where that row is below n and valid
template <class T, int R>
FM_HD void fm_ld_rows(const void* values, const uint8_t* valid, int64_t r0, int64_t n,
                      T (&out)[R], uint32_t* bits) {
    constexpr int B = R * (int)sizeof(T);
    constexpr int A = B < 16 ? B : 16;
    const T* src = (const T*)values + r0;
    if (B >= 4 && r0 + R <= n && fm_aligned(src, A)) {
        FmLane<T, R> u;
#pragma unroll
        for (int v = 0; v < B / A; ++v) fm_ldv<A>((const char*)src + v * A, &u.w[v * A / 4]);
#pragma unroll
        for (int k = 0; k < R; ++k) out[k] = u.v[k];
    } else {
#pragma unroll
        for (int k = 0; k < R; ++k) out[k] = r0 + k < n ? src[k] : (T)0;
    }
    *bits = fm_keep<R>(valid, r0, n);
}

// byte k (k < R <= 8): 1 where row r0 + k is below n and its byte of m
// is not 0 (m null: every such row), else 0
template <int R>
FM_HD uint64_t fm_keep_bytes(const uint8_t* m, int64_t r0, int64_t n) {
    if (R >= 4 && r0 + R <= n && m != nullptr && fm_aligned(m + r0, R)) {
        uint32_t w[2] = {0u, 0u};
        fm_ldv<R>(m + r0, w);
        uint64_t x = (uint64_t)w[0] | (uint64_t)w[1] << 32;
        x |= x >> 4;
        x |= x >> 2;
        x |= x >> 1;
        return x & 0x0101010101010101ull;
    }
    uint64_t x = 0;
#pragma unroll
    for (int k = 0; k < R; ++k)
        if (r0 + k < n && (m == nullptr || m[r0 + k] != 0)) x |= 1ull << (8 * k);
    return x;
}

// out[r0 + k] = byte k of w, for the rows below n (R <= 8)
template <int R>
FM_HD void fm_store_rows(uint8_t* out, int64_t r0, int64_t n, uint64_t w) {
    uint8_t* dst = out + r0;
    if (r0 + R <= n && fm_aligned(dst, R)) {
#ifdef __CUDA_ARCH__
        if (R == 8) *(uint2*)dst = make_uint2((uint32_t)w, (uint32_t)(w >> 32));
        else if (R == 4) *(uint32_t*)dst = (uint32_t)w;
        else if (R == 2) *(uint16_t*)dst = (uint16_t)w;
        else *dst = (uint8_t)w;
#else
        memcpy(dst, &w, R);
#endif
        return;
    }
#pragma unroll
    for (int k = 0; k < R; ++k)
        if (r0 + k < n) dst[k] = (uint8_t)(w >> (8 * k));
}

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
