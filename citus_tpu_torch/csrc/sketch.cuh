// Bucket functions of the sketch aggregates, shared by the port's fold
// kernels (scan_agg_fold.cu, scan_agg_fold_batched.cu: the scalar-mode
// registers of approx_count_distinct, approx_percentile and approx_top_k)
// and the rollup refresh kernel (rollup_delta.cu).  They are the device
// twins of citus_tpu/planner/aggregates.py hll_rho_buckets (:373),
// ddsk_bucket_indexes (:448) and topk_buckets (:530), bit for bit:
//
//   splitmix64's finalizer in uint64_t;
//   hll:  bucket = h & 127, rho = the leading-zero count of the 57-bit
//         window h >> 7, plus one (57 when the window is 0) -- the
//         reference's shift loop, here one __clzll;
//   ddsk: floor((log(max(|v|, 1e-300)) - DDSK_LOG_MIN) * (1 / DDSK_LNG))
//         clipped to [0, 1023], mirrored below 1023 for negative values,
//         1023 for zero and NaN; double precision, and the build passes
//         --fmad=false so nothing contracts.  XLA folds the reference's
//         division by the constant DDSK_LNG into a product with its
//         reciprocal, which lands some values within an ulp of a bucket
//         edge one bucket higher than a true division does (ROADMAP.md C);
//         the device path follows XLA, and like XLA on the CPU it flushes
//         a float64 subnormal to zero (the zero bucket);
//   topk: bucket = h & 1023.
// A float argument hashes its float64 bits (so -0.0 and 0.0 stay
// distinct), any other its int64 value (ops/scan_agg.py, rollup
// kernels.py value_bits).  The constants are the reference's doubles,
// written as hex literals; tests/test_torch_sketch.py reads them back.

#pragma once

#include <float.h>
#include <stdint.h>

#define HLL_M 128
#define DDSK_HALF 1024
#define DDSK_M 2048
#define TOPK_M 1024

// float(np.log(1e-12)) and 1 / (float(np.log(1e24)) / DDSK_HALF)
#define DDSK_LOG_MIN (-0x1.ba18a998fffa0p+4)
#define DDSK_INV_LNG (0x1.287a7636f435fp+4)

#define TOPK_SENTINEL ((long long)0x8000000000000000ull)

__host__ __device__ __forceinline__ uint64_t splitmix64(uint64_t h) {
    h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ull;
    h = (h ^ (h >> 27)) * 0x94D049BB133111EBull;
    return h ^ (h >> 31);
}

// value bits -> HLL register index and rho (1..57)
__device__ __forceinline__ void hll_bucket_rho(long long bits, int* bucket, int* rho) {
    uint64_t h = splitmix64((uint64_t)bits);
    *bucket = (int)(h & (HLL_M - 1));
    uint64_t w = h >> 7;
    *rho = w == 0 ? 57 : __clzll((long long)w) - 7 + 1;
}

__device__ __forceinline__ int ddsk_bucket(double v) {
    double mag = fabs(v);
    // NaN is neither > 0 nor < 0; a subnormal flushes to zero
    if (v != v || mag < DBL_MIN) return DDSK_HALF - 1;
    double x = floor((log(mag > 1e-300 ? mag : 1e-300) - DDSK_LOG_MIN) * DDSK_INV_LNG);
    int li = x < 0.0 ? 0 : (x > (double)(DDSK_HALF - 1) ? DDSK_HALF - 1 : (int)x);
    if (v > 0.0) return DDSK_HALF + li;
    if (v < 0.0) return (DDSK_HALF - 2) - (li < DDSK_HALF - 2 ? li : DDSK_HALF - 2);
    return DDSK_HALF - 1;
}

__device__ __forceinline__ int topk_bucket(long long bits) {
    return (int)(splitmix64((uint64_t)bits) & (TOPK_M - 1));
}
