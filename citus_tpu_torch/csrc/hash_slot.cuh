// The host-compilable half of the hash kernels (hash_probe.cuh): a probe
// fingerprint's slot, h % S, from a reciprocal computed once per table.
// Plain C++ as well as CUDA, so tests/test_torch_hash_slot.py compiles it
// with g++ and holds it against numpy's h % S on the CPU.
//
// The reciprocal is m = floor((2^64 - 1) / S) (ops/hash_agg_insert.py
// slot_magic).  Then q = floor(h * m / 2^64) is floor(h / S) or one less:
// m * S > 2^64 - 1 - S, so h / S - h * m / 2^64 = h * (2^64 - m * S) /
// (S * 2^64) <= h / 2^64 < 1.  So r = h - q * S is h % S or h % S + S,
// and one conditional subtraction finishes it.  h - q * S cannot wrap:
// it is below 2 * S <= 2^63 for every S the kernels take (S < 2^62).
// A 64-bit division by a runtime S is a software routine of dozens of
// instructions on the card; this is a high multiply and a correction.

#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#ifndef __host__
#define __host__
#define __device__
#endif
#endif

__host__ __device__ inline uint64_t hs_umulhi(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
    return __umul64hi(a, b);
#else
    return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

// h % s, with magic = floor((2^64 - 1) / s), 0 < s < 2^62
__host__ __device__ inline uint64_t hs_slot(uint64_t h, uint64_t s, uint64_t magic) {
    uint64_t r = h - hs_umulhi(h, magic) * s;
    return r >= s ? r - s : r;
}
