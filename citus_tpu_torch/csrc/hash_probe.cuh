// The match-or-claim insert of one row into a device hash table, shared
// by the port's hash kernels (hash_agg_insert.cu, one table;
// hash_agg_insert_batched.cu, Q tables over one batch; hash_agg_merge.cu,
// a peer's table entries into one table): the parameter
// block, the canonical key bits and fingerprint of a row, the probe
// of one slot and the fold of a placed row.  See hash_agg_insert.cu for
// the claim protocol.  The inserts take their rows from a generated row
// source (ops/expr_codegen.py generate_fold_row; the interface is
// fold.cuh's, with Row::key_bits(v, k) giving key k's KeyBits in place
// of Row::key).  The layout of HaiParams is mirrored by ctypes in
// citus_tpu_torch/ops/hash_agg_insert.py (_Params); change both together.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "atomics.cuh"
#include "columns.cuh"
#include "expr.cuh"

#define HAI_MAX_KEYS 8
#define HAI_MAX_OPS 32

struct HaiParams {
    int64_t n;
    int64_t slots;                    // S > 0
    const uint8_t* mask;              // [n] bool
    uint8_t* spill;                   // [n] bool, written for every row
    int32_t n_keys;
    int32_t n_ops;
    int32_t key_dtype[HAI_MAX_KEYS];  // SAF_* dtype of each key table
    void* key_values[HAI_MAX_KEYS];   // [S] stored canonical key values
    int8_t* key_flags[HAI_MAX_KEYS];  // [S] 0 empty, 1 NULL, 2 valid
    int32_t op_kind[HAI_MAX_OPS];
    int32_t op_arg[HAI_MAX_OPS];
    int32_t op_dtype[HAI_MAX_OPS];    // accumulator dtype
    void* acc[HAI_MAX_OPS];           // [S] each
    long long* rows;                  // [S] int64
    int* state;                       // [S] 0 empty, 1 publishing, 2 published
};

#define HAI_FNV 0xCBF29CE484222325ull
#define HAI_C1 0xBF58476D1CE4E5B9ull
#define HAI_C2 0x94D049BB133111EBull
#define HAI_GOLD 0x9E3779B97F4A7C15ull

__device__ __forceinline__ uint64_t mix64(uint64_t h, uint64_t v) {
    h = (h ^ v) + HAI_GOLD;
    h = h ^ (h >> 30);
    h = h * HAI_C1;
    h = h ^ (h >> 27);
    h = h * HAI_C2;
    return h ^ (h >> 31);
}

// one key of one row: its canonical value as raw bits of the key dtype,
// its validity, and the 64 bits the fingerprint mixes in
struct KeyBits {
    uint64_t raw;
    uint64_t fp;
    bool valid;
};

// a key's canonical bits (-0.0 -> 0.0, every NaN -> the canonical quiet
// NaN, a NULL key's value -> 0), by the key table's type
__device__ __forceinline__ KeyBits key_bits_u8(uint8_t x, bool valid) {
    if (!valid) x = 0;
    return KeyBits{x, x, valid};
}

__device__ __forceinline__ KeyBits key_bits(bool v, bool valid) {
    return key_bits_u8((uint8_t)v, valid);
}

__device__ __forceinline__ KeyBits key_bits(int32_t v, bool valid) {
    if (!valid) v = 0;
    return KeyBits{(uint32_t)v, (uint64_t)(int64_t)v, valid};
}

__device__ __forceinline__ KeyBits key_bits(int64_t v, bool valid) {
    if (!valid) v = 0;
    return KeyBits{(uint64_t)v, (uint64_t)v, valid};
}

__device__ __forceinline__ KeyBits key_bits(float v, bool valid) {
    if (!valid) v = 0.0f;
    if (v == 0.0f) v = 0.0f;                            // -0.0 -> 0.0
    uint32_t b = v != v ? 0x7fc00000u : __float_as_uint(v);
    return KeyBits{b, (uint64_t)__double_as_longlong((double)__uint_as_float(b)), valid};
}

__device__ __forceinline__ KeyBits key_bits(double v, bool valid) {
    if (!valid) v = 0.0;
    if (v == 0.0) v = 0.0;
    uint64_t b = v != v ? 0x7ff8000000000000ull : (uint64_t)__double_as_longlong(v);
    return KeyBits{b, b, valid};
}

// entry i of a key column
__device__ __forceinline__ KeyBits load_key(const SafCol& c, int64_t i) {
    const bool valid = is_valid(c, i);
    const int64_t j = i * c.data_stride;
    switch (c.dtype) {
        case SAF_U8: return key_bits_u8(((const uint8_t*)c.data)[j], valid);
        case SAF_I32: return key_bits(((const int32_t*)c.data)[j], valid);
        case SAF_I64: return key_bits((int64_t)((const long long*)c.data)[j], valid);
        case SAF_F32: return key_bits(((const float*)c.data)[j], valid);
        default: return key_bits(((const double*)c.data)[j], valid);
    }
}

__device__ __forceinline__ int load_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
    asm volatile("st.release.gpu.global.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// the stored key of slot s, as raw bits, read past L1
__device__ __forceinline__ uint64_t stored_raw(const HaiParams& p, int k, int64_t s) {
    switch (p.key_dtype[k]) {
        case SAF_U8: return (uint8_t)__ldcg((const unsigned char*)p.key_values[k] + s);
        case SAF_I32:
        case SAF_F32: return (uint32_t)__ldcg((const unsigned int*)p.key_values[k] + s);
        default: return (uint64_t)__ldcg((const unsigned long long*)p.key_values[k] + s);
    }
}

__device__ __forceinline__ void store_raw(const HaiParams& p, int k, int64_t s, uint64_t raw) {
    switch (p.key_dtype[k]) {
        case SAF_U8: ((uint8_t*)p.key_values[k])[s] = (uint8_t)raw; break;
        case SAF_I32:
        case SAF_F32: ((uint32_t*)p.key_values[k])[s] = (uint32_t)raw; break;
        default: ((uint64_t*)p.key_values[k])[s] = raw; break;
    }
}

__device__ __forceinline__ bool slot_matches(const HaiParams& p, const KeyBits* keys, int64_t s) {
    for (int k = 0; k < p.n_keys; ++k) {
        int8_t flag = (int8_t)__ldcg((const signed char*)p.key_flags[k] + s);
        if (flag != (keys[k].valid ? 2 : 1)) return false;
        if (stored_raw(p, k, s) != keys[k].raw) return false;
    }
    return true;
}

// -> true when the row lands in slot s (matched or claimed)
__device__ __forceinline__ bool probe(const HaiParams& p, const KeyBits* keys, int64_t s) {
    int* st = p.state + s;
    int cur = load_acquire(st);
    if (cur == 0) {
        cur = atomicCAS(st, 0, 1);
        if (cur == 0) {
            for (int k = 0; k < p.n_keys; ++k) {
                store_raw(p, k, s, keys[k].raw);
                p.key_flags[k][s] = keys[k].valid ? 2 : 1;
            }
            __threadfence();
            store_release(st, 2);
            return true;
        }
    }
    while (cur == 1) {
        __nanosleep(32);
        cur = load_acquire(st);
    }
    return slot_matches(p, keys, s);
}

// the 64-bit fingerprint of n_keys canonical keys
__device__ __forceinline__ uint64_t keys_fingerprint(int n_keys, const KeyBits* keys) {
    uint64_t h = HAI_FNV;
    for (int k = 0; k < n_keys; ++k) {
        uint64_t bits = keys[k].valid ? keys[k].fp : HAI_GOLD;
        h = mix64(h, bits + (keys[k].valid ? 1ull : 0ull));
    }
    return h;
}

// fold the ops of a placed row (evaluated values `v`) into slot `slot` of
// the partial tables, and count it
template <class Row>
__device__ __forceinline__ void fold_slot(const HaiParams& p, const typename Row::Vals& v,
                                          int64_t slot) {
    for (int o = 0; o < p.n_ops; ++o) {
        int kind = p.op_kind[o];
        SafVal a = saf_val((int64_t)0);
        if (kind != SAF_COUNT_STAR && !Row::arg(v, p.op_arg[o], &a)) continue;
        int dt = p.op_dtype[o];
        int w = (kind == SAF_COUNT_STAR || kind == SAF_COUNT
                 || dt == SAF_I64 || dt == SAF_F64) ? 8 : 4;
        fold_value(kind, dt, (char*)p.acc[o] + slot * w, a);
    }
    atomicAdd((unsigned long long*)p.rows + slot, 1ull);
}
