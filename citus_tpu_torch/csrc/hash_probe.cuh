// The match-or-claim insert of one row into a device hash table, shared
// by the port's hash-insert kernels (hash_agg_insert.cu, one table;
// hash_agg_insert_batched.cu, Q tables over one batch): the parameter
// block, the canonical key bits and fingerprint of a row, and the probe
// of one slot.  See hash_agg_insert.cu for the claim protocol.  The layout
// of HaiParams is mirrored by ctypes in
// citus_tpu_torch/ops/hash_agg_insert.py (_Params); change both together.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "atomics.cuh"
#include "columns.cuh"

#define HAI_MAX_KEYS 8
#define HAI_MAX_ARGS 32
#define HAI_MAX_OPS 32

struct HaiParams {
    int64_t n;
    int64_t slots;                    // S > 0
    const uint8_t* mask;              // [n] bool
    uint8_t* spill;                   // [n] bool, written for every row
    int32_t n_keys;
    int32_t n_args;
    int32_t n_ops;
    int32_t pad;
    SafCol keys[HAI_MAX_KEYS];        // values of the table's key dtype
    void* key_values[HAI_MAX_KEYS];   // [S] stored canonical key values
    int8_t* key_flags[HAI_MAX_KEYS];  // [S] 0 empty, 1 NULL, 2 valid
    SafCol args[HAI_MAX_ARGS];
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

__device__ __forceinline__ KeyBits load_key(const SafCol& c, int64_t i) {
    KeyBits k;
    k.valid = is_valid(c, i);
    int64_t j = i * c.data_stride;
    switch (c.dtype) {
        case SAF_U8: {
            uint8_t v = k.valid ? ((const uint8_t*)c.data)[j] : 0;
            k.raw = v;
            k.fp = v;
            break;
        }
        case SAF_I32: {
            int32_t v = k.valid ? ((const int32_t*)c.data)[j] : 0;
            k.raw = (uint32_t)v;
            k.fp = (uint64_t)(int64_t)v;
            break;
        }
        case SAF_I64: {
            long long v = k.valid ? ((const long long*)c.data)[j] : 0;
            k.raw = (uint64_t)v;
            k.fp = (uint64_t)v;
            break;
        }
        case SAF_F32: {
            float v = k.valid ? ((const float*)c.data)[j] : 0.0f;
            if (v == 0.0f) v = 0.0f;                            // -0.0 -> 0.0
            uint32_t b = v != v ? 0x7fc00000u : __float_as_uint(v);
            k.raw = b;
            k.fp = (uint64_t)__double_as_longlong((double)__uint_as_float(b));
            break;
        }
        default: {
            double v = k.valid ? ((const double*)c.data)[j] : 0.0;
            if (v == 0.0) v = 0.0;
            uint64_t b = v != v ? 0x7ff8000000000000ull
                                : (uint64_t)__double_as_longlong(v);
            k.raw = b;
            k.fp = b;
            break;
        }
    }
    return k;
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
    switch (p.keys[k].dtype) {
        case SAF_U8: return (uint8_t)__ldcg((const unsigned char*)p.key_values[k] + s);
        case SAF_I32:
        case SAF_F32: return (uint32_t)__ldcg((const unsigned int*)p.key_values[k] + s);
        default: return (uint64_t)__ldcg((const unsigned long long*)p.key_values[k] + s);
    }
}

__device__ __forceinline__ void store_raw(const HaiParams& p, int k, int64_t s, uint64_t raw) {
    switch (p.keys[k].dtype) {
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

// the canonical keys of row i into keys[], -> the row's 64-bit fingerprint
__device__ __forceinline__ uint64_t row_fingerprint(const HaiParams& p, int64_t i, KeyBits* keys) {
    uint64_t h = HAI_FNV;
    for (int k = 0; k < p.n_keys; ++k) {
        keys[k] = load_key(p.keys[k], i);
        uint64_t bits = keys[k].valid ? keys[k].fp : HAI_GOLD;
        h = mix64(h, bits + (keys[k].valid ? 1ull : 0ull));
    }
    return h;
}

// fold the ops of row i into slot `slot` of the partial tables, and count it
__device__ __forceinline__ void fold_slot(const HaiParams& p, int64_t i, int64_t slot) {
    for (int o = 0; o < p.n_ops; ++o) {
        int kind = p.op_kind[o];
        if (kind != SAF_COUNT_STAR && !is_valid(p.args[p.op_arg[o]], i)) continue;
        int dt = p.op_dtype[o];
        int w = (kind == SAF_COUNT_STAR || kind == SAF_COUNT
                 || dt == SAF_I64 || dt == SAF_F64) ? 8 : 4;
        fold_value(kind, dt, (char*)p.acc[o] + slot * w, p.args[p.op_arg[o]], i);
    }
    atomicAdd((unsigned long long*)p.rows + slot, 1ull);
}
