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
#include "fold.cuh"
#include "hash_slot.cuh"

#define HAI_MAX_KEYS 8
#define HAI_MAX_OPS 32

// The table is one record a slot (ops/hash_agg.py record_layout): table
// q's slot s is the record at records + q * query_stride + s *
// slot_stride, and each field sits at its byte offset inside it: the
// claim word and the key flags first (the probe's head), then the key
// values, the partial registers and the row count.  A placed row's
// probe, key compare and folds touch that one record, where separate
// [S] arrays cost a 32-byte sector each.
struct HaiParams {
    int64_t n;
    int64_t slots;                    // S > 0
    uint64_t slots_magic;             // floor((2^64 - 1) / S), hash_slot.cuh
    const uint8_t* mask;              // [n] bool
    uint8_t* spill;                   // [n] bool, written for every row
    char* records;
    int64_t slot_stride;              // bytes between slots s and s + 1
    int64_t query_stride;             // bytes between tables q and q + 1
    int32_t n_keys;
    int32_t n_ops;
    int32_t key_dtype[HAI_MAX_KEYS];  // SAF_* dtype of each key value
    int32_t key_off[HAI_MAX_KEYS];    // stored canonical key value
    int32_t flag_off[HAI_MAX_KEYS];   // int8 0 empty, 1 NULL, 2 valid
    int32_t op_kind[HAI_MAX_OPS];
    int32_t op_arg[HAI_MAX_OPS];
    int32_t op_dtype[HAI_MAX_OPS];    // accumulator dtype
    int32_t acc_off[HAI_MAX_OPS];
    int32_t rows_off;                 // int64
    int32_t state_off;                // int32 0 empty, 1 publishing, 2 published
};

// the record of slot s of table q
__device__ __forceinline__ char* slot_record(const HaiParams& p, int64_t q, uint64_t s) {
    return p.records + q * p.query_stride + (int64_t)s * p.slot_stride;
}

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

// the stored key k of record r, as raw bits, read past L1
__device__ __forceinline__ uint64_t stored_raw(const HaiParams& p, int k, const char* r) {
    const char* at = r + p.key_off[k];
    switch (p.key_dtype[k]) {
        case SAF_U8: return (uint8_t)__ldcg((const unsigned char*)at);
        case SAF_I32:
        case SAF_F32: return (uint32_t)__ldcg((const unsigned int*)at);
        default: return (uint64_t)__ldcg((const unsigned long long*)at);
    }
}

__device__ __forceinline__ void store_raw(const HaiParams& p, int k, char* r, uint64_t raw) {
    char* at = r + p.key_off[k];
    switch (p.key_dtype[k]) {
        case SAF_U8: *(uint8_t*)at = (uint8_t)raw; break;
        case SAF_I32:
        case SAF_F32: *(uint32_t*)at = (uint32_t)raw; break;
        default: *(uint64_t*)at = raw; break;
    }
}

// NK: the keys a row has (Row::kKeys, so an insert's keys stay in
// registers), or HAI_MAX_KEYS with p.n_keys of them in use
template <int NK>
__device__ __forceinline__ bool slot_matches(const HaiParams& p, const KeyBits* keys,
                                             const char* r) {
#pragma unroll
    for (int k = 0; k < NK && k < p.n_keys; ++k) {
        int8_t flag = (int8_t)__ldcg((const signed char*)(r + p.flag_off[k]));
        if (flag != (keys[k].valid ? 2 : 1)) return false;
        if (stored_raw(p, k, r) != keys[k].raw) return false;
    }
    return true;
}

// -> true when the row lands in record r (matched or claimed).  The
// release store orders the key and flag stores before it (st.release is
// a release fence and the store): no other fence is needed.
template <int NK>
__device__ __forceinline__ bool probe(const HaiParams& p, const KeyBits* keys, char* r) {
    int* st = (int*)(r + p.state_off);
    int cur = load_acquire(st);
    if (cur == 0) {
        cur = atomicCAS(st, 0, 1);
        if (cur == 0) {
#pragma unroll
            for (int k = 0; k < NK && k < p.n_keys; ++k) {
                store_raw(p, k, r, keys[k].raw);
                *(int8_t*)(r + p.flag_off[k]) = keys[k].valid ? 2 : 1;
            }
            store_release(st, 2);
            return true;
        }
    }
    while (cur == 1) {
        __nanosleep(32);
        cur = load_acquire(st);
    }
    return slot_matches<NK>(p, keys, r);
}

// -> the record a row of fingerprint h lands in, in table q: slot h % S,
// then mix64(h, GOLD) % S; null when both probes lose
template <int NK>
__device__ __forceinline__ char* place(const HaiParams& p, const KeyBits* keys, uint64_t h,
                                       int64_t q) {
    const uint64_t S = (uint64_t)p.slots;
    char* r = slot_record(p, q, hs_slot(h, S, p.slots_magic));
    if (probe<NK>(p, keys, r)) return r;
    r = slot_record(p, q, hs_slot(mix64(h, HAI_GOLD), S, p.slots_magic));
    return probe<NK>(p, keys, r) ? r : nullptr;
}

// the 64-bit fingerprint of n_keys canonical keys
template <int NK>
__device__ __forceinline__ uint64_t keys_fingerprint(int n_keys, const KeyBits* keys) {
    uint64_t h = HAI_FNV;
#pragma unroll
    for (int k = 0; k < NK && k < n_keys; ++k) {
        uint64_t bits = keys[k].valid ? keys[k].fp : HAI_GOLD;
        h = mix64(h, bits + (keys[k].valid ? 1ull : 0ull));
    }
    return h;
}

// fold the ops of a placed row (evaluated values `v`) into its record
// r, and count it
template <class Row>
__device__ __forceinline__ void fold_slot(const HaiParams& p, const typename Row::Vals& v,
                                          char* r) {
    for (int o = 0; o < p.n_ops; ++o) {
        int kind = p.op_kind[o];
        SafVal a = saf_val((int64_t)0);
        if (kind != SAF_COUNT_STAR && !Row::arg(v, p.op_arg[o], &a)) continue;
        fold_value(kind, p.op_dtype[o], r + p.acc_off[o], a);
    }
    atomicAdd((unsigned long long*)(r + p.rows_off), 1ull);
}

// ------------------------------------------- rows of one group in a warp

// fold a warp segment's reduced sum, min or max into `slot` (apply: its
// rank-0 lane, when some of its lanes have a value); every lane calls it
template <int K, int DT>
__device__ __forceinline__ void seg_fold(const WarpSeg& s, bool ok, const SafVal& a,
                                         bool apply, char* slot) {
    const unsigned long long y =
        seg_reduce<K, DT>(s, ok ? acc_bits(DT, a) : reduce_identity<K, DT>());
    if (apply) apply_reduced<K, DT>(slot, y);
}

template <int K>
__device__ __forceinline__ void seg_fold_dt(int dt, const WarpSeg& s, bool ok, const SafVal& a,
                                            bool apply, char* slot) {
    switch (dt) {
        case SAF_I64: seg_fold<K, SAF_I64>(s, ok, a, apply, slot); break;
        case SAF_I32: seg_fold<K, SAF_I32>(s, ok, a, apply, slot); break;
        case SAF_F32: seg_fold<K, SAF_F32>(s, ok, a, apply, slot); break;
        default: seg_fold<K, SAF_F64>(s, ok, a, apply, slot); break;
    }
}

// fold the rows of segment s (the lanes of a warp whose rows have one
// group's keys; `live`: this lane has a row) into record r, held by the
// segment's rank-0 lane (null: the rows spill): counts add the
// segment's lanes with a value, sums, min and max reduce over it by
// shuffles (fold.cuh seg_reduce, the combine rules of atomics.cuh), and
// the rank-0 lane makes one update a register.  Every lane of the warp
// calls it.
template <class Row>
__device__ __forceinline__ void fold_segment(const HaiParams& p, const typename Row::Vals& v,
                                             bool live, WarpSeg& s, int lane, char* r) {
    const bool lead = live && s.rank == 0 && r != nullptr;
    seg_sources(s, lane);
    for (int o = 0; o < p.n_ops; ++o) {
        const int kind = p.op_kind[o];
        SafVal a = saf_val((int64_t)0);
        const bool ok = live && (kind == SAF_COUNT_STAR || Row::arg(v, p.op_arg[o], &a));
        const unsigned have = s.peers & __ballot_sync(FULL_WARP, ok);
        char* slot = lead ? r + p.acc_off[o] : nullptr;
        if (kind == SAF_COUNT_STAR || kind == SAF_COUNT) {
            if (lead && have != 0u)
                atomicAdd((unsigned long long*)slot, (unsigned long long)fp_popc(have));
        } else if (kind == SAF_SUM) {
            seg_fold_dt<SAF_SUM>(p.op_dtype[o], s, ok, a, lead && have != 0u, slot);
        } else if (kind == SAF_MIN) {
            seg_fold_dt<SAF_MIN>(p.op_dtype[o], s, ok, a, lead && have != 0u, slot);
        } else {
            seg_fold_dt<SAF_MAX>(p.op_dtype[o], s, ok, a, lead && have != 0u, slot);
        }
    }
    if (lead) atomicAdd((unsigned long long*)(r + p.rows_off), (unsigned long long)s.size);
}
