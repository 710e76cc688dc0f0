// hash_agg_insert: one batch of an unbounded-cardinality GROUP BY,
// inserted into a running device hash table, in one launch.
//
// Replaces: the JAX package's fused streaming hash worker,
// citus_tpu/ops/hash_agg.py:179 build_fused_hash_worker (with _insert_keys
// :119 and _stored_eq :109), jitted under the executor's `jit_hash_fused`
// slot with the table donated.  The filter, the group keys and the
// aggregate arguments stay plain tensor code in this slice; the kernel
// takes their results.
//
// What it computes, per row i with mask[i] set:
//   - the canonical keys (_canon_keys :90): -0.0 -> 0.0, every NaN -> the
//     canonical quiet NaN, a NULL key's value -> 0;
//   - the 64-bit fingerprint h of _fingerprint :63, bit for bit (an FNV
//     seed, one splitmix-style mix per key);
//   - probe slot h % S, then mix(h, GOLD) % S (unsigned modulo; S is any
//     positive integer).  The row lands in a probed slot only if the slot
//     stores exactly its key values and flags (1 = NULL, 2 = valid), or if
//     the row claims the empty slot and publishes its keys there;
//   - count/sum/min/max of every partial op and rows[slot] are folded in
//     with atomics (atomics.cuh);
//   - spill[i] = 1 when both probes lose; the host merges those rows
//     exactly (executor/host_agg.py).
// Occupancy only grows and the probe order is fixed, so a group keeps
// the slot it first landed in across batches, and a key sits in at most
// one slot.
//
// Claiming.  The reference claims in several scatter passes (the minimum
// fingerprint wins, then the stored keys verify the claim).  Here a
// per-slot int32 state word, kept beside the table, orders one pass:
// 0 empty, 1 publishing, 2 published.  A row that finds its slot empty
// claims it with atomicCAS(0 -> 1), stores the keys and flags, fences and
// releases the state to 2; it waits on nothing between claim and
// release, so Hopper's independent thread scheduling lets waiters in the
// same warp spin safely.  Every other row reads the state with acquire
// semantics, sleeps while it is 1, and then compares keys, read past L1.
// Key comparison is on the canonical bits, which is the NaN-aware
// equality of _stored_eq.
//
// What bounds it on an H100: the slot traffic.  Each row reads its mask,
// keys and arguments once (about 27 B a row for bench.py's
// `GROUP BY l_orderkey` with a count and an int64 sum, whose plan adds a
// float64 overflow shadow), but then makes dependent random accesses to
// its slot: the state word, the key and flag, and one atomic per partial
// op plus rows[slot].  At S = 2^20 slots that table is 53 B a slot,
// 56 MB, about the size of the 50 MB L2, and the words every probe reads
// (state, key, flag: 13 MB) fit it, so random slot accesses and atomics
// served from L2, not HBM bytes, are the likely limit.  The design keeps
// every slot access to one cache line per table and issues no second
// pass over the rows.  Warp-level pre-aggregation of equal keys and
// shared-memory staging of hot slots are later work.

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

__global__ void hash_insert(const HaiParams p) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p.n) return;
    if (!p.mask[i]) {
        p.spill[i] = 0;
        return;
    }
    KeyBits keys[HAI_MAX_KEYS];
    uint64_t h = HAI_FNV;
    for (int k = 0; k < p.n_keys; ++k) {
        keys[k] = load_key(p.keys[k], i);
        uint64_t bits = keys[k].valid ? keys[k].fp : HAI_GOLD;
        h = mix64(h, bits + (keys[k].valid ? 1ull : 0ull));
    }
    const uint64_t S = (uint64_t)p.slots;
    int64_t slot = (int64_t)(h % S);
    bool placed = probe(p, keys, slot);
    if (!placed) {
        slot = (int64_t)(mix64(h, HAI_GOLD) % S);
        placed = probe(p, keys, slot);
    }
    p.spill[i] = placed ? 0 : 1;
    if (!placed) return;
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

static const int kThreads = 256;

// Launches one insert of `p` on `stream`.  Returns the CUDA error of the
// launch (0 = cudaSuccess); the kernel runs asynchronously.
extern "C" int hash_agg_insert_launch(const HaiParams* p, void* stream) {
    if (p->n <= 0) return 0;
    if (p->slots <= 0) return (int)cudaErrorInvalidValue;
    long long blocks = (p->n + kThreads - 1) / kThreads;
    hash_insert<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
}

extern "C" int hash_agg_insert_params_size(void) { return (int)sizeof(HaiParams); }
