// hash_agg_merge: the entries of a peer's hash table (a pushed hash GROUP BY
// task's result) re-inserted into the coordinator's running device hash
// table, in one launch per shipped table.
//
// Replaces: the JAX package's device merge door for remote hash partials,
// citus_tpu/ops/hash_agg.py:239 build_fused_entry_merge, jitted under the
// executor's `jit_hash_merge` slot with the table donated
// (citus_tpu/executor/executor.py:807-821).
//
// What it computes, per shipped entry e of M (one thread each):
//   - rows[e] == 0 marks an empty slot of the peer's table and is skipped
//     (spill[e] = 0).  A citus_tpu peer fills its empty slots with key = the
//     dtype's minimum and flag 0: no key of such an entry is ever read;
//   - the canonical keys: a key is valid when its flag is 2, a NULL key's
//     value becomes 0, -0.0 -> 0.0 and every NaN -> the canonical NaN
//     (hash_probe.cuh load_key, as the insert canonicalizes a row);
//   - the fingerprint and the two probes of the insert, h % S and then
//     mix(h, GOLD) % S, matching or claiming through the slot's state word
//     (hash_probe.cuh probe: one probe protocol for every hash kernel);
//   - the entry's partial states merge into the slot it lands in: a count
//     adds the entry's int64 count (not 1), a sum the entry's sum, min/max
//     keep the NaN-propagating extremum (atomics.cuh merge_value), and
//     rows[slot] adds rows[e];
//   - spill[e] = 1 when both probes lose; the executor merges those entries
//     exactly on the host (merge_hash_tables_into with entry_mask).
//
// Parameters: the insert's HaiParams describe the table side (slots, the
// slot records and their fields' offsets); the merge adds the entries: keys[k]
// the entries' key values, args[o] the entries' partial column of op o,
// their key flags and row counts.
//
// What bounds it on an H100: bytes.  Each entry's keys, flags, partial
// states and row count are read once (M entries, mostly empty: a shipped
// table is the peer's whole [S'] table), and each occupied entry then makes
// the dependent slot accesses of the insert (state, key, flag, one atomic
// per op and one on rows, all in the slot's record).  Empty entries cost
// their 8-byte row count only:
// the thread reads rows[e] first and returns.  When the two tables hold
// the same groups, most occupied entries match and no claim is contended.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_probe.cuh"

struct HamParams {
    HaiParams t;                              // the table side
    SafCol keys[HAI_MAX_KEYS];                // [M] entry key values
    SafCol args[HAI_MAX_OPS];                 // [M] entry partials of op o
    const int8_t* entry_flags[HAI_MAX_KEYS];  // [M] 0 empty, 1 NULL, 2 valid
    const long long* entry_rows;              // [M] int64, 0 = empty entry
};

__global__ void hash_merge(const HamParams m) {
    const HaiParams& p = m.t;
    int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= p.n) return;
    const long long r = m.entry_rows[e];
    if (r <= 0) {
        p.spill[e] = 0;
        return;
    }
    KeyBits keys[HAI_MAX_KEYS];
    for (int k = 0; k < p.n_keys; ++k) {
        if (m.entry_flags[k][e] == 2) {
            keys[k] = load_key(m.keys[k], e);
        } else {
            keys[k].raw = 0;
            keys[k].fp = 0;
            keys[k].valid = false;
        }
    }
    const uint64_t h = keys_fingerprint<HAI_MAX_KEYS>(p.n_keys, keys);
    char* slot = place<HAI_MAX_KEYS>(p, keys, h, 0);
    p.spill[e] = slot == nullptr ? 1 : 0;
    if (slot == nullptr) return;
    for (int o = 0; o < p.n_ops; ++o)
        merge_value(p.op_kind[o], p.op_dtype[o], slot + p.acc_off[o], m.args[o], e);
    atomicAdd((unsigned long long*)(slot + p.rows_off), (unsigned long long)r);
}

static const int kThreads = 256;

// Launches one merge of `m` on `stream`.  Returns the CUDA error of the
// launch (0 = cudaSuccess); the kernel runs asynchronously.
extern "C" int hash_agg_merge_launch(const HamParams* m, void* stream) {
    if (m->t.n <= 0) return 0;
    if (m->t.slots <= 0) return (int)cudaErrorInvalidValue;
    long long blocks = (m->t.n + kThreads - 1) / kThreads;
    hash_merge<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(*m);
    return (int)cudaGetLastError();
}

extern "C" int hash_agg_merge_params_size(void) { return (int)sizeof(HamParams); }
