// hash_agg_insert: one batch of an unbounded-cardinality GROUP BY,
// inserted into a running device hash table, in one launch.
//
// Replaces: the JAX package's fused streaming hash worker,
// citus_tpu/ops/hash_agg.py:179 build_fused_hash_worker (with _insert_keys
// :119 and _stored_eq :109), jitted under the executor's `jit_hash_fused`
// slot with the table donated, and the filter, group key and argument
// expressions inlined there (planner/bound.py compile_expr, B10).
//
// This file is not built on its own: the source that
// ops/expr_codegen.py generate_fold_row writes for a hash plan defines
// the plan's row source (struct FoldRow: its WHERE, its keys cast to the
// table's key types as _eval_keys :165 casts them, and its arguments, as
// one __host__ __device__ row function over the scan columns and the
// parameter block) and then includes this file.  One build serves every
// literal variant of the plan: parameters are launch arguments.
//
// What it computes, per row i with mask[i] set (the padding mask) that
// passes the WHERE (NULL is false; every other row gets spill[i] = 0):
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
// What bounds it on an H100: the slot traffic.  Each row reads its mask
// and scan columns once (about 27 B a row for bench.py's
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

#include "hash_probe.cuh"

template <class Row>
__global__ void hash_insert(const HaiParams p, const FmParams rp) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p.n) return;
    if (!p.mask[i]) {
        p.spill[i] = 0;
        return;
    }
    if (!Row::pass(rp, i)) {
        p.spill[i] = 0;
        return;
    }
    typename Row::Vals v;
    Row::values(rp, i, v);
    KeyBits keys[HAI_MAX_KEYS];
    for (int k = 0; k < p.n_keys; ++k) keys[k] = Row::key_bits(v, k);
    const uint64_t h = keys_fingerprint(p.n_keys, keys);
    const uint64_t S = (uint64_t)p.slots;
    int64_t slot = (int64_t)(h % S);
    bool placed = probe(p, keys, slot);
    if (!placed) {
        slot = (int64_t)(mix64(h, HAI_GOLD) % S);
        placed = probe(p, keys, slot);
    }
    p.spill[i] = placed ? 0 : 1;
    if (placed) fold_slot<Row>(p, v, slot);
}

static const int kThreads = 256;

// Launches one insert of `p` on `stream`, the rows from FoldRow over the
// columns and parameters of `r`.  Returns the CUDA error of the launch
// (0 = cudaSuccess); the kernel runs asynchronously.
extern "C" int hash_agg_insert_launch(const HaiParams* p, const FmParams* r, void* stream) {
    if (p->n <= 0) return 0;
    if (p->slots <= 0) return (int)cudaErrorInvalidValue;
    long long blocks = (p->n + kThreads - 1) / kThreads;
    hash_insert<FoldRow><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(*p, *r);
    return (int)cudaGetLastError();
}

extern "C" int hash_agg_insert_params_size(void) { return (int)sizeof(HaiParams); }
extern "C" int fold_row_params_size(void) { return (int)sizeof(FmParams); }
