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
// per-slot int32 state word, the head of the slot's record, orders one
// pass: 0 empty, 1 publishing, 2 published.  A row that finds its slot
// empty claims it with atomicCAS(0 -> 1), stores the keys and flags and
// releases the state to 2 (st.release orders the stores before it); it
// waits on nothing between claim and release, so Hopper's independent thread scheduling lets waiters in the
// same warp spin safely.  Every other row reads the state with acquire
// semantics, sleeps while it is 1, and then compares keys, read past L1.
// Key comparison is on the canonical bits, which is the NaN-aware
// equality of _stored_eq.
//
// What bounds it on an H100: the slot traffic.  Each row reads its mask
// and scan columns once (about 27 B a row for bench.py's
// `GROUP BY l_orderkey` with a count and an int64 sum, whose plan adds a
// float64 overflow shadow), but then makes dependent random accesses to
// its slot: the claim word, the key and flag, and one atomic per partial
// op plus the row count.  Kept as separate [S] arrays these are about
// seven 32-byte sectors a placed row over a 53 MB table at S = 2^20,
// about the size of the 50 MB L2.  Here a slot is one record (48 B for
// that plan; hash_probe.cuh HaiParams), so a placed row touches two or
// three sectors of one record, and the records of the groups a batch
// fills (352,789 of them in an SF1 shard batch, 17 MB) stay in L2 after
// their first touch.  The slot of a fingerprint comes from a reciprocal
// computed once per table (hash_slot.cuh), not a 64-bit division.  The
// rows of one group in a warp (clustered keys: dbgen writes an order's
// lineitem rows together) fold inside the warp first, by fold.cuh's
// segment reductions, and one lane probes and updates the record; a
// warp whose rows are all of different groups (random keys) pays one
// __match_any_sync and a vote for that, and takes the per-row path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_probe.cuh"

template <class Row>
__global__ void hash_insert(const HaiParams p, const FmParams rp) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x & 31;
    bool live = i < p.n && p.mask[i];
    if (live) live = Row::pass(rp, i);
    if (i < p.n && !live) p.spill[i] = 0;
    typename Row::Vals v;
    KeyBits keys[Row::kKeys];
    uint64_t h = 0;
    if (live) {
        Row::values(rp, i, v);
#pragma unroll
        for (int k = 0; k < Row::kKeys; ++k) keys[k] = Row::key_bits(v, k);
        h = keys_fingerprint<Row::kKeys>(p.n_keys, keys);
    }
    // the lanes of this warp whose rows share this row's fingerprint
    unsigned peers = __match_any_sync(FULL_WARP, live ? h : 0ull)
                     & __ballot_sync(FULL_WARP, live);
    if (!live) peers = 1u << lane;
    if (__all_sync(FULL_WARP, fp_popc(peers) == 1)) {
        // every row its own group (random keys: nearly every warp)
        if (!live) return;
        char* r = place<Row::kKeys>(p, keys, h, 0);
        p.spill[i] = r == nullptr ? 1 : 0;
        if (r != nullptr) fold_slot<Row>(p, v, r);
        return;
    }
    // clustered keys: a group's rows fold in the warp first.  Its lanes
    // are those with the fingerprint and the keys of its lowest lane;
    // a lane whose keys differ (a fingerprint collision) is alone.
    const int head = __ffs(peers) - 1;
    bool same = true;
#pragma unroll
    for (int k = 0; k < Row::kKeys; ++k) {
        const uint64_t raw = __shfl_sync(FULL_WARP, live ? keys[k].raw : 0ull, head);
        const int valid = __shfl_sync(FULL_WARP, live ? (int)keys[k].valid : 0, head);
        same = same && (!live || (raw == keys[k].raw && valid == (int)keys[k].valid));
    }
    const unsigned odd = __ballot_sync(FULL_WARP, !same);
    peers = same ? peers & ~odd : 1u << lane;
    WarpSeg seg = warp_seg(peers, lane,
                           seg_steps(__reduce_max_sync(FULL_WARP, (unsigned)fp_popc(peers))));
    char* r = nullptr;
    if (live && seg.rank == 0) r = place<Row::kKeys>(p, keys, h, 0);
    r = (char*)__shfl_sync(FULL_WARP, (unsigned long long)r, __ffs(peers) - 1);
    if (live) p.spill[i] = r == nullptr ? 1 : 0;
    fold_segment<Row>(p, v, live, seg, lane, r);
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
