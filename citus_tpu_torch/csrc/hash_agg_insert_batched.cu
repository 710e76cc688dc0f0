// hash_agg_insert_batched: the insert of hash_agg_insert.cu into Q hash
// tables, one per query of a plan family, over ONE shared scan batch, in
// one launch.
//
// Replaces: the JAX package's `batched:jit_hash_fused` slot,
// citus_tpu/executor/megabatch.py:435-443 -- jax.vmap of the fused hash
// worker (citus_tpu/ops/hash_agg.py:179 build_fused_hash_worker) over a
// leading query axis: [Q, S]-stacked donated tables, data columns
// broadcast, $N parameters mapped, a [Q, N] spill mask out.  Here each
// query's filter arrives as row q of a bool [Q, N] mask from the batched
// predicate kernel; the group keys and aggregate arguments reference no
// parameter: the generated row source (FoldRow, ops/expr_codegen.py
// generate_fold_row) evaluates them once per row and every query shares
// them.  Like hash_agg_insert.cu, this file is included by the generated
// source of a plan, after its FoldRow.
//
// What it computes, per row i: if no query's mask is set, spill[q][i] = 0
// for every q and nothing else.  Otherwise the keys and arguments, the
// canonical key bits and the 64-bit fingerprint h are computed ONCE, then for every query q whose
// mask is set the row is probed into table q exactly as hash_agg_insert
// probes its one table (slot h % S, then mix(h, GOLD) % S, match or
// claim through the per-slot claim word), its ops folded into the slot
// and spill[q][i] set when both probes lose.  Table q is the slice
// [q * S, (q + 1) * S) of every [Q, S] table (claim words, key values
// and flags, partials, rows): its records sit at query_stride from
// table q - 1's (ops/hash_agg.py lays the Q records of a slot side by
// side), so the one-table probe runs unchanged on record (q, s).  Per
// query the result is that of hash_agg_insert on its own table with its
// own mask.
//
// What bounds it on an H100: as for one table, the random slot traffic
// (claim word, keys and flags, one atomic per op and rows: one record)
// -- now Q times
// per row that passes every filter, into Q tables of 48 B a slot for the
// H family's plan (Q * 48 MB at S = 2^20), whose Q records of a slot
// are adjacent, so a row's Q probes of one slot share lines -- while the
// key and argument columns are read once whatever Q is.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_probe.cuh"

template <class Row>
__global__ void hash_insert_q(const HaiParams p, const FmParams rp, const int n_q) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p.n) return;
    bool any = false;
    for (int q = 0; q < n_q; ++q) any |= p.mask[(int64_t)q * p.n + i] != 0;
    if (!any) {
        for (int q = 0; q < n_q; ++q) p.spill[(int64_t)q * p.n + i] = 0;
        return;
    }
    typename Row::Vals v;
    Row::values(rp, i, v);
    KeyBits keys[Row::kKeys];
#pragma unroll
    for (int k = 0; k < Row::kKeys; ++k) keys[k] = Row::key_bits(v, k);
    const uint64_t h = keys_fingerprint<Row::kKeys>(p.n_keys, keys);
    const uint64_t S = (uint64_t)p.slots;
    const uint64_t s1 = hs_slot(h, S, p.slots_magic);
    const uint64_t s2 = hs_slot(mix64(h, HAI_GOLD), S, p.slots_magic);
    for (int q = 0; q < n_q; ++q) {
        const int64_t at = (int64_t)q * p.n + i;
        if (!p.mask[at]) {
            p.spill[at] = 0;
            continue;
        }
        char* r = slot_record(p, q, s1);
        if (!probe<Row::kKeys>(p, keys, r)) {
            r = slot_record(p, q, s2);
            if (!probe<Row::kKeys>(p, keys, r)) r = nullptr;
        }
        p.spill[at] = r == nullptr ? 1 : 0;
        if (r != nullptr) fold_slot<Row>(p, v, r);
    }
}

static const int kThreadsQ = 256;

// Launches one batched insert of `p` for `n_q` queries on `stream`, the
// keys and arguments from FoldRow over the columns of `r`: p->mask and
// p->spill point at [n_q, n] bool masks, p->records at the records of
// n_q tables.  Returns the CUDA error of the launch
// (0 = cudaSuccess); the kernel runs asynchronously.
extern "C" int hash_agg_insert_batched_launch(const HaiParams* p, const FmParams* r, int n_q,
                                              void* stream) {
    if (p->n <= 0 || n_q <= 0) return 0;
    if (p->slots <= 0) return (int)cudaErrorInvalidValue;
    long long blocks = (p->n + kThreadsQ - 1) / kThreadsQ;
    hash_insert_q<FoldRow><<<(unsigned)blocks, kThreadsQ, 0, (cudaStream_t)stream>>>(*p, *r, n_q);
    return (int)cudaGetLastError();
}
