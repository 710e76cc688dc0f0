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
// parameter and are shared by every query.
//
// What it computes, per row i: if no query's mask is set, spill[q][i] = 0
// for every q and nothing else.  Otherwise the canonical keys and the
// 64-bit fingerprint h are computed ONCE, then for every query q whose
// mask is set the row is probed into table q exactly as hash_agg_insert
// probes its one table (slot h % S, then mix(h, GOLD) % S, match or
// claim through the per-slot claim word), its ops folded into the slot
// and spill[q][i] set when both probes lose.  Table q is the slice
// [q * S, (q + 1) * S) of every [Q, S] table (claim words, key values
// and flags, partials, rows), so the one-table probe runs unchanged on
// the flattened slot index q * S + s.  Per query the result is that of
// hash_agg_insert on its own table with its own mask.
//
// What bounds it on an H100: as for one table, the random slot traffic
// (claim word, keys and flags, one atomic per op and rows) -- now Q times
// per row that passes every filter, into Q tables of 53 B a slot (Q * 56 MB
// at S = 2^20: past the 50 MB L2 from Q = 1 on) -- while the key and
// argument columns are read once whatever Q is.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_probe.cuh"

__global__ void hash_insert_q(const HaiParams p, const int n_q) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p.n) return;
    bool any = false;
    for (int q = 0; q < n_q; ++q) any |= p.mask[(int64_t)q * p.n + i] != 0;
    if (!any) {
        for (int q = 0; q < n_q; ++q) p.spill[(int64_t)q * p.n + i] = 0;
        return;
    }
    KeyBits keys[HAI_MAX_KEYS];
    const uint64_t h = row_fingerprint(p, i, keys);
    const uint64_t S = (uint64_t)p.slots;
    const int64_t s1 = (int64_t)(h % S);
    const int64_t s2 = (int64_t)(mix64(h, HAI_GOLD) % S);
    for (int q = 0; q < n_q; ++q) {
        const int64_t at = (int64_t)q * p.n + i;
        if (!p.mask[at]) {
            p.spill[at] = 0;
            continue;
        }
        const int64_t base = (int64_t)q * p.slots;
        int64_t slot = base + s1;
        bool placed = probe(p, keys, slot);
        if (!placed) {
            slot = base + s2;
            placed = probe(p, keys, slot);
        }
        p.spill[at] = placed ? 0 : 1;
        if (placed) fold_slot(p, i, slot);
    }
}

static const int kThreads = 256;

// Launches one batched insert of `p` for `n_q` queries on `stream`:
// p->mask and p->spill point at [n_q, n] bool masks, every table of p at
// [n_q, p->slots] storage.  Returns the CUDA error of the launch
// (0 = cudaSuccess); the kernel runs asynchronously.
extern "C" int hash_agg_insert_batched_launch(const HaiParams* p, int n_q, void* stream) {
    if (p->n <= 0 || n_q <= 0) return 0;
    if (p->slots <= 0) return (int)cudaErrorInvalidValue;
    long long blocks = (p->n + kThreads - 1) / kThreads;
    hash_insert_q<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(*p, n_q);
    return (int)cudaGetLastError();
}

extern "C" int hash_agg_insert_batched_params_size(void) { return (int)sizeof(HaiParams); }
