// scan_agg_fold_batched: the fold of scan_agg_fold.cu for Q queries of one
// plan family over ONE shared scan batch, in one launch.
//
// Replaces: the JAX package's `batched:jit_fused` slot,
// citus_tpu/executor/megabatch.py:343-353 -- jax.vmap of the fused worker
// (citus_tpu/ops/scan_agg.py:277 build_fused_worker_fn) over a leading
// query axis, with the data columns broadcast and the registers and $N
// parameters mapped.  Here the per-query part arrives as masks: each
// query's filter, with its own parameters, is evaluated by the batched
// predicate kernel (filter_mask_batched) into row q of a bool [Q, N]
// mask.  The group keys and aggregate arguments reference no parameter,
// so the generated row source (FoldRow, ops/expr_codegen.py
// generate_fold_row) evaluates them once per row, at the first query
// whose mask the row passes, and every query shares them.  Like
// scan_agg_fold.cu, this file is included by the generated source of a
// plan, after its FoldRow.
//
// What it computes, for every query q and row i with masks[q][i] set:
//   g = the row's group id as in scan_agg_fold (computed once per row),
//   acc[op][q * G + g] (+)= the op's argument, and rows[q * G + g] += 1 in
//   direct mode; registers are [Q, G] per op (scalar mode: G = 1), and
//   [Q, M] for the sketch ops of scalar mode (hll, ddsk, topk, topkv,
//   bucketed as in scan_agg_fold.cu).
// That is scan_agg_fold over a virtual group space of Q * G groups in
// which a row lands in up to Q of them, so the regimes carry over: a
// block-private shared-memory table of every op's registers for Q * G
// groups while its bytes fit the opt-in limit (TPC-H Q1 at Q = 32: 12
// groups, 16 ops and rows = 52,224 B, past the 48 KB default, so the
// launcher raises the kernel's dynamic shared-memory limit; a sketch
// query's ~33 KB of registers fit up to Q = 6); past it, tables of the
// queries in chunks that fit, one chunk per blockIdx.y of the same
// launch (a sketch family at Q = 8, ~264 KB: two chunks of 4); global
// atomics only when one query's registers do not fit.  A row's segment
// of the warp (the lanes of its group, fold.cuh) is found once and
// serves every query: per query, only the lanes that pass it combine.
//
// What bounds it on an H100: memory, as for one query -- the shared key
// and argument columns are read once whatever Q is (the Q passes over a
// row re-read its argument bytes from L1; a chunk of queries re-reads
// the rows some query of it passes), plus Q * N mask bytes and the
// registers -- against 3.35 TB/s, until the per-query ballots and
// reductions of each warp make the instruction issue the limit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"

// Launches one batched fold of `p` for `n_q` queries on `stream`, the
// keys and arguments from FoldRow over the columns of `r`: p->mask points
// at the [n_q, n] masks, every p->acc[o] at [n_q, G * M] registers and
// p->rows at [n_q, G] (or null).  *regime is set to the number of query
// chunks of the shared-memory table (1: one table for all), 0 for global
// atomics.  Returns the CUDA error of
// the launch (0 = cudaSuccess); the kernel runs asynchronously.
extern "C" int scan_agg_fold_batched_launch(const SafParams* p, const FmParams* r, int n_q,
                                            void* stream, int* regime) {
    return launch_fold<FoldRow, false>(p, r, n_q, stream, regime);
}
