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
// so they are computed once and shared by every query.
//
// What it computes, for every query q and row i with masks[q][i] set:
//   g = the row's group id as in scan_agg_fold (computed once per row),
//   acc[op][q * G + g] (+)= the op's argument, and rows[q * G + g] += 1 in
//   direct mode; registers are [Q, G] per op (scalar mode: G = 1), and
//   [Q, M] for the sketch ops of scalar mode (hll, ddsk, topk, topkv,
//   bucketed as in scan_agg_fold.cu).
// That is scan_agg_fold over a virtual group space of Q * G groups in
// which a row lands in up to Q of them, so both regimes carry over: a
// block-private shared-memory table of every op's registers for Q * G
// groups while its bytes fit the opt-in limit (TPC-H Q1 at Q = 32: 12
// groups, 16 ops and rows = 52,224 B, past the 48 KB default, so the
// launcher raises the kernel's dynamic shared-memory limit; a sketch
// query's ~33 KB of registers fit up to Q = 6), global atomics otherwise
// (a sketch family at Q = 8 needs ~264 KB).
//
// What bounds it on an H100: memory, as for one query -- the shared key
// and argument columns are read once whatever Q is (the Q passes over a
// row re-read its argument bytes from L1), plus Q * N mask bytes and the
// registers -- against 3.35 TB/s, until Q * (ops + 1) atomics a row make
// shared-memory atomics the limit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"

// Launches one batched fold of `p` for `n_q` queries on `stream`: p->mask
// points at the [n_q, n] masks, every p->acc[o] at [n_q, G * M] registers
// and p->rows at [n_q, G] (or null).  *regime is set to 1 for the
// shared-memory table, 0 for global atomics.  Returns the CUDA error of
// the launch (0 = cudaSuccess); the kernel runs asynchronously.
extern "C" int scan_agg_fold_batched_launch(const SafParams* p, int n_q, void* stream,
                                            int* regime) {
    return launch_fold(p, n_q, stream, regime);
}

extern "C" int scan_agg_fold_batched_params_size(void) { return (int)sizeof(SafParams); }
