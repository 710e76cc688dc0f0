// The fold of one scan batch into running registers, shared by the port's
// fold kernels: scan_agg_fold.cu (one query) and scan_agg_fold_batched.cu
// (Q queries over one batch).  It holds the parameter block, the group id
// of a row, the fold of one row into one op's register (count/sum/min/max
// and the sketch registers), the warp-aggregated updates, the regimes'
// kernels and their launcher.
// The layout of SafParams is mirrored by ctypes in
// citus_tpu_torch/ops/scan_agg_fold.py (_Params); change both together.
//
// Rows.  The kernels and the launcher are templates over a row source
// `Row`, which ops/expr_codegen.py generate_fold_row writes for each plan
// (the struct FoldRow of a generated source, which then includes
// scan_agg_fold.cu and scan_agg_fold_batched.cu).  Over the plan's scan
// columns and parameters (an FmParams block, expr.cuh) it gives:
//     Row::kKeys                      the plan's group keys (0: scalar
//                                     mode, every row in group 0)
//     Row::Vals                       one row's evaluated keys and arguments
//     Row::pass(rp, i)                row i's WHERE (NULL is false), from
//                                     the columns the WHERE reads
//     Row::values(rp, i, v)           row i's keys and arguments, from the
//                                     columns they read
//     Row::key(v, k, &x) -> valid     key k as int64
//     Row::arg(v, a, &x) -> valid     argument a as a SafVal
// With kFilter the kernel folds rows with mask[i] && Row::pass (one
// query); without it, masks[q][i] alone selects the rows of query q (the
// batched predicate kernel evaluated each query's WHERE), and a row's
// keys and arguments are evaluated once for all Q queries.
//
// Registers.  Op o's register for query q and group g is element
// (q * G + g) * M_o + j of acc[o]: M_o = 1 for count/sum/min/max, and for
// the sketch ops (scalar mode only, G = 1) M = 128 int32 HLL registers
// (max of rho), 2048 int64 DDSketch counts, 1024 int64 top-k counts and
// 1024 int64 top-k values (max value per bucket, INT64_MIN when empty);
// j is the row's bucket (sketch.cuh).
//
// Regimes (the plan: fold_plan.cuh).  While every op's registers for all
// Q * G groups fit the opt-in shared-memory limit (a byte count: 8-byte
// slots for count/sum/min/max and the rows counter, 4-byte HLL
// registers, 8-byte sketch counts and values), each block folds into a
// private table in shared memory and merges its non-identity slots into
// the registers with one global atomic each at the end.  When only some
// queries' registers fit (a sketch family at Q = 8: ~264 KB), the same
// launch folds the queries in chunks that fit, one chunk per
// blockIdx.y, each chunk's blocks walking every row.  Only when a single
// query's registers do not fit (the G = 65,536 direct fold) do the rows
// update the registers with global atomics.  One launch per batch in
// every regime, whatever mix of plain and sketch ops the plan has.
//
// Updates are warp-aggregated.  A warp takes 32 consecutive rows.  When
// more than kFoldDirectLanes of them pass, the lanes whose rows fold
// into the same register (the same group) find each other with
// __match_any_sync, and for each query the lanes that pass it combine
// inside the warp: counts add the popcount of the passing peers, sums,
// min and max reduce by shuffles over the peers (fold_plan.cuh; once for
// all queries that the same lanes pass) with the combine rules of
// atomics.cuh, and one lane per register makes the update.  In scalar
// mode a whole warp's passing rows make one update.  A batched fold with
// room for one more query's registers keeps common registers for the
// rows that pass every query, which fold once and are added to each
// query's at the block's end.  Sparse warps, and the sketch ops (whose
// rows spread over 128-2048 buckets), update per lane, as measured on the
// card (PERF.md §6).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "atomics.cuh"
#include "columns.cuh"
#include "expr.cuh"
#include "fold_plan.cuh"
#include "sketch.cuh"

#define SAF_MAX_KEYS 8
#define SAF_MAX_ARGS 32
#define SAF_MAX_OPS 32

// sketch op kinds (after atomics.cuh's count_star/count/sum/min/max)
#define SAF_HLL 5
#define SAF_DDSK 6
#define SAF_TOPK 7
#define SAF_TOPKV 8

struct SafParams {
    int64_t n;
    int64_t n_groups;
    const uint8_t* mask;    // [n] bool ([n_q, n] batched)
    int32_t n_keys;
    int32_t n_args;
    int32_t n_ops;
    int32_t pad;
    int64_t key_lo[SAF_MAX_KEYS];
    int64_t key_step[SAF_MAX_KEYS];
    int64_t key_stride[SAF_MAX_KEYS];
    int32_t op_kind[SAF_MAX_OPS];
    int32_t op_arg[SAF_MAX_OPS];
    int32_t op_dtype[SAF_MAX_OPS];   // accumulator dtype
    int32_t op_m[SAF_MAX_OPS];       // registers per group (1, or the sketch's M)
    int64_t op_soff[SAF_MAX_OPS + 1];  // shared-table byte offsets (set by the launcher)
    void* acc[SAF_MAX_OPS];          // [n_q * G * M] each
    long long* rows;                 // [n_q * G] int64, or null (scalar mode)
};

__host__ __device__ __forceinline__ bool is_sketch(int kind) { return kind >= SAF_HLL; }

// bytes of one shared-table element of an op of `kind`
__host__ __device__ __forceinline__ int shared_elem_bytes(int kind) {
    return kind == SAF_HLL ? 4 : 8;
}

// the identity of a slot, as its 8 raw bytes (the first 4 for 4-byte types)
__device__ __forceinline__ unsigned long long identity_bits(int kind, int dtype) {
    if (kind == SAF_TOPKV) return 0x8000000000000000ull;
    if (kind == SAF_MIN || kind == SAF_MAX) {
        bool mn = kind == SAF_MIN;
        switch (dtype) {
            case SAF_I32: return (unsigned long long)(unsigned int)(mn ? 0x7fffffff : 0x80000000u);
            case SAF_I64: return mn ? 0x7fffffffffffffffull : 0x8000000000000000ull;
            case SAF_F32: return mn ? 0x7f800000ull : 0xff800000ull;  // +-inf
            default: return mn ? 0x7ff0000000000000ull : 0xfff0000000000000ull;
        }
    }
    return 0ull;
}

__device__ __forceinline__ int op_width(const SafParams& p, int o) {
    int k = p.op_kind[o];
    if (k == SAF_COUNT_STAR || k == SAF_COUNT) return 8;
    int dt = p.op_dtype[o];
    return (dt == SAF_I32 || dt == SAF_F32) ? 4 : 8;
}

// merge `s`, the raw 8 bytes of a block's reduced slot of op `o` (the
// low 4 for a 4-byte type and HLL), into register `r` of the op
__device__ __forceinline__ void merge_bits(const SafParams& p, int o, unsigned long long s,
                                           int64_t r) {
    const int kind = p.op_kind[o];
    if (kind == SAF_HLL) {
        const int v = (int)(unsigned)s;
        if (v != 0) atomicMax((int*)p.acc[o] + r, v);
        return;
    }
    if (kind == SAF_DDSK || kind == SAF_TOPK || kind == SAF_COUNT_STAR || kind == SAF_COUNT) {
        if (s != 0ull) atomicAdd((unsigned long long*)p.acc[o] + r, s);
        return;
    }
    if (kind == SAF_TOPKV) {
        if (s != 0x8000000000000000ull) atomicMax((long long*)p.acc[o] + r, (long long)s);
        return;
    }
    const int dt = p.op_dtype[o];
    unsigned long long id = identity_bits(kind, dt), v = s;
    if (op_width(p, o) == 4) { v &= 0xffffffffull; id &= 0xffffffffull; }
    if (v == id) return;
    switch (dt) {
        case SAF_I64: combine_i64(kind, (long long*)p.acc[o] + r, (long long)s); break;
        case SAF_I32: combine_i32(kind, (int*)p.acc[o] + r, (int)(unsigned)s); break;
        case SAF_F32: combine_f32(kind, (float*)p.acc[o] + r, __uint_as_float((unsigned)s)); break;
        default: combine_f64(kind, (double*)p.acc[o] + r, __longlong_as_double((long long)s)); break;
    }
}

// fold the valid value `a` of op `o` of one row into register `gq` of
// the region at `base`, by the row's own atomic: a plain op's slot is
// `plain_stride` bytes wide (8 in the shared table, the accumulator's
// width in the registers), a sketch op's region holds M registers per
// group in its own type
__device__ __forceinline__ void fold_op(const SafParams& p, int o, char* base, int64_t gq,
                                        int plain_stride, const SafVal& a) {
    const int kind = p.op_kind[o];
    if (!is_sketch(kind)) {
        fold_value(kind, p.op_dtype[o], base + gq * plain_stride, a);
        return;
    }
    const int64_t at = gq * (int64_t)p.op_m[o];
    if (kind == SAF_HLL) {
        long long bits = a.is_float ? __double_as_longlong(val_f64(a)) : val_i64(a);
        int b, rho;
        hll_bucket_rho(bits, &b, &rho);
        atomicMax((int*)base + at + b, rho);
    } else if (kind == SAF_DDSK) {
        atomicAdd((unsigned long long*)base + at + ddsk_bucket(val_f64(a)), 1ull);
    } else if (kind == SAF_TOPK) {
        atomicAdd((unsigned long long*)base + at + topk_bucket(val_i64(a)), 1ull);
    } else {
        long long v = val_i64(a);
        atomicMax((long long*)base + at + topk_bucket(v), v);
    }
}

// ---------------------------------------------------- warp-aggregated updates

#define FULL_WARP 0xffffffffu

// The design's constants, each measured on the card (PERF.md §6):
//   kFoldThreads      threads a block
//   kFoldMinBlocks    blocks an SM must fit (__launch_bounds__: caps the
//                     registers a thread at 64)
//   kFoldDirectLanes  a warp whose rows pass in at most this many lanes,
//                     and a query's sum, min or max that at most this
//                     many lanes fold into, update by each lane's own
//                     atomic: too few rows for a reduction to pay
static constexpr int kFoldThreads = 512;
static constexpr int kFoldMinBlocks = 2;
static constexpr int kFoldDirectLanes = 12;

// a row's argument as the raw bits of op o's accumulator type (the low 4
// bytes for a 4-byte type), cast as combine_value casts it
__device__ __forceinline__ unsigned long long acc_bits(int dt, const SafVal& a) {
    switch (dt) {
        case SAF_I64: return (unsigned long long)val_i64(a);
        case SAF_I32: return (unsigned long long)(unsigned)(int)val_i64(a);
        case SAF_F32: return (unsigned long long)__float_as_uint(val_f32(a));
        default: return (unsigned long long)__double_as_longlong(val_f64(a));
    }
}

// the identity of a sum, min or max of accumulator type DT, as its bits
// (-0.0 for a float sum: x + -0.0 is x for every x)
template <int K, int DT>
__device__ __forceinline__ unsigned long long reduce_identity() {
    if (K == SAF_SUM) {
        if (DT == SAF_F64) return 0x8000000000000000ull;
        if (DT == SAF_F32) return 0x80000000ull;
        return 0ull;
    }
    return identity_bits(K, DT) & (DT == SAF_I32 || DT == SAF_F32 ? 0xffffffffull : ~0ull);
}

// a op b, as the atomics of atomics.cuh fold them: integer sums wrap,
// float min/max keep NaN (once either side is NaN the result is), and
// otherwise take the other side only when it is strictly smaller
// (larger), so -0.0 and +0.0 keep the first as atomic_min_f64 does
template <int K, int DT>
__device__ __forceinline__ unsigned long long combine_bits(unsigned long long a,
                                                           unsigned long long b) {
    if (DT == SAF_I64) {
        if (K == SAF_SUM) return a + b;
        const long long x = (long long)a, y = (long long)b;
        return (K == SAF_MIN ? y < x : y > x) ? b : a;
    }
    if (DT == SAF_I32) {
        if (K == SAF_SUM) return (unsigned long long)((unsigned)a + (unsigned)b);
        const int x = (int)(unsigned)a, y = (int)(unsigned)b;
        return (K == SAF_MIN ? y < x : y > x) ? b : a;
    }
    if (DT == SAF_F32) {
        const float x = __uint_as_float((unsigned)a), y = __uint_as_float((unsigned)b);
        if (K == SAF_SUM) return (unsigned long long)__float_as_uint(x + y);
        if (x != x) return a;
        if (y != y) return b;
        return (K == SAF_MIN ? y < x : y > x) ? b : a;
    }
    const double x = __longlong_as_double((long long)a), y = __longlong_as_double((long long)b);
    if (K == SAF_SUM) return (unsigned long long)__double_as_longlong(x + y);
    if (x != x) return a;
    if (y != y) return b;
    return (K == SAF_MIN ? y < x : y > x) ? b : a;
}

// the reduction of x over this lane's segment, held by its rank-0 lane;
// every lane of the warp must call it (full-mask shuffles)
template <int K, int DT>
__device__ __forceinline__ unsigned long long seg_reduce(const WarpSeg& s, unsigned long long x) {
#pragma unroll
    for (int k = 0; k < SEG_MAX_STEPS; ++k) {
        if (k >= s.steps) break;
        unsigned long long y;
        if (DT == SAF_I32 || DT == SAF_F32)
            y = (unsigned long long)__shfl_sync(FULL_WARP, (unsigned)x, s.src[k]);
        else
            y = __shfl_sync(FULL_WARP, x, s.src[k]);
        if (seg_takes(s, k)) x = combine_bits<K, DT>(x, y);
    }
    return x;
}

// fold a segment's reduced value into the register at `slot`
template <int K, int DT>
__device__ __forceinline__ void apply_reduced(char* slot, unsigned long long v) {
    if (DT == SAF_I64) combine_i64(K, (long long*)slot, (long long)v);
    else if (DT == SAF_I32) combine_i32(K, (int*)slot, (int)(unsigned)v);
    else if (DT == SAF_F32) combine_f32(K, (float*)slot, __uint_as_float((unsigned)v));
    else combine_f64(K, (double*)slot, __longlong_as_double((long long)v));
}

// One row-iteration of a warp: each lane's group and its segment by
// group (the lanes of the group whose rows pass some query of the chunk)
struct WarpRows {
    int lane;
    int64_t g;
    WarpSeg seg;
    bool sources;   // seg.src computed (the first reduction does it)
};

// count, count(*) or the rows counter of the queries of `wq` (bit j: the
// word's query j, which some lane passes; lane bits `qbits`): the
// segment's rank-0 lane adds how many of its lanes pass query j and have
// `ok` (a valid argument) to register (ql + j) * G + g
__device__ __forceinline__ void fold_counts(const WarpRows& w, int64_t G, char* base, bool ok,
                                            unsigned qbits, unsigned wq, int64_t ql) {
    for (unsigned m = wq; m != 0u; m &= m - 1u) {
        const int j = __ffs(m) - 1;
        const unsigned cb = __ballot_sync(FULL_WARP, ok && ((qbits >> j) & 1u));
        const int cnt = fp_popc(w.seg.peers & cb);
        if (w.seg.rank == 0 && cnt != 0)
            atomicAdd((unsigned long long*)base + ((ql + j) * G + w.g), (unsigned long long)cnt);
    }
}

// sum, min or max of accumulator type DT, `stride` bytes a register:
// per query, the passing lanes' values reduce over their segments (once
// for queries that the same lanes pass), and the rank-0 lanes update
template <int K, int DT>
__device__ __forceinline__ void fold_values(WarpRows& w, int64_t G, char* base, int stride,
                                            bool ok, unsigned long long x, unsigned qbits,
                                            unsigned wq, int64_t ql) {
    const unsigned long long id = reduce_identity<K, DT>();
    unsigned last = 0u;
    unsigned long long r = id;
    for (unsigned m = wq; m != 0u; m &= m - 1u) {
        const int j = __ffs(m) - 1;
        const bool c = ok && ((qbits >> j) & 1u);
        const unsigned cb = __ballot_sync(FULL_WARP, c);
        if (fp_popc(cb) <= kFoldDirectLanes) {
            if (c) apply_reduced<K, DT>(base + ((ql + j) * G + w.g) * stride, x);
            continue;
        }
        if (cb != last) {
            if (!w.sources) {
                seg_sources(w.seg, w.lane);
                w.sources = true;
            }
            r = seg_reduce<K, DT>(w.seg, c ? x : id);
            last = cb;
        }
        if (w.seg.rank == 0 && (w.seg.peers & cb) != 0u)
            apply_reduced<K, DT>(base + ((ql + j) * G + w.g) * stride, r);
    }
}

template <int K>
__device__ __forceinline__ void fold_values_dt(int dt, WarpRows& w, int64_t G, char* base,
                                               int stride, bool ok, unsigned long long x,
                                               unsigned qbits, unsigned wq, int64_t ql) {
    switch (dt) {
        case SAF_I64: fold_values<K, SAF_I64>(w, G, base, stride, ok, x, qbits, wq, ql); break;
        case SAF_I32: fold_values<K, SAF_I32>(w, G, base, stride, ok, x, qbits, wq, ql); break;
        case SAF_F32: fold_values<K, SAF_F32>(w, G, base, stride, ok, x, qbits, wq, ql); break;
        default: fold_values<K, SAF_F64>(w, G, base, stride, ok, x, qbits, wq, ql); break;
    }
}

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
    int64_t q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
    return q;
}

template <class Row>
__device__ __forceinline__ int64_t group_of(const SafParams& p, const typename Row::Vals& v) {
    // no key: group 0, with no int64 division compiled in
    if (Row::kKeys == 0) return 0;
    // unsigned arithmetic: wraps like the reference's int64 lanes
    unsigned long long gid = 0;
    for (int k = 0; k < p.n_keys; ++k) {
        long long x = 0, code = 0;
        if (Row::key(v, k, &x)) {
            long long d = (long long)((unsigned long long)x - (unsigned long long)p.key_lo[k]);
            code = floor_div(d, p.key_step[k]) + 1;
            if (code < 0) code = 0;
        }
        gid += (unsigned long long)code * (unsigned long long)p.key_stride[k];
    }
    long long g = (long long)gid;
    if (g < 0) g = 0;
    if (g > p.n_groups - 1) g = p.n_groups - 1;
    return g;
}

// the lanes whose `slot` (of `slots`) is this lane's, for a lane that
// takes part (`in`); a lane that does not is alone (32-bit matches while
// the slots fit: they are cheaper than 64-bit ones)
__device__ __forceinline__ unsigned match_slot(int lane, bool in, int64_t slot, int64_t slots) {
    if (slots < 0x80000000ll)
        return __match_any_sync(FULL_WARP, in ? (unsigned)slot : 0x80000000u | (unsigned)lane);
    return __match_any_sync(FULL_WARP, in ? (unsigned long long)slot
                                          : 0x8000000000000000ull | (unsigned)lane);
}

// bit j: the row's mask of query q + j, for the queries [q, q + nj)
__device__ __forceinline__ unsigned query_bits(const SafParams& p, int64_t i, int q, int nj) {
    unsigned bits = 0u;
    for (int j = 0; j < nj; ++j)
        if (p.mask[(int64_t)(q + j) * p.n + i]) bits |= 1u << j;
    return bits;
}

// One row-iteration of a warp over the queries [q0, q0 + nq) of a chunk:
// lane i's row (in_range: i < n) folds into register (q * G + g) of every
// query q whose mask it passes, the registers of query q at index
// (q - q0) * G + g of a block's table (`shared`) or q * G + g of the
// registers.  Each row's columns, keys, arguments and group id are
// evaluated once, when it passes some query of the chunk.  When more
// than kFoldDirectLanes lanes pass, the lanes that fold into one
// register combine inside the warp first (fold_counts, fold_values; the
// sketch ops, whose rows spread over many buckets, update per lane) and
// one lane updates it; else each lane updates its own registers.  With
// kCommon (a block's table of nq <= 32 queries and one more, local query
// nq), a row that passes every query folds once, into the common
// registers, which the block adds to every query's at its end; in the
// aggregated path only when every passing lane passes every query.
// Every lane of the warp calls this with the same q0 and nq.
template <class Row, bool kFilter, bool kCommon>
__device__ __forceinline__ void fold_warp(const SafParams& p, const FmParams& rp, int q0, int nq,
                                          int64_t i, bool in_range, char* table, bool shared,
                                          bool reduces) {
    const int64_t G = p.n_groups;
    const int lane = threadIdx.x & 31;
    // the first word's query bits, read once; later words (Q > 32) again
    unsigned qbits0 = 0u;
    bool has = false;
    if (in_range) {
        qbits0 = query_bits(p, i, q0, nq < 32 ? nq : 32);
        has = qbits0 != 0u;
        for (int q = q0 + 32; !has && q < q0 + nq; ++q) has = p.mask[(int64_t)q * p.n + i] != 0;
        if (kFilter && has) has = Row::pass(rp, i);
        if (!has) qbits0 = 0u;
    }
    const unsigned hb = __ballot_sync(FULL_WARP, has);
    if (hb == 0u) return;
    typename Row::Vals v;
    int64_t g = 0;
    if (has) {
        Row::values(rp, i, v);
        g = group_of<Row>(p, v);
    }
    const unsigned every = nq >= 32 ? FULL_WARP : (1u << nq) - 1u;
    if (fp_popc(hb) <= kFoldDirectLanes) {
        if (!has) return;
        for (int w0 = 0; w0 < nq; w0 += 32) {
            unsigned qbits =
                w0 == 0 ? qbits0 : query_bits(p, i, q0 + w0, nq - w0 < 32 ? nq - w0 : 32);
            int64_t ql = shared ? w0 : q0 + w0;
            if (kCommon && qbits == every) {
                qbits = 1u;
                ql = nq;
            }
            for (int o = 0; o < p.n_ops; ++o) {
                SafVal a = saf_val((int64_t)0);
                if (p.op_kind[o] != SAF_COUNT_STAR && !Row::arg(v, p.op_arg[o], &a)) continue;
                char* base = shared ? table + p.op_soff[o] : (char*)p.acc[o];
                const int stride = shared ? 8 : op_width(p, o);
                for (unsigned m = qbits; m != 0u; m &= m - 1u)
                    fold_op(p, o, base, (ql + __ffs(m) - 1) * G + g, stride, a);
            }
            if (p.rows != nullptr) {
                unsigned long long* r = shared ? (unsigned long long*)(table + p.op_soff[p.n_ops])
                                               : (unsigned long long*)p.rows;
                for (unsigned m = qbits; m != 0u; m &= m - 1u)
                    atomicAdd(r + (ql + __ffs(m) - 1) * G + g, 1ull);
            }
        }
        return;
    }
    WarpRows w;
    w.lane = lane;
    w.g = g;
    // segments by group: in scalar mode every passing lane shares one
    const unsigned peers =
        Row::kKeys > 0 && G > 1 ? match_slot(lane, has, g, G) : (has ? hb : (1u << lane));
    // the shuffle steps of the warp's largest segment, when some op
    // reduces values over segments (counts need only the popcounts)
    const int steps =
        reduces ? seg_steps((int)__reduce_max_sync(FULL_WARP, (unsigned)fp_popc(peers))) : 0;
    w.seg = warp_seg(peers, lane, steps);
    w.sources = false;
    for (int w0 = 0; w0 < nq; w0 += 32) {
        unsigned qbits =
            w0 == 0 ? qbits0
                    : (has ? query_bits(p, i, q0 + w0, nq - w0 < 32 ? nq - w0 : 32) : 0u);
        // the queries of the word some lane passes
        unsigned wq = __reduce_or_sync(FULL_WARP, qbits);
        if (wq == 0u) continue;
        int64_t ql = shared ? w0 : q0 + w0;
        if (kCommon && __all_sync(FULL_WARP, !has || qbits == every)) {
            qbits = has ? 1u : 0u;
            wq = 1u;
            ql = nq;
        }
        for (int o = 0; o < p.n_ops; ++o) {
            const int kind = p.op_kind[o];
            SafVal a = saf_val((int64_t)0);
            bool ok = has;
            if (has && kind != SAF_COUNT_STAR) ok = Row::arg(v, p.op_arg[o], &a);
            char* base = shared ? table + p.op_soff[o] : (char*)p.acc[o];
            if (is_sketch(kind)) {
                if (ok)
                    for (unsigned m = qbits; m != 0u; m &= m - 1u)
                        fold_op(p, o, base, (ql + __ffs(m) - 1) * G + g, 8, a);
            } else if (kind == SAF_COUNT_STAR || kind == SAF_COUNT) {
                fold_counts(w, G, base, ok, qbits, wq, ql);
            } else {
                const int dt = p.op_dtype[o];
                const int stride = shared ? 8 : op_width(p, o);
                const unsigned long long x = ok ? acc_bits(dt, a) : 0ull;
                if (kind == SAF_SUM)
                    fold_values_dt<SAF_SUM>(dt, w, G, base, stride, ok, x, qbits, wq, ql);
                else if (kind == SAF_MIN)
                    fold_values_dt<SAF_MIN>(dt, w, G, base, stride, ok, x, qbits, wq, ql);
                else
                    fold_values_dt<SAF_MAX>(dt, w, G, base, stride, ok, x, qbits, wq, ql);
            }
        }
        if (p.rows != nullptr)
            fold_counts(w, G, shared ? table + p.op_soff[p.n_ops] : (char*)p.rows, has, qbits, wq,
                        ql);
    }
}

// the block's rows, a warp at a time (every lane of a warp runs the
// same iterations, as fold_warp needs)
template <class Row, bool kFilter, bool kCommon>
__device__ __forceinline__ void fold_rows(const SafParams& p, const FmParams& rp, int q0, int nq,
                                          char* table, bool shared) {
    const int lane = threadIdx.x & 31;
    bool reduces = false;
    for (int o = 0; o < p.n_ops; ++o)
        reduces = reduces || p.op_kind[o] == SAF_SUM || p.op_kind[o] == SAF_MIN
                  || p.op_kind[o] == SAF_MAX;
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t b = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x - lane); b < p.n; b += step)
        fold_warp<Row, kFilter, kCommon>(p, rp, q0, nq, b + lane, b + lane < p.n, table, shared,
                                         reduces);
}

// shared-memory regime: a block-private table of every op's registers
// for the G groups of the q_chunk queries of chunk blockIdx.y, and with
// kCommon (one chunk) the registers of the rows every query passes
template <class Row, bool kFilter, bool kCommon>
__global__ void __launch_bounds__(kFoldThreads, kFoldMinBlocks)
    fold_shared_q(const __grid_constant__ SafParams p, const __grid_constant__ FmParams rp,
                  const int n_q, const int q_chunk) {
    const int common = kCommon ? 1 : 0;
    extern __shared__ __align__(8) char table[];
    const int q0 = blockIdx.y * q_chunk;
    const int nq = n_q - q0 < q_chunk ? n_q - q0 : q_chunk;
    const int64_t G = p.n_groups;
    const int64_t QG = (int64_t)(nq + common) * G;
    for (int o = 0; o < p.n_ops; ++o) {
        const int kind = p.op_kind[o];
        const int64_t count = QG * p.op_m[o];
        char* region = table + p.op_soff[o];
        if (kind == SAF_HLL) {
            for (int64_t t = threadIdx.x; t < count; t += blockDim.x) ((int*)region)[t] = 0;
            continue;
        }
        const unsigned long long id = identity_bits(kind, p.op_dtype[o]);
        for (int64_t t = threadIdx.x; t < count; t += blockDim.x)
            ((unsigned long long*)region)[t] = id;
    }
    if (p.rows != nullptr) {
        unsigned long long* r = (unsigned long long*)(table + p.op_soff[p.n_ops]);
        for (int64_t t = threadIdx.x; t < QG; t += blockDim.x) r[t] = 0ull;
    }
    __syncthreads();
    fold_rows<Row, kFilter, kCommon>(p, rp, q0, nq, table, true);
    __syncthreads();
    if (kCommon) {
        // the common registers into every query's (no sketch ops here)
        for (int o = 0; o < p.n_ops; ++o) {
            const unsigned long long* c = (const unsigned long long*)(table + p.op_soff[o]) + nq * G;
            for (int64_t t = threadIdx.x; t < nq * G; t += blockDim.x)
                merge_bits(p, o, c[t % G], (int64_t)q0 * G + t);
        }
        if (p.rows != nullptr) {
            const unsigned long long* c =
                (const unsigned long long*)(table + p.op_soff[p.n_ops]) + nq * G;
            for (int64_t t = threadIdx.x; t < nq * G; t += blockDim.x)
                if (c[t % G] != 0ull)
                    atomicAdd((unsigned long long*)p.rows + (int64_t)q0 * G + t, c[t % G]);
        }
    }
    for (int o = 0; o < p.n_ops; ++o) {
        const int64_t count = (int64_t)nq * G * p.op_m[o];
        const int64_t at = (int64_t)q0 * G * p.op_m[o];
        const char* region = table + p.op_soff[o];
        const bool hll = p.op_kind[o] == SAF_HLL;
        for (int64_t t = threadIdx.x; t < count; t += blockDim.x)
            merge_bits(p, o, hll ? (unsigned)((const int*)region)[t]
                                 : ((const unsigned long long*)region)[t], at + t);
    }
    if (p.rows != nullptr) {
        const unsigned long long* r = (const unsigned long long*)(table + p.op_soff[p.n_ops]);
        for (int64_t t = threadIdx.x; t < nq * G; t += blockDim.x)
            if (r[t] != 0ull) atomicAdd((unsigned long long*)p.rows + (int64_t)q0 * G + t, r[t]);
    }
}

// global regime: the warps' reduced updates go straight to the registers
template <class Row, bool kFilter>
__global__ void __launch_bounds__(kFoldThreads, kFoldMinBlocks)
    fold_global_q(const __grid_constant__ SafParams p, const __grid_constant__ FmParams rp,
                  const int n_q) {
    fold_rows<Row, kFilter, false>(p, rp, 0, n_q, nullptr, false);
}

// Launches one fold of `p0` for `n_q` queries on `stream`, the rows from
// `Row` over the columns and parameters of `rp`: p0->mask points at the
// [n_q, n] masks, every p0->acc[o] at [n_q * G * M_o] registers and
// p0->rows at [n_q * G] (or null).  *regime is set to the number of query
// chunks of the shared-memory table (1: one table for all queries), 0 for
// global atomics.  Returns the CUDA error of the launch (0 = cudaSuccess);
// the kernel runs asynchronously.
template <class Row, bool kFilter>
static int launch_fold(const SafParams* p0, const FmParams* rp, int n_q, void* stream,
                       int* regime) {
    if (p0->n <= 0 || n_q <= 0) { *regime = -1; return 0; }
    SafParams p = *p0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, smem_optin = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    int kind_bytes[SAF_MAX_OPS], m[SAF_MAX_OPS];
    bool sketches = false;
    for (int o = 0; o < p.n_ops; ++o) {
        kind_bytes[o] = shared_elem_bytes(p.op_kind[o]);
        m[o] = p.op_m[o];
        sketches = sketches || is_sketch(p.op_kind[o]);
    }
    const bool rows = p.rows != nullptr;
    const int q_chunk = fold_query_chunk(p.n_ops, kind_bytes, m, p.n_groups, n_q, rows,
                                         smem_optin);
    const int chunks = q_chunk > 0 ? (n_q + q_chunk - 1) / q_chunk : 0;
    const long long want_blocks = (p.n + kFoldThreads - 1) / kFoldThreads;
    cudaStream_t s = (cudaStream_t)stream;
    if (q_chunk > 0 && chunks <= 65535) {
        // the registers of rows every query passes, once, when one more
        // query's fit (not for sketch registers: their rows spread)
        const int common = !sketches && q_chunk == n_q && n_q > 1 && n_q <= 32
                           && fold_table_bytes(p.n_ops, kind_bytes, m, p.n_groups, n_q + 1,
                                               rows, nullptr) <= smem_optin;
        const int bytes = (int)fold_table_bytes(p.n_ops, kind_bytes, m, p.n_groups,
                                                q_chunk + common, rows, p.op_soff);
        // (one query, kFilter, has no common registers: no such kernel)
        auto kernel = common ? fold_shared_q<Row, kFilter, !kFilter>
                             : fold_shared_q<Row, kFilter, false>;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return (int)err;
        int per_sm = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFoldThreads, bytes);
        if (err != cudaSuccess) return (int)err;
        if (per_sm < 1) per_sm = 1;
        // a sketch table's end-of-block merge costs thousands of global
        // atomics per block: fewer, longer blocks
        if (sketches && per_sm > 2) per_sm = 2;
        long long blocks = ((long long)sms * per_sm + chunks - 1) / chunks;
        if (blocks > want_blocks) blocks = want_blocks;
        *regime = chunks;
        dim3 grid((unsigned)blocks, (unsigned)chunks);
        kernel<<<grid, kFoldThreads, bytes, s>>>(p, *rp, n_q, q_chunk);
    } else {
        long long blocks = (long long)sms * 8;
        if (blocks > want_blocks) blocks = want_blocks;
        *regime = 0;
        fold_global_q<Row, kFilter><<<(unsigned)blocks, kFoldThreads, 0, s>>>(p, *rp, n_q);
    }
    return (int)cudaGetLastError();
}
