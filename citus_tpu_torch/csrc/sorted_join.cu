// sorted_join: one device's inner equi-join of two relations on dense
// join-group ids, and the gather of every output column (ROADMAP.md B8).
//
// Replaces the TPU kernel citus_tpu/parallel/shuffle.py
// _sorted_join_indexes (:95) and the gathers out_l / out_r of
// build_repartition_join (:124).  For join_cap output slots j it computes
// exactly the reference's l_idx[j], r_idx[j], out_valid[j] = j < total
// and total: the left rows sorted stably by gid (invalid ones last), each
// valid right row's run of equal left gids, the runs laid out in right
// row order, and for the slots past the last pair the values the
// reference's clipped searches give (r_idx = R - 1 and the left row its
// clipped offset lands on).  Then out[j] = column[l_idx[j]] (or r_idx)
// for every column, values and validity alike.
//
// The gids are dense in [0, U) (np.unique's inverse in the caller), so
// nothing is searched and nothing compared.  A valid left gid outside
// [0, U) joins as an invalid row, as in the wrapper's plain version:
//   1. the valid left rows are counted per gid (one atomic add per row)
//      and the counts scanned: starts[g] = valid left rows of gid < g;
//   2. the left rows are sorted stably by gid (U for an invalid row) with
//      a least-significant-digit radix sort, 8 bits a pass
//      (csrc/partition.cuh counting passes, ceil(log2(U + 1) / 8) of
//      them): order[];
//   3. right row r's run is [starts[g], starts[g + 1]) of order, its
//      length is scanned into its first output slot, and one thread per
//      right row writes its run's (l_idx, r_idx) pairs;
//   4. one thread per slot fills the slots past the last pair;
//   5. the columns are gathered (sorted_join_gather_launch, as many
//      launches as column groups of SJ_MAX_COLS).
//
// Bound: bytes.  The validity of both sides and the gids of their valid
// rows are read, the four index outputs are written, and every gathered
// column is read at the distinct rows its index reaches and written
// once; the sort's passes re-read and re-write the
// left keys and row numbers (8 bytes a row a pass), the one cost above
// the bound that grows with the data.  A right row's run is written by
// one thread, so a heavily skewed gid serialises on it: simple first.

#include "partition.cuh"

#define SJ_MAX_COLS 32

// The layouts are mirrored by ctypes in citus_tpu_torch/parallel/
// shuffle.py (_SjParams, _SjGather); change both together.
struct SjParams {
    int64_t L, R, U, J;
    const int64_t* lgid;     // [L]
    const uint8_t* lvalid;   // [L] bool
    const int64_t* rgid;     // [R]
    const uint8_t* rvalid;   // [R] bool
    int64_t* l_idx;          // [J]
    int64_t* r_idx;          // [J]
    uint8_t* out_valid;      // [J] bool
    int64_t* total;          // [1]
    // scratch
    int32_t* key_a;          // [L] x4: keys and row numbers, two buffers
    int32_t* key_b;
    int32_t* idx_a;
    int32_t* idx_b;
    int64_t* hist;           // 256 * pt_tiles(L)
    int64_t* bsum;           // pt_tiles of the longest scan
    int64_t* starts;         // [U + 1]
    int64_t* lo;             // [R]
    int64_t* run;            // [R]: run lengths, then their exclusive scan
};

struct SjColumn {
    const void* in;   // [n] values
    void* out;        // [J]
    int64_t elem;     // bytes per value: 1, 4 or 8
};

struct SjGather {
    int64_t J;
    const int64_t* idx;   // [J] row of each slot
    int64_t n_cols;
    SjColumn cols[SJ_MAX_COLS];
};

// (1) keys and row numbers of the left side; counts of valid gids
__global__ void sj_left_keys(const SjParams p) {
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < p.L;
         i += (int64_t)gridDim.x * blockDim.x) {
        const int64_t g = p.lgid[i];
        const bool ok = p.lvalid[i] != 0 && g >= 0 && g < p.U;
        p.key_a[i] = ok ? (int32_t)g : (int32_t)p.U;
        p.idx_a[i] = (int32_t)i;
        if (ok) atomicAdd((unsigned long long*)&p.starts[g], 1ull);
    }
}

struct SjDigit {
    const int32_t* key;
    int shift;
    __device__ int operator()(int64_t i) const { return (key[i] >> shift) & 255; }
};

struct SjEmit {
    const int32_t* key_in;
    const int32_t* idx_in;
    int32_t* key_out;
    int32_t* idx_out;
    __device__ void operator()(int64_t i, int, int64_t pos) const {
        key_out[pos] = key_in[i];
        idx_out[pos] = idx_in[i];
    }
};

// (3) each right row's first left position and run length.  A gid outside
// [0, U) finds what the reference's searchsorted finds there: nothing
// below 0, every valid left row below a gid >= U, and for the int64
// maximum (the reference's key of an invalid left row) the invalid rows.
__global__ void sj_right_runs(const SjParams p) {
    const int64_t nvl = p.starts[p.U];
    for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < p.R;
         r += (int64_t)gridDim.x * blockDim.x) {
        const int64_t g = p.rgid[r];
        int64_t lo, hi;
        if (g < 0) {
            lo = hi = 0;
        } else if (g >= p.U) {
            lo = nvl;
            hi = g == INT64_MAX ? p.L : nvl;
        } else {
            lo = p.starts[g];
            hi = p.starts[g + 1];
        }
        p.lo[r] = lo;
        p.run[r] = p.rvalid[r] != 0 ? hi - lo : 0;
    }
}

// (3) the pairs of right row r, after run[] became its exclusive scan
__global__ void sj_expand(const SjParams p, const int32_t* order) {
    const int64_t total = *p.total;
    for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < p.R;
         r += (int64_t)gridDim.x * blockDim.x) {
        const int64_t start = p.run[r];
        const int64_t end = r + 1 < p.R ? p.run[r + 1] : total;
        const int64_t lo = p.lo[r];
        for (int64_t j = start; j < end && j < p.J; ++j) {
            p.l_idx[j] = order[lo + (j - start)];
            p.r_idx[j] = r;
            p.out_valid[j] = 1;
        }
    }
}

// (4) the slots past the last pair, as the reference's clipped searches
// leave them
__global__ void sj_tail(const SjParams p, const int32_t* order) {
    const int64_t total = *p.total;
    const int64_t rl = p.R - 1;
    const int64_t base = p.lo[rl] - p.run[rl];
    for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < p.J;
         j += (int64_t)gridDim.x * blockDim.x) {
        if (j < total) continue;
        int64_t pos = base + j;
        pos = pos < 0 ? 0 : (pos > p.L - 1 ? p.L - 1 : pos);
        p.l_idx[j] = order[pos];
        p.r_idx[j] = rl;
        p.out_valid[j] = 0;
    }
}

static inline unsigned sj_blocks(int64_t n) {
    long long b = (n + 255) / 256;
    if (b > 65535) b = 65535;
    return (unsigned)(b < 1 ? 1 : b);
}

// the indexes, out_valid and total (steps 1-4); L, R >= 1
extern "C" int sorted_join_launch(const SjParams* pp, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const SjParams& p = *pp;
    if (p.L < 1 || p.R < 1 || p.U < 0 || p.J < 0 || p.L >= INT32_MAX
        || p.U >= INT32_MAX)
        return (int)cudaErrorInvalidValue;
    int err = (int)cudaMemsetAsync(p.starts, 0, sizeof(int64_t) * (p.U + 1), s);
    if (err != 0) return err;
    sj_left_keys<<<sj_blocks(p.L), 256, 0, s>>>(p);
    err = pt_scan(p.starts, p.starts, p.U, p.bsum, p.starts + p.U, s);
    if (err != 0) return err;
    int32_t *ka = p.key_a, *kb = p.key_b, *ia = p.idx_a, *ib = p.idx_b;
    for (int shift = 0; shift < 31 && (p.U >> shift) > 0; shift += 8) {
        SjDigit digit{ka, shift};
        SjEmit emit{ka, ia, kb, ib};
        err = pt_counting_pass(p.L, 256, digit, emit, p.hist, p.bsum, s);
        if (err != 0) return err;
        int32_t* t = ka; ka = kb; kb = t;
        t = ia; ia = ib; ib = t;
    }
    sj_right_runs<<<sj_blocks(p.R), 256, 0, s>>>(p);
    err = pt_scan(p.run, p.run, p.R, p.bsum, p.total, s);
    if (err != 0) return err;
    if (p.J > 0) {
        sj_expand<<<sj_blocks(p.R), 256, 0, s>>>(p, ia);
        sj_tail<<<sj_blocks(p.J), 256, 0, s>>>(p, ia);
    }
    return (int)cudaGetLastError();
}

__global__ void sj_gather(const SjGather g) {
    for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < g.J;
         j += (int64_t)gridDim.x * blockDim.x) {
        const int64_t src = g.idx[j];
        for (int64_t c = 0; c < g.n_cols; ++c) {
            const SjColumn& col = g.cols[c];
            switch (col.elem) {
                case 8: ((int64_t*)col.out)[j] = ((const int64_t*)col.in)[src]; break;
                case 4: ((int32_t*)col.out)[j] = ((const int32_t*)col.in)[src]; break;
                default: ((uint8_t*)col.out)[j] = ((const uint8_t*)col.in)[src]; break;
            }
        }
    }
}

// out[j] = in[idx[j]] for up to SJ_MAX_COLS columns
extern "C" int sorted_join_gather_launch(const SjGather* g, void* stream) {
    if (g->n_cols < 0 || g->n_cols > SJ_MAX_COLS) return (int)cudaErrorInvalidValue;
    if (g->J <= 0 || g->n_cols == 0) return 0;
    sj_gather<<<sj_blocks(g->J), 256, 0, (cudaStream_t)stream>>>(*g);
    return (int)cudaGetLastError();
}

extern "C" int sorted_join_params_size(void) { return (int)sizeof(SjParams); }
extern "C" int sorted_join_gather_size(void) { return (int)sizeof(SjGather); }
extern "C" int sorted_join_tile(void) { return PT_TILE; }
