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
// The gids are dense in [0, U) (np.unique's inverse in the caller), so a
// row's sort key is its gid, U for an invalid row (a valid left gid
// outside [0, U) joins as an invalid row, as in the wrapper's plain
// version).  Five steps, 5 + passes launches (8 at QJOIN's U = 1.48 M):
//   1. sj_count: the left rows counted per key into starts[] (the
//      invalid ones at U), warp-aggregated;
//   2. sj_scan over starts[0..U]: starts[g] = valid left rows of gid < g,
//      and the digit histograms of every radix pass from the counts
//      (shared-memory counts a block, one global add a digit);
//   3. sj_pass, once a pass: the stable least-significant-digit radix
//      sort of the keys, with row numbers, ceil(bits / 8) passes of
//      ceil(bits / passes) bits (bits = the bit length of U): each tile
//      of 2,048 rows counts its digits, publishes them, and takes the
//      rows of its digit before it from the tiles before it by a
//      decoupled look-back (Merrill and Garland's single-pass scan;
//      Adinets and Merrill's Onesweep), so a pass is one read and one
//      write of 8 bytes a row in one launch, the writes staged in shared
//      memory into runs of one digit.  The first pass reads the gids
//      themselves, the last writes only row numbers (order[]);
//   4. sj_scan over the right rows: run r is [starts[g], starts[g + 1])
//      for a valid right row of gid g (what the reference's searchsorted
//      finds for a gid outside [0, U): nothing below 0, every valid left
//      row below a gid >= U, and for the int64 maximum, the reference's
//      key of an invalid left row, the invalid rows); the inclusive run
//      ends and base[r] = run start - slot of its first pair, and total;
//   5. sj_expand, one thread an output slot: its right row r is the
//      number of run ends <= j (a binary search, clipped to R - 1, as the
//      reference's searchsorted(ends, j)), its left row order[clip(base[r]
//      + j)], then every gathered column at them (up to SJ_MAX_COLS;
//      sorted_join_gather_launch takes the rest from l_idx / r_idx).
// The look-backs wait only on tiles with smaller tickets, taken in the
// order blocks start, so they always finish.  Their status words carry
// the launch's epoch, so the reused workspace never needs clearing.
//
// Bound: bytes.  The validity of both sides and the gids of their valid
// rows are read, the four index outputs are written, and every gathered
// column is read at the distinct rows its index reaches and written
// once.  Above the bound: each radix pass reads and writes 8 bytes a
// row, and the first pass reads the gids the count has read.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define SJ_MAX_COLS 32
#define SJ_MAX_PASSES 4
#define SJ_THREADS 256
#define SJ_ITEMS 8
#define SJ_TILE (SJ_THREADS * SJ_ITEMS)
#define SJ_WARPS (SJ_THREADS / 32)
#define SJ_MAX_DIGITS 256
// tickets: the starts scan, each pass, the right scan
#define SJ_TICKETS (2 + SJ_MAX_PASSES)

struct SjColumn {
    const void* in;   // [L] or [R] values
    void* out;        // [J]
    int64_t elem;     // bytes per value: 1, 4 or 8
    int64_t right;    // 1: gathered at r_idx, 0: at l_idx
};

// One look-back scan's tile states: a tile's aggregate and inclusive
// prefix, and its flag word (epoch << 2 | SJ_AGG or SJ_INCL).
struct SjScanState {
    int64_t* agg;
    int64_t* incl;
    unsigned* flag;
};

// The parameter block: every field 8 bytes, so the wrapper fills it as
// int64 words (citus_tpu_torch/parallel/shuffle.py _sj_params); change
// both together.
struct SjParams {
    int64_t L, R, U, J;
    int64_t epoch;             // 1 .. 2^30 - 1, new for every launch
    int64_t passes, width;     // radix passes and their digit bits
    const int64_t* lgid;       // [L]
    const uint8_t* lvalid;     // [L] bool
    const int64_t* rgid;       // [R]
    const uint8_t* rvalid;     // [R] bool
    int64_t* l_idx;            // [J]
    int64_t* r_idx;            // [J]
    uint8_t* out_valid;        // [J] bool
    int64_t* total;            // [1]
    // workspace: zeroed by the launch ([zero, zero + zero_bytes))
    void* zero;
    int64_t zero_bytes;
    int64_t* starts;           // [U + 1]
    int64_t* hist;             // [SJ_MAX_PASSES][256] digit counts
    unsigned* tickets;         // [SJ_TICKETS]
    // workspace: epoch-tagged, never cleared
    SjScanState scan_u;        // tiles of U + 1
    SjScanState scan_r;        // tiles of R
    uint64_t* digit_state;     // [passes][tiles of L][256]
    // scratch
    int32_t* key_a;            // [L] x4: keys and row numbers, two buffers
    int32_t* key_b;
    int32_t* idx_a;
    int32_t* idx_b;
    int64_t* base;             // [R]
    int64_t* ends;             // [R]
    int64_t n_cols;
    SjColumn cols[SJ_MAX_COLS];
};

#define SJ_AGG 1u
#define SJ_INCL 2u

__host__ __device__ inline int64_t sj_tiles(int64_t n) { return (n + SJ_TILE - 1) / SJ_TILE; }

__device__ __forceinline__ unsigned ld_acquire_u32(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release_u32(unsigned* p, unsigned v) {
    asm volatile("st.release.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint64_t ld_relaxed_u64(const uint64_t* p) {
    uint64_t v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_relaxed_u64(uint64_t* p, uint64_t v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

// the next tile of a look-back launch, in the order blocks start
__device__ __forceinline__ int64_t sj_ticket(unsigned* ticket) {
    __shared__ unsigned t;
    if (threadIdx.x == 0) t = atomicAdd(ticket, 1u);
    __syncthreads();
    return (int64_t)t;
}

// exclusive scan of one value a thread over the block; *total gets the
// block's sum.  Every thread of the block must call it.
__device__ __forceinline__ int64_t sj_block_scan(int64_t v, int64_t* total) {
    __shared__ int64_t s_warp[SJ_WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int64_t x = v;
    for (int o = 1; o < 32; o <<= 1) {
        const int64_t y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    int64_t before = 0, all = 0;
    for (int w = 0; w < SJ_WARPS; ++w) {
        if (w < warp) before += s_warp[w];
        all += s_warp[w];
    }
    __syncthreads();
    *total = all;
    return before + x - v;
}

// ---- 1. counts per gid and the digit histograms --------------------------

__device__ __forceinline__ int32_t sj_key(const SjParams& p, int64_t i) {
    const int64_t g = p.lgid[i];
    return p.lvalid[i] != 0 && g >= 0 && g < p.U ? (int32_t)g : (int32_t)p.U;
}

// The rows of a gid in a warp add once, through their lowest lane, so
// one gid holding most rows does not serialise on one address.  The
// invalid rows count at U.
__global__ void __launch_bounds__(SJ_THREADS) sj_count(const SjParams p) {
    const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         i - (threadIdx.x & 31) < p.L; i += (int64_t)gridDim.x * blockDim.x) {
        const bool live = i < p.L;
        const int32_t key = live ? sj_key(p, i) : -1;
        const unsigned same = __match_any_sync(0xffffffffu, key);
        if (live && (same & lt) == 0)
            atomicAdd((unsigned long long*)&p.starts[key], (unsigned long long)__popc(same));
    }
}

// ---- 2 and 4. single-pass scans with a decoupled look-back ---------------

// the exclusive prefix of tile t: the tiles before it, walked back until
// one has published its inclusive prefix
__device__ int64_t sj_look_back(const SjScanState& s, unsigned epoch, int64_t t) {
    int64_t sum = 0;
    for (int64_t j = t - 1; j >= 0; --j) {
        unsigned f = ld_acquire_u32(&s.flag[j]);
        while ((f >> 2) != epoch) {
            __nanosleep(20);
            f = ld_acquire_u32(&s.flag[j]);
        }
        if ((f & 3u) == SJ_INCL) return sum + __ldcg((const long long*)&s.incl[j]);
        sum += __ldcg((const long long*)&s.agg[j]);
    }
    return sum;
}

// the rows of digit d in the tiles before t (st: the pass's [tiles][256]
// words, each its tile's count and flag)
__device__ int64_t sj_digit_look_back(const uint64_t* st, int d, unsigned epoch, int64_t t) {
    int64_t before = 0;
    for (int64_t j = t - 1; j >= 0; --j) {
        uint64_t w = ld_relaxed_u64(&st[j * SJ_MAX_DIGITS + d]);
        while ((unsigned)(w >> 34) != epoch) {
            __nanosleep(20);
            w = ld_relaxed_u64(&st[j * SJ_MAX_DIGITS + d]);
        }
        before += (int64_t)(uint32_t)w;
        if (((w >> 32) & 3u) == SJ_INCL) break;
    }
    return before;
}

// starts[g] = counts of gid < g, in place, over g in [0, U]; and the
// digit histograms of every radix pass, each gid's digits weighted by
// its count (the invalid rows at U)
struct SjStarts {
    static constexpr bool kDigits = true;
    static __device__ int64_t value(const SjParams& q, int64_t g, int64_t* aux) {
        *aux = 0;
        return q.starts[g];
    }
    static __device__ void out(const SjParams& q, int64_t g, int64_t excl, int64_t, int64_t) {
        q.starts[g] = excl;
    }
};

// right row r's run: its length (0 for an invalid row) and its first
// left position; out: its inclusive end, base[r] = first position - first
// slot, and the total at the last row
struct SjRuns {
    static constexpr bool kDigits = false;
    static __device__ int64_t value(const SjParams& q, int64_t r, int64_t* lo_out) {
        const int64_t g = q.rgid[r];
        const int64_t nvl = q.starts[q.U];
        int64_t lo, hi;
        if (g < 0) {
            lo = hi = 0;
        } else if (g >= q.U) {
            lo = nvl;
            hi = g == INT64_MAX ? q.L : nvl;
        } else {
            lo = q.starts[g];
            hi = q.starts[g + 1];
        }
        *lo_out = lo;
        return q.rvalid[r] != 0 ? hi - lo : 0;
    }
    static __device__ void out(const SjParams& q, int64_t r, int64_t excl, int64_t len,
                               int64_t lo) {
        q.ends[r] = excl + len;
        q.base[r] = lo - excl;
        if (r == q.R - 1) *q.total = excl + len;
    }
};

template <class Op>
__global__ void __launch_bounds__(SJ_THREADS) sj_scan(const SjParams p, int64_t n,
                                                      const SjScanState s, unsigned* ticket) {
    __shared__ int digits_s[Op::kDigits ? SJ_MAX_PASSES : 1][SJ_MAX_DIGITS];
    const int digits = 1 << p.width;
    if (Op::kDigits)
        for (int d = threadIdx.x; d < SJ_MAX_PASSES * SJ_MAX_DIGITS; d += blockDim.x)
            digits_s[d / SJ_MAX_DIGITS][d % SJ_MAX_DIGITS] = 0;
    const int64_t t = sj_ticket(ticket);
    const int64_t first = t * SJ_TILE + (int64_t)threadIdx.x * SJ_ITEMS;
    int64_t v[SJ_ITEMS], aux[SJ_ITEMS];
    int64_t sum = 0;
    for (int k = 0; k < SJ_ITEMS; ++k) {
        v[k] = first + k < n ? Op::value(p, first + k, &aux[k]) : 0;
        sum += v[k];
        if (Op::kDigits && v[k] != 0)
            for (int d = 0; d < p.passes; ++d)
                atomicAdd(&digits_s[d][((first + k) >> (d * p.width)) & (digits - 1)],
                          (int)v[k]);
    }
    int64_t tile_total;
    int64_t run = sj_block_scan(sum, &tile_total);
    __shared__ int64_t prefix;
    if (threadIdx.x == 0) {
        const unsigned epoch = (unsigned)p.epoch;
        int64_t before = 0;
        if (t == 0) {
            s.incl[t] = tile_total;
            st_release_u32(&s.flag[t], epoch << 2 | SJ_INCL);
        } else {
            s.agg[t] = tile_total;
            st_release_u32(&s.flag[t], epoch << 2 | SJ_AGG);
            before = sj_look_back(s, epoch, t);
            s.incl[t] = before + tile_total;
            st_release_u32(&s.flag[t], epoch << 2 | SJ_INCL);
        }
        prefix = before;
    }
    __syncthreads();
    run += prefix;
    for (int k = 0; k < SJ_ITEMS; ++k) {
        if (first + k < n) Op::out(p, first + k, run, v[k], aux[k]);
        run += v[k];
    }
    if (Op::kDigits) {
        __syncthreads();
        for (int d = threadIdx.x; d < p.passes * SJ_MAX_DIGITS; d += blockDim.x) {
            const int c = digits_s[d / SJ_MAX_DIGITS][d % SJ_MAX_DIGITS];
            if (c != 0) atomicAdd((unsigned long long*)&p.hist[d], (unsigned long long)c);
        }
    }
}

// ---- 3. one stable radix pass in one launch ------------------------------

// a digit's tile state: epoch << 34 | flag << 32 | count (counts < 2^31)
__device__ __forceinline__ uint64_t sj_digit_word(unsigned epoch, unsigned flag, int64_t v) {
    return (uint64_t)epoch << 34 | (uint64_t)flag << 32 | (uint64_t)(uint32_t)v;
}

// A tile is 8 warps of 256 consecutive rows, 32 a round.  Each warp
// ranks its rows among its own rows of the same digit (__match_any_sync,
// a count a digit kept by the warp: no block barrier a round); the warps'
// counts give each warp's start within the tile's rows of a digit, the
// look-back the tile's start among all rows.  The rows are staged in
// shared memory in their sorted order within the tile and written out
// from there, so neighbouring threads store to neighbouring addresses of
// one digit's run.
template <bool kFirst, bool kLast>
__global__ void __launch_bounds__(SJ_THREADS) sj_pass(const SjParams p, int pass,
                                                      const int32_t* key_in,
                                                      const int32_t* idx_in,
                                                      int32_t* key_out, int32_t* idx_out) {
    __shared__ int warp_start[SJ_WARPS][SJ_MAX_DIGITS];
    __shared__ int local_start[SJ_MAX_DIGITS];
    __shared__ int64_t offset[SJ_MAX_DIGITS];
    __shared__ int32_t s_key[SJ_TILE];
    __shared__ int32_t s_idx[SJ_TILE];
    const int digits = 1 << p.width, shift = pass * (int)p.width;
    const unsigned epoch = (unsigned)p.epoch;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned lt = (1u << lane) - 1u;
    for (int d = threadIdx.x; d < digits; d += blockDim.x)
        for (int w = 0; w < SJ_WARPS; ++w) warp_start[w][d] = 0;
    const int64_t t = sj_ticket(&p.tickets[1 + pass]);
    const int64_t n_tiles = sj_tiles(p.L);
    const int64_t base = t * SJ_TILE;
    const int64_t first = base + (int64_t)warp * (SJ_ITEMS * 32) + lane;
    int32_t key[SJ_ITEMS], idx[SJ_ITEMS];
    int dig[SJ_ITEMS], rank[SJ_ITEMS];
    for (int k = 0; k < SJ_ITEMS; ++k) {
        const int64_t i = first + k * 32;
        dig[k] = -1;
        if (i < p.L) {
            key[k] = kFirst ? sj_key(p, i) : key_in[i];
            idx[k] = kFirst ? (int32_t)i : idx_in[i];
            dig[k] = (key[k] >> shift) & (digits - 1);
        }
        const unsigned peers = __match_any_sync(0xffffffffu, dig[k]);
        if (dig[k] >= 0) rank[k] = warp_start[warp][dig[k]] + __popc(peers & lt);
        __syncwarp();
        if (dig[k] >= 0 && (peers & lt) == 0) warp_start[warp][dig[k]] += __popc(peers);
        __syncwarp();
    }
    __syncthreads();
    // thread d: the tile's rows of digit d, each warp's start among them
    const int d = threadIdx.x;
    int count = 0;
    if (d < digits) {
        for (int w = 0; w < SJ_WARPS; ++w) {
            const int c = warp_start[w][d];
            warp_start[w][d] = count;
            count += c;
        }
    }
    int64_t all;
    const int64_t global_before =
        sj_block_scan(d < digits ? p.hist[pass * SJ_MAX_DIGITS + d] : 0, &all);
    const int64_t tile_before = sj_block_scan(count, &all);
    if (d < digits) {
        uint64_t* st = p.digit_state + ((int64_t)pass * n_tiles) * SJ_MAX_DIGITS;
        int64_t before = 0;
        if (t == 0) {
            st_relaxed_u64(&st[d], sj_digit_word(epoch, SJ_INCL, count));
        } else {
            st_relaxed_u64(&st[t * SJ_MAX_DIGITS + d], sj_digit_word(epoch, SJ_AGG, count));
            before = sj_digit_look_back(st, d, epoch, t);
            st_relaxed_u64(&st[t * SJ_MAX_DIGITS + d],
                           sj_digit_word(epoch, SJ_INCL, before + count));
        }
        local_start[d] = (int)tile_before;
        offset[d] = global_before + before - tile_before;
    }
    __syncthreads();
    for (int k = 0; k < SJ_ITEMS; ++k) {
        if (dig[k] < 0) continue;
        const int at = local_start[dig[k]] + warp_start[warp][dig[k]] + rank[k];
        s_key[at] = key[k];
        s_idx[at] = idx[k];
    }
    __syncthreads();
    const int live = (int)(p.L - base < SJ_TILE ? p.L - base : SJ_TILE);
    for (int at = threadIdx.x; at < live; at += SJ_THREADS) {
        const int32_t kv = s_key[at];
        const int64_t pos = offset[(kv >> shift) & (digits - 1)] + at;
        if (!kLast) key_out[pos] = kv;
        idx_out[pos] = s_idx[at];
    }
}

// ---- 5. the pairs, the clipped tail and the gathers, a slot a thread -----

__global__ void sj_expand(const SjParams p, const int32_t* order) {
    const int64_t total = *p.total;
    for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < p.J;
         j += (int64_t)gridDim.x * blockDim.x) {
        int64_t lo = 0, hi = p.R;
        while (lo < hi) {
            const int64_t mid = (lo + hi) >> 1;
            if (p.ends[mid] <= j) lo = mid + 1;
            else hi = mid;
        }
        const int64_t r = lo < p.R ? lo : p.R - 1;
        int64_t pos = p.base[r] + j;
        pos = pos < 0 ? 0 : (pos > p.L - 1 ? p.L - 1 : pos);
        const int64_t l = order != nullptr ? (int64_t)order[pos] : pos;
        p.l_idx[j] = l;
        p.r_idx[j] = r;
        p.out_valid[j] = j < total ? 1 : 0;
        for (int64_t c = 0; c < p.n_cols; ++c) {
            const SjColumn& col = p.cols[c];
            const int64_t src = col.right ? r : l;
            switch (col.elem) {
                case 8: ((int64_t*)col.out)[j] = ((const int64_t*)col.in)[src]; break;
                case 4: ((int32_t*)col.out)[j] = ((const int32_t*)col.in)[src]; break;
                default: ((uint8_t*)col.out)[j] = ((const uint8_t*)col.in)[src]; break;
            }
        }
    }
}

static inline unsigned sj_blocks(int64_t n) {
    long long b = (n + 255) / 256;
    if (b > 65535) b = 65535;
    return (unsigned)(b < 1 ? 1 : b);
}

// The indexes, out_valid, total and the first n_cols gathers (steps 1-5)
// of the parameter block `words` (SjParams as int64 words); L, R >= 1.
extern "C" int sorted_join_launch(const int64_t* words, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    SjParams p;
    memcpy(&p, words, sizeof(p));
    if (p.L < 1 || p.R < 1 || p.U < 0 || p.J < 0 || p.L >= INT32_MAX
        || p.U >= INT32_MAX || p.passes < 0 || p.passes > SJ_MAX_PASSES
        || p.width < 0 || p.width > 8 || p.passes * p.width > 31
        || (p.U >> (p.passes * p.width)) != 0 || p.n_cols < 0
        || p.n_cols > SJ_MAX_COLS || p.epoch < 1 || p.epoch >= (1 << 30))
        return (int)cudaErrorInvalidValue;
    int err = (int)cudaMemsetAsync(p.zero, 0, (size_t)p.zero_bytes, s);
    if (err != 0) return err;
    const unsigned count_blocks = sj_blocks(p.L);
    sj_count<<<count_blocks < 2048 ? count_blocks : 2048, SJ_THREADS, 0, s>>>(p);
    sj_scan<SjStarts><<<(unsigned)sj_tiles(p.U + 1), SJ_THREADS, 0, s>>>(
        p, p.U + 1, p.scan_u, &p.tickets[0]);
    int32_t *ka = p.key_a, *kb = p.key_b, *ia = p.idx_a, *ib = p.idx_b;
    const unsigned tiles = (unsigned)sj_tiles(p.L);
    for (int k = 0; k < p.passes; ++k) {
        const bool first = k == 0, last = k == p.passes - 1;
        if (first && last) sj_pass<true, true><<<tiles, SJ_THREADS, 0, s>>>(p, k, ka, ia, kb, ib);
        else if (first) sj_pass<true, false><<<tiles, SJ_THREADS, 0, s>>>(p, k, ka, ia, kb, ib);
        else if (last) sj_pass<false, true><<<tiles, SJ_THREADS, 0, s>>>(p, k, ka, ia, kb, ib);
        else sj_pass<false, false><<<tiles, SJ_THREADS, 0, s>>>(p, k, ka, ia, kb, ib);
        int32_t* t = ka; ka = kb; kb = t;
        t = ia; ia = ib; ib = t;
    }
    sj_scan<SjRuns><<<(unsigned)sj_tiles(p.R), SJ_THREADS, 0, s>>>(
        p, p.R, p.scan_r, &p.tickets[1 + SJ_MAX_PASSES]);
    if (p.J > 0)
        sj_expand<<<sj_blocks(p.J), 256, 0, s>>>(p, p.passes > 0 ? ia : nullptr);
    return (int)cudaGetLastError();
}

__global__ void sj_gather(const int64_t J, const int64_t* idx, const SjColumn col) {
    for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < J;
         j += (int64_t)gridDim.x * blockDim.x) {
        const int64_t src = idx[j];
        switch (col.elem) {
            case 8: ((int64_t*)col.out)[j] = ((const int64_t*)col.in)[src]; break;
            case 4: ((int32_t*)col.out)[j] = ((const int32_t*)col.in)[src]; break;
            default: ((uint8_t*)col.out)[j] = ((const uint8_t*)col.in)[src]; break;
        }
    }
}

// out[j] = in[idx[j]] for one column past the first SJ_MAX_COLS
extern "C" int sorted_join_gather_launch(int64_t J, const int64_t* idx, const SjColumn* col,
                                         void* stream) {
    if (J <= 0) return 0;
    sj_gather<<<sj_blocks(J), 256, 0, (cudaStream_t)stream>>>(J, idx, *col);
    return (int)cudaGetLastError();
}

extern "C" int sorted_join_params_words(void) { return (int)(sizeof(SjParams) / 8); }
extern "C" int sorted_join_max_cols(void) { return SJ_MAX_COLS; }
extern "C" int sorted_join_tile(void) { return SJ_TILE; }
