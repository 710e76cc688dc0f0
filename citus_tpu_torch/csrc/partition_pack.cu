// partition_pack: one source's rows arranged into [n_dev, C] send blocks
// by destination (ROADMAP.md B7).
//
// Replaces the TPU kernel citus_tpu/parallel/shuffle.py _pack_blocks
// (:32), the packing half of build_repartition (:62) and of the exchange
// inside build_repartition_join (:124): rows go to their target's block
// in input order (the reference's argsort is stable), masked rows go to a
// virtual destination n_dev and are dropped, rows past C in a block are
// dropped and counted in the overflow.  What the reference does next, an
// all_to_all over the mesh, is the caller's (parallel/shuffle.py): on one
// card it is the identity.
//
// One difference from the jitted body, on purpose: the reference clips
// the slot of a dropped row into the last block's last slot and scatters
// there, so when the last destination's block is full and any row comes
// after it (a masked row, or an overflowing one) that slot's row can be
// overwritten by a dropped one, with overflow 0 (ROADMAP.md C8).  Here a
// dropped row writes nothing.
//
// Bound: bytes.  Every input column, the target and the mask are read
// once and every output block is written once; no arithmetic to speak
// of.  Two launches a call:
//   1. pp_pass, one tile of PP_TILE rows a block, tiles numbered by a
//      ticket in the order blocks start: each warp ranks its own rows
//      among its rows of the same destination (__match_any_sync, a count
//      a destination kept by the warp, no block barrier a round); the
//      warps' counts give each warp's start within the tile's rows of a
//      destination; the tile publishes its counts and takes the rows of
//      each destination in the tiles before it by a decoupled look-back
//      (Merrill and Garland's single-pass scan, as csrc/sorted_join.cu's
//      radix passes do) on epoch-tagged status words, so the reused
//      workspace is never cleared.  Up to PP_WARPS destinations a warp
//      looks back for each, 32 tiles a step (a look-back a tile at a time
//      walks over every tile still in flight, hundreds at once on a full
//      card); more, a thread for each, a tile a step.  The kept rows are staged in shared
//      memory in (destination, input) order, and each column is then
//      copied in that order: neighbouring threads write neighbouring
//      slots of one destination's run.  A tile whose rows all go to one
//      destination (QJOIN's sides on a one-member mesh) copies its rows
//      as they lie, by 16-byte vectors where both runs allow.  Target and
//      mask are read once.
//   2. pp_fill: from the totals alone (the last tile's inclusive counts)
//      the slots no row reached, [min(total, C), C) of each block, get
//      zero values and validity false, and the overflow is summed; no
//      division per slot.  With capacity the largest block, as the join
//      sizes it, there is nothing to fill on n_dev = 1.
// The look-backs wait only on tiles with smaller tickets, taken in the
// order blocks start, so they always finish.  A ticket is a global
// counter less the tickets of the launches before (the wrapper keeps
// that base), so the counter is never cleared either.  Any n_dev up to
// PP_MAX_DEV works the same way: each thread keeps PP_DPT destinations
// of the tile's counts, look-backs and starts.

#include <cuda_runtime.h>
#include <stdint.h>

#define PP_MAX_COLS 64
#define PP_THREADS 256
#define PP_WARPS (PP_THREADS / 32)
#define PP_ITEMS 8
#define PP_TILE (PP_THREADS * PP_ITEMS)
#define PP_DPT 4
#define PP_MAX_DEV (PP_THREADS * PP_DPT - 1)

#define PP_AGG 1u
#define PP_INCL 2u

// The layout is mirrored by ctypes in citus_tpu_torch/parallel/shuffle.py
// (_PpParams); change both together.
struct PpColumn {
    const void* in;     // [n] values (1, 4 or 8 bytes each)
    void* out;          // [n_dev * capacity]
    int64_t elem;       // bytes per value
};

struct PpParams {
    int64_t n;
    int64_t n_dev;
    int64_t capacity;
    const int32_t* target;   // [n]
    const uint8_t* mask;     // [n] bool
    int64_t n_cols;
    PpColumn cols[PP_MAX_COLS];
    uint8_t* out_valid;      // [n_dev * capacity] bool
    int64_t* overflow;       // [1]
    // workspace, reused launch after launch on one stream, never cleared:
    // the ticket counter, and [tiles][n_dev] status words (epoch << 34 |
    // flag << 32 | the tile's count, or with PP_INCL the count of the
    // tiles up to it) of this launch's epoch or an earlier one's
    unsigned long long* ticket;
    uint64_t* state;
    int64_t ticket_base;     // tickets taken by the launches before
    int64_t epoch;           // 1 .. 2^30 - 1, new for every launch
};

static inline int64_t pp_tiles(int64_t n) { return (n + PP_TILE - 1) / PP_TILE; }

__device__ __forceinline__ uint64_t ld_relaxed_u64(const uint64_t* p) {
    uint64_t v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_relaxed_u64(uint64_t* p, uint64_t v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t pp_word(unsigned epoch, unsigned flag, int64_t v) {
    return (uint64_t)epoch << 34 | (uint64_t)flag << 32 | (uint64_t)(uint32_t)v;
}

// the rows of destination d in the tiles before t
__device__ int64_t pp_look_back(const uint64_t* st, int64_t n_dev, int d, unsigned epoch,
                                int64_t t) {
    int64_t before = 0;
    for (int64_t j = t - 1; j >= 0; --j) {
        const uint64_t* w = &st[j * n_dev + d];
        uint64_t v = ld_relaxed_u64(w);
        while ((unsigned)(v >> 34) != epoch) {
            __nanosleep(20);
            v = ld_relaxed_u64(w);
        }
        before += (int64_t)(uint32_t)v;
        if (((v >> 32) & 3u) == PP_INCL) break;
    }
    return before;
}

// The same, by the 32 lanes of a warp: each step reads the words of 32
// tiles at once (lane 0 the nearest), adds the counts up to the nearest
// inclusive one and stops there.  Every lane gets the sum.
__device__ int64_t pp_warp_look_back(const uint64_t* st, int64_t n_dev, int d,
                                     unsigned epoch, int64_t t) {
    const int lane = threadIdx.x & 31;
    int64_t before = 0;
    for (int64_t hi = t - 1; hi >= 0; hi -= 32) {
        const int64_t j = hi - lane;
        uint64_t v = 0;
        if (j >= 0) {
            const uint64_t* w = &st[j * n_dev + d];
            v = ld_relaxed_u64(w);
            while ((unsigned)(v >> 34) != epoch) {
                __nanosleep(20);
                v = ld_relaxed_u64(w);
            }
        }
        const unsigned incl =
            __ballot_sync(0xffffffffu, j < 0 || ((v >> 32) & 3u) == PP_INCL);
        const int stop = incl != 0 ? __ffs(incl) - 1 : 31;
        int64_t c = j >= 0 && lane <= stop ? (int64_t)(uint32_t)v : 0;
        for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
        before += c;
        if (incl != 0) break;
    }
    return before;
}

// exclusive scan of one value a thread over the block; *total gets the
// block's sum.  Every thread of the block must call it.
__device__ __forceinline__ int pp_block_scan(int v, int* total) {
    __shared__ int s_warp[PP_WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    int before = 0, all = 0;
    for (int w = 0; w < PP_WARPS; ++w) {
        if (w < warp) before += s_warp[w];
        all += s_warp[w];
    }
    __syncthreads();
    *total = all;
    return before + x - v;
}

template <class T>
__device__ __forceinline__ void pp_copy(const PpColumn& c, const int64_t (&slot)[PP_ITEMS],
                                        const int (&row)[PP_ITEMS], int64_t base) {
    const T* in = (const T*)c.in + base;
    T* out = (T*)c.out;
#pragma unroll
    for (int k = 0; k < PP_ITEMS; ++k)
        if (slot[k] >= 0) out[slot[k]] = in[row[k]];
}

// rows [base, base + m) of column col to slots [slot, slot + m), by the
// block: 16-byte vectors when both runs start on 16 bytes, else value by
// value (neighbouring threads on neighbouring values either way)
template <class T>
__device__ __forceinline__ void pp_copy_run(const PpColumn& col, int64_t base, int64_t slot,
                                            int m) {
    const T* src = (const T*)col.in + base;
    T* dst = (T*)col.out + slot;
    int from = 0;
    if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0) {
        constexpr int V = 16 / (int)sizeof(T);
        const int nv = m / V;
        for (int v = threadIdx.x; v < nv; v += PP_THREADS)
            ((uint4*)dst)[v] = ((const uint4*)src)[v];
        from = nv * V;
    }
    for (int i = from + threadIdx.x; i < m; i += PP_THREADS) dst[i] = src[i];
}

// A tile is 8 warps of 256 consecutive rows, 32 a round.
__global__ void __launch_bounds__(PP_THREADS) pp_pass(const PpParams p) {
    // each warp's count of a destination, then its start among the
    // tile's rows of it
    __shared__ uint16_t warp_start[PP_WARPS][PP_MAX_DEV + 1];
    // a destination's first position among the tile's kept rows
    __shared__ uint16_t local_start[PP_MAX_DEV + 1];
    // a destination's slot of the tile's position 0
    __shared__ int64_t slot_base[PP_MAX_DEV + 1];
    // the tile's kept rows in (destination, input) order: row within
    // the tile and destination
    __shared__ uint16_t s_row[PP_TILE];
    __shared__ uint16_t s_dst[PP_TILE];
    __shared__ int s_count[PP_WARPS];
    // the destination of every row of the tile, or -1
    __shared__ int s_dense;
    __shared__ int64_t s_ticket;
    const int n_dev = (int)p.n_dev;
    const unsigned epoch = (unsigned)p.epoch;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned lt = (1u << lane) - 1u;
    for (int d = threadIdx.x; d < n_dev; d += PP_THREADS)
        for (int w = 0; w < PP_WARPS; ++w) warp_start[w][d] = 0;
    if (threadIdx.x == 0) {
        s_ticket = (int64_t)atomicAdd(p.ticket, 1ull) - p.ticket_base;
        s_dense = -1;
    }
    __syncthreads();
    const int64_t t = s_ticket;
    const int64_t base = t * PP_TILE;
    const int first = warp * (PP_ITEMS * 32) + lane;
    // every item's target and mask read before the rounds, whose warp
    // barriers would keep a load from starting before the round before
    int dst[PP_ITEMS], rank[PP_ITEMS];
#pragma unroll
    for (int k = 0; k < PP_ITEMS; ++k) {
        const int64_t i = base + first + k * 32;
        dst[k] = -1;
        if (i < p.n) {
            const int32_t g = p.target[i];
            if (p.mask[i] != 0 && g >= 0 && g < n_dev) dst[k] = g;
        }
    }
#pragma unroll
    for (int k = 0; k < PP_ITEMS; ++k) {
        const unsigned peers = __match_any_sync(0xffffffffu, dst[k]);
        rank[k] = 0;
        if (dst[k] >= 0) rank[k] = warp_start[warp][dst[k]] + __popc(peers & lt);
        __syncwarp();
        if (dst[k] >= 0 && (peers & lt) == 0)
            warp_start[warp][dst[k]] += (uint16_t)__popc(peers);
        __syncwarp();
    }
    __syncthreads();
    // thread h: destinations [h * PP_DPT, h * PP_DPT + PP_DPT), their
    // counts in the tile and each warp's start among their rows
    const int d0 = threadIdx.x * PP_DPT;
    int count[PP_DPT], mine = 0;
#pragma unroll
    for (int j = 0; j < PP_DPT; ++j) {
        const int d = d0 + j;
        count[j] = 0;
        if (d < n_dev) {
            for (int w = 0; w < PP_WARPS; ++w) {
                const int c = warp_start[w][d];
                warp_start[w][d] = (uint16_t)count[j];
                count[j] += c;
            }
        }
        mine += count[j];
    }
    int kept;
    int local = pp_block_scan(mine, &kept);
    const int live = (int)(p.n - base < PP_TILE ? p.n - base : PP_TILE);
    uint64_t* st = p.state + t * p.n_dev;
#pragma unroll
    for (int j = 0; j < PP_DPT; ++j) {
        const int d = d0 + j;
        if (d < n_dev) {
            st_relaxed_u64(&st[d], pp_word(epoch, t == 0 ? PP_INCL : PP_AGG, count[j]));
            local_start[d] = (uint16_t)local;
            if (d < PP_WARPS) s_count[d] = count[j];
            if (count[j] == live) s_dense = d;
            local += count[j];
        }
    }
    __syncthreads();
    const int dense = s_dense;
#pragma unroll
    for (int k = 0; k < PP_ITEMS; ++k) {
        if (dense >= 0 || dst[k] < 0) continue;
        const int at = local_start[dst[k]] + warp_start[warp][dst[k]] + rank[k];
        s_row[at] = (uint16_t)(first + k * 32);
        s_dst[at] = (uint16_t)dst[k];
    }
    // the rows of each destination in the tiles before: a warp a
    // destination, 32 tiles a step, up to PP_WARPS destinations; else a
    // thread a destination, a tile a step
    if (n_dev <= PP_WARPS) {
        if (warp < n_dev) {
            const int d = warp;
            const int64_t before =
                t > 0 ? pp_warp_look_back(p.state, p.n_dev, d, epoch, t) : 0;
            if (lane == 0) {
                if (t > 0) st_relaxed_u64(&st[d], pp_word(epoch, PP_INCL, before + s_count[d]));
                slot_base[d] = (int64_t)d * p.capacity + before - local_start[d];
            }
        }
    } else {
#pragma unroll
        for (int j = 0; j < PP_DPT; ++j) {
            const int d = d0 + j;
            if (d < n_dev) {
                int64_t before = 0;
                if (t > 0) {
                    before = pp_look_back(p.state, p.n_dev, d, epoch, t);
                    st_relaxed_u64(&st[d], pp_word(epoch, PP_INCL, before + count[j]));
                }
                slot_base[d] = (int64_t)d * p.capacity + before - local_start[d];
            }
        }
    }
    __syncthreads();
    if (dense >= 0) {
        // every row of the tile kept, to one destination: its run is the
        // rows themselves, copied as they lie
        const int64_t first_slot = slot_base[dense] + local_start[dense];
        const int64_t room = (int64_t)(dense + 1) * p.capacity - first_slot;
        const int m = room < live ? (int)room : live;
        for (int c = 0; c < p.n_cols; ++c) {
            const PpColumn& col = p.cols[c];
            if (col.elem == 8) pp_copy_run<int64_t>(col, base, first_slot, m);
            else if (col.elem == 4) pp_copy_run<int32_t>(col, base, first_slot, m);
            else pp_copy_run<uint8_t>(col, base, first_slot, m);
        }
        for (int i = threadIdx.x; i < m; i += PP_THREADS) p.out_valid[first_slot + i] = 1;
        return;
    }
    // position at: its destination's run, rows past the capacity dropped
    int64_t slot[PP_ITEMS];
    int row[PP_ITEMS];
#pragma unroll
    for (int k = 0; k < PP_ITEMS; ++k) {
        const int at = threadIdx.x + k * PP_THREADS;
        slot[k] = -1;
        row[k] = 0;
        if (at < kept) {
            const int d = s_dst[at];
            const int64_t s = slot_base[d] + at;
            if (s < (int64_t)(d + 1) * p.capacity) {
                slot[k] = s;
                row[k] = s_row[at];
            }
        }
    }
    for (int c = 0; c < p.n_cols; ++c) {
        const PpColumn& col = p.cols[c];
        if (col.elem == 8) pp_copy<int64_t>(col, slot, row, base);
        else if (col.elem == 4) pp_copy<int32_t>(col, slot, row, base);
        else pp_copy<uint8_t>(col, slot, row, base);
    }
#pragma unroll
    for (int k = 0; k < PP_ITEMS; ++k)
        if (slot[k] >= 0) p.out_valid[slot[k]] = 1;
}

template <class T>
__device__ __forceinline__ void pp_zero(void* out, int64_t from, int64_t to, int64_t stride) {
    for (int64_t s = from; s < to; s += stride) ((T*)out)[s] = 0;
}

// Block (x, d): the slots of block d past its rows, [min(total, C), C),
// zero values and validity false; block (0, 0) also the overflow.
// total: the last tile's inclusive count of d (none without rows).
__global__ void __launch_bounds__(PP_THREADS) pp_fill(const PpParams p, int64_t n_tiles) {
    const int d = blockIdx.y;
    const uint64_t* last = p.state + (n_tiles - 1) * p.n_dev;
    const int64_t total = n_tiles > 0 ? (int64_t)(uint32_t)last[d] : 0;
    const int64_t C = p.capacity;
    const int64_t from = (int64_t)d * C + (total < C ? total : C)
                         + (int64_t)blockIdx.x * PP_THREADS + threadIdx.x;
    const int64_t to = (int64_t)(d + 1) * C, stride = (int64_t)gridDim.x * PP_THREADS;
    if (total < C) {
        for (int c = 0; c < p.n_cols; ++c) {
            const PpColumn& col = p.cols[c];
            if (col.elem == 8) pp_zero<int64_t>(col.out, from, to, stride);
            else if (col.elem == 4) pp_zero<int32_t>(col.out, from, to, stride);
            else pp_zero<uint8_t>(col.out, from, to, stride);
        }
        pp_zero<uint8_t>(p.out_valid, from, to, stride);
    }
    if (blockIdx.x == 0 && blockIdx.y == 0) {
        int64_t over = 0;
        for (int64_t e = threadIdx.x; e < p.n_dev; e += PP_THREADS) {
            const int64_t c = n_tiles > 0 ? (int64_t)(uint32_t)last[e] : 0;
            if (c > C) over += c - C;
        }
        for (int o = 16; o > 0; o >>= 1) over += __shfl_xor_sync(0xffffffffu, over, o);
        __shared__ int64_t s_over[PP_WARPS];
        if ((threadIdx.x & 31) == 0) s_over[threadIdx.x >> 5] = over;
        __syncthreads();
        if (threadIdx.x == 0) {
            int64_t all = 0;
            for (int w = 0; w < PP_WARPS; ++w) all += s_over[w];
            *p.overflow = all;
        }
    }
}

// One call: the pass over every tile, then the fill.  The workspace of
// `p` holds at least pp_tiles(n) * n_dev status words.
extern "C" int partition_pack_launch(const PpParams* p, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (p->n_dev < 1 || p->n_dev > PP_MAX_DEV || p->capacity < 1 || p->n < 0
        || p->n >= INT32_MAX || p->n_cols < 0 || p->n_cols > PP_MAX_COLS
        || p->epoch < 1 || p->epoch >= (1 << 30))
        return (int)cudaErrorInvalidValue;
    const int64_t nt = pp_tiles(p->n);
    if (nt > 0) pp_pass<<<(unsigned)nt, PP_THREADS, 0, s>>>(*p);
    // about two blocks an SM in all, none past the capacity
    int64_t gx = (264 + p->n_dev - 1) / p->n_dev;
    const int64_t need = (p->capacity + PP_THREADS - 1) / PP_THREADS;
    if (gx > need) gx = need;
    pp_fill<<<dim3((unsigned)gx, (unsigned)p->n_dev), PP_THREADS, 0, s>>>(*p, nt);
    return (int)cudaGetLastError();
}

extern "C" int partition_pack_params_size(void) { return (int)sizeof(PpParams); }
extern "C" int partition_pack_tile(void) { return PP_TILE; }
extern "C" int partition_pack_max_dev(void) { return PP_MAX_DEV; }
