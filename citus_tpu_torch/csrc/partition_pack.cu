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
// of.  The design is a stable counting partition (csrc/partition.cuh):
// a per-tile histogram of destinations, a scan of it, and a scatter in
// which each row learns its rank among its destination's rows from its
// warp (__match_any_sync) and the tile's running counts.  The target and
// mask are read twice (histogram and scatter); each row's columns move
// once, element by element in the row's thread, and the slots no row
// reached are zeroed by a second kernel that reads only the counts.
// Any n_dev up to PT_MAX_DIGITS - 1 works the same way.

#include "partition.cuh"

#define PP_MAX_COLS 64

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
    int64_t* hist;           // scratch: (n_dev + 1) * pt_tiles(n)
    int64_t* bsum;           // scratch: pt_tiles((n_dev + 1) * pt_tiles(n))
};

struct PpDigit {
    const int32_t* target;
    const uint8_t* mask;
    int n_dev;
    __device__ int operator()(int64_t i) const {
        const int32_t t = target[i];
        return (mask[i] != 0 && t >= 0 && t < n_dev) ? t : n_dev;
    }
};

__device__ inline void pp_copy(const PpColumn& c, int64_t dst, int64_t src) {
    switch (c.elem) {
        case 8: ((int64_t*)c.out)[dst] = ((const int64_t*)c.in)[src]; break;
        case 4: ((int32_t*)c.out)[dst] = ((const int32_t*)c.in)[src]; break;
        default: ((uint8_t*)c.out)[dst] = ((const uint8_t*)c.in)[src]; break;
    }
}

__device__ inline void pp_zero(const PpColumn& c, int64_t dst) {
    switch (c.elem) {
        case 8: ((int64_t*)c.out)[dst] = 0; break;
        case 4: ((int32_t*)c.out)[dst] = 0; break;
        default: ((uint8_t*)c.out)[dst] = 0; break;
    }
}

// the parameter block travels by value, as a kernel argument (~1.6 KB)
struct PpEmit {
    PpParams p;
    int64_t n_tiles;
    __device__ void operator()(int64_t i, int d, int64_t pos) const {
        if (d >= p.n_dev) return;
        const int64_t rank = pos - p.hist[(int64_t)d * n_tiles];
        if (rank >= p.capacity) return;
        const int64_t slot = (int64_t)d * p.capacity + rank;
        for (int64_t c = 0; c < p.n_cols; ++c) pp_copy(p.cols[c], slot, i);
        p.out_valid[slot] = 1;
    }
};

// rows of destination d: the scanned offsets of d + 1 and d
__device__ inline int64_t pp_count(const PpParams& p, int64_t n_tiles, int64_t d) {
    if (n_tiles == 0) return 0;
    return p.hist[(d + 1) * n_tiles] - p.hist[d * n_tiles];
}

// every slot past its block's rows: zero values, validity false
__global__ void pp_fill(const PpParams p, int64_t n_tiles) {
    const int64_t total = p.n_dev * p.capacity;
    for (int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; s < total;
         s += (int64_t)gridDim.x * blockDim.x) {
        const int64_t d = s / p.capacity, r = s - d * p.capacity;
        if (r < pp_count(p, n_tiles, d)) continue;
        for (int64_t c = 0; c < p.n_cols; ++c) pp_zero(p.cols[c], s);
        p.out_valid[s] = 0;
    }
}

__global__ void pp_overflow(const PpParams p, int64_t n_tiles) {
    if (threadIdx.x != 0 || blockIdx.x != 0) return;
    int64_t over = 0;
    for (int64_t d = 0; d < p.n_dev; ++d) {
        const int64_t c = pp_count(p, n_tiles, d);
        if (c > p.capacity) over += c - p.capacity;
    }
    *p.overflow = over;
}

extern "C" int partition_pack_launch(const PpParams* p, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (p->n_dev < 1 || p->n_dev >= PT_MAX_DIGITS || p->capacity < 1
        || p->n_cols < 0 || p->n_cols > PP_MAX_COLS)
        return (int)cudaErrorInvalidValue;
    const int64_t nt = pt_tiles(p->n);
    PpDigit digit{p->target, p->mask, (int)p->n_dev};
    PpEmit emit{*p, nt};
    int err = pt_counting_pass(p->n, (int)p->n_dev + 1, digit, emit, p->hist,
                               p->bsum, s);
    if (err != 0) return err;
    const int64_t slots = p->n_dev * p->capacity;
    long long blocks = (slots + 255) / 256;
    if (blocks > 65535) blocks = 65535;
    if (blocks < 1) blocks = 1;
    pp_fill<<<(unsigned)blocks, 256, 0, s>>>(*p, nt);
    pp_overflow<<<1, 32, 0, s>>>(*p, nt);
    return (int)cudaGetLastError();
}

extern "C" int partition_pack_params_size(void) { return (int)sizeof(PpParams); }
extern "C" int partition_pack_tile(void) { return PT_TILE; }
