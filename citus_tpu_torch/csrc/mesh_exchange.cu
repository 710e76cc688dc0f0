// mesh_exchange: the all_to_all of a repartition over a mesh's members,
// one launch per card for every destination on it, every source and
// every column (ROADMAP.md B7/B8, the exchange).
//
// Replaces the exchange inside the TPU kernels
// citus_tpu/parallel/shuffle.py:62 build_repartition and :124
// build_repartition_join: after each member packs its rows into [n, C]
// send blocks (B7, csrc/partition_pack.cu), `jax.lax.all_to_all(split_axis=0,
// concat_axis=0)` hands block d of every source to member d, which then
// holds, per column, the [n * C] concatenation of its blocks in source
// order.  Here one launch fills the receive rows of every destination on
// one card: block (destination d, source s, column c) -- C values of
// `elem` bytes at row d of source s's [n, C] column -- is copied to
// values [s * C, (s + 1) * C) of row k of column c's [n_dst, n * C]
// receive tensor, k being d's position among the launch's destinations.
// On one card every member is a destination, k = d, and the receive
// tensor is the stacked [n, n * C] output a repartition returns.  When
// members sit on other cards, parallel/shuffle.py has first copied the
// blocks this card's destinations need onto it (bit s of `remote`: source
// s's rows are those copies, row k for the k-th destination), so every
// pointer here is local.
//
// Bound: bytes.  Every block is read once and every received value
// written once; no arithmetic.  The design: blockIdx.y takes one run
// (destination, source, column), a contiguous span of C * elem bytes on
// both sides, and threads copy it 16 bytes at a time.  The runs start at
// offsets d * C * elem and (k * n + s) * C * elem, which 16 does not
// divide for 1- and 4-byte columns at most capacities (QJOIN's C is
// 376,388), and not by the same remainder on both sides: each thread
// stores one aligned 16-byte chunk of the destination and loads the two
// aligned 16-byte chunks of the source that cover it, shifting their
// words into place (a shift that is the same for the whole run, so the
// loop is chosen once per run); the unaligned head and tail bytes go one
// byte a thread.  No per-element branch, no padding of C.

#include <cuda_runtime.h>
#include <stdint.h>

#define MX_MAX_SRC 16
#define MX_MAX_COLS 24

// The layout is mirrored by parallel/shuffle.py (_MX_LAYOUT: a flat int64
// block built with numpy); change both together.
struct MxParams {
    int64_t n_src;                       // members n
    int64_t capacity;                    // C
    int64_t n_cols;
    int64_t n_dst;                       // destinations of this launch
    int64_t remote;                      // bit s: source s's rows are copies, one per destination
    int64_t dst_ids[MX_MAX_SRC];         // the member of each destination row k
    int64_t elem[MX_MAX_COLS];           // bytes per value: 1, 4 or 8
    void* dst[MX_MAX_COLS];              // [n_dst, n_src * C] receive rows
    const void* src[MX_MAX_COLS][MX_MAX_SRC];  // source s's [n or n_dst, C] blocks
};

// the 16 bytes of the source at byte offset 16 * m + 4 * WO + SH / 8 of
// the 16-byte aligned `p`, from the two aligned chunks that hold them
template <int WO>
__device__ __forceinline__ uint4 shifted(const uint4* p, int64_t m, unsigned sh) {
    const uint4 a = p[m], b = p[m + 1];
    const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint4 r;
    r.x = __funnelshift_r(w[WO], w[WO + 1], sh);
    r.y = __funnelshift_r(w[WO + 1], w[WO + 2], sh);
    r.z = __funnelshift_r(w[WO + 2], w[WO + 3], sh);
    r.w = __funnelshift_r(w[WO + 3], w[WO + 4], sh);
    return r;
}

// chunks [first, nb) step `stride` of a run's aligned body: d[m] = the 16
// source bytes at byte offset 16 * m of `s` (any alignment)
template <int WO>
__device__ __forceinline__ void copy_body(const uint8_t* s, uint4* d, int64_t nb, int64_t first,
                                          int64_t stride) {
    const uintptr_t a = (uintptr_t)s;
    const uint4* p = (const uint4*)(a & ~(uintptr_t)15);
    const unsigned sh = (unsigned)(a & 3) * 8u;
    for (int64_t m = first; m < nb; m += stride) d[m] = shifted<WO>(p, m, sh);
}

__global__ void mx_kernel(const __grid_constant__ MxParams p) {
    const int64_t r = blockIdx.y;
    const int64_t c = r % p.n_cols;
    const int64_t s = (r / p.n_cols) % p.n_src;
    const int64_t k = r / (p.n_cols * p.n_src);
    const int64_t len = p.capacity * p.elem[c];
    const int64_t row = ((p.remote >> s) & 1) ? k : p.dst_ids[k];
    const uint8_t* src = (const uint8_t*)p.src[c][s] + row * len;
    uint8_t* dst = (uint8_t*)p.dst[c] + (k * p.n_src + s) * len;
    int64_t head = (int64_t)((16 - ((uintptr_t)dst & 15)) & 15);
    if (head > len) head = len;
    const int64_t nb = (len - head) / 16;
    const int64_t tail = len - head - nb * 16;
    if (blockIdx.x == 0) {
        if (threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
        if (threadIdx.x < tail) dst[head + nb * 16 + threadIdx.x] = src[head + nb * 16 + threadIdx.x];
    }
    const uint8_t* s0 = src + head;
    uint4* d0 = (uint4*)(dst + head);
    const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const unsigned off = (unsigned)((uintptr_t)s0 & 15);
    if (off == 0) {
        const uint4* q = (const uint4*)s0;
        for (int64_t m = first; m < nb; m += stride) d0[m] = q[m];
        return;
    }
    switch (off >> 2) {
        case 0: copy_body<0>(s0, d0, nb, first, stride); break;
        case 1: copy_body<1>(s0, d0, nb, first, stride); break;
        case 2: copy_body<2>(s0, d0, nb, first, stride); break;
        default: copy_body<3>(s0, d0, nb, first, stride); break;
    }
}

static const int kMxThreads = 256;
// 16-byte chunks a thread copies of the longest run
static const int kMxChunksPerThread = 4;

extern "C" int mesh_exchange_launch(const MxParams* p, void* stream) {
    if (p->n_src < 1 || p->n_src > MX_MAX_SRC || p->n_cols < 1 || p->n_cols > MX_MAX_COLS
        || p->n_dst < 1 || p->n_dst > MX_MAX_SRC || p->capacity < 1)
        return (int)cudaErrorInvalidValue;
    int64_t longest = 0;
    for (int64_t c = 0; c < p->n_cols; ++c) {
        const int64_t e = p->elem[c];
        if (e != 1 && e != 4 && e != 8) return (int)cudaErrorInvalidValue;
        if (p->capacity * e > longest) longest = p->capacity * e;
    }
    const int64_t per_block = (int64_t)kMxThreads * kMxChunksPerThread * 16;
    long long blocks = (longest + per_block - 1) / per_block;
    if (blocks > 65535) blocks = 65535;
    dim3 grid((unsigned)blocks, (unsigned)(p->n_dst * p->n_src * p->n_cols));
    mx_kernel<<<grid, kMxThreads, 0, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
}

extern "C" int mesh_exchange_params_size(void) { return (int)sizeof(MxParams); }
extern "C" int mesh_exchange_max_src(void) { return MX_MAX_SRC; }
extern "C" int mesh_exchange_max_cols(void) { return MX_MAX_COLS; }
