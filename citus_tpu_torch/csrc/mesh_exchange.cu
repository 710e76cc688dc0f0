// mesh_exchange: the all_to_all of a repartition over a mesh's members,
// one launch per destination member (ROADMAP.md B7/B8, the exchange).
//
// Replaces the exchange inside the TPU kernels
// citus_tpu/parallel/shuffle.py:62 build_repartition and :124
// build_repartition_join: after each member packs its rows into [n, C]
// send blocks (B7, csrc/partition_pack.cu), `jax.lax.all_to_all(split_axis=0,
// concat_axis=0)` hands block d of every source to member d, which then
// holds, per column, the [n * C] concatenation of its blocks in source
// order.  Here one launch fills destination d's receive buffers: block
// (source s, column c) is copied to rows [s * C, (s + 1) * C) of column
// c's buffer.  The source blocks' pointers ride the parameter block; when
// the members sit on other cards, parallel/mesh.py has first copied the
// blocks destination d needs onto d's card, so every pointer here is local.
// On one card the n launches are a block transpose of every column.
//
// Bound: bytes.  Each of destination d's n * C slots of every column is
// read once from its source block and written once; no arithmetic.  The
// design: blocks (x, y, z) take (slot range, source y, column z), threads
// neighbouring slots, so reads and writes are coalesced runs of C values.

#include <cuda_runtime.h>
#include <stdint.h>

#define MX_MAX_SRC 16
#define MX_MAX_COLS 24

// The layout is mirrored by ctypes in citus_tpu_torch/parallel/shuffle.py
// (_MxParams); change both together.
struct MxColumn {
    void* dst;                      // [n_src * capacity] on the destination
    int64_t elem;                   // bytes per value: 1, 4 or 8
    const void* src[MX_MAX_SRC];    // source s's block for this destination
};

struct MxParams {
    int64_t n_src;
    int64_t capacity;
    int64_t n_cols;
    MxColumn cols[MX_MAX_COLS];
};

__global__ void mx_kernel(const MxParams p) {
    const MxColumn& c = p.cols[blockIdx.z];
    const int64_t s = blockIdx.y;
    const int64_t base = s * p.capacity;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < p.capacity;
         i += (int64_t)gridDim.x * blockDim.x) {
        switch (c.elem) {
            case 8: ((int64_t*)c.dst)[base + i] = ((const int64_t*)c.src[s])[i]; break;
            case 4: ((int32_t*)c.dst)[base + i] = ((const int32_t*)c.src[s])[i]; break;
            default: ((uint8_t*)c.dst)[base + i] = ((const uint8_t*)c.src[s])[i]; break;
        }
    }
}

extern "C" int mesh_exchange_launch(const MxParams* p, void* stream) {
    if (p->n_src < 1 || p->n_src > MX_MAX_SRC || p->n_cols < 1
        || p->n_cols > MX_MAX_COLS || p->capacity < 1)
        return (int)cudaErrorInvalidValue;
    for (int64_t c = 0; c < p->n_cols; ++c) {
        const int64_t e = p->cols[c].elem;
        if (e != 1 && e != 4 && e != 8) return (int)cudaErrorInvalidValue;
    }
    long long blocks = (p->capacity + 255) / 256;
    if (blocks > 4096) blocks = 4096;
    dim3 grid((unsigned)blocks, (unsigned)p->n_src, (unsigned)p->n_cols);
    mx_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
}

extern "C" int mesh_exchange_params_size(void) { return (int)sizeof(MxParams); }
extern "C" int mesh_exchange_max_src(void) { return MX_MAX_SRC; }
extern "C" int mesh_exchange_max_cols(void) { return MX_MAX_COLS; }
