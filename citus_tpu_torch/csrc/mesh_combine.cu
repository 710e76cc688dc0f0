// mesh_combine: the partial-aggregate registers of a mesh's members
// combined into one set, in one launch for every partial position
// (ROADMAP.md B6).
//
// Replaces the collective half of the TPU kernel
// citus_tpu/parallel/mesh.py:46 sharded_partial_agg (the executor's
// `mesh_run` slot, citus_tpu/executor/executor.py:332-336): after each
// member folds its batch, position i of the partial tuple is combined over
// the shard axis by `psum` (kind "sum"), by `all_gather` and then
// `jnp.min` / `jnp.max` (kinds "min" / "max"), or returned stacked per
// member (kind "none").  Here every member's registers are a separate
// buffer on the combining card (parallel/mesh.py moves them there first
// when the members sit on other cards), and one thread makes one output
// element from the n members' elements:
//   - "sum" adds in member order, member 0 first: int64 and int32 wrap as
//     XLA's psum does; a float sum is the same left-to-right sum on every run
//     (the fold's float atomics are not);
//   - "min" / "max" give NaN when any member holds NaN, as jnp.min / jnp.max
//     over the gathered axis do; between +0.0 and -0.0, min gives -0.0 and
//     max +0.0 whatever the members' order (XLA's comparison, checked in
//     tests/test_torch_mesh.py); a +-inf sentinel of a member that saw no
//     row loses to any real value by plain comparison;
//   - "none" copies member m's elements to rows m of the [n, numel] output.
//
// Bound: bytes.  Each member's registers are read once and the output
// written once; one comparison or add per element and member.  At a
// query's register shapes (Q1: 12 groups x 13 positions; a direct fold of
// 65,536 groups) that is a few KB to a few MB, so the launch itself is most
// of the time: the design is the plain one, one launch whose blocks take
// (position, element range), the members' pointers and each position's
// kind and type riding the parameter block.

#include <cuda_runtime.h>
#include <stdint.h>

#define MC_MAX_MEMBERS 16
#define MC_MAX_POS 24

enum { MC_SUM = 0, MC_MIN = 1, MC_MAX = 2, MC_NONE = 3 };
enum { MC_I64 = 0, MC_F64 = 1, MC_I32 = 2, MC_F32 = 3 };

// The layout is mirrored by ctypes in citus_tpu_torch/parallel/mesh.py
// (_McParams); change both together.
struct McPos {
    int32_t kind;                      // MC_SUM .. MC_NONE
    int32_t dtype;                     // MC_I64, MC_F64, MC_I32, MC_F32
    int64_t numel;                     // elements of one member's buffer
    void* out;                         // [numel], or [n_members, numel]
    const void* in[MC_MAX_MEMBERS];    // member m's [numel] buffer
};

struct McParams {
    int64_t n_members;
    int64_t n_pos;
    McPos pos[MC_MAX_POS];
};

template <typename T>
__device__ inline T mc_pick(int kind, T a, T b) {
    return kind == MC_MIN ? (b < a ? b : a) : (b > a ? b : a);
}

// float min/max as XLA's: NaN wins, then -0.0 < +0.0
__device__ inline double mc_pick(int kind, double a, double b) {
    if (isnan(a) || isnan(b)) return __longlong_as_double(0x7ff8000000000000LL);
    if (a == b) {
        const bool na = signbit(a);
        if (kind == MC_MIN) return na ? a : b;
        return na ? b : a;
    }
    return kind == MC_MIN ? (b < a ? b : a) : (b > a ? b : a);
}

__device__ inline float mc_pick(int kind, float a, float b) {
    if (isnan(a) || isnan(b)) return __int_as_float(0x7fc00000);
    if (a == b) {
        const bool na = signbit(a);
        if (kind == MC_MIN) return na ? a : b;
        return na ? b : a;
    }
    return kind == MC_MIN ? (b < a ? b : a) : (b > a ? b : a);
}

template <typename T>
__device__ inline void mc_element(const McPos& q, int64_t n, int64_t i) {
    const T* const* in = (const T* const*)q.in;
    T* out = (T*)q.out;
    if (q.kind == MC_NONE) {
        for (int64_t m = 0; m < n; ++m) out[m * q.numel + i] = in[m][i];
        return;
    }
    T acc = in[0][i];
    if (q.kind == MC_SUM) {
        for (int64_t m = 1; m < n; ++m) acc = acc + in[m][i];
    } else {
        for (int64_t m = 1; m < n; ++m) acc = mc_pick(q.kind, acc, in[m][i]);
    }
    out[i] = acc;
}

// integer sums wrap (two's complement), as XLA's do
template <>
__device__ inline void mc_element<int64_t>(const McPos& q, int64_t n, int64_t i) {
    const int64_t* const* in = (const int64_t* const*)q.in;
    int64_t* out = (int64_t*)q.out;
    if (q.kind == MC_NONE) {
        for (int64_t m = 0; m < n; ++m) out[m * q.numel + i] = in[m][i];
        return;
    }
    int64_t acc = in[0][i];
    if (q.kind == MC_SUM) {
        for (int64_t m = 1; m < n; ++m)
            acc = (int64_t)((uint64_t)acc + (uint64_t)in[m][i]);
    } else {
        for (int64_t m = 1; m < n; ++m) acc = mc_pick(q.kind, acc, in[m][i]);
    }
    out[i] = acc;
}

template <>
__device__ inline void mc_element<int32_t>(const McPos& q, int64_t n, int64_t i) {
    const int32_t* const* in = (const int32_t* const*)q.in;
    int32_t* out = (int32_t*)q.out;
    if (q.kind == MC_NONE) {
        for (int64_t m = 0; m < n; ++m) out[m * q.numel + i] = in[m][i];
        return;
    }
    int32_t acc = in[0][i];
    if (q.kind == MC_SUM) {
        for (int64_t m = 1; m < n; ++m)
            acc = (int32_t)((uint32_t)acc + (uint32_t)in[m][i]);
    } else {
        for (int64_t m = 1; m < n; ++m) acc = mc_pick(q.kind, acc, in[m][i]);
    }
    out[i] = acc;
}

// block (x, y): position y, elements x, x + gridDim.x, ... (in blocks)
__global__ void mc_kernel(const McParams p) {
    const McPos& q = p.pos[blockIdx.y];
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < q.numel;
         i += (int64_t)gridDim.x * blockDim.x) {
        switch (q.dtype) {
            case MC_I64: mc_element<int64_t>(q, p.n_members, i); break;
            case MC_F64: mc_element<double>(q, p.n_members, i); break;
            case MC_F32: mc_element<float>(q, p.n_members, i); break;
            default: mc_element<int32_t>(q, p.n_members, i); break;
        }
    }
}

extern "C" int mesh_combine_launch(const McParams* p, void* stream) {
    if (p->n_members < 1 || p->n_members > MC_MAX_MEMBERS || p->n_pos < 1
        || p->n_pos > MC_MAX_POS)
        return (int)cudaErrorInvalidValue;
    int64_t most = 1;
    for (int64_t k = 0; k < p->n_pos; ++k) {
        const McPos& q = p->pos[k];
        if (q.kind < MC_SUM || q.kind > MC_NONE || q.dtype < MC_I64
            || q.dtype > MC_F32 || q.numel < 0)
            return (int)cudaErrorInvalidValue;
        if (q.numel > most) most = q.numel;
    }
    long long blocks = (most + 255) / 256;
    if (blocks > 1024) blocks = 1024;
    dim3 grid((unsigned)blocks, (unsigned)p->n_pos);
    mc_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
}

extern "C" int mesh_combine_params_size(void) { return (int)sizeof(McParams); }
extern "C" int mesh_combine_max_members(void) { return MC_MAX_MEMBERS; }
extern "C" int mesh_combine_max_pos(void) { return MC_MAX_POS; }
