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
// member (kind "none").  Here every member's registers lie on the
// combining card (parallel/mesh.py moves them there first when the
// members sit on other cards), and the output is one allocation with
// each position a segment of it:
//   - "sum" adds in member order, member 0 first: int64 and int32 wrap as
//     XLA's psum does; a float sum is the same left-to-right sum on every run
//     (the fold's float atomics are not);
//   - "min" / "max" give NaN when any member holds NaN, as jnp.min / jnp.max
//     over the gathered axis do; between +0.0 and -0.0, min gives -0.0 and
//     max +0.0 whatever the members' order (XLA's comparison, checked in
//     tests/test_torch_mesh.py); a +-inf sentinel of a member that saw no
//     row loses to any real value by plain comparison;
//   - "none" copies member m's elements to row m of its [n, numel] segment.
//
// Bound: bytes.  Each member's registers are read once and the output
// written once: a few KB for a query's registers (Q1: 12 groups x 17
// positions), 31 MB for a direct fold of 65,536 groups over 4 members, so
// at a query's shapes the launch and the wrapper are most of the time.
// The design:
//   - a segment table, one 4-word record a position (kind and dtype, its
//     first block, its byte offset in a member's registers and in the
//     output, its element count), rides the parameter block as a
//     __grid_constant__ (no copy to the card, no local copy): the
//     executor's registers are one allocation a member (parallel/mesh.py
//     RegisterLayout), so a call fills only the members' base pointers
//     and the output's; registers that are separate tensors take a pointer
//     per member and position after the table;
//   - each block takes a range of one segment (its row of a 2-D grid; a
//     1-D grid whose blocks found their segment by a binary search of the
//     table cost Q1's 0.0016 ms combine 0.0004 ms more on an H100), so the
//     kind and dtype branch is the block's, never an element's;
//   - a thread takes one 16-byte vector of every member, all its loads in
//     flight before it combines them in member order;
//   - one launch for any number of positions: the parameter block grows
//     to CUDA 12.1's 32,764 bytes in three sizes (1, 8 and 32 KB of table).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define MC_MAX_MEMBERS 16
#define MC_THREADS 128
#define MC_ALIGNED (1u << 16)

enum { MC_SUM = 0, MC_MIN = 1, MC_MAX = 2, MC_NONE = 3 };
enum { MC_I64 = 0, MC_F64 = 1, MC_I32 = 2, MC_F32 = 3 };

// The layout is mirrored by parallel/mesh.py (RegisterLayout's words);
// change both together.  words: segment s at words[4s .. 4s+3]:
//   [kind | dtype << 8 | MC_ALIGNED (every access 16-byte aligned)
//    | first block << 32, in byte offset, out byte offset, numel];
// then, with `general`, the input pointers [n_segs][n_members].
template <int CAP>
struct McArgs {
    int32_t n_members;
    int32_t n_segs;
    int32_t general;
    int32_t blocks;
    char* out;
    const char* base[MC_MAX_MEMBERS];   // member m's registers (arena path)
    uint64_t words[CAP];
};

static const int kHeaderWords = 19;
static const int kMaxWords = 4000;
static_assert(sizeof(McArgs<1>) - 8 == kHeaderWords * 8, "header words");
static_assert(sizeof(McArgs<kMaxWords>) <= 32764, "CUDA's parameter limit");

template <typename T>
__device__ __forceinline__ T mc_add(T a, T b) { return a + b; }

// integer sums wrap (two's complement), as XLA's do
template <>
__device__ __forceinline__ int64_t mc_add<int64_t>(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a + (uint64_t)b);
}

template <>
__device__ __forceinline__ int32_t mc_add<int32_t>(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}

template <int KIND, typename T>
__device__ __forceinline__ T mc_pick(T a, T b) {
    return KIND == MC_MIN ? (b < a ? b : a) : (b > a ? b : a);
}

// float min/max as XLA's: NaN wins, then -0.0 < +0.0
template <int KIND, typename T>
__device__ __forceinline__ T mc_pick_float(T a, T b) {
    if (isnan(a) || isnan(b)) return (T)NAN;
    if (a == b) {
        const bool na = signbit(a);
        if (KIND == MC_MIN) return na ? a : b;
        return na ? b : a;
    }
    return KIND == MC_MIN ? (b < a ? b : a) : (b > a ? b : a);
}

template <>
__device__ __forceinline__ double mc_pick<MC_MIN, double>(double a, double b) {
    return mc_pick_float<MC_MIN>(a, b);
}
template <>
__device__ __forceinline__ double mc_pick<MC_MAX, double>(double a, double b) {
    return mc_pick_float<MC_MAX>(a, b);
}
template <>
__device__ __forceinline__ float mc_pick<MC_MIN, float>(float a, float b) {
    return mc_pick_float<MC_MIN>(a, b);
}
template <>
__device__ __forceinline__ float mc_pick<MC_MAX, float>(float a, float b) {
    return mc_pick_float<MC_MAX>(a, b);
}

template <typename T, int VEC>
__device__ __forceinline__ void mc_load(const char* p, bool vec, int cnt, T x[VEC]) {
    if (vec) {
        const int4 w = *reinterpret_cast<const int4*>(p);
        memcpy(x, &w, 16);
        return;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) x[j] = j < cnt ? reinterpret_cast<const T*>(p)[j] : T(0);
}

template <typename T, int VEC>
__device__ __forceinline__ void mc_store(char* p, bool vec, int cnt, const T x[VEC]) {
    if (vec) {
        int4 w;
        memcpy(&w, x, 16);
        *reinterpret_cast<int4*>(p) = w;
        return;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j)
        if (j < cnt) reinterpret_cast<T*>(p)[j] = x[j];
}

// one thread's vector `v` of segment `seg`: every member's elements
// loaded, then combined in member order (or stored row by row)
template <int KIND, typename T, int CAP>
__device__ __forceinline__ void mc_vector(const McArgs<CAP>& a, int seg, bool aligned,
                                          int64_t v) {
    constexpr int VEC = 16 / sizeof(T);
    const int64_t numel = (int64_t)a.words[4 * seg + 3];
    const int64_t e0 = v * VEC;
    if (e0 >= numel) return;
    const int cnt = numel - e0 < VEC ? (int)(numel - e0) : VEC;
    const bool vec = aligned && cnt == VEC;
    const int n = a.n_members;
    const int64_t in_off = (int64_t)a.words[4 * seg + 1] + e0 * (int64_t)sizeof(T);
    const int ptrs = 4 * a.n_segs + seg * n;
    // the loops leave at n (a branch the block takes together), so the
    // members past n issue nothing
    T x[MC_MAX_MEMBERS][VEC];
#pragma unroll
    for (int m = 0; m < MC_MAX_MEMBERS; ++m) {
        if (m >= n) break;
        const char* p = a.general ? (const char*)a.words[ptrs + m] + e0 * (int64_t)sizeof(T)
                                  : a.base[m] + in_off;
        mc_load<T, VEC>(p, vec, cnt, x[m]);
    }
    char* out = a.out + (int64_t)a.words[4 * seg + 2];
    if constexpr (KIND == MC_NONE) {
#pragma unroll
        for (int m = 0; m < MC_MAX_MEMBERS; ++m) {
            if (m >= n) break;
            mc_store<T, VEC>(out + (m * numel + e0) * (int64_t)sizeof(T), vec, cnt, x[m]);
        }
    } else {
#pragma unroll
        for (int m = 1; m < MC_MAX_MEMBERS; ++m) {
            if (m >= n) break;
#pragma unroll
            for (int j = 0; j < VEC; ++j)
                x[0][j] = KIND == MC_SUM ? mc_add<T>(x[0][j], x[m][j])
                                         : mc_pick<KIND, T>(x[0][j], x[m][j]);
        }
        mc_store<T, VEC>(out + e0 * (int64_t)sizeof(T), vec, cnt, x[0]);
    }
}

template <typename T, int CAP>
__device__ __forceinline__ void mc_segment(const McArgs<CAP>& a, int seg, uint32_t code,
                                           int64_t v) {
    const bool aligned = code & MC_ALIGNED;
    switch (code & 0xff) {
        case MC_SUM: mc_vector<MC_SUM, T>(a, seg, aligned, v); break;
        case MC_MIN: mc_vector<MC_MIN, T>(a, seg, aligned, v); break;
        case MC_MAX: mc_vector<MC_MAX, T>(a, seg, aligned, v); break;
        default: mc_vector<MC_NONE, T>(a, seg, aligned, v); break;
    }
}

template <int CAP>
__global__ void __launch_bounds__(MC_THREADS) mc_kernel(const __grid_constant__ McArgs<CAP> a) {
    // the grid is [blocks of the largest segment] x [segments]: the
    // block's segment is its row, and a block past a shorter segment's
    // end returns at once
    const int seg = blockIdx.y;
    const uint32_t b = blockIdx.x;   // the block's index in its segment
    const uint32_t first = (uint32_t)(a.words[4 * seg] >> 32);
    const uint32_t end = seg + 1 < a.n_segs ? (uint32_t)(a.words[4 * seg + 4] >> 32)
                                            : (uint32_t)a.blocks;
    if (b >= end - first) return;
    const uint32_t code = (uint32_t)a.words[4 * seg];
    const int64_t v = (int64_t)b * MC_THREADS + threadIdx.x;
    switch ((code >> 8) & 0xff) {
        case MC_I64: mc_segment<int64_t>(a, seg, code, v); break;
        case MC_F64: mc_segment<double>(a, seg, code, v); break;
        case MC_I32: mc_segment<int32_t>(a, seg, code, v); break;
        default: mc_segment<float>(a, seg, code, v); break;
    }
}

template <int CAP>
static int mc_launch(const uint64_t* words, int64_t n_words, cudaStream_t st) {
    McArgs<CAP> a;
    memcpy(&a, words, n_words * 8);
    // as many blocks a row as the largest segment takes
    uint32_t most = 0;
    for (int s = 0; s < a.n_segs; ++s) {
        const uint32_t end = s + 1 < a.n_segs ? (uint32_t)(a.words[4 * s + 4] >> 32)
                                              : (uint32_t)a.blocks;
        const uint32_t k = end - (uint32_t)(a.words[4 * s] >> 32);
        if (k > most) most = k;
    }
    mc_kernel<CAP><<<dim3(most, (unsigned)a.n_segs), MC_THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
}

// Launches one combine on `stream` from `words`, the parameter block as
// parallel/mesh.py builds it (header, segment table, pointers), `n_words`
// long.  Returns the CUDA error of the launch.
extern "C" int mesh_combine_launch(const uint64_t* words, int64_t n_words, void* stream) {
    if (n_words < kHeaderWords || n_words > kHeaderWords + kMaxWords)
        return (int)cudaErrorInvalidValue;
    const int32_t n = (int32_t)words[0], n_segs = (int32_t)(words[0] >> 32);
    const int32_t general = (int32_t)words[1], blocks = (int32_t)(words[1] >> 32);
    const int64_t table = kHeaderWords + 4 * (int64_t)n_segs;
    if (n < 1 || n > MC_MAX_MEMBERS || n_segs < 1 || blocks < 0
        || n_words != table + (general ? (int64_t)n_segs * n : 0))
        return (int)cudaErrorInvalidValue;
    for (int s = 0; s < n_segs; ++s) {
        const uint64_t w = words[kHeaderWords + 4 * s];
        if ((w & 0xff) > MC_NONE || ((w >> 8) & 0xff) > MC_F32 || (int64_t)words[kHeaderWords + 4 * s + 3] < 0)
            return (int)cudaErrorInvalidValue;
    }
    if (blocks == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t used = n_words - kHeaderWords;
    if (used <= 128) return mc_launch<128>(words, n_words, st);
    if (used <= 1024) return mc_launch<1024>(words, n_words, st);
    return mc_launch<kMaxWords>(words, n_words, st);
}

extern "C" int mesh_combine_header_words(void) { return kHeaderWords; }
extern "C" int mesh_combine_max_words(void) { return kMaxWords; }
extern "C" int mesh_combine_max_members(void) { return MC_MAX_MEMBERS; }
extern "C" int mesh_combine_threads(void) { return MC_THREADS; }
