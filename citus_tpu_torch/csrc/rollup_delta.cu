// rollup_delta: the per-group partial states of one CDC delta batch, the
// rollup refresh's device step, in one launch per aggregate.
//
// Replaces: the JAX package's rollup kernel family,
// citus_tpu/rollup/kernels.py:47 _build (jitted per (kind, n, G) under
// GLOBAL_KERNELS[("rollup", kind, n, g)]) driven by :92 delta_partials --
// a scatter (.at[].add / .at[].max) of one padded delta batch into
// per-group tables, for six kinds:
//   count      out[g] += 1                      int64 [G]
//   sum_int    out[g] += v                      int64 [G] (wraps)
//   sum_float  out[g] += v                      float64 [G]
//   hll        out[g, b] = max(out[g, b], rho)  int32 [G, 128]
//   ddsk       out[g, b] += 1                   int64 [G, 2048]
//   topk       rec[g, b] = (count + 1, max(value, v))
//                                               int64 [G, 1024, 2]
// over the rows with ok[i] set (a padding row or a NULL value has ok
// false and changes nothing), g = gidx[i], b the row's bucket from
// sketch.cuh (the same bucket functions as the scan fold, so rollup and
// raw-scan estimates agree).  A row whose g is not below G changes
// nothing.  The wrapper (rollup/kernels.py) allocates the table and pads
// n and G to powers of two, as the reference does; the launch fills it.
//
// What bounds it on an H100: the batch's bytes (13-17 B a row) and the
// table's, written once: 0.03 ms for a 2^23-row backfill batch, 0.08 ms
// for a 16,384-group DDSketch or top-k table.  The design:
//   - one kernel per kind (a template), no switch a row;
//   - a thread takes 4 consecutive rows: 4 group ids in one 16-byte load,
//     4 ok bytes in one word, the values in two 16-byte loads, where the
//     batch is whole and aligned (else a row at a time);
//   - direct regime (a refresh batch, the sketch kinds): one global
//     atomic without a return a row (top-k: two on one record); hll,
//     DDSketch and top-k at 2^23 rows are bound by the atomics themselves
//     (L2's rate on hll's 8 MB table, random read-modify-writes of top-k's
//     records spread over 164 MB).  Two choices were timed on an H100
//     (scripts/kernel_variants.py --only B9) and left out: the lanes of a
//     warp on one cell folded by __match_any_sync first, which made a
//     uniform 65,536-row refresh batch's count and sums slower and wins
//     only where a warp's rows share a group, which the rollup's CDC
//     batches were not shown to do; and hll's and top-k's register read
//     first, an atomic only where the row raises it, slower at 2^23 rows,
//     a fresh table's registers being raised by nearly every row;
//   - privatized regime (count and sums when rows far outnumber groups,
//     the backfill): a block folds its rows into the [G] table in its
//     shared memory (128 KB at G = 16,384), then flushes its nonzero
//     slots by global atomics into the zeroed table (writing it as the
//     block's partial row, summed in block order by a second pass, was
//     slower on an H100 at 2^23 rows);
//   - top-k's count and maximum of a cell are one 16-byte record, so a
//     row touches one line of the table, not one in each of two tables;
//     its fill is one launch of 16-byte stores, the others' a memset.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sketch.cuh"

#define RD_COUNT 0
#define RD_SUM_INT 1
#define RD_SUM_FLOAT 2
#define RD_HLL 3
#define RD_DDSK 4
#define RD_TOPK 5

#define RD_DIRECT 0
#define RD_PRIVATE 1

static const int kDirectThreads = 256;
static const int kPrivateThreads = 1024;
static const int kMaxDevices = 64;
// a block's shared table in the privatized regime, at most
static const int64_t kPrivateMaxBytes = 200 * 1024;

// ------------------------------------------------------------------ rows

// Rows 4q .. 4q+3: group ids, ok flags and value bits (int64, or a
// float64's bits); rows at or past n are not ok.
template <int K>
__device__ __forceinline__ void load_quad(int64_t q, int64_t n, bool vec,
                                          const long long* vals,
                                          const int32_t* gidx,
                                          const uint8_t* ok, int32_t g[4],
                                          bool m[4], long long v[4]) {
    if (vec) {
        const int4 gg = __ldcs(reinterpret_cast<const int4*>(gidx) + q);
        const unsigned int oo = __ldcs(reinterpret_cast<const unsigned int*>(ok) + q);
        g[0] = gg.x; g[1] = gg.y; g[2] = gg.z; g[3] = gg.w;
#pragma unroll
        for (int r = 0; r < 4; ++r) m[r] = (oo >> (8 * r)) & 0xff;
        if (K != RD_COUNT) {
            const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(vals) + 2 * q);
            const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(vals) + 2 * q + 1);
            v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
        } else {
            v[0] = v[1] = v[2] = v[3] = 0;
        }
        return;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int64_t i = 4 * q + r;
        const bool in = i < n;
        g[r] = in ? gidx[i] : 0;
        m[r] = in && ok[i];
        v[r] = (in && K != RD_COUNT) ? vals[i] : 0;
    }
}

// the row's cell of the kind's table and the value it folds there: the
// summand (sums), rho (hll), the value bits (top-k), unused (counts)
template <int K>
__device__ __forceinline__ int64_t cell_of(int32_t g, long long bits, long long* val) {
    *val = bits;
    if (K == RD_HLL) {
        int b, rho;
        hll_bucket_rho(bits, &b, &rho);
        *val = rho;
        return (int64_t)g * HLL_M + b;
    }
    if (K == RD_DDSK) return (int64_t)g * DDSK_M + ddsk_bucket(__longlong_as_double(bits));
    if (K == RD_TOPK) return (int64_t)g * TOPK_M + topk_bucket(bits);
    return g;
}

// ---------------------------------------------------- the direct regime

// One row: its cell of the table updated by one global atomic without a
// return (top-k: two, on the one 16-byte record of the cell).
template <int K>
__device__ __forceinline__ void direct_update(int64_t cell, long long val, void* out) {
    switch (K) {
        case RD_COUNT:
        case RD_DDSK:
            atomicAdd((unsigned long long*)out + cell, 1ull);
            break;
        case RD_SUM_INT:
            atomicAdd((unsigned long long*)out + cell, (unsigned long long)val);
            break;
        case RD_SUM_FLOAT:
            atomicAdd((double*)out + cell, __longlong_as_double(val));
            break;
        case RD_HLL:
            atomicMax((int*)out + cell, (int)val);
            break;
        default: {
            long long* rec = (long long*)out + 2 * cell;
            atomicAdd((unsigned long long*)rec, 1ull);
            atomicMax(rec + 1, val);
        }
    }
}

template <int K>
__global__ void __launch_bounds__(kDirectThreads)
rd_direct(int64_t n, int64_t groups, bool vec, const long long* vals,
          const int32_t* gidx, const uint8_t* ok, void* out) {
    const int64_t quads = (n + 3) >> 2;
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < quads; q += step) {
        int32_t g[4];
        bool m[4];
        long long v[4];
        load_quad<K>(q, n, vec, vals, gidx, ok, g, m, v);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            if (!m[r] || (uint32_t)g[r] >= (uint64_t)groups) continue;
            long long val;
            const int64_t cell = cell_of<K>(g[r], v[r], &val);
            direct_update<K>(cell, val, out);
        }
    }
}

// ------------------------------------------------ the privatized regime

template <int K>
__global__ void __launch_bounds__(kPrivateThreads)
rd_private(int64_t n, int32_t groups, bool vec, const long long* vals,
           const int32_t* gidx, const uint8_t* ok, unsigned long long* out) {
    extern __shared__ unsigned long long tab[];
    for (int s = threadIdx.x; s < groups; s += blockDim.x) tab[s] = 0;
    __syncthreads();
    const int64_t quads = (n + 3) >> 2;
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < quads; q += step) {
        int32_t g[4];
        bool m[4];
        long long v[4];
        load_quad<K>(q, n, vec, vals, gidx, ok, g, m, v);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            if (!m[r] || (uint32_t)g[r] >= (uint32_t)groups) continue;
            if (K == RD_COUNT) atomicAdd(&tab[g[r]], 1ull);
            else if (K == RD_SUM_INT) atomicAdd(&tab[g[r]], (unsigned long long)v[r]);
            else atomicAdd((double*)&tab[g[r]], __longlong_as_double(v[r]));
        }
    }
    __syncthreads();
    // a slot left at 0 (+0.0) adds nothing: the table starts at 0 and a
    // float sum into it never becomes -0.0
    for (int s = threadIdx.x; s < groups; s += blockDim.x) {
        const unsigned long long x = tab[s];
        if (x == 0) continue;
        if (K == RD_SUM_FLOAT) atomicAdd((double*)out + s, __longlong_as_double(x));
        else atomicAdd(out + s, x);
    }
}

// ------------------------------------------------------------- the fill

// top-k's empty records: (0, INT64_MIN) by 16-byte stores
__global__ void __launch_bounds__(kDirectThreads) rd_fill_topk(int64_t cells, longlong2* rec) {
    const longlong2 empty = make_longlong2(0, TOPK_SENTINEL);
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < cells;
         i += (int64_t)gridDim.x * blockDim.x)
        rec[i] = empty;
}

// -------------------------------------------------------------- launches

struct RdDevice {
    int sms;
    int smem_per_sm;
    bool smem_set[3];
};

// the current card's SM count and shared memory, queried once a card
static RdDevice* rd_device() {
    static RdDevice devices[kMaxDevices];
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return nullptr;
    RdDevice* d = &devices[dev];
    if (d->sms == 0) {
        cudaDeviceGetAttribute(&d->smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
        cudaDeviceGetAttribute(&d->sms, cudaDevAttrMultiProcessorCount, dev);
    }
    return d;
}

static int private_blocks(const RdDevice* d, int64_t n, int64_t groups) {
    const int64_t bytes = groups * 8 + 1024;
    int per_sm = (int)(d->smem_per_sm / bytes);
    if (per_sm > 2048 / kPrivateThreads) per_sm = 2048 / kPrivateThreads;
    if (per_sm < 1) per_sm = 1;
    int64_t blocks = (int64_t)d->sms * per_sm;
    const int64_t most = ((n + 3) / 4 + kPrivateThreads - 1) / kPrivateThreads;
    if (blocks > most) blocks = most;
    return blocks < 1 ? 1 : (int)blocks;
}

static int64_t cells_of(int kind, int64_t groups) {
    return groups * (kind == RD_HLL ? HLL_M : kind == RD_DDSK ? DDSK_M : kind == RD_TOPK ? TOPK_M : 1);
}

template <int K>
static void launch_direct(const RdDevice* d, int64_t n, int64_t groups, bool vec,
                          const long long* vals, const int32_t* gidx, const uint8_t* ok,
                          void* out, cudaStream_t st) {
    const int64_t quads = (n + 3) / 4;
    int64_t blocks = (quads + kDirectThreads - 1) / kDirectThreads;
    if (blocks > (int64_t)d->sms * 16) blocks = (int64_t)d->sms * 16;
    rd_direct<K><<<(unsigned)blocks, kDirectThreads, 0, st>>>(n, groups, vec, vals, gidx, ok, out);
}

template <int K>
static int launch_private(RdDevice* d, int64_t n, int32_t groups, bool vec,
                          const long long* vals, const int32_t* gidx, const uint8_t* ok,
                          unsigned long long* out, cudaStream_t st) {
    const int bytes = groups * 8;
    if (!d->smem_set[K]) {
        cudaError_t err = cudaFuncSetAttribute(rd_private<K>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)kPrivateMaxBytes);
        if (err != cudaSuccess) return (int)err;
        d->smem_set[K] = true;
    }
    rd_private<K><<<private_blocks(d, n, groups), kPrivateThreads, bytes, st>>>(
        n, groups, vec, vals, gidx, ok, out);
    return 0;
}

// Launches one delta fold on `stream` in `regime` (RD_DIRECT, or
// RD_PRIVATE for count and the sums): `vals` [n] (int64 for sum_int, hll
// and topk, where it holds the value bits; float64 for sum_float and
// ddsk; unused for count), `gidx` [n] int32 group indexes, `ok` [n] bool,
// `out` the kind's table of `groups` groups.  With `fill` the launch first
// sets the table empty.  Returns the CUDA error of the launch.
extern "C" int rollup_delta_launch(int kind, int regime, int64_t n, int64_t groups,
                                   const void* vals, const int32_t* gidx, const uint8_t* ok,
                                   void* out, int fill, void* stream) {
    if (kind < RD_COUNT || kind > RD_TOPK || regime < RD_DIRECT || regime > RD_PRIVATE
        || groups < 1 || n < 0
        || (regime == RD_PRIVATE && (kind > RD_SUM_FLOAT || groups * 8 > kPrivateMaxBytes)))
        return (int)cudaErrorInvalidValue;
    RdDevice* d = rd_device();
    if (d == nullptr) return (int)cudaErrorInvalidDevice;
    cudaStream_t st = (cudaStream_t)stream;
    if (fill) {
        const int64_t cells = cells_of(kind, groups);
        if (kind == RD_TOPK) {
            int64_t blocks = (cells + kDirectThreads - 1) / kDirectThreads;
            if (blocks > (int64_t)d->sms * 16) blocks = (int64_t)d->sms * 16;
            rd_fill_topk<<<(unsigned)blocks, kDirectThreads, 0, st>>>(cells, (longlong2*)out);
        } else {
            cudaError_t err = cudaMemsetAsync(out, 0, cells * (kind == RD_HLL ? 4 : 8), st);
            if (err != cudaSuccess) return (int)err;
        }
    }
    if (n == 0) return (int)cudaGetLastError();
    const long long* v = (const long long*)vals;
    const bool vec = n % 4 == 0 && ((uintptr_t)gidx & 15) == 0 && ((uintptr_t)ok & 3) == 0
                     && (kind == RD_COUNT || ((uintptr_t)vals & 15) == 0);
    unsigned long long* o = (unsigned long long*)out;
    int err = 0;
    if (regime == RD_PRIVATE) {
        switch (kind) {
            case RD_COUNT: err = launch_private<RD_COUNT>(d, n, (int32_t)groups, vec, v, gidx, ok, o, st); break;
            case RD_SUM_INT: err = launch_private<RD_SUM_INT>(d, n, (int32_t)groups, vec, v, gidx, ok, o, st); break;
            default: err = launch_private<RD_SUM_FLOAT>(d, n, (int32_t)groups, vec, v, gidx, ok, o, st); break;
        }
        if (err != 0) return err;
        return (int)cudaGetLastError();
    }
    switch (kind) {
        case RD_COUNT: launch_direct<RD_COUNT>(d, n, groups, vec, v, gidx, ok, out, st); break;
        case RD_SUM_INT: launch_direct<RD_SUM_INT>(d, n, groups, vec, v, gidx, ok, out, st); break;
        case RD_SUM_FLOAT: launch_direct<RD_SUM_FLOAT>(d, n, groups, vec, v, gidx, ok, out, st); break;
        case RD_HLL: launch_direct<RD_HLL>(d, n, groups, vec, v, gidx, ok, out, st); break;
        case RD_DDSK: launch_direct<RD_DDSK>(d, n, groups, vec, v, gidx, ok, out, st); break;
        default: launch_direct<RD_TOPK>(d, n, groups, vec, v, gidx, ok, out, st); break;
    }
    return (int)cudaGetLastError();
}
