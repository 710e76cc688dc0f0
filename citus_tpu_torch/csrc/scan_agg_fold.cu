// scan_agg_fold: one batch of the scan -> filter -> partial-aggregate
// hot loop, folded into running per-group registers, in one launch.
//
// Replaces: the reduction and the running merge of the JAX package's
// fused worker, citus_tpu/ops/scan_agg.py:43 build_worker_fn (scalar and
// direct modes) and :277 build_fused_worker_fn, jitted under the
// executor's `jit_fused` slot.  The filter and the argument expressions
// stay plain tensor code in this slice (planner/bound.py compile_expr);
// the kernel takes their results.
//
// What it computes, for rows with mask[i] set:
//   gid  = sum_k clip((key_k - lo_k) // step_k + 1, 0) * stride_k, with a
//          NULL key coding 0, clamped to [0, G-1]   (scan_agg.py:189-206)
//   ok   = mask & valid(arg)
//   acc[op][gid] (+)= value cast to the accumulator type, for count(*),
//          count, sum, min, max; rows[gid] += 1 in direct mode.
// int64 sums wrap in two's complement as XLA's do (the float64 shadow
// sum of the planner detects overflow); float min/max propagate NaN as
// jnp.minimum does; groups that see no row keep their sentinels.
//
// What bounds it on an H100: memory.  Each row is read once -- the mask,
// the key and argument columns with their validity bytes (about 51 B a
// row for TPC-H Q1, bench.py Q1_BYTES_PER_ROW) -- against 3.35 TB/s;
// the arithmetic per row is a few integer operations and one atomic per
// partial op.  The design serves that bound with one pass over the
// inputs, a block-private group table in shared memory when
// G * (ops + 1) * 8 B fits (merged into the registers with one atomic per
// non-empty slot at the end of the block), global atomics otherwise, and
// no intermediate written to device memory.  Warp-level pre-aggregation
// and 16-byte vector loads are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define SAF_MAX_KEYS 8
#define SAF_MAX_ARGS 32
#define SAF_MAX_OPS 32

// value dtypes
#define SAF_U8 0   // bool or uint8
#define SAF_I32 1
#define SAF_I64 2
#define SAF_F32 3
#define SAF_F64 4

// partial-op kinds
#define SAF_COUNT_STAR 0
#define SAF_COUNT 1
#define SAF_SUM 2
#define SAF_MIN 3
#define SAF_MAX 4

struct SafCol {
    const void* data;       // [n] or [1] values
    const uint8_t* valid;   // [n] or [1] bool, or null = all valid
    int64_t data_stride;    // 1, or 0 for a broadcast constant
    int64_t valid_stride;
    int32_t dtype;
    int32_t pad;
};

struct SafParams {
    int64_t n;
    int64_t n_groups;
    const uint8_t* mask;    // [n] bool
    int32_t n_keys;
    int32_t n_args;
    int32_t n_ops;
    int32_t pad;
    SafCol keys[SAF_MAX_KEYS];
    int64_t key_lo[SAF_MAX_KEYS];
    int64_t key_step[SAF_MAX_KEYS];
    int64_t key_stride[SAF_MAX_KEYS];
    SafCol args[SAF_MAX_ARGS];
    int32_t op_kind[SAF_MAX_OPS];
    int32_t op_arg[SAF_MAX_OPS];
    int32_t op_dtype[SAF_MAX_OPS];   // accumulator dtype
    void* acc[SAF_MAX_OPS];          // [G] each
    long long* rows;                 // [G] int64, or null (scalar mode)
};

// ------------------------------------------------------------ loads

__device__ __forceinline__ long long load_i64(const SafCol& c, int64_t i) {
    int64_t j = i * c.data_stride;
    switch (c.dtype) {
        case SAF_U8: return (long long)((const uint8_t*)c.data)[j];
        case SAF_I32: return (long long)((const int32_t*)c.data)[j];
        case SAF_I64: return ((const long long*)c.data)[j];
        case SAF_F32: return (long long)((const float*)c.data)[j];
        default: return (long long)((const double*)c.data)[j];
    }
}

__device__ __forceinline__ double load_f64(const SafCol& c, int64_t i) {
    int64_t j = i * c.data_stride;
    switch (c.dtype) {
        case SAF_U8: return (double)((const uint8_t*)c.data)[j];
        case SAF_I32: return (double)((const int32_t*)c.data)[j];
        case SAF_I64: return (double)((const long long*)c.data)[j];
        case SAF_F32: return (double)((const float*)c.data)[j];
        default: return ((const double*)c.data)[j];
    }
}

__device__ __forceinline__ float load_f32(const SafCol& c, int64_t i) {
    int64_t j = i * c.data_stride;
    switch (c.dtype) {
        case SAF_U8: return (float)((const uint8_t*)c.data)[j];
        case SAF_I32: return (float)((const int32_t*)c.data)[j];
        case SAF_I64: return (float)((const long long*)c.data)[j];
        case SAF_F32: return ((const float*)c.data)[j];
        default: return (float)((const double*)c.data)[j];
    }
}

__device__ __forceinline__ bool is_valid(const SafCol& c, int64_t i) {
    return c.valid == nullptr || c.valid[i * c.valid_stride] != 0;
}

// ------------------------------------------------------------ atomics

// float min/max that propagate NaN (jnp.minimum / jnp.maximum): once a
// slot holds NaN it stays NaN, and a NaN update always lands
__device__ __forceinline__ void atomic_min_f64(double* p, double v) {
    unsigned long long* a = (unsigned long long*)p;
    unsigned long long old = *a, assumed;
    do {
        assumed = old;
        double cur = __longlong_as_double((long long)assumed);
        if (cur != cur) return;
        if (!(v != v) && !(v < cur)) return;
        old = atomicCAS(a, assumed, (unsigned long long)__double_as_longlong(v));
    } while (old != assumed);
}

__device__ __forceinline__ void atomic_max_f64(double* p, double v) {
    unsigned long long* a = (unsigned long long*)p;
    unsigned long long old = *a, assumed;
    do {
        assumed = old;
        double cur = __longlong_as_double((long long)assumed);
        if (cur != cur) return;
        if (!(v != v) && !(v > cur)) return;
        old = atomicCAS(a, assumed, (unsigned long long)__double_as_longlong(v));
    } while (old != assumed);
}

__device__ __forceinline__ void atomic_min_f32(float* p, float v) {
    unsigned int* a = (unsigned int*)p;
    unsigned int old = *a, assumed;
    do {
        assumed = old;
        float cur = __uint_as_float(assumed);
        if (cur != cur) return;
        if (!(v != v) && !(v < cur)) return;
        old = atomicCAS(a, assumed, __float_as_uint(v));
    } while (old != assumed);
}

__device__ __forceinline__ void atomic_max_f32(float* p, float v) {
    unsigned int* a = (unsigned int*)p;
    unsigned int old = *a, assumed;
    do {
        assumed = old;
        float cur = __uint_as_float(assumed);
        if (cur != cur) return;
        if (!(v != v) && !(v > cur)) return;
        old = atomicCAS(a, assumed, __float_as_uint(v));
    } while (old != assumed);
}

// min/max/add of one operand into a register, by accumulator type
__device__ __forceinline__ void combine_i64(int kind, long long* p, long long v) {
    if (kind == SAF_MIN) atomicMin(p, v);
    else if (kind == SAF_MAX) atomicMax(p, v);
    else atomicAdd((unsigned long long*)p, (unsigned long long)v);
}

__device__ __forceinline__ void combine_i32(int kind, int* p, int v) {
    if (kind == SAF_MIN) atomicMin(p, v);
    else if (kind == SAF_MAX) atomicMax(p, v);
    else atomicAdd(p, v);
}

__device__ __forceinline__ void combine_f64(int kind, double* p, double v) {
    if (kind == SAF_MIN) atomic_min_f64(p, v);
    else if (kind == SAF_MAX) atomic_max_f64(p, v);
    else atomicAdd(p, v);
}

__device__ __forceinline__ void combine_f32(int kind, float* p, float v) {
    if (kind == SAF_MIN) atomic_min_f32(p, v);
    else if (kind == SAF_MAX) atomic_max_f32(p, v);
    else atomicAdd(p, v);
}

// the identity of a slot, as its 8 raw bytes (the first 4 for 4-byte types)
__device__ __forceinline__ unsigned long long identity_bits(int kind, int dtype) {
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

// fold one valid row of op `o` into the 8-byte slot at `slot`
__device__ __forceinline__ void fold_row(const SafParams& p, int o, void* slot, int64_t i) {
    int kind = p.op_kind[o];
    int dt = p.op_dtype[o];
    if (kind == SAF_COUNT_STAR || kind == SAF_COUNT) {
        atomicAdd((unsigned long long*)slot, 1ull);
        return;
    }
    const SafCol& a = p.args[p.op_arg[o]];
    switch (dt) {
        case SAF_I64: combine_i64(kind, (long long*)slot, load_i64(a, i)); break;
        case SAF_I32: combine_i32(kind, (int*)slot, (int)load_i64(a, i)); break;
        case SAF_F32: combine_f32(kind, (float*)slot, load_f32(a, i)); break;
        default: combine_f64(kind, (double*)slot, load_f64(a, i)); break;
    }
}

__device__ __forceinline__ int op_width(const SafParams& p, int o) {
    int k = p.op_kind[o];
    if (k == SAF_COUNT_STAR || k == SAF_COUNT) return 8;
    int dt = p.op_dtype[o];
    return (dt == SAF_I32 || dt == SAF_F32) ? 4 : 8;
}

// merge one reduced shared-memory slot into the global register
__device__ __forceinline__ void merge_slot(const SafParams& p, int o, int64_t g,
                                           const unsigned long long* s) {
    int kind = p.op_kind[o];
    int dt = p.op_dtype[o];
    if (kind == SAF_COUNT_STAR || kind == SAF_COUNT) {
        atomicAdd((unsigned long long*)p.acc[o] + g, *s);
        return;
    }
    switch (dt) {
        case SAF_I64: combine_i64(kind, (long long*)p.acc[o] + g, *(const long long*)s); break;
        case SAF_I32: combine_i32(kind, (int*)p.acc[o] + g, *(const int*)s); break;
        case SAF_F32: combine_f32(kind, (float*)p.acc[o] + g, *(const float*)s); break;
        default: combine_f64(kind, (double*)p.acc[o] + g, *(const double*)s); break;
    }
}

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
    int64_t q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
    return q;
}

__device__ __forceinline__ int64_t group_of(const SafParams& p, int64_t i) {
    // unsigned arithmetic: wraps like the reference's int64 lanes
    unsigned long long gid = 0;
    for (int k = 0; k < p.n_keys; ++k) {
        const SafCol& c = p.keys[k];
        long long code = 0;
        if (is_valid(c, i)) {
            long long d = (long long)((unsigned long long)load_i64(c, i)
                                      - (unsigned long long)p.key_lo[k]);
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

// ------------------------------------------------------------ kernels

// shared-memory regime: a block-private [slots][G] table of 8-byte slots
__global__ void fold_shared(const SafParams p) {
    extern __shared__ unsigned long long table[];
    const int64_t G = p.n_groups;
    const int n_slots = p.n_ops + (p.rows != nullptr ? 1 : 0);
    for (int64_t t = threadIdx.x; t < G * n_slots; t += blockDim.x) {
        int s = (int)(t / G);
        table[t] = s < p.n_ops ? identity_bits(p.op_kind[s], p.op_dtype[s]) : 0ull;
    }
    __syncthreads();
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < p.n; i += step) {
        if (!p.mask[i]) continue;
        int64_t g = group_of(p, i);
        for (int o = 0; o < p.n_ops; ++o) {
            if (p.op_kind[o] != SAF_COUNT_STAR && !is_valid(p.args[p.op_arg[o]], i)) continue;
            fold_row(p, o, &table[(int64_t)o * G + g], i);
        }
        if (p.rows != nullptr) atomicAdd(&table[(int64_t)p.n_ops * G + g], 1ull);
    }
    __syncthreads();
    for (int64_t t = threadIdx.x; t < G * n_slots; t += blockDim.x) {
        int s = (int)(t / G);
        int64_t g = t - (int64_t)s * G;
        if (s == p.n_ops) {
            if (table[t] != 0ull) atomicAdd((unsigned long long*)p.rows + g, table[t]);
            continue;
        }
        unsigned long long id = identity_bits(p.op_kind[s], p.op_dtype[s]);
        unsigned long long v = table[t];
        if (op_width(p, s) == 4) { v &= 0xffffffffull; id &= 0xffffffffull; }
        if (v != id) merge_slot(p, s, g, &table[t]);
    }
}

// global regime: every valid row updates the registers directly
__global__ void fold_global(const SafParams p) {
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < p.n; i += step) {
        if (!p.mask[i]) continue;
        int64_t g = group_of(p, i);
        for (int o = 0; o < p.n_ops; ++o) {
            if (p.op_kind[o] != SAF_COUNT_STAR && !is_valid(p.args[p.op_arg[o]], i)) continue;
            int w = op_width(p, o);
            fold_row(p, o, (char*)p.acc[o] + g * w, i);
        }
        if (p.rows != nullptr) atomicAdd((unsigned long long*)p.rows + g, 1ull);
    }
}

// ------------------------------------------------------------ launch

static const int kThreads = 256;

// Launches one fold of `p` on `stream`.  *regime is set to 1 for the
// shared-memory table, 0 for global atomics.  Returns the CUDA error of
// the launch (0 = cudaSuccess); the kernel runs asynchronously.
extern "C" int scan_agg_fold_launch(const SafParams* p, void* stream, int* regime) {
    if (p->n <= 0) { *regime = -1; return 0; }
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, smem_optin = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const int n_slots = p->n_ops + (p->rows != nullptr ? 1 : 0);
    const long long table_bytes = (long long)p->n_groups * n_slots * 8;
    const long long want_blocks = (p->n + kThreads - 1) / kThreads;
    cudaStream_t s = (cudaStream_t)stream;
    if (table_bytes <= smem_optin) {
        int bytes = (int)table_bytes;
        err = cudaFuncSetAttribute(fold_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return (int)err;
        int per_sm = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fold_shared, kThreads, bytes);
        if (err != cudaSuccess) return (int)err;
        if (per_sm < 1) per_sm = 1;
        long long blocks = (long long)sms * per_sm;
        if (blocks > want_blocks) blocks = want_blocks;
        *regime = 1;
        fold_shared<<<(unsigned)blocks, kThreads, bytes, s>>>(*p);
    } else {
        long long blocks = (long long)sms * 8;
        if (blocks > want_blocks) blocks = want_blocks;
        *regime = 0;
        fold_global<<<(unsigned)blocks, kThreads, 0, s>>>(*p);
    }
    return (int)cudaGetLastError();
}

extern "C" int scan_agg_fold_params_size(void) { return (int)sizeof(SafParams); }
