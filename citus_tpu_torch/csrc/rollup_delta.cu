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
//   topk       out[g, b] += 1 and out2[g, b] = max(out2[g, b], v)
//                                               int64 [G, 1024] x 2
// over the rows with ok[i] set (a padding row or a NULL value has ok
// false and changes nothing), g = gidx[i], b the row's bucket from
// sketch.cuh (the same bucket functions as the scan fold, so rollup and
// raw-scan estimates agree).  The wrapper (rollup/kernels.py) allocates
// and fills the tables (torch.zeros / torch.full) and pads n and G to
// powers of two, as the reference does.
//
// What bounds it on an H100: for the count and sum kinds, the bytes of
// the batch (13-17 B a row) and of the [G] table; for the sketch kinds,
// writing the [G, M] tables once (at G = 10,000 a DDSketch table is 160 MB
// against a 65,536-row batch of under 1 MB).  The kernel itself touches
// one register per row: one global atomic each, contended only where many
// rows share a group and bucket.  Simple first: no shared-memory staging.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sketch.cuh"

#define RD_COUNT 0
#define RD_SUM_INT 1
#define RD_SUM_FLOAT 2
#define RD_HLL 3
#define RD_DDSK 4
#define RD_TOPK 5

__global__ void rollup_delta_kernel(int kind, int64_t n, const void* vals,
                                    const int32_t* gidx, const uint8_t* ok,
                                    void* out, long long* out2) {
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
        if (!ok[i]) continue;
        const int64_t g = gidx[i];
        switch (kind) {
            case RD_COUNT:
                atomicAdd((unsigned long long*)out + g, 1ull);
                break;
            case RD_SUM_INT:
                atomicAdd((unsigned long long*)out + g,
                          (unsigned long long)((const long long*)vals)[i]);
                break;
            case RD_SUM_FLOAT:
                atomicAdd((double*)out + g, ((const double*)vals)[i]);
                break;
            case RD_HLL: {
                int b, rho;
                hll_bucket_rho(((const long long*)vals)[i], &b, &rho);
                atomicMax((int*)out + g * HLL_M + b, rho);
                break;
            }
            case RD_DDSK:
                atomicAdd((unsigned long long*)out + g * DDSK_M
                              + ddsk_bucket(((const double*)vals)[i]), 1ull);
                break;
            default: {
                const long long v = ((const long long*)vals)[i];
                const int64_t at = g * TOPK_M + topk_bucket(v);
                atomicAdd((unsigned long long*)out + at, 1ull);
                atomicMax(out2 + at, v);
                break;
            }
        }
    }
}

static const int kThreads = 256;

// Launches one delta fold on `stream`: `vals` [n] (int64 for sum_int,
// hll and topk, where it holds the value bits; float64 for sum_float and
// ddsk; unused for count), `gidx` [n] int32 group indexes below the
// tables' G, `ok` [n] bool, `out` the kind's table, `out2` the top-k value
// table (else null).  Returns the CUDA error of the launch.
extern "C" int rollup_delta_launch(int kind, int64_t n, const void* vals, const int32_t* gidx,
                                   const uint8_t* ok, void* out, long long* out2,
                                   void* stream) {
    if (n <= 0) return 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > (long long)sms * 8) blocks = (long long)sms * 8;
    rollup_delta_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        kind, n, vals, gidx, ok, out, out2);
    return (int)cudaGetLastError();
}
