// Native columnar runtime: the IO + codec hot path.
//
// The reference implements its columnar engine in C inside PostgreSQL
// (src/backend/columnar/columnar_compression.c, columnar_reader.c);
// this library is the equivalent native layer under the Python/JAX
// planner: batch chunk reads (one pread per stream), zstd/lz4/zlib
// decompression, and validity-bitmap unpacking, all without the
// per-chunk Python overhead.  Exposed through a plain C ABI consumed
// via ctypes (no pybind11 dependency).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <zstd.h>
#include <zlib.h>

extern "C" {
// liblz4 runtime is present; header is not — declare what we use.
int LZ4_decompress_safe(const char* src, char* dst, int srcSize, int dstCapacity);
int LZ4_compress_default(const char* src, char* dst, int srcSize, int dstCapacity);
int LZ4_compressBound(int inputSize);
}

enum Codec : int32_t {
    CODEC_NONE = 0,
    CODEC_ZSTD = 1,
    CODEC_LZ4 = 2,
    CODEC_ZLIB = 3,
};

extern "C" {

// ---- single-shot codecs -------------------------------------------------

// returns decompressed size, or -1 on failure
int64_t ct_decompress(int32_t codec, const uint8_t* src, int64_t src_len,
                      uint8_t* dst, int64_t dst_cap) {
    switch (codec) {
        case CODEC_NONE:
            if (src_len > dst_cap) return -1;
            memcpy(dst, src, (size_t)src_len);
            return src_len;
        case CODEC_ZSTD: {
            size_t n = ZSTD_decompress(dst, (size_t)dst_cap, src, (size_t)src_len);
            if (ZSTD_isError(n)) return -1;
            return (int64_t)n;
        }
        case CODEC_LZ4: {
            int n = LZ4_decompress_safe((const char*)src, (char*)dst,
                                        (int)src_len, (int)dst_cap);
            return n < 0 ? -1 : n;
        }
        case CODEC_ZLIB: {
            uLongf out_len = (uLongf)dst_cap;
            int rc = uncompress((Bytef*)dst, &out_len, (const Bytef*)src,
                                (uLong)src_len);
            return rc == Z_OK ? (int64_t)out_len : -1;
        }
    }
    return -1;
}

int64_t ct_compress(int32_t codec, const uint8_t* src, int64_t src_len,
                    uint8_t* dst, int64_t dst_cap, int32_t level) {
    switch (codec) {
        case CODEC_NONE:
            if (src_len > dst_cap) return -1;
            memcpy(dst, src, (size_t)src_len);
            return src_len;
        case CODEC_ZSTD: {
            size_t n = ZSTD_compress(dst, (size_t)dst_cap, src, (size_t)src_len,
                                     level);
            if (ZSTD_isError(n)) return -1;
            return (int64_t)n;
        }
        case CODEC_LZ4: {
            int n = LZ4_compress_default((const char*)src, (char*)dst,
                                         (int)src_len, (int)dst_cap);
            return n <= 0 ? -1 : n;
        }
        case CODEC_ZLIB: {
            uLongf out_len = (uLongf)dst_cap;
            int rc = compress2((Bytef*)dst, &out_len, (const Bytef*)src,
                               (uLong)src_len, level > 9 ? 9 : level);
            return rc == Z_OK ? (int64_t)out_len : -1;
        }
    }
    return -1;
}

int64_t ct_compress_bound(int32_t codec, int64_t src_len) {
    switch (codec) {
        case CODEC_NONE: return src_len;
        case CODEC_ZSTD: return (int64_t)ZSTD_compressBound((size_t)src_len);
        case CODEC_LZ4:  return (int64_t)LZ4_compressBound((int)src_len);
        case CODEC_ZLIB: return (int64_t)compressBound((uLong)src_len);
    }
    return -1;
}

// ---- batched stripe-chunk reads ----------------------------------------
// Reads n streams from one open file and decompresses each into its slot
// of a caller-provided contiguous output buffer.  This is the native
// inner loop of the stripe reader (one call per (stripe, column) scan).
// returns 0 on success, -(1+i) identifying the failing stream.

int64_t ct_read_streams(const char* path, int32_t codec, int64_t n,
                        const int64_t* offsets, const int64_t* comp_lens,
                        const int64_t* raw_lens, const int64_t* dst_offsets,
                        uint8_t* dst, int64_t dst_cap,
                        uint8_t* scratch, int64_t scratch_cap) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1000000;
    for (int64_t i = 0; i < n; i++) {
        if (comp_lens[i] > scratch_cap) { fclose(f); return -(1 + i); }
        if (dst_offsets[i] + raw_lens[i] > dst_cap) { fclose(f); return -(1 + i); }
        if (fseeko(f, (off_t)offsets[i], SEEK_SET) != 0) { fclose(f); return -(1 + i); }
        if (fread(scratch, 1, (size_t)comp_lens[i], f) != (size_t)comp_lens[i]) {
            fclose(f);
            return -(1 + i);
        }
        int64_t got = ct_decompress(codec, scratch, comp_lens[i],
                                    dst + dst_offsets[i], raw_lens[i]);
        if (got != raw_lens[i]) { fclose(f); return -(1 + i); }
    }
    fclose(f);
    return 0;
}

// ---- parallel batched reads --------------------------------------------
// Same contract as ct_read_streams, but streams are claimed from a
// shared counter by a small thread pool; each worker owns a file handle
// and scratch buffer.  The reference parallelizes scans across worker
// backends; within one host process this is the analog for saturating
// storage + decompression bandwidth on cold scans.

int64_t ct_read_streams_mt(const char* path, int32_t codec, int64_t n,
                           const int64_t* offsets, const int64_t* comp_lens,
                           const int64_t* raw_lens, const int64_t* dst_offsets,
                           uint8_t* dst, int64_t dst_cap, int32_t n_threads) {
    std::atomic<int64_t> err{0};
    std::atomic<int64_t> next{0};
    auto worker = [&]() {
        FILE* f = fopen(path, "rb");
        if (!f) {
            int64_t expect = 0;
            err.compare_exchange_strong(expect, -1000000);
            return;
        }
        std::vector<uint8_t> scratch;
        while (err.load(std::memory_order_relaxed) == 0) {
            int64_t i = next.fetch_add(1);
            if (i >= n) break;
            int64_t fail = -(1 + i), expect = 0;
            if ((int64_t)scratch.size() < comp_lens[i]) {
                scratch.resize((size_t)comp_lens[i]);
            }
            if (dst_offsets[i] + raw_lens[i] > dst_cap ||
                fseeko(f, (off_t)offsets[i], SEEK_SET) != 0 ||
                fread(scratch.data(), 1, (size_t)comp_lens[i], f)
                    != (size_t)comp_lens[i] ||
                ct_decompress(codec, scratch.data(), comp_lens[i],
                              dst + dst_offsets[i], raw_lens[i]) != raw_lens[i]) {
                err.compare_exchange_strong(expect, fail);
                break;
            }
        }
        fclose(f);
    };
    int nt = n_threads < 1 ? 1 : (n_threads > 16 ? 16 : n_threads);
    if ((int64_t)nt > n) nt = (int)n;
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; t++) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
    return err.load();
}

// ---- validity bitmap unpack --------------------------------------------
// big-endian bit order, matching numpy packbits

void ct_unpack_bits(const uint8_t* src, int64_t n_bits, uint8_t* dst) {
    for (int64_t i = 0; i < n_bits; i++) {
        dst[i] = (src[i >> 3] >> (7 - (i & 7))) & 1;
    }
}

int32_t ct_version(void) { return 1; }

}  // extern "C"
