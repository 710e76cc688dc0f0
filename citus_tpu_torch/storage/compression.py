"""Compression codecs for column streams.

Reference: src/backend/columnar/columnar_compression.c (pglz/LZ4/ZSTD).
We provide zstd (python-zstandard), zlib (stdlib, the pglz stand-in), lz4
(via the system liblz4 through ctypes — no Python lz4 package is assumed),
and none.  A native C++ batch-decompression path lives in
citus_tpu_torch/native and is used automatically when built; this module is the
portable fallback and the single place codec ids are defined.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import zlib

from citus_tpu_torch.errors import StorageError

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover
    _zstd = None

CODEC_NONE = "none"
CODEC_ZSTD = "zstd"
CODEC_LZ4 = "lz4"
CODEC_ZLIB = "zlib"

_lz4 = None


def _load_lz4():
    global _lz4
    if _lz4 is not None:
        return _lz4
    path = ctypes.util.find_library("lz4") or "liblz4.so.1"
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:  # pragma: no cover
        raise StorageError(f"liblz4 not available: {e}")
    lib.LZ4_compress_default.restype = ctypes.c_int
    lib.LZ4_compress_default.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.LZ4_compressBound.restype = ctypes.c_int
    lib.LZ4_compressBound.argtypes = [ctypes.c_int]
    lib.LZ4_decompress_safe.restype = ctypes.c_int
    lib.LZ4_decompress_safe.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    _lz4 = lib
    return lib


def _native():
    from citus_tpu_torch.native import CODEC_IDS, get_lib
    return get_lib(), CODEC_IDS


def compress(data: bytes, codec: str, level: int = 3) -> bytes:
    if codec == CODEC_NONE:
        return data
    lib, ids = _native()
    if lib is not None and codec in ids:
        import numpy as np
        cid = ids[codec]
        bound = lib.ct_compress_bound(cid, len(data))
        out = np.empty(bound, np.uint8)
        src = np.frombuffer(data, np.uint8)
        n = lib.ct_compress(
            cid, src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), bound, level)
        if n > 0:
            return out[:n].tobytes()
    if codec == CODEC_ZSTD:
        if _zstd is None:
            # no python-zstandard and no native backend: degrade to the
            # stdlib codec instead of making every write path unusable.
            # decompress() mirrors the fallback, so files written in
            # this environment round-trip; genuine zstd bytes from
            # elsewhere still fail cleanly there.
            return zlib.compress(data, min(level, 9))
        return _zstd.ZstdCompressor(level=level).compress(data)
    if codec == CODEC_ZLIB:
        return zlib.compress(data, min(level, 9))
    if codec == CODEC_LZ4:
        lib = _load_lz4()
        bound = lib.LZ4_compressBound(len(data))
        out = ctypes.create_string_buffer(bound)
        n = lib.LZ4_compress_default(data, out, len(data), bound)
        if n <= 0:
            raise StorageError("LZ4 compression failed")
        return out.raw[:n]
    raise StorageError(f"unknown codec {codec!r}")


def decompress(data: bytes, codec: str, raw_size: int) -> bytes:
    if codec == CODEC_NONE:
        return data
    lib, ids = _native()
    if lib is not None and codec in ids:
        import numpy as np
        out = np.empty(raw_size, np.uint8)
        src = np.frombuffer(data, np.uint8)
        n = lib.ct_decompress(
            ids[codec], src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            raw_size)
        if n == raw_size:
            return out.tobytes()
        if n >= 0:
            return out[:n].tobytes()
    if codec == CODEC_ZSTD:
        if _zstd is None:
            try:
                # mirror of the compress() fallback: zstd-labelled data
                # written without a zstd backend is zlib bytes
                return zlib.decompress(data)
            except zlib.error as e:
                raise StorageError(
                    "zstd-compressed data but no zstd backend available "
                    "(install zstandard or build the native codec)") from e
        return _zstd.ZstdDecompressor().decompress(data, max_output_size=raw_size)
    if codec == CODEC_ZLIB:
        return zlib.decompress(data)
    if codec == CODEC_LZ4:
        lib = _load_lz4()
        out = ctypes.create_string_buffer(raw_size)
        n = lib.LZ4_decompress_safe(data, out, len(data), raw_size)
        if n < 0:
            raise StorageError("LZ4 decompression failed")
        return out.raw[:n]
    raise StorageError(f"unknown codec {codec!r}")
