"""ctypes bindings for the native columnar runtime.

Auto-builds libcitus_tpu_native.so with make on first use (a few
seconds, cached under ``build/citus_tpu_torch/native/<source hash>/``);
every caller must tolerate ``LIB is None`` and fall back to the
pure-Python path, so the framework works even without a toolchain —
exactly as the reference package's loader does.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from citus_tpu_torch.utils.build import build_dir, sources_digest

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "columnar_native.cpp")
_SO_NAME = "libcitus_tpu_native.so"
_lock = threading.Lock()
_attempted = False

LIB = None

CODEC_IDS = {"none": 0, "zstd": 1, "lz4": 2, "zlib": 3}


def _so_path() -> str:
    digest = sources_digest([_SRC, os.path.join(_HERE, "Makefile")])
    return os.path.join(build_dir("native", digest), _SO_NAME)


def _try_build(so: str) -> bool:
    if os.path.exists(so):
        return True
    # build under a private name and rename: concurrent processes
    # (test workers) never load a half-written library
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["make", "-C", _HERE, f"OUT={tmp}"],
                       capture_output=True, timeout=120, check=True)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ct_decompress.restype = i64
    lib.ct_decompress.argtypes = [i32, u8p, i64, u8p, i64]
    lib.ct_compress.restype = i64
    lib.ct_compress.argtypes = [i32, u8p, i64, u8p, i64, i32]
    lib.ct_compress_bound.restype = i64
    lib.ct_compress_bound.argtypes = [i32, i64]
    lib.ct_read_streams.restype = i64
    lib.ct_read_streams.argtypes = [ctypes.c_char_p, i32, i64, i64p, i64p,
                                    i64p, i64p, u8p, i64, u8p, i64]
    lib.ct_read_streams_mt.restype = i64
    lib.ct_read_streams_mt.argtypes = [ctypes.c_char_p, i32, i64, i64p, i64p,
                                       i64p, i64p, u8p, i64, i32]
    lib.ct_unpack_bits.restype = None
    lib.ct_unpack_bits.argtypes = [u8p, i64, u8p]
    lib.ct_version.restype = i32
    lib.ct_version.argtypes = []
    return lib


def get_lib():
    """The bound native library, or None when unavailable."""
    global LIB, _attempted
    if LIB is not None:
        return LIB
    with _lock:
        if LIB is not None or _attempted:
            return LIB
        _attempted = True
        # lint: disable=BLK01 -- one-shot native build: the lock exists precisely to run make exactly once
        so = _so_path()
        if _try_build(so):
            try:
                LIB = _bind(ctypes.CDLL(so))
            except OSError:
                LIB = None
    return LIB
