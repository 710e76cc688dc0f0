"""The port's native columnar codec (``citus_tpu_torch/native``).

Its source declares the zstd and lz4 entry points it calls and links the
versioned shared libraries, so it builds where those libraries are
installed without their headers.  Held here: the source includes
neither header, the library builds and loads, every codec round-trips
through ``storage/compression.py``, and its zstd frames are the ones
python-zstandard (the JAX package's codec) reads and writes.
"""

import shutil
import subprocess

import numpy as np
import pytest

from citus_tpu_torch import native
from citus_tpu_torch.storage import compression as C


def _data() -> bytes:
    rng = np.random.default_rng(3)
    cols = [rng.integers(0, 50, 20_000).astype(np.int64),
            np.arange(20_000, dtype=np.int64),
            rng.standard_normal(20_000)]
    return b"".join(c.tobytes() for c in cols)


def test_source_needs_no_zstd_or_lz4_header():
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ here to list the source's headers")
    deps = subprocess.run(
        [cxx, "-std=c++17", "-M", "columnar_native.cpp"], cwd=native._HERE,
        capture_output=True, text=True, check=True).stdout
    assert "zstd.h" not in deps and "lz4.h" not in deps
    assert "zlib.h" in deps


@pytest.mark.parametrize("codec", ["zstd", "lz4", "zlib"])
def test_native_codec_round_trips(codec):
    assert native.get_lib() is not None
    data = _data()
    blob = C.compress(data, codec, 3)
    assert len(blob) < len(data)
    assert C.decompress(blob, codec, len(data)) == data


def test_native_zstd_frames_are_python_zstandard_frames():
    zstandard = pytest.importorskip("zstandard")
    assert native.get_lib() is not None
    data = _data()
    assert zstandard.ZstdDecompressor().decompress(
        C.compress(data, "zstd", 3), max_output_size=len(data)) == data
    frame = zstandard.ZstdCompressor(level=3).compress(data)
    assert C.decompress(frame, "zstd", len(data)) == data
