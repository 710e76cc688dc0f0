"""Builds the port's CUDA kernels from ``citus_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded
with ``ctypes``: a build takes seconds, where one that includes
PyTorch's headers takes minutes.  The library lands under
``build/citus_tpu_torch/cuda/<hash of source and flags>/`` at first use.
``build_all`` starts one ``nvcc`` per source together.  Every
``csrc/*.cuh`` header is part of each build's hash.

Generated sources (the predicate kernels of ``ops/expr_codegen.py``)
build the same way through ``load_generated``: the source is written
into its own build directory, named by the digest of the source, the
headers and the flags, so one predicate family builds once.

There is no fallback: a missing ``nvcc`` or a failed build raises, and
the caller that wanted the kernel fails with it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from citus_tpu_torch.utils.build import PACKAGE_DIR, build_dir, sources_digest

CSRC = os.path.join(PACKAGE_DIR, "csrc")
#: --fmad=false: no fused multiply-add contraction, so float expressions
#: round as the reference's (XLA on the CPU) do
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.RLock()
_libs: dict[str, ctypes.CDLL] = {}
_launch_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` under a lock: several threads
    (``Cluster.execute`` callers, a megabatch leader) launch kernels at
    once, and ``+=`` on an attribute is not atomic."""
    with _launch_lock:
        wrapper.launches += 1


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError("nvcc not found: the CUDA kernels of "
                           "citus_tpu_torch need the CUDA toolkit")


def _headers() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cuh"))


def _flags() -> list[str]:
    return [*NVCC_FLAGS, "-I", CSRC]


def _paths(name: str) -> tuple[str, str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    digest = sources_digest([src, *_headers()], extra=" ".join(NVCC_FLAGS))
    d = build_dir("cuda", digest)
    return src, os.path.join(d, f"lib{name}.so"), os.path.join(d, "build.log")


def _start(name: str, paths=None):
    """-> (so path, running nvcc or None when already built)."""
    src, so, log = paths or _paths(name)
    if os.path.exists(so):
        return so, None
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *_flags(), "-o", tmp, src]
    fh = open(log, "w")
    proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return so, (proc, fh, tmp, log)


def _finish(name: str, so: str, job) -> None:
    if job is None:
        return
    proc, fh, tmp, log = job
    rc = proc.wait()
    fh.close()
    if rc != 0:
        with open(log) as f:
            raise KernelBuildError(f"nvcc failed for {name}.cu:\n{f.read()}")
    os.replace(tmp, so)


def _generated_paths(name: str, source: str) -> tuple[str, str, str]:
    h = hashlib.sha256(source.encode())
    h.update(sources_digest(_headers(), extra=" ".join(NVCC_FLAGS)).encode())
    d = build_dir("cuda", f"{name}-{h.hexdigest()[:16]}")
    src = os.path.join(d, f"{name}.cu")
    if not os.path.exists(src):
        tmp = f"{src}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(source)
        os.replace(tmp, src)
    return src, os.path.join(d, f"lib{name}.so"), os.path.join(d, "build.log")


def start_generated(name: str, source: str):
    """Start building a generated source; -> a handle for
    ``finish_generated`` (several builds can run at once)."""
    paths = _generated_paths(name, source)
    so, job = _start(name, paths)
    return name, so, job


def finish_generated(handle) -> ctypes.CDLL:
    """Wait for a build from ``start_generated``; -> its loaded library."""
    name, so, job = handle
    with _lock:
        lib = _libs.get(so)
        if lib is None:
            _finish(name, so, job)
            lib = ctypes.CDLL(so)
            _libs[so] = lib
    return lib


def load_generated(name: str, source: str) -> ctypes.CDLL:
    """The loaded library of a generated CUDA source, built at first use
    under a directory named by its digest."""
    with _lock:
        return finish_generated(start_generated(name, source))


def build_all(names) -> dict[str, str]:
    """Build every named kernel, all ``nvcc`` processes at once;
    -> {name: library path}."""
    jobs = {n: _start(n) for n in names}
    for n, (so, job) in jobs.items():
        _finish(n, so, job)
    return {n: so for n, (so, _) in jobs.items()}


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``) of the last build."""
    _, _, log = _paths(name)
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = build_all([name])[name]
            lib = ctypes.CDLL(so)
            _libs[name] = lib
    return lib
