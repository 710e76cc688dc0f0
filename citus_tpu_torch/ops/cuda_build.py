"""Builds the port's CUDA kernels from ``citus_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded
with ``ctypes``: a build takes seconds, where one that includes
PyTorch's headers takes minutes.  The library lands under
``build/citus_tpu_torch/cuda/<hash of source and flags>/`` at first use.
``build_all`` starts one ``nvcc`` per source together.

There is no fallback: a missing ``nvcc`` or a failed build raises, and
the caller that wanted the kernel fails with it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

from citus_tpu_torch.utils.build import PACKAGE_DIR, build_dir, sources_digest

CSRC = os.path.join(PACKAGE_DIR, "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


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


def _paths(name: str) -> tuple[str, str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    digest = sources_digest([src], extra=" ".join(NVCC_FLAGS))
    d = build_dir("cuda", digest)
    return src, os.path.join(d, f"lib{name}.so"), os.path.join(d, "build.log")


def _start(name: str):
    """-> (so path, running nvcc or None when already built)."""
    src, so, log = _paths(name)
    if os.path.exists(so):
        return so, None
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
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
