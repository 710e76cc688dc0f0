"""Where the port's native sources are built at first use.

Everything compiled from ``citus_tpu_torch`` sources (the columnar
codec library, the CUDA kernels) lands under ``build/citus_tpu_torch/``
beside the package, in a directory named by a hash of the sources, so
an edited source never loads a stale binary and the checkout itself
stays free of build outputs (``.gitignore`` lists ``build/``).
"""

from __future__ import annotations

import hashlib
import os

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_ROOT = os.path.join(os.path.dirname(PACKAGE_DIR), "build",
                          "citus_tpu_torch")


def sources_digest(paths, extra: str = "") -> str:
    """Short content hash over ``paths`` (and any build flags)."""
    h = hashlib.sha256(extra.encode())
    for p in sorted(paths):
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build_dir(kind: str, digest: str) -> str:
    d = os.path.join(BUILD_ROOT, kind, digest)
    os.makedirs(d, exist_ok=True)
    return d
