"""Bucket functions of the sketch aggregates on torch tensors.

The torch twins of ``planner/aggregates.py``'s ``hll_rho_buckets``,
``ddsk_bucket_indexes`` and ``topk_buckets`` (numpy-namespace copies of
the reference's, kept for the host oracle), used by the plain versions
of the fold kernels (``ops/scan_agg_fold.py``) and of the rollup kernel
(``rollup/kernels.py``).  The kernels compute the same buckets in
``csrc/sketch.cuh``.

torch on the CPU has no uint64 ``>>``, so the splitmix64 finalizer runs
on int64 bits with masked logical shifts and wrapping products, as the
hash aggregation's fingerprints do (``ops/hash_agg.py``): bit-identical
to the reference's uint64 arithmetic.
"""

from __future__ import annotations

import torch

from citus_tpu_torch.ops.hash_agg import _C1, _C2, _srl
from citus_tpu_torch.planner.aggregates import (
    DDSK_HALF, DDSK_LNG, DDSK_LOG_MIN, HLL_M, TOPK_M,
)


def value_bits(v: torch.Tensor) -> torch.Tensor:
    """Values -> the int64 bits the hash sketches consume: a float hashes
    its float64 bits, anything else its int64 value."""
    if v.is_floating_point():
        return v.to(torch.float64).view(torch.int64)
    return v.to(torch.int64)


def _splitmix64(bits: torch.Tensor) -> torch.Tensor:
    h = bits.to(torch.int64)
    h = (h ^ _srl(h, 30)) * _C1
    h = (h ^ _srl(h, 27)) * _C2
    return h ^ _srl(h, 31)


def hll_rho_buckets(bits: torch.Tensor, ok: torch.Tensor):
    """int64 value bits -> (bucket int32, rho int32); rows not ``ok`` get
    rho 0 (neutral under max)."""
    h = _splitmix64(bits)
    bucket = (h & (HLL_M - 1)).to(torch.int32)
    w = _srl(h, 7)  # the remaining 57 bits, non-negative
    lz = torch.zeros(w.shape, dtype=torch.int32, device=w.device)
    x = w
    for shift in (32, 16, 8, 4, 2, 1):
        big = (x >> shift) != 0
        lz = lz + torch.where(big, 0, shift).to(torch.int32)
        x = torch.where(big, x >> shift, x)
    rho = torch.where(w == 0, 57, lz - 7 + 1).to(torch.int32)
    return bucket, torch.where(ok, rho, 0).to(torch.int32)


#: XLA folds the reference's division by the constant DDSK_LNG into a
#: product with its reciprocal; the device path does the same (a value
#: within an ulp of a bucket edge can land one bucket above where the
#: numpy oracle's true division puts it: ROADMAP.md C)
DDSK_INV_LNG = 1.0 / DDSK_LNG
_DBL_MIN = float(torch.finfo(torch.float64).tiny)


def ddsk_bucket_indexes(v: torch.Tensor) -> torch.Tensor:
    """float values -> DDSketch bucket index int32 (callers mask invalid
    rows themselves), as the reference's jitted body computes it."""
    val = v.to(torch.float64)
    # XLA on the CPU flushes float64 subnormals to zero: they bucket as 0
    val = torch.where(torch.abs(val) < _DBL_MIN, 0.0, val)
    mag = torch.abs(val)
    li = torch.clamp(
        torch.floor((torch.log(torch.clamp(mag, min=1e-300)) - DDSK_LOG_MIN)
                    * DDSK_INV_LNG), 0, DDSK_HALF - 1)
    # NaN lands in the zero bucket below whatever its index casts to
    li = torch.where(torch.isnan(li), 0.0, li).to(torch.int32)
    neg_idx = (DDSK_HALF - 2) - torch.clamp(li, max=DDSK_HALF - 2)
    pos_idx = DDSK_HALF + li
    return torch.where(val > 0, pos_idx,
                       torch.where(val < 0, neg_idx, DDSK_HALF - 1)
                       ).to(torch.int32)


def topk_buckets(bits: torch.Tensor) -> torch.Tensor:
    """int64 value bits -> top-k bucket int32 (callers mask invalid rows
    themselves)."""
    return (_splitmix64(bits) & (TOPK_M - 1)).to(torch.int32)
