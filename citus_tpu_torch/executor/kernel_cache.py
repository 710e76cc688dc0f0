"""Process-wide built-worker cache keyed by structural plan fingerprint.

The reference caches one local plan per prepared statement
(local_plan_cache.c); the JAX package caches the *compiled XLA program*
per plan **family**, and this port caches the built per-plan worker
closures (compiled expression trees around the ``scan_agg_fold``
kernel) under the same keys.  Two queries that differ only in hoisted
comparison literals (planner/auto_param.py) bind to structurally
identical plans, so their worker/merge/filter kernels are the same
program — this module makes that sharing explicit and process-wide:

- ``plan_fingerprint(plan)`` — canonical digest over everything the
  worker builder in ops/scan_agg.py closes over: the bound filter tree,
  the group keys, deduped aggregate args, partial-op kinds/dtypes, the
  group mode (domains/strides), the scan columns with their device
  dtypes, and the parameter count (env layout).  Deliberately EXCLUDED:
  pruning intervals, shard indexes, router key, limit/order,
  final_exprs and agg_extract — the combine/finalize half runs on the
  host, so none of them change the built worker.
- ``get_kernel(plan, slot, build)`` — per-plan ``runtime_cache`` mirror
  in front of a global LRU (``citus.kernel_cache_size`` entries), so a
  plan-cache hit costs a dict lookup and a plan-cache miss that lands on
  a known fingerprint skips the build (kernel_cache_hits counter).

PyTorch runs eagerly, so the reference's ``jit_compile`` door and its
persistent XLA compilation cache have no counterpart here; the CUDA
kernels themselves are built once per source (ops/cuda_build.py).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Callable

from citus_tpu_torch.observability import trace as _trace

#: default LRU entry cap (entries, not bytes: built workers are
#: host-memory cheap relative to device batches) — citus.kernel_cache_size
DEFAULT_CAPACITY = 512


def _counters():
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    return GLOBAL_COUNTERS


class KernelLRU:
    """Entry-counted LRU of compiled kernels, shared by every plan (and
    every decoded worker task) in the process."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._mu = threading.RLock()
        self._e: OrderedDict[tuple, object] = OrderedDict()
        self.capacity = capacity

    def get(self, key: tuple):
        with self._mu:
            k = self._e.get(key)
            if k is not None:
                self._e.move_to_end(key)
            return k

    def put(self, key: tuple, kernel) -> None:
        with self._mu:
            self._e[key] = kernel
            self._e.move_to_end(key)
            while len(self._e) > max(1, self.capacity):
                self._e.popitem(last=False)

    def set_capacity(self, n: int) -> None:
        with self._mu:
            self.capacity = int(n)
            while len(self._e) > max(1, self.capacity):
                self._e.popitem(last=False)

    def clear(self) -> None:
        with self._mu:
            self._e.clear()

    def __len__(self) -> int:
        with self._mu:
            return len(self._e)


GLOBAL_KERNELS = KernelLRU()


def plan_fingerprint(plan) -> str:
    """Canonical structural digest of a plan's kernel-relevant parts.

    Contract (docs/COMPONENTS.md): includes exactly the closure deps of
    the kernel builders — bound filter, group keys, agg_args, partial
    ops, group mode, (scan column, device dtype) pairs, parameter count.
    Bound expression nodes are frozen dataclasses, so their reprs are
    canonical; param count (not spec contents) keeps coordinator plans
    and worker-decoded plans (logical specs rebuilt from the task's
    param_specs types) on one fingerprint.
    """
    fp = plan.runtime_cache.get("_fingerprint")
    if fp is None:
        schema = plan.bound.table.schema
        parts = [
            repr(plan.bound.filter),
            repr(plan.bound.group_keys),
            repr(plan.agg_args),
            repr(plan.partial_ops),
            repr(plan.group_mode),
            repr([(c, str(schema.scan_dtype(c, device=True)))
                  for c in plan.scan_columns]),
            str(len(plan.bound.param_specs)),
        ]
        fp = hashlib.sha256("\x1f".join(parts).encode()).hexdigest()
        plan.runtime_cache["_fingerprint"] = fp
    return fp


def get_kernel(plan, slot: str, build: Callable[[], object],
               extra: tuple = ()):
    """Compiled kernel for (plan family, slot): runtime_cache first (no
    counter traffic — same plan object re-executing), then the global
    LRU by fingerprint, building and publishing on a true miss."""
    rc = plan.runtime_cache
    k = rc.get(slot)
    if k is not None:
        return k
    key = (plan_fingerprint(plan), slot) + tuple(extra)
    k = GLOBAL_KERNELS.get(key)
    if k is None:
        _counters().bump("kernel_cache_misses")
        _trace.set_phase("compile")
        with _trace.span("kernel", slot=slot, cache="miss"):
            k = build()
        GLOBAL_KERNELS.put(key, k)
    else:
        _counters().bump("kernel_cache_hits")
        with _trace.span("kernel", slot=slot, cache="hit"):
            pass
    rc[slot] = k
    return k
