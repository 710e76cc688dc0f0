"""Device-side hash aggregation for unbounded GROUP BY cardinality.

When the key domain can't be proven small (no direct-gid mode), the
executor aggregates on the device into ONE fixed-size open-addressed
hash table that lives on the card for the whole scan.  Each batch goes
through ``build_fused_hash_worker``: the filter, the group keys and the
aggregate arguments evaluate as tensor code, then one
``hash_agg_insert`` (``ops/hash_agg_insert.py``: the hand-written CUDA
kernel on a card, its plain PyTorch version on the CPU) canonicalizes
and fingerprints the keys, places each row in its group's slot or
reports it in a spill mask, and folds the partial states in place —
the port's counterpart of the reference's ``donate_argnums=0``.  Rows
that lose both probes are re-aggregated exactly on the host
(``executor/host_agg.py HostGroupAccumulator``); occupancy only grows
and the probe sequence is fixed, so a group keeps the slot it first
landed in across batches.

Float keys are canonicalized before fingerprinting and storage
(``-0.0`` → ``0.0``, every NaN payload → the canonical quiet NaN), as
in the reference (``citus_tpu/ops/hash_agg.py``); HostGroupAccumulator
applies the same canonicalization to its key bytes, keeping the two
paths in one group space.

The 64-bit fingerprint arithmetic runs on int64 tensors: torch on the
CPU has no uint64 ``>>``, ``%`` or scatter-min, so shifts are masked
logical shifts, products wrap, and the unsigned modulo is computed from
the signed remainder.  The results are bit-identical to the
reference's uint64 arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from citus_tpu_torch.ops.scan_agg import _sentinel, _validity, _vec
from citus_tpu_torch.planner.bound import (
    _as_mask, compile_expr, param_env_names, predicate_mask,
)
from citus_tpu_torch.planner.physical import PhysicalPlan


def _s64(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_FNV = _s64(0xCBF29CE484222325)
_C1 = _s64(0xBF58476D1CE4E5B9)
_C2 = _s64(0x94D049BB133111EB)
_GOLD = _s64(0x9E3779B97F4A7C15)
_INT64_MIN = -(1 << 63)


def _srl(h: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (h >> k) & ((1 << (64 - k)) - 1)


def _mix(h: torch.Tensor, v) -> torch.Tensor:
    h = (h ^ v) + _GOLD
    h = h ^ _srl(h, 30)
    h = h * _C1
    h = h ^ _srl(h, 27)
    h = h * _C2
    return h ^ _srl(h, 31)


def _fingerprint(keys, shape, device) -> torch.Tensor:
    """keys: [(values, valid_mask)] -> int64 tensor holding the uint64
    fingerprints' bits."""
    h = torch.full(tuple(shape), _FNV, dtype=torch.int64, device=device)
    for kv, kvm in keys:
        if kv.dtype == torch.float64:
            bits = kv.view(torch.int64)
        elif kv.is_floating_point():
            bits = kv.to(torch.float64).view(torch.int64)
        else:
            bits = kv.to(torch.int64)
        bits = torch.where(kvm, bits, _GOLD)
        h = _mix(h, bits + kvm.to(torch.int64))
    return h


def _umod(h: torch.Tensor, S: int) -> torch.Tensor:
    """``h % S`` with ``h`` read as uint64 (its int64 bits), 0 < S < 2^62."""
    r = torch.remainder(h, S)
    return torch.where(h < 0, torch.remainder(r + (1 << 64) % S, S), r)


def _key_sentinel(dt: np.dtype):
    """Empty-slot fill for a key value table: the dtype's minimum, so
    occupied slots survive neutral scatter-max claims."""
    dt = np.dtype(dt)
    if np.issubdtype(dt, np.floating):
        return dt.type(-np.inf)
    if dt == np.dtype(bool):
        return False
    return dt.type(np.iinfo(dt).min)


def _canon_keys(keys):
    """Canonical float key values: ``-0.0`` → ``0.0`` and every NaN
    payload → the dtype's canonical quiet NaN, so SQL-equal values share
    one bit pattern in fingerprints AND key-table storage.  Null key
    values are zeroed (the valid flag disambiguates)."""
    out = []
    for kv, kvm in keys:
        if kv.is_floating_point():
            kv = torch.where(kv == 0, 0.0, kv)
            kv = torch.where(torch.isnan(kv), float("nan"), kv)
        kv = torch.where(kvm, kv, torch.zeros((), dtype=kv.dtype,
                                              device=kv.device))
        out.append((kv, kvm))
    return out


def _eval_keys(xp, key_fns, key_dtypes, env, shape):
    """Group-key values cast to their key dtypes, with validity masks,
    each [N].  Unlike the reference's ``_eval_keys`` they are not yet
    canonical: ``hash_agg_insert`` canonicalizes them (the kernel in its
    key loads, the plain version with ``_canon_keys``)."""
    from citus_tpu_torch.ops.xp_torch import torch_dtype
    keys = []
    for kf, kdt in zip(key_fns, key_dtypes):
        kv, kvalid = kf(env)
        kv = xp.asarray(kv).to(torch_dtype(kdt))
        if kv.dim() == 0 or kv.shape != tuple(shape):
            kv = kv.reshape(-1).expand(tuple(shape))
        kvm = _as_mask(xp, kvalid, kv)
        kvm = xp.asarray(kvm)
        if kvm.dim() == 0 or kvm.shape != tuple(shape):
            kvm = kvm.reshape(-1).expand(tuple(shape))
        keys.append((kv, kvm))
    return keys


@dataclass
class HashTable:
    """The running device hash table of one scan, updated in place.

    ``key_values[k]`` [S] holds key ``k``'s canonical value (its dtype's
    minimum while empty), ``key_flags[k]`` [S] int8 0 = empty, 1 = NULL,
    2 = valid; ``partials[i]`` [S] is partial op ``i``'s register,
    ``rows`` [S] int64 the rows placed in each slot (occupied ⇔
    ``rows > 0``).  ``state`` [S] int32 is the kernel's claim word per
    slot (0 empty, 1 publishing, 2 published), kept equal to
    ``2 * (rows > 0)`` between launches.

    Stacked for Q queries of one plan family (the megabatch path), every
    tensor is [Q, S] and ``query(q)`` is query q's own [S] table."""
    key_values: list
    key_flags: list
    partials: list
    rows: torch.Tensor
    state: torch.Tensor

    @property
    def slots(self) -> int:
        return int(self.rows.shape[-1])

    def query(self, q: int) -> "HashTable":
        """Query q's table of a stacked table, as [S] views."""
        return HashTable([v[q] for v in self.key_values],
                         [f[q] for f in self.key_flags],
                         [p[q] for p in self.partials], self.rows[q],
                         self.state[q])

    def to_host(self):
        """-> (key_tables [(values, flags)], partials, rows) as numpy,
        the reference's fetched table layout."""
        return ([(v.cpu().numpy(), f.cpu().numpy())
                 for v, f in zip(self.key_values, self.key_flags)],
                tuple(p.cpu().numpy() for p in self.partials),
                self.rows.cpu().numpy())


def empty_hash_state(plan: PhysicalPlan, slots: int, key_dtypes: tuple,
                     device, n_queries: Optional[int] = None) -> HashTable:
    """Empty table on ``device``: key value tables filled with their
    dtype minimum, flag tables at 0, partial tables at their op's
    identity/sentinel, rows and claim words at 0.  With ``n_queries``,
    Q stacked tables ([Q, S] tensors)."""
    S = int(slots)
    if S <= 0:
        raise ValueError(f"hash table needs a positive slot count, got {S}")
    shape = (S,) if n_queries is None else (int(n_queries), S)

    def t(a):
        return torch.from_numpy(a).to(device)
    key_values, key_flags = [], []
    for kdt in key_dtypes:
        kdt = np.dtype(kdt)
        key_values.append(t(np.full(shape, _key_sentinel(kdt), kdt)))
        key_flags.append(t(np.zeros(shape, np.int8)))
    partials = []
    for op in plan.partial_ops:
        dt = np.dtype(op.dtype)
        if op.kind == "count" or op.arg_index < 0:
            partials.append(t(np.zeros(shape, np.int64)))
        elif op.kind == "sum":
            partials.append(t(np.zeros(shape, dt)))
        else:
            partials.append(t(np.full(shape, dt.type(_sentinel(op.kind, dt)),
                                      dt)))
    return HashTable(key_values, key_flags, partials,
                     t(np.zeros(shape, np.int64)),
                     t(np.zeros(shape, np.int32)))


def hash_slot_bytes(plan: PhysicalPlan, key_dtypes: tuple) -> int:
    """Device bytes of one slot of a table: key values and flags,
    partials, rows and the claim word."""
    return (sum(np.dtype(k).itemsize + 1 for k in key_dtypes)
            + sum(8 if op.kind == "count" or op.arg_index < 0
                  else np.dtype(op.dtype).itemsize
                  for op in plan.partial_ops) + 8 + 4)


def build_hash_insert_inputs(plan: PhysicalPlan, xp,
                             key_dtypes: tuple) -> Callable:
    """``inputs(table, cols, valids, row_mask)`` -> the argument tuple of
    ``hash_agg_insert`` for one batch: (table, mask, keys, arguments,
    ops).  The fused worker calls the kernel with it; a caller that
    holds the kernel against its plain version gets the main path's
    exact kernel inputs from it."""
    filter_fn = compile_expr(plan.bound.filter, xp) \
        if plan.bound.filter is not None else None
    shared, ops = build_shared_hash_inputs(plan, xp, key_dtypes)
    names = plan.scan_columns + param_env_names(plan.bound.param_specs)

    def inputs(table, cols, valids, row_mask):
        env = {n: (c, v) for n, c, v in zip(names, cols, valids)}
        mask = row_mask
        if filter_fn is not None:
            mask = row_mask & predicate_mask(xp, filter_fn, env, row_mask)
        keys, args = shared(cols, valids, row_mask)
        return table, _vec(xp, mask), keys, args, ops

    return inputs


def build_shared_hash_inputs(plan: PhysicalPlan, xp, key_dtypes: tuple):
    """The part of an insert's inputs that no parameter changes: ->
    (``shared(cols, valids, row_mask)`` -> (keys, arguments) of one
    batch, ops).  The megabatch path computes it once per batch for
    every query of a family; each query contributes only its mask."""
    from citus_tpu_torch.ops.scan_agg_fold import FoldOp
    key_fns = [compile_expr(k, xp) for k in plan.bound.group_keys]
    used = sorted({op.arg_index for op in plan.partial_ops
                   if op.arg_index >= 0})
    arg_fns = [compile_expr(plan.agg_args[i], xp) for i in used]
    slot = {ai: j for j, ai in enumerate(used)}
    ops = [FoldOp("count_star") if op.arg_index < 0
           else FoldOp(op.kind, slot[op.arg_index])
           for op in plan.partial_ops]
    names = plan.scan_columns + param_env_names(plan.bound.param_specs)
    key_dtypes = tuple(np.dtype(d) for d in key_dtypes)

    def shared(cols, valids, row_mask):
        env = {n: (c, v) for n, c, v in zip(names, cols, valids)}
        keys = [(kv.contiguous(), kvm.contiguous()) for kv, kvm in
                _eval_keys(xp, key_fns, key_dtypes, env, row_mask.shape)]
        args = []
        for af in arg_fns:
            v, valid = af(env)
            args.append((_vec(xp, v), _validity(xp, valid)))
        return keys, args

    return shared, ops


def build_fused_hash_worker(plan: PhysicalPlan, xp,
                            key_dtypes: tuple) -> Callable:
    """Fused streaming insert: ``fused(table, cols, valids, row_mask)``
    -> spill mask [N] bool, with ``table`` (a ``HashTable``) updated in
    place — one ``hash_agg_insert`` per batch.  The slot count is read
    off the table, so one built worker serves any
    ``citus.hash_agg_slots`` setting."""
    from citus_tpu_torch.ops.hash_agg_insert import hash_agg_insert
    inputs = build_hash_insert_inputs(plan, xp, key_dtypes)

    def fused(table, cols, valids, row_mask):
        return hash_agg_insert(*inputs(table, cols, valids, row_mask))
    return fused


def merge_hash_tables_into(acc, plan: PhysicalPlan, key_tables, partials, rows,
                           entry_mask=None):
    """Feed a fetched hash table (or its spilled entries) into a
    HostGroupAccumulator."""
    rows = np.asarray(rows)
    occupied = rows > 0
    if entry_mask is not None:
        occupied = occupied & np.asarray(entry_mask)
    keys = []
    for (kvt, kvalid_t), key in zip(key_tables, plan.bound.group_keys):
        kvt = np.asarray(kvt)
        kvalid = np.asarray(kvalid_t) == 2  # stored flag: valid keys are +1
        keys.append((kvt, kvalid))
    partial_vals = [np.asarray(p) for p in partials]
    acc.merge_partials(occupied, keys, partial_vals, rows)
