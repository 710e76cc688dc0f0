"""Device-side hash aggregation for unbounded GROUP BY cardinality.

When the key domain can't be proven small (no direct-gid mode), the
executor aggregates on the device into ONE fixed-size open-addressed
hash table that lives on the card for the whole scan.  Each batch goes
through ``build_fused_hash_worker``: one ``hash_agg_insert``
(``ops/hash_agg_insert.py``: on a card the CUDA kernel generated from
the plan's filter, group keys and aggregate arguments, on the CPU its
plain PyTorch version) evaluates them, canonicalizes and fingerprints
the keys, places each row in its group's slot or reports it in a spill
mask, and folds the partial states in place —
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

from citus_tpu_torch.ops.scan_agg import _sentinel
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
    tensor is [Q, S] and ``query(q)`` is query q's own [S] table.

    ``empty_hash_state`` lays every slot out as one record
    (``SlotRecord``) of ``records``, [S, W] (stacked: [S, Q, W], the Q
    records of a slot side by side) int64 words, and the tensors above
    are strided views of it, so the insert kernels touch one record a
    slot.  A table of separate tensors (``records`` None) serves the
    plain versions; the kernels refuse it."""
    key_values: list
    key_flags: list
    partials: list
    rows: torch.Tensor
    state: torch.Tensor
    records: Optional[torch.Tensor] = None

    @property
    def slots(self) -> int:
        return int(self.rows.shape[-1])

    def query(self, q: int) -> "HashTable":
        """Query q's table of a stacked table, as [S] views."""
        return HashTable([v[q] for v in self.key_values],
                         [f[q] for f in self.key_flags],
                         [p[q] for p in self.partials], self.rows[q],
                         self.state[q],
                         None if self.records is None
                         else self.records[:, q])

    def to_host(self):
        """-> (key_tables [(values, flags)], partials, rows) as numpy,
        the reference's fetched table layout (of a record table: one copy
        of its records, viewed field by field)."""
        t = self
        if self.records is not None:
            t = record_views(self.records.cpu(),
                             [v.dtype for v in self.key_values],
                             [p.dtype for p in self.partials])
        return ([(v.cpu().numpy(), f.cpu().numpy())
                 for v, f in zip(t.key_values, t.key_flags)],
                tuple(p.cpu().numpy() for p in t.partials),
                t.rows.cpu().numpy())


@dataclass(frozen=True)
class SlotRecord:
    """The byte offsets of a slot's fields in its record of ``words``
    int64 words: the claim word at 0 and key k's flag at ``4 + k`` (the
    head, the words a probe reads first), then one word for each key
    value, one for each partial register (a 4-byte one in its low half)
    and the row count."""
    words: int
    flags: tuple
    keys: tuple
    partials: tuple
    rows: int
    state: int = 0


def record_layout(n_k: int, n_o: int) -> SlotRecord:
    """The slot record of a table of ``n_k`` keys and ``n_o`` partial
    ops."""
    head = -(-(4 + n_k) // 8)
    return SlotRecord(head + n_k + n_o + 1,
                      tuple(4 + k for k in range(n_k)),
                      tuple(8 * (head + k) for k in range(n_k)),
                      tuple(8 * (head + n_k + o) for o in range(n_o)),
                      8 * (head + n_k + n_o))


def _field(records: torch.Tensor, dtype: torch.dtype, off: int):
    """The field at byte ``off`` of every record, as a strided view."""
    return records.view(dtype)[..., off // dtype.itemsize]


def record_views(records: torch.Tensor, key_dtypes, acc_dtypes
                 ) -> HashTable:
    """``records`` ([S, W] or [S, Q, W] int64, ``record_layout``'s W) as
    a HashTable of [S] / [Q, S] views of these key and register torch
    dtypes."""
    lay = record_layout(len(key_dtypes), len(acc_dtypes))
    if records.dtype != torch.int64 or records.shape[-1] != lay.words:
        raise ValueError(f"hash table records must be int64 [..., "
                         f"{lay.words}]")

    def f(dtype, off):
        v = _field(records, dtype, off)
        return v if v.dim() == 1 else v.transpose(0, 1)
    return HashTable([f(d, o) for d, o in zip(key_dtypes, lay.keys)],
                     [f(torch.int8, o) for o in lay.flags],
                     [f(d, o) for d, o in zip(acc_dtypes, lay.partials)],
                     f(torch.int64, lay.rows), f(torch.int32, lay.state),
                     records)


def empty_hash_state(plan: PhysicalPlan, slots: int, key_dtypes: tuple,
                     device, n_queries: Optional[int] = None) -> HashTable:
    """Empty table on ``device``: key value tables filled with their
    dtype minimum, flag tables at 0, partial tables at their op's
    identity/sentinel, rows and claim words at 0.  With ``n_queries``,
    Q stacked tables ([Q, S] tensors).  Every slot is one record of
    ``records`` (``record_layout``); the tensors are views of it."""
    from citus_tpu_torch.ops.xp_torch import torch_dtype
    S = int(slots)
    if S <= 0:
        raise ValueError(f"hash table needs a positive slot count, got {S}")
    kdts = [np.dtype(k) for k in key_dtypes]
    adts = [_acc_dtype(op) for op in plan.partial_ops]
    tk = [torch_dtype(k) for k in kdts]
    ta = [torch_dtype(a) for a in adts]
    shape = (S,) if n_queries is None else (S, int(n_queries))
    # filled on the host and copied: no device kernel but the inserts'
    table = record_views(
        torch.zeros(shape + (record_layout(len(tk), len(ta)).words,),
                    dtype=torch.int64), tk, ta)
    for v, kdt in zip(table.key_values, kdts):
        v.fill_(np.asarray(_key_sentinel(kdt)).item())
    for p, op, dt in zip(table.partials, plan.partial_ops, adts):
        if op.kind in ("min", "max") and op.arg_index >= 0:
            p.fill_(np.asarray(_sentinel(op.kind, dt), dt).item())
    return record_views(table.records.to(device), tk, ta)


def _acc_dtype(op) -> np.dtype:
    """The register dtype of a hash table's partial op."""
    if op.kind == "count" or op.arg_index < 0:
        return np.dtype(np.int64)
    return np.dtype(op.dtype)


def hash_slot_bytes(plan: PhysicalPlan, key_dtypes: tuple) -> int:
    """Device bytes of one slot of a table: its record (key values and
    flags, partials, rows and the claim word, ``record_layout``)."""
    return 8 * record_layout(len(key_dtypes), len(plan.partial_ops)).words


def build_hash_insert_inputs(plan: PhysicalPlan, key_dtypes: tuple,
                             param_dtypes=None) -> Callable:
    """``inputs(table, cols, valids, row_mask, params=None)`` -> the
    argument tuple of ``hash_agg_insert`` for one batch: (the plan's
    hash ``FoldProgram``, table, scan columns by name, parameters, row
    mask).  The fused worker calls the kernel with it; a caller that
    holds the kernel against its plain version gets the main path's
    exact kernel inputs from it."""
    from citus_tpu_torch.ops.scan_agg_fold import FoldProgram
    prog = FoldProgram.of_plan(plan, param_dtypes or {}, key_dtypes)
    names = plan.scan_columns

    def inputs(table, cols, valids, row_mask, params=None):
        return (prog, table, dict(zip(names, zip(cols, valids))),
                params or {}, row_mask)

    return inputs


def build_fused_hash_worker(plan: PhysicalPlan, key_dtypes: tuple,
                            param_dtypes=None) -> Callable:
    """Fused streaming insert: ``fused(table, cols, valids, row_mask,
    params=None)`` -> spill mask [N] bool, with ``table`` (a
    ``HashTable``) updated in place — one ``hash_agg_insert`` per batch.
    The slot count is read off the table, so one built worker serves any
    ``citus.hash_agg_slots`` setting."""
    from citus_tpu_torch.ops.hash_agg_insert import hash_agg_insert
    inputs = build_hash_insert_inputs(plan, key_dtypes, param_dtypes)

    def fused(table, cols, valids, row_mask, params=None):
        return hash_agg_insert(*inputs(table, cols, valids, row_mask,
                                       params))
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
