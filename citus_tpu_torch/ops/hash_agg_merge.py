"""A peer's hash table merged into the running device hash table: the
hand-written CUDA kernel ``csrc/hash_agg_merge.cu`` and its plain
PyTorch version.

``hash_agg_merge(table, keys, partials, rows, kinds)`` re-inserts the
entries of a hash table another coordinator shipped back for a pushed
hash GROUP BY task (``net/data_plane.py decode_hash_partials``) into
``table`` (an ``ops/hash_agg.HashTable``), in place, and returns the
entry spill mask: the entries that lost both probes, which the caller
merges exactly on the host.  It is the reference's
``citus_tpu/ops/hash_agg.py`` ``build_fused_entry_merge``.

The M entries are the peer's whole table, mostly empty: ``keys`` are
(values of the table's key dtype, int8 flags) pairs of [M] vectors
(flag 0 empty, 1 NULL, 2 valid), ``partials[o]`` the peer's [M] register
of partial op ``o`` in the table's accumulator dtype, ``rows`` the
entries' int64 row counts (0 = empty: skipped, its key never read, so a
``citus_tpu`` peer's layout — dtype-minimum keys and flag 0 in empty
slots — merges as well as this package's).  ``kinds[o]`` is op ``o``'s
partial kind: count and sum add the entry's value (a count adds the
entry's count, not 1), min and max keep the NaN-propagating extremum;
``rows`` adds into the table's row counts.  Probing and claiming are the
insert's (``ops/hash_agg_insert.py``): a group's slot is the same
whichever of the two fills it.

On CUDA tensors it launches the kernel (one launch per call, counted in
``hash_agg_merge.launches``) or raises; on CPU tensors it runs
``hash_agg_merge_plain``.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from citus_tpu_torch.ops.cuda_build import count_launch
from citus_tpu_torch.ops.hash_agg import _canon_keys, _fingerprint
from citus_tpu_torch.ops.hash_agg_insert import (
    _MAX_KEYS, _MAX_OPS, _Params, _insert_keys, table_block,
)
from citus_tpu_torch.ops.scan_agg_fold import _DTYPE_CODES, _sentinel

#: partial kinds a slot can merge (the reference's _HASH_MERGE_KINDS)
MERGE_KINDS = ("count", "sum", "min", "max")


def hash_agg_merge_plain(table, keys: Sequence[tuple],
                         partials: Sequence[torch.Tensor],
                         rows: torch.Tensor, kinds: Sequence[str]
                         ) -> torch.Tensor:
    """The same merge in plain tensor ops, on any device: the insert's
    claim-then-verify passes (``_insert_keys``) over the occupied
    entries, then ``index_add_``/``scatter_reduce_`` of their partial
    states.  -> entry spill mask [M]."""
    mask = rows > 0
    canon = _canon_keys([(kv, kf == 2) for kv, kf in keys])
    h = _fingerprint(canon, tuple(rows.shape), rows.device)
    slot, placed, _ = _insert_keys(canon, mask, h, table.key_values,
                                   table.key_flags, table.rows > 0)
    for prior, p, kind in zip(table.partials, partials, kinds):
        if kind in ("count", "sum"):
            prior.index_add_(0, slot, torch.where(placed, p, 0)
                             .to(prior.dtype))
        else:
            upd = torch.where(placed, p.to(prior.dtype),
                              _sentinel(kind, prior.dtype))
            prior.scatter_reduce_(0, slot, upd,
                                  "amin" if kind == "min" else "amax",
                                  include_self=True)
    table.rows.index_add_(0, slot, torch.where(placed, rows, 0))
    table.state.copy_(torch.where(table.rows > 0, 2, 0).to(torch.int32))
    return mask & ~placed


# ------------------------------------------------------------- kernel


class _Col(ctypes.Structure):
    """A column of entries (``SafCol``, ``csrc/columns.cuh``)."""
    _fields_ = [("data", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("data_stride", ctypes.c_int64),
                ("valid_stride", ctypes.c_int64),
                ("dtype", ctypes.c_int32), ("pad", ctypes.c_int32)]


class _MergeParams(ctypes.Structure):
    _fields_ = [("t", _Params),
                ("keys", _Col * _MAX_KEYS),
                ("args", _Col * _MAX_OPS),
                ("entry_flags", ctypes.c_void_p * _MAX_KEYS),
                ("entry_rows", ctypes.c_void_p)]


_lib = None


def _library():
    global _lib
    if _lib is None:
        from citus_tpu_torch.ops.cuda_build import load
        lib = load("hash_agg_merge")
        lib.hash_agg_merge_launch.restype = ctypes.c_int
        lib.hash_agg_merge_launch.argtypes = [ctypes.POINTER(_MergeParams),
                                              ctypes.c_void_p]
        lib.hash_agg_merge_params_size.restype = ctypes.c_int
        lib.hash_agg_merge_params_size.argtypes = []
        if lib.hash_agg_merge_params_size() != ctypes.sizeof(_MergeParams):
            raise RuntimeError("hash_agg_merge: parameter block layout "
                               "differs between Python and CUDA")
        _lib = lib
    return _lib


def _check_entries(t: torch.Tensor, what: str, m: int, dtypes, dev) -> None:
    if t.device != dev or t.dtype not in dtypes or t.shape != (m,) \
            or not t.is_contiguous():
        raise ValueError(
            f"hash_agg_merge: {what} must be a contiguous [{m}] tensor of "
            f"{dtypes} on {dev}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def _entry_col(t: torch.Tensor, what: str, m: int, dtypes, dev) -> _Col:
    _check_entries(t, what, m, dtypes, dev)
    c = _Col()
    c.data = t.data_ptr()
    c.data_stride = 1
    c.dtype = _DTYPE_CODES[t.dtype]
    return c


def _block(table, keys, partials, rows, kinds, spill) -> _MergeParams:
    dev = rows.device
    m = rows.shape[0] if rows.dim() == 1 else -1
    if m < 0 or rows.dtype != torch.int64 or not rows.is_contiguous():
        raise ValueError("hash_agg_merge: rows must be a contiguous int64 "
                         "vector")
    if not 0 < len(keys) <= _MAX_KEYS or len(kinds) > _MAX_OPS:
        raise ValueError(f"hash_agg_merge takes 1 to {_MAX_KEYS} keys and "
                         f"at most {_MAX_OPS} partial ops")
    if len(keys) != len(table.key_values) \
            or not len(partials) == len(kinds) == len(table.partials):
        raise ValueError("hash_agg_merge: one key and flag entry column "
                         "per key table, one partial column and kind per "
                         "partial table")
    for kind in kinds:
        if kind not in MERGE_KINDS:
            raise ValueError(f"hash_agg_merge: cannot merge partial kind "
                             f"{kind!r}")
    S = table.slots
    if S <= 0 or S >= 1 << 62:
        raise ValueError(f"hash_agg_merge: bad slot count {S}")
    mp = _MergeParams()
    mp.t = table_block(table, kinds, (S,), dev, m)
    mp.t.spill = spill.data_ptr()
    for i, ((kv, kf), kvt) in enumerate(zip(keys, table.key_values)):
        mp.keys[i] = _entry_col(kv, f"key entries {i}", m, (kvt.dtype,), dev)
        _check_entries(kf, f"key flag entries {i}", m, (torch.int8,), dev)
        mp.entry_flags[i] = kf.data_ptr()
    for o, (a, e, kind) in enumerate(zip(table.partials, partials, kinds)):
        mp.args[o] = _entry_col(e, f"partial entries {o} ({kind})", m,
                                (a.dtype,), dev)
        mp.t.op_arg[o] = o
    mp.entry_rows = rows.data_ptr()
    return mp


def _launch(table, keys, partials, rows, kinds) -> torch.Tensor:
    dev = rows.device
    spill = torch.zeros(rows.shape, dtype=torch.bool, device=dev)
    mp = _block(table, keys, partials, rows, kinds, spill)
    if mp.t.n == 0:
        return spill
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().hash_agg_merge_launch(ctypes.byref(mp), stream)
    if err != 0:
        raise RuntimeError(f"hash_agg_merge launch failed: CUDA error {err}")
    count_launch(hash_agg_merge)
    return spill


def hash_agg_merge(table, keys: Sequence[tuple],
                   partials: Sequence[torch.Tensor], rows: torch.Tensor,
                   kinds: Sequence[str]) -> torch.Tensor:
    """Merge a peer's table entries into ``table`` in place; -> entry
    spill mask [M] bool.

    CUDA tensors launch the kernel, CPU tensors run the plain version."""
    if rows.device.type == "cuda":
        return _launch(table, keys, partials, rows, kinds)
    if rows.device.type != "cpu":
        raise ValueError(f"hash_agg_merge: no kernel for {rows.device}")
    return hash_agg_merge_plain(table, keys, partials, rows, kinds)


#: kernel launches since the counter was last set to 0
hash_agg_merge.launches = 0
