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

import numpy as np
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


def _word(*path) -> int:
    """The int64 word of a field of ``_MergeParams`` (a path of names and
    array indexes)."""
    t, off = _MergeParams, 0
    for name in path:
        if isinstance(name, int):
            size = ctypes.sizeof(t._type_)
            t, off = t._type_, off + name * size
        else:
            f = getattr(t, name)
            off += f.offset
            t = dict(t._fields_)[name]
    return off // 8


#: the words a merge call fills: the entry count, the spill mask, each
#: key's values and flags, each op's partials, the row counts
_W_N, _W_SPILL = _word("t", "n"), _word("t", "spill")
_W_KEYS = [_word("keys", i, "data") for i in range(_MAX_KEYS)]
_W_FLAGS = [_word("entry_flags", i) for i in range(_MAX_KEYS)]
_W_ARGS = [_word("args", o, "data") for o in range(_MAX_OPS)]
_W_ROWS = _word("entry_rows")


def _template(table, kinds, dev) -> tuple:
    """-> (the merge block of ``table`` and these kinds with no entries,
    the word indexes a call fills, the entry dtypes), built once per
    table side (``table_block``) and kept on the table."""
    for kind in kinds:
        if kind not in MERGE_KINDS:
            raise ValueError(f"hash_agg_merge: cannot merge partial kind "
                             f"{kind!r}")
    side = table_block(table, kinds, (table.slots,), dev, 0)
    key = bytes(side)
    cached = getattr(table, "_merge_block", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    mp = _MergeParams()
    mp.t = side
    n_k, n_o = len(table.key_values), len(kinds)
    for i, kvt in enumerate(table.key_values):
        mp.keys[i].data_stride, mp.keys[i].dtype = 1, _DTYPE_CODES[kvt.dtype]
    for o, a in enumerate(table.partials):
        mp.args[o].data_stride, mp.args[o].dtype = 1, _DTYPE_CODES[a.dtype]
        mp.t.op_arg[o] = o
    words = np.array(_W_KEYS[:n_k] + _W_FLAGS[:n_k] + _W_ARGS[:n_o]
                     + [_W_ROWS, _W_SPILL, _W_N], np.int64)
    dtypes = ([v.dtype for v in table.key_values] + [torch.int8] * n_k
              + [a.dtype for a in table.partials] + [torch.int64])
    out = (bytes(mp), words, dtypes)
    table._merge_block = (key, out)
    return out


def _block(table, keys, partials, rows, kinds, spill) -> _MergeParams:
    """The parameter block (``HamParams``) of one merge: the table's
    template with this call's entry pointers written in as int64 words."""
    dev = rows.device
    m = rows.shape[0] if rows.dim() == 1 else -1
    if not 0 < len(keys) <= _MAX_KEYS or len(kinds) > _MAX_OPS:
        raise ValueError(f"hash_agg_merge takes 1 to {_MAX_KEYS} keys and "
                         f"at most {_MAX_OPS} partial ops")
    if len(keys) != len(table.key_values) \
            or not len(partials) == len(kinds) == len(table.partials):
        raise ValueError("hash_agg_merge: one key and flag entry column "
                         "per key table, one partial column and kind per "
                         "partial table")
    block, words, dtypes = _template(table, kinds, dev)
    entries = ([kv for kv, _ in keys] + [kf for _, kf in keys]
               + list(partials) + [rows])
    for t, want in zip(entries, dtypes):
        if t.dtype != want or t.shape != (m,) or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(
                f"hash_agg_merge: every entry column must be a contiguous "
                f"[{m}] tensor on {dev} of its table's dtype (keys, int8 "
                f"flags, partials, int64 rows), got {t.dtype} "
                f"{tuple(t.shape)} on {t.device} for {want}")
    buf = bytearray(block)
    np.frombuffer(buf, np.int64)[words] = [t.data_ptr() for t in entries] \
        + [spill.data_ptr(), m]
    return _MergeParams.from_buffer(buf)


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
