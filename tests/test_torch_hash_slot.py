"""The slot arithmetic of the port's hash kernels on the CPU:

- ``csrc/hash_slot.cuh hs_slot``, compiled with g++, with the reciprocal
  of ``ops/hash_agg_insert.py slot_magic``, equals numpy's ``h % S`` for
  seeded random 64-bit fingerprints, the edges of the uint64 range and
  multiples of S and their neighbours, at S = 1, 2, 7, 1000, 2^20,
  2^20 + 7, 2^31 - 1, a large odd S and the largest S the kernels take;
- the slot record of a hash table (``ops/hash_agg.py record_layout``):
  ``hash_slot_bytes`` is the record's size, every field of
  ``empty_hash_state``'s table lies inside its record, aligned to its
  size, no two overlap, the Q records of a stacked table's slot sit side
  by side, and the kernel's parameter block (``table_block``) takes the
  same offsets and strides.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from citus_tpu_torch.ops import cuda_build
from citus_tpu_torch.ops.hash_agg import (
    empty_hash_state, hash_slot_bytes, record_layout,
)
from citus_tpu_torch.ops.hash_agg_insert import slot_magic, table_block
from citus_tpu_torch.planner.physical import PartialOp

_HARNESS = r"""
#include "hash_slot.cuh"

extern "C" void h_slots(const uint64_t* h, int64_t n, uint64_t s, uint64_t magic,
                        uint64_t* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = hs_slot(h[i], s, magic);
}
"""

SLOTS = [1, 2, 7, 1000, 1 << 20, (1 << 20) + 7, 2**31 - 1,
         0x2545F4914F6CDD1D >> 3 | 1, (1 << 62) - 1]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ (the native codec's compiler) on this machine")
    d = tmp_path_factory.mktemp("hash_slot")
    (d / "harness.cpp").write_text(_HARNESS)
    so = d / "libhashslot.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                    cuda_build.CSRC, "-o", str(so), str(d / "harness.cpp")],
                   check=True, timeout=300)
    h = ctypes.CDLL(str(so))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    h.h_slots.argtypes = [u64p, ctypes.c_int64, ctypes.c_uint64,
                          ctypes.c_uint64, u64p]
    return h


@pytest.mark.parametrize("S", SLOTS)
def test_slot_of_a_fingerprint_is_its_remainder(lib, S):
    rng = np.random.default_rng(S % 1000)
    top = np.uint64(2**64 - 1)
    h = np.concatenate([
        rng.integers(0, 2**64 - 1, 20_000, dtype=np.uint64, endpoint=True),
        np.array([0, 1, top, top - np.uint64(1), 2**63, 2**63 - 1],
                 np.uint64),
        ((rng.integers(0, (2**64 - 1) // S, 200, dtype=np.uint64,
                       endpoint=True) * np.uint64(S))[:, None]
         + np.array([0, 1, top], np.uint64)).reshape(-1)])
    out = np.empty_like(h)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.h_slots(h.ctypes.data_as(u64p), h.size, S, slot_magic(S),
                out.ctypes.data_as(u64p))
    np.testing.assert_array_equal(out, h % np.uint64(S))


def _plan(kinds_dtypes):
    class Plan:
        partial_ops = [PartialOp(k, -1 if k == "count" else 0, d)
                       for k, d in kinds_dtypes]
    return Plan()


#: bench.py's GROUP BY l_orderkey (count, an int64 sum and its float64
#: shadow), six keys and a 4-byte min, and five keys of one byte each
LAYOUTS = [
    ((np.int64,), [("count", "int64"), ("sum", "int64"),
                   ("sum", "float64")]),
    ((np.int64, np.float64, np.int32, np.bool_, np.float32, np.int64),
     [("count", "int64"), ("min", "int32"), ("max", "float64")]),
    ((np.bool_,) * 5, [("count", "int64")]),
]


@pytest.mark.parametrize("n_q", [None, 3])
@pytest.mark.parametrize("layout", range(len(LAYOUTS)))
def test_slot_records_hold_every_field_once(layout, n_q):
    key_dtypes, ops = LAYOUTS[layout]
    plan = _plan(ops)
    S = 9
    t = empty_hash_state(plan, S, key_dtypes, "cpu", n_queries=n_q)
    lay = record_layout(len(key_dtypes), len(ops))
    rec = hash_slot_bytes(plan, key_dtypes)
    assert rec == 8 * lay.words == 8 * t.records.shape[-1]
    assert t.records.shape[:-1] == ((S,) if n_q is None else (S, n_q))
    fields = t.key_values + t.key_flags + t.partials + [t.rows, t.state]
    base = t.records.data_ptr()
    spans = []
    for f in fields:
        es = f.element_size()
        off = f.data_ptr() - base
        assert off % es == 0 and 0 <= off <= rec - es
        strides = tuple(x * es for x in f.stride())
        assert strides == ((rec,) if n_q is None else (rec, n_q * rec))
        spans.append((off, off + es))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    # the claim word and the flags lead (a probe's head), the row count
    # ends the record
    assert lay.state == 0 and lay.flags == tuple(range(4, 4 + len(key_dtypes)))
    assert lay.rows == rec - 8
    kinds = [k for k, _ in ops]
    shape = (S,) if n_q is None else (n_q, S)
    p = table_block(t, kinds, shape, torch.device("cpu"), 5, n_q)
    assert p.records == base and p.slot_stride == strides[-1]
    assert p.query_stride == (0 if n_q is None else rec)
    assert list(p.key_off[:len(key_dtypes)]) == list(lay.keys)
    assert list(p.flag_off[:len(key_dtypes)]) == list(lay.flags)
    assert list(p.acc_off[:len(ops)]) == list(lay.partials)
    assert (p.rows_off, p.state_off) == (lay.rows, lay.state)
    assert p.slots_magic == slot_magic(S) and p.n == 5
    # cached on the table: the same block again, for another row count
    q = table_block(t, kinds, shape, torch.device("cpu"), 7, n_q)
    assert bytes(q)[8:] == bytes(p)[8:] and q.n == 7


def test_table_block_refuses_tables_not_in_records():
    key_dtypes, ops = LAYOUTS[0]
    t = empty_hash_state(_plan(ops), 9, key_dtypes, "cpu")
    t.rows = t.rows.contiguous()    # a field outside the records
    with pytest.raises(ValueError, match="slot records"):
        table_block(t, [k for k, _ in ops], (9,), torch.device("cpu"), 5)
