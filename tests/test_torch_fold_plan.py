"""The host-compilable half of the port's fold kernel
(``citus_tpu_torch/csrc/fold_plan.cuh``), compiled with g++ and held
against Python models on the CPU:

- the shared-memory plan: the table's bytes and op offsets for q queries
  (8-byte slots, 4-byte HLL registers, 8-aligned regions, the rows
  counter last), and the queries per chunk when only some queries'
  registers fit the opt-in limit: every query in one table, the fewest
  chunks that fit, balanced, or 0 (global atomics) when one query's
  registers do not fit; at the limit's edges, and for the plans
  chip_smoke.py runs (TPC-H Q1's family at Q = 8 and 32, the S family
  of sketch aggregates at Q = 6 and 8, the G = 65,536 direct fold);
- the warp segments of the warp-aggregated updates: the n-th set bit of
  a mask, and a whole warp's tree reduction over its segments (the
  shuffles emulated lane by lane), whose rank-0 lanes must hold each
  segment's sum: one segment of 32 lanes, 32 singletons, half the lanes
  out (singletons that pass nothing), TPC-H Q1's 4 filled groups, and
  random partitions.

The device half (the shuffles, ballots and atomics) runs on a card:
``tests/test_torch_fold_card.py``.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from citus_tpu_torch.ops import cuda_build
from citus_tpu_torch.ops.scan_agg_fold import SKETCH_M

#: the opt-in shared-memory limit of a block on an H100 (232,448 B)
H100_SMEM = 227 * 1024

_HARNESS = r"""
#include "fold_plan.cuh"

extern "C" int h_nth_set_bit(unsigned m, int n) { return nth_set_bit(m, n); }
extern "C" int h_seg_steps(int s) { return seg_steps(s); }

extern "C" int64_t h_table_bytes(int n_ops, const int* kb, const int* m, int64_t g,
                                 int64_t q, int rows, int64_t* soff) {
    return fold_table_bytes(n_ops, kb, m, g, q, rows != 0, soff);
}

extern "C" int h_query_chunk(int n_ops, const int* kb, const int* m, int64_t g, int n_q,
                             int rows, int64_t limit) {
    return fold_query_chunk(n_ops, kb, m, g, n_q, rows != 0, limit);
}

// a warp's tree reduction over its segments, the shuffles emulated:
// every lane reads, at step k, lane src[k]'s value of the step before
extern "C" int h_warp_sum(const unsigned* peers, const long long* x, long long* out) {
    int largest = 0;
    for (int l = 0; l < 32; ++l) {
        const int s = fp_popc(peers[l]);
        largest = s > largest ? s : largest;
    }
    const int steps = seg_steps(largest);
    WarpSeg seg[32];
    for (int l = 0; l < 32; ++l) {
        seg[l] = warp_seg(peers[l], l, steps);
        seg_sources(seg[l], l);
        out[l] = x[l];
    }
    for (int k = 0; k < steps; ++k) {
        long long y[32];
        for (int l = 0; l < 32; ++l) y[l] = out[seg[l].src[k]];
        for (int l = 0; l < 32; ++l)
            if (seg_takes(seg[l], k)) out[l] += y[l];
    }
    return steps;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ (the native codec's compiler) on this machine")
    d = tmp_path_factory.mktemp("fold_plan")
    (d / "harness.cpp").write_text(_HARNESS)
    so = d / "libfoldplan.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                    cuda_build.CSRC, "-o", str(so), str(d / "harness.cpp")],
                   check=True, timeout=300)
    h = ctypes.CDLL(str(so))
    i32p, i64p = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64)
    h.h_nth_set_bit.argtypes = [ctypes.c_uint, ctypes.c_int]
    h.h_seg_steps.argtypes = [ctypes.c_int]
    h.h_table_bytes.argtypes = [ctypes.c_int, i32p, i32p, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_int, i64p]
    h.h_table_bytes.restype = ctypes.c_int64
    h.h_query_chunk.argtypes = [ctypes.c_int, i32p, i32p, ctypes.c_int64,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int64]
    h.h_warp_sum.argtypes = [ctypes.POINTER(ctypes.c_uint),
                             ctypes.POINTER(ctypes.c_longlong),
                             ctypes.POINTER(ctypes.c_longlong)]
    return h


def _ops(kinds):
    """(kind bytes, registers per group) arrays of a fold's ops, as the
    launcher passes them."""
    kb = (ctypes.c_int * len(kinds))(*[4 if k == "hll" else 8
                                       for k in kinds])
    m = (ctypes.c_int * len(kinds))(*[SKETCH_M.get(k, 1) for k in kinds])
    return kb, m


def _model_bytes(kinds, G, q, rows):
    """The table's bytes and op offsets, modelled in Python."""
    offs, b = [], 0
    for k in kinds:
        offs.append(b)
        b += q * G * SKETCH_M.get(k, 1) * (4 if k == "hll" else 8)
        b = -(-b // 8) * 8
    offs.append(b)
    return b + (q * G * 8 if rows else 0), offs


def _model_chunk(kinds, G, n_q, rows, limit):
    fit = 0
    for q in range(1, n_q + 1):
        if _model_bytes(kinds, G, q, rows)[0] > limit:
            break
        fit = q
    if fit == 0:
        return 0
    chunks = -(-n_q // fit)
    return -(-n_q // chunks)


#: TPC-H Q1's partial ops as the port plans them (16: each sum beside
#: its float64 shadow, each avg as sum and count) and the S family's
#: (S1: count(*), approx_count_distinct, approx_percentile, approx_top_k)
Q1_OPS = ["sum", "count", "sum"] * 5 + ["count_star"]
S_OPS = ["count_star", "hll", "ddsk", "topk", "topkv"]


def test_table_bytes_and_offsets_match_the_model(lib):
    rng = np.random.default_rng(3)
    kinds_all = ["count_star", "count", "sum", "min", "max", "hll", "ddsk",
                 "topk", "topkv"]
    for _ in range(200):
        kinds = list(rng.choice(kinds_all, int(rng.integers(1, 12))))
        G, q = int(rng.integers(1, 5000)), int(rng.integers(1, 40))
        rows = bool(rng.integers(0, 2))
        kb, m = _ops(kinds)
        soff = (ctypes.c_int64 * (len(kinds) + 1))()
        got = lib.h_table_bytes(len(kinds), kb, m, G, q, rows, soff)
        want, offs = _model_bytes(kinds, G, q, rows)
        assert got == want and list(soff) == offs


@pytest.mark.parametrize("kinds,G,n_q,rows,want", [
    # Q1's family: 12 groups, every query in one table
    (Q1_OPS, 12, 8, True, 8),
    (Q1_OPS, 12, 32, True, 32),
    # a sketch query's ~33 KB: 6 fit, so Q = 8 folds in two chunks of 4
    (S_OPS, 1, 6, False, 6),
    (S_OPS, 1, 8, False, 4),
    (S_OPS, 1, 7, False, 4),
    (S_OPS, 1, 13, False, 5),
    (S_OPS, 1, 1, False, 1),
    # the G = 65,536 direct fold: one query does not fit
    (["count_star", "sum", "min", "max"], 65536, 1, True, 0),
    (["count_star", "sum", "min", "max"], 65536, 3, True, 0),
])
def test_query_chunks_of_the_main_path_plans(lib, kinds, G, n_q, rows, want):
    kb, m = _ops(kinds)
    if kinds is Q1_OPS and n_q == 32:      # scan_agg_fold_batched.cu's figure
        assert _model_bytes(kinds, G, n_q, rows)[0] == 52_224
    got = lib.h_query_chunk(len(kinds), kb, m, G, n_q, rows, H100_SMEM)
    assert got == want == _model_chunk(kinds, G, n_q, rows, H100_SMEM)


def test_query_chunks_at_the_limits_edges(lib):
    """A table of exactly the limit fits, one byte less does not; chunks
    are balanced; no queries, or one query past the limit, give 0."""
    kinds = ["count_star", "sum", "hll"]
    kb, m = _ops(kinds)
    one = _model_bytes(kinds, 7, 1, True)[0]
    for q in (1, 2, 5, 9):
        exact = _model_bytes(kinds, 7, q, True)[0]
        assert lib.h_query_chunk(3, kb, m, 7, q, True, exact) == q
        got = lib.h_query_chunk(3, kb, m, 7, q, True, exact - 1)
        assert got == _model_chunk(kinds, 7, q, True, exact - 1)
        assert (got < q) if q > 1 else got == 0
    assert lib.h_query_chunk(3, kb, m, 7, 0, True, 10**9) == 0
    assert lib.h_query_chunk(3, kb, m, 7, 4, True, one - 1) == 0
    assert lib.h_query_chunk(3, kb, m, 7, 4, True, one) == 1
    # 10 queries, 3 fit: 4 chunks of 3 (not 3, 3, 3, 1 unbalanced: the
    # fewest chunks, then the fewest queries a chunk)
    three = _model_bytes(kinds, 7, 3, True)[0]
    assert lib.h_query_chunk(3, kb, m, 7, 10, True, three) == 3
    assert lib.h_query_chunk(3, kb, m, 7, 9, True, three) == 3
    four = _model_bytes(kinds, 7, 4, True)[0]
    assert lib.h_query_chunk(3, kb, m, 7, 9, True, four) == 3
    rng = np.random.default_rng(5)
    for _ in range(300):
        G, n_q = int(rng.integers(1, 300)), int(rng.integers(1, 70))
        limit = int(rng.integers(0, 300_000))
        rows = bool(rng.integers(0, 2))
        got = lib.h_query_chunk(3, kb, m, G, n_q, rows, limit)
        assert got == _model_chunk(kinds, G, n_q, rows, limit)
        if got:
            assert _model_bytes(kinds, G, got, rows)[0] <= limit
            chunks = -(-n_q // got)
            assert (chunks - 1) * got < n_q


def test_nth_set_bit(lib):
    rng = np.random.default_rng(11)
    masks = [0xffffffff, 1, 0x80000000, 0x80000001, 0x55555555] + [
        int(x) for x in rng.integers(1, 2**32, 500, dtype=np.uint64)]
    for m in masks:
        bits = [b for b in range(32) if (m >> b) & 1]
        for n, b in enumerate(bits):
            assert lib.h_nth_set_bit(m, n) == b
    assert [lib.h_seg_steps(s) for s in (1, 2, 3, 4, 5, 16, 17, 32)] == \
        [0, 1, 2, 2, 3, 4, 5, 5]


def _segments(labels):
    """Each lane's peers mask: the lanes of its label (label -1: a lane
    that passes nothing, its own segment)."""
    peers = []
    for lane, lab in enumerate(labels):
        if lab < 0:
            peers.append(1 << lane)
        else:
            peers.append(sum(1 << j for j, x in enumerate(labels)
                             if x == lab))
    return peers


def _warp_sum(lib, labels, x):
    peers = _segments(labels)
    out = (ctypes.c_longlong * 32)()
    steps = lib.h_warp_sum((ctypes.c_uint * 32)(*peers),
                           (ctypes.c_longlong * 32)(*x), out)
    return peers, list(out), steps


@pytest.mark.parametrize("case", ["one segment", "singletons", "half out",
                                  "q1 groups", "random"])
def test_warp_tree_reduction_over_segments(lib, case):
    rng = np.random.default_rng(len(case))
    for trial in range(50):
        if case == "one segment":
            labels = [0] * 32
        elif case == "singletons":
            labels = list(range(32))
        elif case == "half out":
            labels = [0 if lane % 2 else -1 for lane in range(32)]
        elif case == "q1 groups":     # 4 filled groups of 12
            labels = list(rng.choice([0, 3, 7, 11], 32))
        else:
            labels = list(rng.integers(-1, int(rng.integers(1, 33)), 32))
        x = [int(v) for v in rng.integers(-10**12, 10**12, 32)]
        peers, out, steps = _warp_sum(lib, labels, x)
        largest = max(bin(p).count("1") for p in peers)
        assert steps == (largest - 1).bit_length()
        for lane, p in enumerate(peers):
            if p & ((1 << lane) - 1):
                continue             # not the segment's rank-0 lane
            want = sum(x[j] for j in range(32) if (p >> j) & 1)
            assert out[lane] == want, (case, trial, lane)
