"""Filtered projections and the generated predicate kernel of the port,
held against the JAX package.

- The same SELECT without aggregates goes through ``citus_tpu.Cluster``
  and ``citus_tpu_torch.Cluster(device="cpu")`` over the same rows: the
  projections of tests/test_oracle.py, TPC-H drill-down P1 and a few
  more.  Rows must be identical: as lists under ORDER BY, as multisets
  without it (without ORDER BY the row order is the scan order, which
  both packages share today, but SQL does not promise it).
- Every node kind the predicate generator (``ops/expr_codegen.py``)
  takes goes through ``filter_mask``'s plain version and through the
  reference's ``predicate_mask`` under JAX, on the same numpy-seeded
  columns with nulls, NaN, +-inf, +-0.0 and zero divisors: the masks
  must be identical.
- The generated ``__host__ __device__`` predicate compiles with g++ (the
  compiler of the port's native codec) into a host harness loaded with
  ctypes, and gives the same masks: the generator's C++ semantics are
  checked here, not only on a card.
- ``test_filter_kernel_matches_plain_on_card`` holds the CUDA kernel
  against the plain version; it needs a card and skips here.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import citus_tpu as ct
import jax.numpy as jnp
import torch

import citus_tpu_torch as ctt
from citus_tpu.planner import parse_sql as ref_parse
from citus_tpu.planner.auto_param import auto_parameterize as ref_auto_param
from citus_tpu.planner.bind import bind_select as ref_bind
from citus_tpu.planner.bound import compile_expr as ref_compile
from citus_tpu.planner.bound import predicate_mask as ref_predicate_mask
from citus_tpu_torch.ops import cuda_build
from citus_tpu_torch.ops.expr_codegen import generate_predicate
from citus_tpu_torch.ops.filter_mask import (
    FilterProgram, _FmBatch, _FmParams, _param_bits, filter_mask,
    filter_mask_batched, filter_mask_batched_plain, filter_mask_plain,
    stack_params,
)
from citus_tpu_torch.planner import parse_sql
from citus_tpu_torch.planner.auto_param import auto_parameterize
from citus_tpu_torch.planner.bind import bind_select
from citus_tpu_torch.planner.bound import param_env_names

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from torch_fold_cases import predicate_table as _predicate_table  # noqa: E402
from test_torch_slice import (  # noqa: E402
    _load_events, _load_lineitem, assert_same_rows,
)

N = 2000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    ref = ct.Cluster(str(tmp_path_factory.mktemp("ref")))
    port = ctt.Cluster(str(tmp_path_factory.mktemp("port")), device="cpu")
    for cl in (ref, port):
        _load_lineitem(cl, 3000)
        _load_events(cl)
    yield ref, port
    port.close()
    ref.close()


PROJECTIONS = [
    # tests/test_oracle.py:65, :69, :70
    "SELECT id, qty FROM events WHERE id = 777",
    "SELECT device FROM events WHERE id < 20 ORDER BY device NULLS FIRST "
    "LIMIT 5",
    "SELECT DISTINCT kind FROM events ORDER BY kind NULLS LAST",
    # TPC-H drill-down P1 (chip_smoke.py)
    chip_smoke.P1,
    "SELECT id, kind, score FROM events WHERE kind = 'buy' AND qty > 90 "
    "ORDER BY id",
    "SELECT id, qty * 2, score / 2 FROM events WHERE device IS NULL "
    "OR score < 1 ORDER BY id",
    "SELECT id FROM events WHERE d BETWEEN '2021-01-01' AND '2021-12-31' "
    "AND kind LIKE 'v%' ORDER BY id LIMIT 7",
    "SELECT id, device FROM events WHERE device % 7 = 3",
    "SELECT id, d FROM events WHERE NOT (qty >= 10) ORDER BY id DESC LIMIT 9",
    "SELECT l_orderkey, l_quantity FROM lineitem WHERE l_orderkey = 17",
    "SELECT id FROM events ORDER BY id LIMIT 4",
]


def _same_rows(got, want, ordered):
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert_same_rows(got, want)


@pytest.mark.parametrize("sql", PROJECTIONS)
def test_projection_rows_identical_to_reference(pair, sql):
    ref, port = pair
    r = port.execute(sql)
    _same_rows(r.rows, ref.execute(sql).rows, "ORDER BY" in sql)


def test_projection_explain_strategy_and_cpu_backend(pair):
    """The explain dict names the projection strategy, as the
    reference's does, and the numpy ``cpu`` backend gives the rows the
    device backend gives."""
    ref, port = pair
    sql = PROJECTIONS[4]
    r = port.execute(sql)
    assert r.explain["strategy"] == "projection"
    assert ref.execute(sql).explain["strategy"] == "projection"
    port.execute("SET citus.task_executor_backend = 'cpu'")
    try:
        assert port.execute(sql).rows == r.rows
    finally:
        port.execute("SET citus.task_executor_backend = 'gpu'")


# ------------------------------------------------ predicates, node by node

#: each predicate binds to the node kinds named beside it
PREDICATES = [
    "a > 10 AND b <= 3",                          # BBinOp and, comparisons
    "a < 0 OR s > 0.5",                           # or, float compare, NaN
    "NOT (f < 0.25)",                             # BUnOp not, float32
    "(a > 0 AND s > 0) OR (b < 2 AND f > 0)",     # three-valued nesting
    "a + b * 3 - 7 > 20",                         # int + - *
    "a / b > 1",                                  # _trunc_div, b = 0 null
    "a % b = 1",                                  # %, zero divisor
    "-a < 5",                                     # BUnOp -
    "p > 12.5",                                   # BScale (decimal literal)
    "p + 1.25 > 40",                              # decimal arithmetic
    "p * 2 < 100",
    "p / 3 > 5",                                  # decimal division
    "s / 2 > 0.1",                                # float division
    "s / u > 1",                                  # float divide by zero
    "s * u + s > 0.75",                           # float * then + (no FMA)
    "a IS NULL",                                  # BIsNull
    "s IS NOT NULL AND f IS NULL",
    "CAST(a AS double) > 12.5",                   # BCast int -> float
    "CAST(u AS bigint) = 3",                      # float -> int
    "CAST(s AS bigint) = 0 OR CAST(f AS bigint) > 5",  # NaN, inf -> int
    "CAST(p AS bigint) > 7",                      # decimal -> int
    "CAST(p AS double) < 33.3",                   # decimal -> float
    "CAST(p AS decimal(12,4)) > 20",              # decimal scale up
    "CAST(p AS decimal(12,0)) = 9",               # decimal scale down
    "CAST(u AS decimal(12,2)) > 2.5",             # float -> decimal
    "CAST(a AS decimal(12,2)) < 40",              # int -> decimal
    "txt IN ('x', 'z')",                          # BDictMask
    "txt LIKE 'y%' OR txt IS NULL",
    "d >= '2021-03-01' AND d < '2021-06-01'",     # date, int32
    "flag AND a > 3",                             # boolean column
    "flag = true OR NOT flag",
    "a = a",
    "a > 5 AND b = NULL",                         # NULL literal
    "a > 5 OR b = NULL",
    "s <> s",                                     # NaN <> NaN
    # BExtract: every field, pre-1970 dates, leap days, timestamps
    "extract(year FROM d2) = 2020",
    "extract(month FROM d2) = 2 AND extract(day FROM d2) = 29",
    "extract(quarter FROM d2) = 4 OR extract(year FROM d2) < 1900",
    "extract(dow FROM d2) = 0",
    "extract(doy FROM d2) > 365",
    "extract(epoch FROM d2) < 0",
    "extract(hour FROM d2) = 0 AND extract(day FROM d2) = 31",
    "extract(hour FROM ts) = 13 OR extract(minute FROM ts) < 3",
    "extract(second FROM ts) >= 57",
    "extract(epoch FROM ts) > 1000000000",
    "extract(year FROM ts) < 1970 AND extract(month FROM ts) = 12",
    "extract(doy FROM ts) = 60",
    # BDateTrunc (fixed-width units) and BDateTruncCivil
    "date_trunc('week', d2) = d2",
    "date_trunc('day', d2) = d2 AND d2 < '1960-01-01'",
    "date_trunc('day', ts) < ts",
    "date_trunc('hour', ts) = date_trunc('minute', ts)",
    "date_trunc('week', ts) < '1969-12-29'",
    "date_trunc('month', d2) = date '2020-02-01'",
    "date_trunc('quarter', d2) < date '1960-01-01'",
    "date_trunc('year', d2) = date '1900-01-01' OR d2 IS NULL",
    "date_trunc('month', ts) < '1950-01-01'",
    "date_trunc('year', ts) > '2000-01-01'",
    # BAddMonths: PostgreSQL's end-of-month clamp
    "extract(day FROM d2 + interval '1 month') = 29",
    "d2 - interval '13 months' < date '1969-02-28'",
    "extract(day FROM d2 + interval '12 months') = 28 AND "
    "extract(month FROM d2) = 2",
    "ts + interval '1 month' > '2020-03-31'",
    "extract(day FROM ts - interval '1 month') = 30",
    # BCase: three-valued WHEN, no ELSE, abs/coalesce/nullif
    "CASE WHEN a > 5 THEN s ELSE 0 END > 0.5",
    "CASE WHEN a > 5 THEN b WHEN a < -5 THEN -b END = 1",
    "CASE WHEN s > 0 THEN 1 WHEN s IS NULL THEN 2 ELSE 3 END = 2",
    "CASE WHEN b = NULL THEN 1 ELSE 0 END = 0",
    "CASE WHEN a > 0 THEN p ELSE 1.5 END > 10",
    "abs(a - 3) < 10",
    "abs(s) > 1",
    "coalesce(b, a) > 2",
    "nullif(a, 5) IS NULL",
    # BDictRemap and BDictLookup
    "upper(txt) = 'Y'",
    "lower(upper(txt)) = 'yy' OR upper(txt) = 'Q'",
    "length(txt) = 2",
    "strpos(txt, 'y') = 1",
    # BMathFunc: transcendentals with domain violations, rounding,
    # sign, greatest/least
    "sqrt(s) > 0.5",
    "exp(s) > 2",
    "ln(u) < 1",
    "log10(u) > 0.2",
    "log2(u) < 2",
    "log(2, u) > 1",
    "power(u, b) > 3",
    "power(s, 0.5) > 0.5",
    "floor(s) = 0",
    "ceil(u) = 3",
    "round(u) = 2",
    "round(u, 1) > 2.3",
    "trunc(s) = 0 AND s < 0",
    "floor(f) = -1",
    "round(p, 1) > 10",
    "floor(p) = 3",
    "ceil(p) > 5 AND p < 6",
    "trunc(p, 1) = -2.5",
    "round(p) = -3",
    "sign(a) = -1",
    "sign(s) < 0",
    "sign(p) = 1",
    "greatest(a, b, 3) > 10",
    "least(s, u) < 0",
    "greatest(p, 10) = 10",
    # 32 and 56 bytes of columns a row, and a long predicate: 4, 2 and 1
    # rows a thread
    "a > 5 AND s < 0.5 AND p > 3 AND u < 1",
    "a + b > 3 AND p < s + u AND f < 0.5 AND ts > '1990-01-01' "
    "AND d2 > '1950-01-01'",
    "extract(year FROM d2) = 2020 OR extract(month FROM ts) = 2 OR "
    "extract(day FROM d2 + interval '1 month') = 29 OR "
    "date_trunc('quarter', d2) < date '1960-01-01' OR "
    "extract(doy FROM ts + interval '1 month') = 60 OR "
    "extract(day FROM ts - interval '13 months') = 31 OR "
    "date_trunc('year', ts + interval '2 months') > '2000-01-01'",
]


@pytest.fixture(scope="module")
def predicate_env(tmp_path_factory):
    """A data directory written by citus_tpu and opened by the port (one
    dictionary for both), and numpy-seeded columns of the scan's device
    dtypes: nulls, NaN, +-inf, +-0.0 and zero divisors."""
    d = str(tmp_path_factory.mktemp("pred"))
    ref = ct.Cluster(d)
    _predicate_table(ref)
    port = ctt.Cluster(d, device="cpu")
    rng = np.random.default_rng(23)
    n = N
    s = rng.normal(0, 1, n)
    s[rng.integers(0, n, 40)] = np.nan
    s[rng.integers(0, n, 20)] = np.inf
    s[rng.integers(0, n, 20)] = -np.inf
    s[rng.integers(0, n, 20)] = -0.0
    s[rng.integers(0, n, 20)] = 0.0
    f = rng.normal(0, 1, n).astype(np.float32)
    f[rng.integers(0, n, 30)] = np.nan
    f[rng.integers(0, n, 20)] = -0.0
    cols = {
        "a": rng.integers(-50, 50, n).astype(np.int64),
        "b": rng.integers(-3, 4, n).astype(np.int64),
        "p": rng.integers(-5000, 5000, n).astype(np.int64),
        "s": s,
        "f": f,
        "u": np.round(rng.uniform(-8, 8, n), 2),
        "txt": rng.integers(0, 4, n).astype(np.int32),
        "d": rng.integers(18600, 18800, n).astype(np.int32),
        "flag": rng.integers(0, 2, n).astype(np.int32),
    }
    cols["a"][:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1]
    valids = {c: rng.random(n) > 0.1 for c in cols}
    # dates from 1800 to 2200 with month ends, leap days (2000, 2020,
    # and 1900, which has none) and the days around 1970-01-01 planted;
    # timestamps on those days at any microsecond
    d2 = rng.integers(-62000, 84000, n).astype(np.int32)
    special = np.array([-25509, -25508, -25447, -1, 0, 1, -365, 11016,
                        11017, 10956, 18321, 18322, 18262, 18627, 18658,
                        18686, 18717, -3653, -3654, 47541], np.int32)
    d2[rng.integers(0, n, 400)] = rng.choice(special, 400)
    cols["d2"] = d2
    cols["ts"] = (d2.astype(np.int64) * 86_400_000_000
                  + rng.integers(0, 86_400_000_000, n))
    for c in ("d2", "ts"):
        valids[c] = rng.random(n) > 0.1
    yield ref, port, cols, valids
    port.close()
    ref.close()


def _bound(pkg_parse, pkg_bind, pkg_auto, cat, pred, auto):
    bound = pkg_bind(cat, pkg_parse(f"SELECT k FROM t WHERE {pred}")[0])
    values = []
    if auto:
        ap = pkg_auto(bound)
        if ap is not None:
            bound, values = ap
    return bound, values


def _param_arrays(bound, values):
    """Parameter env of the auto-parameterized literals, as 0-d numpy
    (value, valid) pairs of their device dtypes."""
    out = {}
    for name, (ptype, _), v in zip(param_env_names(bound.param_specs),
                                   bound.param_specs, values):
        out[name] = (np.asarray(v, ptype.device_dtype), np.asarray(True))
    return out


def _reference_mask(ref, pred, cols, valids, row_mask, auto, params=None):
    """The reference's mask; ``params`` (an env of (value, valid)) in
    place of the predicate's own literals."""
    bound, values = _bound(ref_parse, ref_bind, ref_auto_param, ref.catalog,
                           pred, auto)
    env = {c: (jnp.asarray(cols[c]), jnp.asarray(valids[c])) for c in cols}
    if params is None:
        params = _param_arrays(bound, values)
    for name, (v, m) in params.items():
        env[name] = (jnp.asarray(v), jnp.asarray(m))
    fn = ref_compile(bound.filter, jnp)
    rm = jnp.asarray(row_mask)
    return np.asarray(rm & ref_predicate_mask(jnp, fn, env, rm))


def _port_program(port, pred, auto):
    bound, values = _bound(parse_sql, bind_select, auto_parameterize,
                           port.catalog, pred, auto)
    schema = bound.table.schema
    params = _param_arrays(bound, values)
    prog = FilterProgram(
        bound.filter,
        {c: schema.scan_dtype(c, device=True) for c in schema.names},
        {k: v.dtype for k, (v, _) in params.items()})
    return prog, params


def _row_mask(n):
    m = np.ones(n, bool)
    m[-17:] = False  # padding rows
    return m


@pytest.mark.parametrize("auto", [False, True], ids=["literals", "params"])
@pytest.mark.parametrize("pred", PREDICATES)
def test_plain_filter_mask_matches_jax(predicate_env, pred, auto):
    ref, port, cols, valids = predicate_env
    row_mask = _row_mask(N)
    want = _reference_mask(ref, pred, cols, valids, row_mask, auto)
    prog, params = _port_program(port, pred, auto)
    tcols = {c: (torch.from_numpy(cols[c]), torch.from_numpy(valids[c]))
             for c in prog.columns}
    got = filter_mask(prog, tcols, params, torch.from_numpy(row_mask))
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------- the g++ host harness


def _host_params(prog, cols, valids, params, row_mask, out, keep):
    """A filled FmParams over numpy buffers (``keep`` holds them); a
    null row mask for None."""
    pred = prog.predicate
    p = _FmParams()
    p.n = out.shape[0]
    p.row_mask = 0 if row_mask is None else row_mask.ctypes.data
    p.out = out.ctypes.data
    for j, c in enumerate(pred.columns):
        v = np.ascontiguousarray(cols[c].astype(prog.col_dtypes[c]))
        m = np.ascontiguousarray(valids[c])
        keep += [v, m]
        p.cols[j] = v.ctypes.data
        p.valids[j] = m.ctypes.data
    for j, name in enumerate(pred.params):
        v, m = params[name]
        p.params[j] = _param_bits(v, prog.param_dtypes[name])
        p.param_valid[j] = 1 if bool(m) else 0
    for j, t in enumerate(pred.tables):
        arr = np.ascontiguousarray(t)
        keep.append(arr)
        p.tables[j] = arr.ctypes.data
        p.table_len[j] = arr.size
    return p


def _chunk_entries(q: str) -> str:
    """The harness's C entries of generated source ``q``.inc: ``run_q``
    and ``run_b_q`` run every thread's rows of one query and of Q
    queries, as the kernels' threads do (``fm_rows``,
    ``fm_batched_rows``, FM_ROWS consecutive rows a thread)."""
    return (f"#undef FM_ROWS\n#undef FM_PARAMS\n"
            f"namespace {q} {{\n#include \"{q}.inc\"\n}}\n"
            f"extern \"C\" void run_{q}(const FmParams* p) {{\n"
            f"    for (int64_t g = 0; g < {q}::fm_threads(p->n); ++g)"
            f" {q}::fm_rows(*p, g);\n}}\n"
            f"extern \"C\" void run_b_{q}(const FmParams* p, const FmBatch* b)"
            " {\n"
            f"    for (int64_t g = 0; g < {q}::fm_threads(p->n); ++g)"
            f" {q}::fm_batched_rows(*p, *b, g);\n}}\n")


@pytest.fixture(scope="module")
def host_harness(predicate_env, tmp_path_factory):
    """Every predicate of PREDICATES, literal and parameterized, generated
    and compiled by g++ into one host library: -> (library, programs)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ (the native codec's compiler) on this machine")
    _, port, _, _ = predicate_env
    d = tmp_path_factory.mktemp("harness")
    progs = {}
    parts = ['#include "expr.cuh"']
    for i, pred in enumerate(PREDICATES):
        for auto in (False, True):
            prog, params = _port_program(port, pred, auto)
            q = f"q{i}_{int(auto)}"
            progs[(pred, auto)] = (q, prog, params)
            (d / f"{q}.inc").write_text(prog.predicate.source)
            parts.append(_chunk_entries(q))
    (d / "harness.cpp").write_text("\n".join(parts))
    so = d / "libharness.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC",
                    "-I", cuda_build.CSRC, "-I", str(d), "-o", str(so),
                    str(d / "harness.cpp")], check=True, timeout=300)
    return ctypes.CDLL(str(so)), progs


@pytest.mark.parametrize("auto", [False, True], ids=["literals", "params"])
@pytest.mark.parametrize("pred", PREDICATES)
def test_generated_predicate_on_host_matches_jax(predicate_env, host_harness,
                                                 pred, auto):
    ref, _, cols, valids = predicate_env
    lib, progs = host_harness
    q, prog, params = progs[(pred, auto)]
    row_mask = _row_mask(N)
    want = _reference_mask(ref, pred, cols, valids, row_mask, auto)
    out = np.zeros(N, np.uint8)
    keep: list = []
    p = _host_params(prog, cols, valids, params, row_mask, out, keep)
    fn = getattr(lib, f"run_{q}")
    fn.argtypes = [ctypes.POINTER(_FmParams)]
    fn.restype = None
    fn(ctypes.byref(p))
    np.testing.assert_array_equal(out.astype(bool), want)


#: predicates of the kernels' row cases: every column dtype (int64,
#: float64, float32, decimal, dictionary ids, int32 days, timestamps,
#: bool), and 8, 4, 2 and 1 rows a thread
CHUNK_PREDICATES = [
    "s * u + s > 0.75",
    "txt IN ('x', 'z')",
    "d >= '2021-03-01' AND d < '2021-06-01'",
    "flag AND a > 3",
    "extract(hour FROM ts) = 13 OR extract(minute FROM ts) < 3",
    "CASE WHEN a > 0 THEN p ELSE 1.5 END > 10",
    "floor(f) = -1",
    "date_trunc('month', d2) = date '2020-02-01'",
    "a > 5 AND s < 0.5 AND p > 3 AND u < 1",
    "a + b > 3 AND p < s + u AND f < 0.5 AND ts > '1990-01-01' "
    "AND d2 > '1950-01-01'",
    "extract(year FROM d2) = 2020 OR extract(month FROM ts) = 2 OR "
    "extract(day FROM d2 + interval '1 month') = 29 OR "
    "date_trunc('quarter', d2) < date '1960-01-01' OR "
    "extract(doy FROM ts + interval '1 month') = 60 OR "
    "extract(day FROM ts - interval '13 months') = 31 OR "
    "date_trunc('year', ts + interval '2 months') > '2000-01-01'",
]
#: (rows, the views' first element in their buffers, a row mask): n not
#: a multiple of a thread's rows, n under one vector, views (and output)
#: at odd offsets, no row mask
CHUNK_SHAPES = {"tail": (1999, 0, True), "short": (3, 0, True),
                "misaligned": (1997, 3, True),
                "misaligned_no_row_mask": (1001, 1, False),
                "no_row_mask": (2000, 0, False)}


def _at(a: np.ndarray, offset: int) -> np.ndarray:
    """``a`` as a view starting ``offset`` elements into a buffer (16-byte
    aligned, as numpy allocates), so not aligned for an odd offset."""
    buf = np.zeros(a.size + offset + 16, a.dtype)
    buf[offset:offset + a.size] = a
    return buf[offset:offset + a.size]


def _chunk_case(prog, cols, valids, shape, seed):
    """-> (columns, validity, row mask or None) of one shape, the columns
    cast to the program's dtypes and placed as views."""
    n, offset, with_mask = CHUNK_SHAPES[shape]
    ncols = {c: _at(cols[c][:n].astype(prog.col_dtypes[c]), offset)
             for c in prog.columns}
    nvalid = {c: _at(valids[c][:n], offset) for c in prog.columns}
    rng = np.random.default_rng(seed)
    row_mask = _at(rng.random(n) > 0.2, offset) if with_mask else None
    return ncols, nvalid, row_mask


def _chunk_params(prog, cols, valids, row_mask, keep):
    """A filled FmParams over the given arrays as they lie (``keep``
    holds what it points to); a null row mask for None."""
    p = _FmParams()
    p.n = len(next(iter(cols.values()))) if cols else 0
    p.row_mask = 0 if row_mask is None else row_mask.ctypes.data
    for j, c in enumerate(prog.predicate.columns):
        p.cols[j], p.valids[j] = cols[c].ctypes.data, valids[c].ctypes.data
    for j, t in enumerate(prog.predicate.tables):
        arr = np.ascontiguousarray(t)
        keep.append(arr)
        p.tables[j] = arr.ctypes.data
        p.table_len[j] = arr.size
    return p


def _variants(prog, params: dict, q: int) -> list:
    """``q`` parameter envs of one family: query k moves every integer
    parameter by k and scales every float one by 1 + k / 4; query 5's
    first parameter is NULL."""
    out = []
    for k in range(q):
        env = {}
        for j, (name, (v, ok)) in enumerate(params.items()):
            dt = prog.param_dtypes[name]
            w = v * (1 + k / 4) if dt.kind == "f" else \
                v if dt.kind == "b" else v + k
            env[name] = (np.asarray(w, dt),
                         np.asarray(bool(ok) and not (k == 5 and j == 0)))
        out.append(env)
    return out


@pytest.mark.parametrize("shape", list(CHUNK_SHAPES))
@pytest.mark.parametrize("pred", CHUNK_PREDICATES)
def test_generated_chunks_on_host_match_jax(predicate_env, host_harness,
                                            pred, shape):
    """Every thread's rows of one query, as the kernel's threads run them
    (``fm_rows``, several rows a thread, by vectors where the addresses
    allow), compiled by g++: a tail shorter than a thread's rows, fewer
    rows than one vector, columns, validity and output at odd offsets, a
    null row mask; masks identical to the reference's."""
    ref, _, cols, valids = predicate_env
    lib, progs = host_harness
    q, prog, params = progs[(pred, True)]
    ncols, nvalid, row_mask = _chunk_case(prog, cols, valids, shape, 7)
    n = CHUNK_SHAPES[shape][0]
    want = _reference_mask(ref, pred, ncols, nvalid,
                           np.ones(n, bool) if row_mask is None else row_mask,
                           True)
    out = _at(np.full(n, 9, np.uint8), CHUNK_SHAPES[shape][1])
    keep: list = []
    p = _chunk_params(prog, ncols, nvalid, row_mask, keep)
    p.out = out.ctypes.data
    for j, name in enumerate(prog.predicate.params):
        v, m = params[name]
        p.params[j] = _param_bits(v, prog.param_dtypes[name])
        p.param_valid[j] = 1 if bool(m) else 0
    fn = getattr(lib, f"run_{q}")
    fn.argtypes = [ctypes.POINTER(_FmParams)]
    fn.restype = None
    fn(ctypes.byref(p))
    np.testing.assert_array_equal(out, want.astype(np.uint8))


@pytest.mark.parametrize("shape", ["misaligned", "no_row_mask"])
@pytest.mark.parametrize("n_q", [1, 8, 32])
@pytest.mark.parametrize("pred", CHUNK_PREDICATES)
def test_generated_batched_chunks_on_host_match_jax(
        predicate_env, host_harness, pred, n_q, shape):
    """Every thread's rows of Q queries of one family
    (``fm_batched_rows``: the rows' columns loaded once, then query by
    query its parameters and its bytes of out[q]), compiled by g++, Q =
    1, 8 and 32, rows q of the output at odd offsets (n odd); each
    query's mask identical to the reference's under its parameters."""
    ref, _, cols, valids = predicate_env
    lib, progs = host_harness
    q, prog, params = progs[(pred, True)]
    ncols, nvalid, row_mask = _chunk_case(prog, cols, valids, shape, 8)
    n = CHUNK_SHAPES[shape][0]
    envs = _variants(prog, params, n_q)
    stacked = stack_params(prog, envs, "cpu")
    out = np.full((n_q, n), 9, np.uint8)
    keep: list = []
    p = _chunk_params(prog, ncols, nvalid, row_mask, keep)
    bits = np.ascontiguousarray(stacked.bits.numpy())
    pvalid = np.ascontiguousarray(stacked.valid.numpy())
    b = _FmBatch()
    b.n_q, b.n_params = n_q, bits.shape[1]
    b.params, b.param_valid = bits.ctypes.data, pvalid.ctypes.data
    b.out = out.ctypes.data
    fn = getattr(lib, f"run_b_{q}")
    fn.argtypes = [ctypes.POINTER(_FmParams), ctypes.POINTER(_FmBatch)]
    fn.restype = None
    fn(ctypes.byref(p), ctypes.byref(b))
    rm = np.ones(n, bool) if row_mask is None else row_mask
    for k, env in enumerate(envs):
        want = _reference_mask(ref, pred, ncols, nvalid, rm, True, env)
        np.testing.assert_array_equal(out[k], want.astype(np.uint8),
                                      err_msg=f"query {k}")


@pytest.mark.parametrize("pred", CHUNK_PREDICATES)
def test_filter_mask_without_row_mask_keeps_every_row(predicate_env, pred):
    """``filter_mask`` and ``filter_mask_batched`` with no row mask (the
    projection path's batches) mask the columns' every row, as the
    reference does under an all-true row mask."""
    ref, port, cols, valids = predicate_env
    prog, params = _port_program(port, pred, True)
    tcols = {c: (torch.from_numpy(cols[c]), torch.from_numpy(valids[c]))
             for c in prog.columns}
    ones = np.ones(N, bool)
    got = filter_mask(prog, tcols, params, None)
    np.testing.assert_array_equal(
        got.numpy(), _reference_mask(ref, pred, cols, valids, ones, True))
    envs = _variants(prog, params, 3)
    got = filter_mask_batched(prog, tcols, stack_params(prog, envs, "cpu"),
                              None)
    for k, env in enumerate(envs):
        np.testing.assert_array_equal(
            got[k].numpy(),
            _reference_mask(ref, pred, cols, valids, ones, True, env))


def test_unsupported_node_raises_naming_b10(predicate_env):
    """What the generator does not take raises on the card's path: the
    predicate never falls back to eager tensor code there.  Every bound
    node kind is generated; a column of a dtype outside the generator's
    C types (a uint8 column) is still refused."""
    from citus_tpu_torch.errors import UnsupportedFeatureError
    _, port, _, _ = predicate_env
    prog, _ = _port_program(port, "extract(year from d) = 2021", False)
    assert "fm_extract_civil" in prog.predicate.source
    prog = FilterProgram(prog.expr, {"d": np.uint8}, {})
    with pytest.raises(UnsupportedFeatureError, match="B10"):
        prog.predicate


def test_parameters_are_kernel_arguments(predicate_env):
    """Literal variants of one auto-parameterized predicate generate one
    source (one build serves the family); the literal-bound trees do
    not."""
    _, port, _, _ = predicate_env
    a, _ = _port_program(port, "a > 10 AND p < 3.5", True)
    b, _ = _port_program(port, "a > 11 AND p < 9.25", True)
    assert a.predicate.source == b.predicate.source
    assert a.predicate.params and not a.predicate.source.count("0x000000000000000a")
    c, _ = _port_program(port, "a > 10 AND p < 3.5", False)
    d, _ = _port_program(port, "a > 11 AND p < 9.25", False)
    assert c.predicate.source != d.predicate.source


@pytest.mark.cuda
def test_filter_kernel_matches_plain_on_card(predicate_env):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    _, port, cols, valids = predicate_env
    row_mask = torch.from_numpy(_row_mask(N)).cuda()
    for pred in PREDICATES:
        for auto in (False, True):
            prog, params = _port_program(port, pred, auto)
            tcols = {c: (torch.from_numpy(cols[c]).cuda(),
                         torch.from_numpy(valids[c]).cuda())
                     for c in prog.columns}
            launches = filter_mask.launches
            got = filter_mask(prog, tcols, params, row_mask)
            assert filter_mask.launches == launches + 1
            want = filter_mask_plain(prog, tcols, params, row_mask)
            assert torch.equal(got, want), pred


@pytest.mark.cuda
def test_filter_kernels_match_plain_on_misaligned_views_on_card(
        predicate_env):
    """Both kernels of each chunk predicate against their plain versions
    on the card, in every CHUNK_SHAPES shape (views at odd offsets, no
    row mask, short and ragged batches), the batched one at Q = 32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    _, port, cols, valids = predicate_env
    for pred in CHUNK_PREDICATES:
        prog, params = _port_program(port, pred, True)
        stacked = stack_params(prog, _variants(prog, params, 32), "cuda")
        for shape in CHUNK_SHAPES:
            ncols, nvalid, rm = _chunk_case(prog, cols, valids, shape, 9)
            offset = CHUNK_SHAPES[shape][1]

            def card(a):
                t = torch.zeros(a.size + offset + 16, dtype=torch.from_numpy(
                    a[:0]).dtype, device="cuda")
                t[offset:offset + a.size] = torch.from_numpy(
                    np.ascontiguousarray(a)).cuda()
                return t[offset:offset + a.size]
            tcols = {c: (card(ncols[c]), card(nvalid[c])) for c in ncols}
            trm = None if rm is None else card(rm)
            got = filter_mask(prog, tcols, params, trm)
            assert torch.equal(got, filter_mask_plain(prog, tcols, params,
                                                      trm)), (pred, shape)
            got = filter_mask_batched(prog, tcols, stacked, trm)
            assert torch.equal(got, filter_mask_batched_plain(
                prog, tcols, stacked, trm)), (pred, shape)


# ------------------------------------------------------------------ C1
# ROADMAP.md C1: on the card a projection whose WHERE held one of these
# nodes raised, where the reference answers.  Each WHERE (over
# _load_events, seed 11) with the reference's row count.

C1_WHERES = [
    ("extract(year FROM d) = 2021", 489),                 # BExtract
    ("abs(score - 50) < 3", 103),                         # BCase (abs)
    ("CASE WHEN qty > 5 THEN score ELSE 0 END > 40", 1023),  # BCase
    ("upper(kind) = 'BUY'", 507),                         # BDictRemap
    ("date_trunc('month', d) = date '2021-03-01'", 56),   # BDateTruncCivil
]
C1_IDS = ["extract", "abs", "case", "upper", "date_trunc"]


def _c1_sql(where):
    return f"SELECT id FROM events WHERE {where} ORDER BY id"


@pytest.fixture(scope="module")
def c1_recorded(pair):
    """Each C1 projection through both packages, every ``filter_mask``
    call of the port's projection path recorded: -> {where: (reference
    rows, port result, [(program, columns, parameters, row mask, mask)])}."""
    from citus_tpu_torch.ops import filter_mask as fm_mod
    ref, port = pair
    real = fm_mod.filter_mask
    out = {}
    for where, _ in C1_WHERES:
        calls = []

        def record(prog, cols, params, row_mask, n=None, _calls=calls):
            got = real(prog, cols, params, row_mask, n)
            _calls.append((prog, cols, params, row_mask, got))
            return got
        fm_mod.filter_mask = record
        try:
            r = port.execute(_c1_sql(where))
        finally:
            fm_mod.filter_mask = real
        out[where] = (ref.execute(_c1_sql(where)).rows, r, calls)
    return out


@pytest.mark.parametrize("where,count", C1_WHERES, ids=C1_IDS)
def test_c1_projection_rows_identical_to_reference(c1_recorded, where,
                                                   count):
    """The serial projection path answers with the reference's rows,
    through ``filter_mask`` on every scanned batch, and the predicate
    generator takes the WHERE (it raised before)."""
    want, r, calls = c1_recorded[where]
    assert len(want) == count
    assert r.rows == want
    assert r.explain["strategy"] == "projection"
    assert calls and r.explain["pipeline"]["filter_dispatches"] == len(calls)
    assert "fm_eval" in calls[0][0].predicate.source


@pytest.fixture(scope="module")
def c1_harness(c1_recorded, tmp_path_factory):
    """The generated sources of the five C1 predicates compiled by g++
    into one host library: -> (library, {where: symbol})."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ (the native codec's compiler) on this machine")
    d = tmp_path_factory.mktemp("c1")
    parts = ['#include "expr.cuh"']
    names = {}
    for i, (where, _) in enumerate(C1_WHERES):
        prog = c1_recorded[where][2][0][0]
        q = f"c1_{i}"
        names[where] = q
        (d / f"{q}.inc").write_text(prog.predicate.source)
        parts.append(_chunk_entries(q))
    (d / "harness.cpp").write_text("\n".join(parts))
    so = d / "libc1.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", cuda_build.CSRC, "-I", str(d),
                    "-o", str(so), str(d / "harness.cpp")],
                   check=True, timeout=300)
    return ctypes.CDLL(str(so)), names


@pytest.mark.parametrize("where,count", C1_WHERES, ids=C1_IDS)
def test_c1_generated_predicate_on_scan_batches(c1_recorded, c1_harness,
                                                where, count):
    """The generated predicate, compiled for the host, gives the plain
    version's mask on every batch the projection path scanned (the
    columns as the scan decoded them: dictionary ids, int32 days,
    scaled decimals)."""
    lib, names = c1_harness
    fn = getattr(lib, f"run_{names[where]}")
    fn.argtypes = [ctypes.POINTER(_FmParams)]
    fn.restype = None
    kept = 0
    for prog, cols, params, row_mask, want in c1_recorded[where][2]:
        ncols = {c: v.numpy() for c, (v, _) in cols.items()}
        nvalid = {c: (np.ones(len(v), bool) if m is None else m.numpy())
                  for c, (v, m) in cols.items()}
        rm = None if row_mask is None else row_mask.numpy()
        out = np.zeros(want.shape[0], np.uint8)
        keep: list = []
        p = _host_params(prog, ncols, nvalid, params, rm, out, keep)
        fn(ctypes.byref(p))
        np.testing.assert_array_equal(out.astype(bool), want.numpy())
        kept += int(out.sum())
    assert kept == count


@pytest.fixture(scope="module")
def c1_pair(tmp_path_factory):
    """Two port coordinators (A the authority, B attached; 2 of the 4
    events shards on B) over _load_events, loaded through A."""
    from test_torch_net import _open_pair
    a, b = _open_pair(tmp_path_factory.mktemp("c1pair"))
    try:
        _load_events(a)
        yield a, b
    finally:
        b.close()
        a.close()


@pytest.mark.parametrize("where,count", C1_WHERES, ids=C1_IDS)
def test_c1_pushed_projection_rows(c1_pair, c1_recorded, where, count):
    """A pushed projection task filters on B through the same
    ``_ProjectionMask``: the rows are the reference's, with both remote
    shards pushed and no fallback."""
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    a, _ = c1_pair
    a.execute("SET citus.remote_task_execution = auto")
    c0 = GLOBAL_COUNTERS.snapshot()
    rows = a.execute(_c1_sql(where)).rows
    c1 = GLOBAL_COUNTERS.snapshot()
    assert c1.get("remote_tasks_pushed", 0) - \
        c0.get("remote_tasks_pushed", 0) == 2
    assert c1.get("remote_task_fallbacks", 0) == \
        c0.get("remote_task_fallbacks", 0)
    assert rows == c1_recorded[where][0] and len(rows) == count


#: literal families of C1's WHEREs (query i of a family binds literal
#: i).  Neither package hoists a literal inside a CASE (or abs), so the
#: CASE families vary the literal outside it
C1_FAMILIES = [
    [f"extract(year FROM d) = {2020 + i}" for i in range(4)],
    [f"abs(score - 50) < {3 + i}" for i in range(4)],
    [f"CASE WHEN qty > 5 THEN score ELSE 0 END > {40 + i}"
     for i in range(4)],
    [f"upper(kind) = 'BUY' AND id > {100 * i}" for i in range(4)],
    [f"date_trunc('month', d) = date '2021-0{3 + i}-01'" for i in range(4)],
]


@pytest.fixture(scope="module")
def c1_family_pair(tmp_path_factory):
    ref = ct.Cluster(str(tmp_path_factory.mktemp("c1fam_ref")))
    port = ctt.Cluster(str(tmp_path_factory.mktemp("c1fam_port")),
                       device="cpu")
    for cl in (ref, port):
        _load_events(cl)
        cl.execute("SET citus.megabatch_window_ms = 1000")
        cl.execute("SET citus.megabatch_max_size = 4")
    yield ref, port
    port.close()
    ref.close()


@pytest.mark.parametrize("family", C1_FAMILIES, ids=C1_IDS)
def test_c1_family_coalesces_with_reference_rows(c1_family_pair, family):
    """Literal variants of each C1 WHERE coalesce into shared scans in
    both packages (the port's eligibility check generates the
    predicate), with the reference's rows and batch count."""
    from citus_tpu.executor.megabatch import GLOBAL_MEGABATCH as REF_MB
    from citus_tpu_torch.executor.megabatch import GLOBAL_MEGABATCH
    from test_torch_megabatch import _fanout
    ref, port = c1_family_pair
    sqls = [_c1_sql(w) for w in family]
    r0 = REF_MB.stats()["batches"]
    want, ref_err = _fanout(ref, sqls)
    ref_batches = REF_MB.stats()["batches"] - r0
    assert ref_err == {}
    c0, s0 = port.counters.snapshot(), GLOBAL_MEGABATCH.stats()
    got, errors = _fanout(port, sqls)
    c1, s1 = port.counters.snapshot(), GLOBAL_MEGABATCH.stats()
    assert errors == {}
    batches = s1["batches"] - s0["batches"]
    assert batches == ref_batches
    assert 1 <= batches < 4     # occupancy above 1
    assert [got[i] for i in range(4)] == [want[i] for i in range(4)]
    assert c1.get("megabatch_queries", 0) - \
        c0.get("megabatch_queries", 0) == 4
    assert c1.get("megabatch_fallbacks", 0) == \
        c0.get("megabatch_fallbacks", 0)
