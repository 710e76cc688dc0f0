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
    FilterProgram, _FmParams, _param_bits, filter_mask, filter_mask_plain,
)
from citus_tpu_torch.planner import parse_sql
from citus_tpu_torch.planner.auto_param import auto_parameterize
from citus_tpu_torch.planner.bind import bind_select
from citus_tpu_torch.planner.bound import param_env_names

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
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
]


def _predicate_table(cl, rows=N):
    cl.execute("CREATE TABLE t (k bigint NOT NULL, a bigint, b int, "
               "p decimal(12,2), s double, f real, u double, txt text, "
               "d date, flag boolean)")
    cl.execute("SELECT create_distributed_table('t', 'k', 2)")
    cl.execute("INSERT INTO t VALUES (0, 1, 2, 3.5, 0.5, 0.25, 1.5, 'x', "
               "'2021-01-02', true), (1, NULL, NULL, NULL, NULL, NULL, NULL, "
               "NULL, NULL, NULL), (2, 5, 0, 1.0, 0.0, 0.0, 0.0, 'y', "
               "'2021-04-04', false), (3, 7, 1, 2.0, 1.0, 1.0, 2.0, 'z', "
               "'2021-05-05', true), (4, 9, 1, 2.0, 1.0, 1.0, 2.0, 'yy', "
               "'2021-05-05', true)")


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


def _reference_mask(ref, pred, cols, valids, row_mask, auto):
    bound, values = _bound(ref_parse, ref_bind, ref_auto_param, ref.catalog,
                           pred, auto)
    env = {c: (jnp.asarray(cols[c]), jnp.asarray(valids[c])) for c in cols}
    for name, (v, m) in _param_arrays(bound, values).items():
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
    """A filled FmParams over numpy buffers (``keep`` holds them)."""
    pred = prog.predicate
    p = _FmParams()
    p.n = row_mask.shape[0]
    p.row_mask = row_mask.ctypes.data
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
        arr = np.asarray(t, np.uint8)
        keep.append(arr)
        p.tables[j] = arr.ctypes.data
        p.table_len[j] = arr.size
    return p


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
            parts.append(
                f"namespace {q} {{\n#include \"{q}.inc\"\n}}\n"
                f"extern \"C\" void run_{q}(const FmParams* p) {{\n"
                "    for (int64_t i = 0; i < p->n; ++i)\n"
                "        p->out[i] = (p->row_mask == nullptr || p->row_mask[i])"
                f" && {q}::fm_predicate(*p, i);\n}}\n")
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


def test_unsupported_node_raises_naming_b10(predicate_env):
    """A node the generator does not know raises on the card's path: the
    predicate never falls back to eager tensor code there."""
    from citus_tpu_torch.errors import UnsupportedFeatureError
    _, port, _, _ = predicate_env
    prog, _ = _port_program(port, "extract(year from d) = 2021", False)
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
