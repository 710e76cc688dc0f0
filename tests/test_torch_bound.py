"""The port's expression compiler on a torch namespace against the JAX
package's on jax.numpy.

Each SQL expression binds in both packages over the same table; the
compiled functions run on the same numpy-seeded columns (JAX arrays on
one side, CPU tensors on the other).  Values where valid and the
validity masks must be identical (float results within rel 1e-12 for
transcendental ones).  Covers decimal arithmetic, SQL's truncating
integer division and modulo, dates and intervals, CASE, casts, and the
WHERE-clause predicate (NULL -> false) of predicate_mask.
"""

import numpy as np
import pytest

import citus_tpu as ct
import jax.numpy as jnp
import torch

import citus_tpu_torch as ctt
from citus_tpu.planner import parse_sql as ref_parse
from citus_tpu.planner.bind import bind_select as ref_bind
from citus_tpu.planner.bound import compile_expr as ref_compile
from citus_tpu.planner.bound import predicate_mask as ref_predicate
from citus_tpu_torch.ops.xp_torch import TorchNamespace
from citus_tpu_torch.planner import parse_sql
from citus_tpu_torch.planner.bind import bind_select
from citus_tpu_torch.planner.bound import compile_expr, predicate_mask

N = 2000

EXPRS = [
    # decimal arithmetic (scaled int64)
    "price * 2 + 1",
    "price * qty",
    "price - 0.05",
    "price * (1 - disc) * (1 + disc)",
    "price / 3",
    "price + score",
    # SQL integer division truncates toward zero; modulo follows it
    "qty / 7",
    "qty % 5",
    "-qty / 3",
    "qty / (qty - qty)",
    # dates and intervals
    "d + interval '1 month'",
    "d - interval '3 days'",
    "d + 30",
    "extract(year from d)",
    "extract(month from d)",
    "extract(dow from d)",
    "extract(doy from d)",
    "date_trunc('month', d)",
    "date_trunc('week', d)",
    # CASE
    "CASE WHEN qty > 0 THEN price WHEN qty < -5 THEN -price END",
    "CASE WHEN s = 'a' THEN 1 WHEN s IS NULL THEN 2 ELSE 3 END",
    # casts
    "CAST(price AS double)",
    "CAST(score AS decimal(10,2))",
    "CAST(price AS bigint)",
    "CAST(qty AS double)",
    "CAST(f AS double)",
    "CAST(price AS decimal(12,4))",
    "CAST(price AS decimal(12,1))",
    # math
    "round(price, 1)",
    "floor(score)",
    "sqrt(score)",
    "power(score, 2)",
    "abs(qty)",
    "greatest(qty, 3)",
]

PREDICATES = [
    "d <= date '1998-12-01' - interval '90' day",
    "d >= date '1994-01-01' AND d < date '1995-01-01' "
    "AND disc BETWEEN 0.05 AND 0.07 AND price < 24",
    "s IN ('a', 'c') OR qty > 10",
    "s LIKE 'b%'",
    "NOT (score > 0.5)",
    "s IS NULL",
    "price IS NOT NULL AND qty % 2 = 0",
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("db"))
    ref = ct.Cluster(d)
    ref.execute("CREATE TABLE t (qty bigint, price decimal(12,2), "
                "disc decimal(12,2), score double, f real, d date, s text)")
    ref.copy_from("t", rows=[(1, 1.5, 0.05, 0.25, 1.0, "1995-03-01", "a"),
                             (2, 2.5, 0.06, 0.5, 2.0, "1996-03-01", "b"),
                             (3, 3.5, 0.07, 0.75, 3.0, "1997-03-01", "c")])
    port = ctt.Cluster(d, device="cpu")
    yield ref.catalog, port.catalog
    port.close()
    ref.close()


def _env(cat, bound):
    """numpy columns (device dtypes) for the bound select's scan, with
    nulls, negative values and dates across leap years."""
    rng = np.random.default_rng(17)
    schema = bound.table.schema
    env = {}
    for c in schema.names:
        dt = schema.scan_dtype(c, device=True)
        if c == "d":
            v = rng.integers(-1000, 20000, N)
        elif c == "s":
            v = rng.integers(0, 3, N)
        elif c in ("score", "f"):
            v = rng.random(N) * 4 - 1
        elif c == "disc":
            v = rng.integers(0, 11, N)
        else:
            v = rng.integers(-10**6, 10**6, N)
        env[c] = (v.astype(dt), rng.random(N) > 0.1)
    return env


def _bind_both(tables, sql):
    rcat, pcat = tables
    rb = ref_bind(rcat, ref_parse(sql)[0])
    pb = bind_select(pcat, parse_sql(sql)[0])
    return rb, pb


def _as_np(x, n):
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return np.broadcast_to(a.reshape(-1) if a.size == 1 else a, (n,))


def _same(got, want, float_rtol=0.0):
    gv, gm = got
    wv, wm = want
    gm, wm = _as_np(gm, N), _as_np(wm, N)
    np.testing.assert_array_equal(gm, wm)
    gv, wv = _as_np(gv, N), _as_np(wv, N)
    assert gv.dtype == wv.dtype, (gv.dtype, wv.dtype)
    if np.issubdtype(wv.dtype, np.floating) and float_rtol:
        np.testing.assert_allclose(gv[wm], wv[wm], rtol=float_rtol, atol=0)
    else:
        np.testing.assert_array_equal(gv[wm], wv[wm])


@pytest.mark.parametrize("expr", EXPRS)
def test_compile_expr_matches_jax(tables, expr):
    rb, pb = _bind_both(tables, f"SELECT {expr} FROM t")
    (re,), (pe,) = rb.final_exprs, pb.final_exprs
    env = _env(None, rb)
    jenv = {c: (jnp.asarray(v), jnp.asarray(m)) for c, (v, m) in env.items()}
    tenv = {c: (torch.from_numpy(v), torch.from_numpy(m))
            for c, (v, m) in env.items()}
    want = ref_compile(re, jnp)(jenv)
    got = compile_expr(pe, TorchNamespace("cpu"))(tenv)
    transcendental = expr.startswith(("sqrt", "power"))
    _same(got, want, float_rtol=1e-12 if transcendental else 0.0)


@pytest.mark.parametrize("pred", PREDICATES)
def test_predicate_mask_matches_jax(tables, pred):
    rb, pb = _bind_both(tables, f"SELECT count(*) FROM t WHERE {pred}")
    env = _env(None, rb)
    jenv = {c: (jnp.asarray(v), jnp.asarray(m)) for c, (v, m) in env.items()}
    tenv = {c: (torch.from_numpy(v), torch.from_numpy(m))
            for c, (v, m) in env.items()}
    rows = np.ones(N, bool)
    want = ref_predicate(jnp, ref_compile(rb.filter, jnp), jenv,
                         jnp.asarray(rows))
    got = predicate_mask(TorchNamespace("cpu"),
                         compile_expr(pb.filter, TorchNamespace("cpu")),
                         tenv, torch.from_numpy(rows))
    np.testing.assert_array_equal(_as_np(got, N), _as_np(want, N))


def test_numpy_oracle_unchanged(tables):
    """The port's bound.py stays namespace-generic: under numpy it gives
    the reference's own numpy results."""
    for expr in EXPRS:
        rb, pb = _bind_both(tables, f"SELECT {expr} FROM t")
        env = _env(None, rb)
        want = ref_compile(rb.final_exprs[0], np)(env)
        got = compile_expr(pb.final_exprs[0], np)(env)
        _same(got, want)


def test_int32_date_against_int64_parameter_promotes_like_numpy():
    """A typed constant is strongly typed, as a numpy scalar is in JAX:
    int32 dates compared with an int64 value beyond int32 compare in
    int64, not wrapped to int32."""
    xp = TorchNamespace("cpu")
    d = torch.tensor([1, 2, 3], dtype=torch.int32)
    big = xp.asarray(np.asarray(2**33, np.int64))
    assert (d < big).tolist() == [True, True, True]
    assert (d * xp.const(2**31, np.int64)).dtype == torch.int64
    assert xp.truediv(torch.tensor([1, 2]), 4).dtype == torch.float64
