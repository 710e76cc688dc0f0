"""Plans and inputs shared by the tests of the generated fold and insert
rows: ``test_torch_fold_codegen.py`` (the g++-compiled rows against the
JAX package, on the CPU) and ``test_torch_fold_card.py`` (the generated
kernels against their plain versions, on the card).  Nothing here
imports JAX, so the card's tests run where the JAX package is absent."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

N = 3000
I64 = np.iinfo(np.int64)

#: synthetic plans over the predicate table: keys and arguments over
#: every node kind of ROADMAP.md C1's predicate (EXTRACT, date_trunc,
#: + interval, CASE and abs/coalesce/nullif, upper/length/strpos, the
#: transcendentals, rounding, sign, greatest/least, casts both ways)
SYN_HASH_KEYS = ("extract(year FROM d2), date_trunc('month', d2), upper(txt), "
                 "CASE WHEN a > 0 THEN s ELSE -s END, CAST(s AS bigint), "
                 "a % b")
SYN_HASH = (
    "SELECT " + SYN_HASH_KEYS + ", "
    "count(*), sum(a / b), sum(s * u + s), min(abs(s)), max(sqrt(u)), "
    "sum(CAST(p AS double)), sum(round(p, 1)), min(greatest(a, b, 3)), "
    "max(length(txt)), sum(extract(epoch FROM ts)), max(power(u, b)), "
    "sum(coalesce(b, a)), count(nullif(a, 5)), sum(ln(u)), min(exp(s)), "
    "max(sign(p)), sum(floor(s)), min(trunc(p, 1)), sum(strpos(txt, 'y')), "
    "max(CASE WHEN s > 0 THEN 1 WHEN s IS NULL THEN 2 ELSE 3 END), "
    "sum(CAST(u AS decimal(12,2))), min(least(s, u)), max(f), "
    "sum(extract(dow FROM d2 + interval '1 month')), "
    "max(extract(hour FROM date_trunc('hour', ts))), "
    "sum(CAST(f AS bigint)), min(log10(u)), max(ceil(p)), "
    "sum(extract(doy FROM date_trunc('quarter', d2))) "
    "FROM t WHERE a > -40 OR s IS NULL GROUP BY " + SYN_HASH_KEYS)
#: SYN_HASH's keys with signed float sums, within the insert kernel's
#: limits (8 keys, 32 partial ops, 32 arguments; SYN_HASH has 65 ops)
SYN_HASH_CARD = (
    "SELECT " + SYN_HASH_KEYS + ", count(*), sum(s * u + s), min(abs(s)), "
    "max(sqrt(u)), sum(CAST(p AS double)), sum(a / b), sum(ln(u)), "
    "min(exp(s)), sum(floor(s)), max(f), sum(CAST(a AS double) / 3), "
    "sum(round(s, 2)), count(nullif(a, 5)) "
    "FROM t WHERE a > -40 OR s IS NULL GROUP BY " + SYN_HASH_KEYS)
SYN_DIRECT = (
    "SELECT b, flag, count(*), count(s), sum(a * 2 - b), min(s), max(f), "
    "sum(CAST(a AS double) / 3), sum(p * 2), min(d), max(d2), "
    "sum(CASE WHEN flag THEN a ELSE -a END) "
    "FROM t WHERE NOT (f < 0.25) OR a % b = 1 GROUP BY b, flag")
SYN_SCALAR = (
    "SELECT count(*), sum(round(s, 2)), min(-a), max(a), sum(1), "
    "sum(CAST(p AS double) * u), count(txt) FROM t WHERE s <> s OR u > 0")

#: name -> (data set, SELECT, direct_gid_limit or None)
PLANS = {
    "q1": ("lineitem", cs.Q1, None),
    "q6": ("lineitem", cs.Q6, None),
    "h1": ("lineitem", cs.H1, 100),
    "h2": ("lineitem", cs.H2, 100),
    "bench_hash": ("lineitem", cs.BENCH_HASH, 100),
    "s1": ("sketch", cs.S1, None),
    "syn_hash": ("t", SYN_HASH, None),
    "syn_hash_card": ("t", SYN_HASH_CARD, None),
    "syn_direct": ("t", SYN_DIRECT, None),
    "syn_scalar": ("t", SYN_SCALAR, None),
}


def predicate_table(cl) -> None:
    """Table ``t`` of the predicate tests: every column type the
    generated expressions read, a few rows (the tests' inputs are
    numpy-seeded columns, not these rows)."""
    cl.execute("CREATE TABLE t (k bigint NOT NULL, a bigint, b int, "
               "p decimal(12,2), s double, f real, u double, txt text, "
               "d date, flag boolean, d2 date, ts timestamp)")
    cl.execute("SELECT create_distributed_table('t', 'k', 2)")
    cl.execute("INSERT INTO t (k, a, b, p, s, f, u, txt, d, flag) "
               "VALUES (0, 1, 2, 3.5, 0.5, 0.25, 1.5, 'x', "
               "'2021-01-02', true), (1, NULL, NULL, NULL, NULL, NULL, NULL, "
               "NULL, NULL, NULL), (2, 5, 0, 1.0, 0.0, 0.0, 0.0, 'y', "
               "'2021-04-04', false), (3, 7, 1, 2.0, 1.0, 1.0, 2.0, 'z', "
               "'2021-05-05', true), (4, 9, 1, 2.0, 1.0, 1.0, 2.0, 'yy', "
               "'2021-05-05', true)")


def load_data(name: str, cl) -> None:
    """Data set ``name`` (lineitem, sketch or t) into ``cl``, a cluster of
    either package."""
    if name == "lineitem":
        cl.execute(cs.LINEITEM_DDL)
        cl.execute("SELECT create_distributed_table('lineitem', "
                   "'l_orderkey', 4)")
        cl.copy_from("lineitem", columns=cs.copy_columns(
            next(cs.lineitem_chunks(4000))))
    elif name == "sketch":
        cl.execute(cs.S_DDL)
        cl.execute("SELECT create_distributed_table('lineitem', "
                   "'l_suppkey', 4)")
        cl.copy_from("lineitem", columns=cs.sketch_copy_columns(
            next(cs.sketch_chunks(4000, 3, 4000))))
    else:
        predicate_table(cl)


def port_plan(cat, sql: str, direct_limit):
    """-> (the port's plan, encoded parameters) as Cluster.execute plans
    ``sql``."""
    from citus_tpu_torch.executor.executor import encode_params
    from citus_tpu_torch.planner import parse_sql
    from citus_tpu_torch.planner.auto_param import auto_parameterize
    from citus_tpu_torch.planner.bind import bind_select
    from citus_tpu_torch.planner.physical import plan_select
    bound = bind_select(cat, parse_sql(sql)[0])
    values = None
    ap = auto_parameterize(bound)
    if ap is not None:
        bound, values = ap
    plan = plan_select(cat, bound, direct_limit=direct_limit or 65536)
    return plan, encode_params(cat, bound, values)


def columns(plan, seed: int):
    """numpy columns of the plan's scan in their device dtypes: nulls,
    NaN, +-inf, +-0.0, zero divisors, INT64_MIN/MAX, floats past the
    int64 range; -> (cols, valids) by name."""
    rng = np.random.default_rng(seed)
    schema = plan.bound.table.schema
    cols, valids = {}, {}
    for c in plan.scan_columns:
        dt = np.dtype(schema.scan_dtype(c, device=True))
        if dt.kind == "f":
            v = rng.normal(0, 3, N) * 10.0 ** rng.integers(-2, 4, N)
            v[rng.integers(0, N, 40)] = np.nan
            v[rng.integers(0, N, 20)] = np.inf
            v[rng.integers(0, N, 20)] = -np.inf
            v[rng.integers(0, N, 20)] = -0.0
            v[rng.integers(0, N, 20)] = 0.0
            v[rng.integers(0, N, 10)] = 3e19      # past int64
            v[rng.integers(0, N, 10)] = -3e19
            v = v.astype(dt)
        elif dt == np.int32:
            # dates, dictionary ids, ints: small ranges, dates around 1970
            v = rng.integers(-4000, 20000, N).astype(np.int32)
            if c in ("txt", "l_returnflag", "l_linestatus"):
                v = rng.integers(0, 4, N).astype(np.int32)
            elif c in ("b",):
                v = rng.integers(-3, 4, N).astype(np.int32)
        elif dt == np.bool_:
            v = rng.integers(0, 2, N).astype(bool)
        else:
            v = rng.integers(-60, 60, N).astype(dt)
            big = rng.integers(0, N, 60)
            v[big] = rng.integers(-10**15, 10**15, 60)
            v[:4] = [I64.min, I64.max, 0, -1]
            if c == "ts":
                v = rng.integers(-3 * 10**15, 4 * 10**15, N)
        cols[c] = np.ascontiguousarray(v)
        valids[c] = rng.random(N) > 0.1
    return cols, valids


def row_mask() -> np.ndarray:
    m = np.ones(N, bool)
    m[-17:] = False  # padding rows
    return m
