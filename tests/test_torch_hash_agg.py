"""Hash GROUP BY of the port (hash_host group mode), held against the JAX
package.

- ``_mix``, ``_fingerprint`` and ``_canon_keys`` of
  ``citus_tpu_torch.ops.hash_agg`` give the bits of
  ``citus_tpu.ops.hash_agg``'s, over numpy-seeded keys of every key dtype
  with ``-0.0``, NaN payloads and nulls.
- ``hash_agg_insert``'s plain version against the reference's
  ``build_fused_hash_worker`` (jitted on the CPU) over several batches
  into one running table, at S = 1024, 1000 and 7 slots (at 7 most rows
  spill): the groups after the host merge of table and spilled rows
  must be equal.  The two claim differently (the reference: minimum
  fingerprint, then verify; the kernel: first atomic claim), so slots
  and spills may differ, merged groups may not.
- The same SQL through ``citus_tpu.Cluster`` and
  ``citus_tpu_torch.Cluster(device="cpu")``: the cases of
  tests/test_hash_agg_fused.py (cardinality sweep, adversarial spill,
  float keys), bench.py's ``bench_hash_agg`` query, TPC-H H1 and H2 at a
  small scale, ``count(DISTINCT)`` and a text key (the host branch), and
  the ``cpu`` backend against the device backend.

Rows compare as lists under ORDER BY and as multisets without it: the
row order of an unordered hash GROUP BY follows slot order, which the
port's table layout is free to change.  Float sums within rel 1e-12
(summed in another order), everything else identical.
``test_hash_kernel_matches_plain_on_card`` needs a card and skips here.
"""

import collections
import math
import os
import sys

import numpy as np
import pytest

import citus_tpu as ct
import jax
import jax.numpy as jnp
import torch

import citus_tpu_torch as ctt
from citus_tpu.executor.host_agg import HostGroupAccumulator as RefAcc
from citus_tpu.ops import hash_agg as ref_hash
from citus_tpu.planner import parse_sql as ref_parse
from citus_tpu.planner.bind import bind_select as ref_bind
from citus_tpu.planner.bound import compile_expr as ref_compile
from citus_tpu.planner.physical import plan_select as ref_plan
from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
from citus_tpu_torch.executor.host_agg import HostGroupAccumulator
from citus_tpu_torch.ops import hash_agg
from citus_tpu_torch.ops.hash_agg import (
    build_fused_hash_worker, build_hash_insert_inputs, empty_hash_state,
    merge_hash_tables_into,
)
from citus_tpu_torch.ops.hash_agg_insert import (
    hash_agg_insert, hash_agg_insert_plain, insert_plain,
)
from citus_tpu_torch.planner import parse_sql
from citus_tpu_torch.planner.bind import bind_select
from citus_tpu_torch.planner.bound import compile_expr
from citus_tpu_torch.planner.physical import plan_select

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402
import chip_smoke  # noqa: E402
from test_torch_slice import (  # noqa: E402
    _load_events, _load_lineitem, assert_same_rows,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------ fingerprint bits

_NAN_PAYLOADS = [0x7FF8000000000000, 0x7FF0000000000001, 0xFFF8000000000000,
                 0x7FFFFFFFFFFFFFFF, 0xFFF0000000000123]


def _keys_of(dtype, n, rng):
    """Values of ``dtype`` with -0.0, NaN payloads, infinities, extremes."""
    dt = np.dtype(dtype)
    if dt == np.bool_:
        return rng.integers(0, 2, n).astype(bool)
    if dt.kind == "i":
        v = rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, n, dtype=dt,
                         endpoint=True)
        v[:3] = [np.iinfo(dt).min, np.iinfo(dt).max, 0]
        return v
    v = rng.normal(0, 1e6, n).astype(dt)
    v[0], v[1], v[2], v[3] = 0.0, -0.0, np.inf, -np.inf
    bits = np.array(_NAN_PAYLOADS, np.uint64)
    if dt == np.float32:
        nans = (bits >> np.uint64(32)).astype(np.uint32).view(np.float32)
    else:
        nans = bits.view(np.float64)
    v[4:4 + len(nans)] = nans
    return v


@pytest.mark.parametrize("dtypes", [
    ("int64",), ("int32",), ("float64",), ("float32",), ("bool",),
    ("int64", "float64", "int32"), ("float32", "bool", "int64"),
])
def test_fingerprint_and_canon_bits_match_reference(dtypes):
    rng = np.random.default_rng(len(dtypes) * 7 + len(dtypes[0]))
    n = 4000
    keys = []
    for d in dtypes:
        v = _keys_of(d, n, rng)
        valid = rng.random(n) > 0.1
        keys.append((v, valid))
    ref_canon = ref_hash._canon_keys(
        jnp, [(jnp.asarray(v), jnp.asarray(m)) for v, m in keys])
    ref_h = np.asarray(ref_hash._fingerprint(jnp, ref_canon, (n,)))
    canon = hash_agg._canon_keys(
        [(torch.from_numpy(v), torch.from_numpy(m)) for v, m in keys])
    h = hash_agg._fingerprint(canon, (n,), "cpu")
    np.testing.assert_array_equal(h.numpy().view(np.uint64), ref_h)
    for (rv, rm), (tv, tm) in zip(ref_canon, canon):
        rv = np.asarray(rv)
        np.testing.assert_array_equal(tv.numpy().view(np.uint8),
                                      rv.view(np.uint8))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(rm))
    # the second probe's remix, and the unsigned slot of each probe
    h2 = hash_agg._mix(h, hash_agg._GOLD).numpy().view(np.uint64)
    ref_h2 = np.asarray(ref_hash._mix(jnp, jnp.asarray(ref_h),
                                      ref_hash._GOLD))
    np.testing.assert_array_equal(h2, ref_h2)
    for S in (1000, 1024, 7, (1 << 31) - 1):
        np.testing.assert_array_equal(
            hash_agg._umod(h, S).numpy(), (ref_h % np.uint64(S)).astype(np.int64))


# ------------------------------------------- plain insert vs the reference

HASH_SQL = ("SELECT g, f, d, count(*), count(v), sum(v), sum(s), min(s), "
            "max(v), min(d) FROM t WHERE v > -900 GROUP BY g, f, d")


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    """One data directory written by citus_tpu and opened by the port:
    a hash-mode plan of each package over the same table."""
    d = str(tmp_path_factory.mktemp("plans"))
    ref = ct.Cluster(d)
    ref.execute("CREATE TABLE t (k bigint NOT NULL, g bigint, f double, "
                "d date, v bigint, s double)")
    ref.execute("SELECT create_distributed_table('t', 'k', 2)")
    ref.execute("INSERT INTO t VALUES (0, 1, 0.5, '2020-01-01', 1, 1.0), "
                "(1, 1000000000000, -1.5, '2024-01-01', -5, 2.0)")
    port = ctt.Cluster(d, device="cpu")
    rp = ref_plan(ref.catalog, ref_bind(ref.catalog, ref_parse(HASH_SQL)[0]))
    pp = plan_select(port.catalog, bind_select(port.catalog,
                                               parse_sql(HASH_SQL)[0]))
    assert rp.group_mode.kind == pp.group_mode.kind == "hash_host"
    yield rp, pp
    port.close()
    ref.close()


def _batches(seed, n_batches=3, n=3000, groups=600):
    """Padded batches of the plan's scan columns (g, f, d, v, s) with
    nulls, -0.0 and NaN keys and padding rows."""
    rng = np.random.default_rng(seed)
    gk = rng.integers(0, 10**12, groups)
    fk = rng.normal(0, 10, groups)
    fk[:6] = [0.0, -0.0, np.nan, np.nan, 1.5, -1.5]
    out = []
    for _ in range(n_batches):
        pick = rng.integers(0, groups, n)
        g = gk[pick]
        f = fk[pick].copy()
        f[rng.random(n) < 0.05] = -0.0
        nan_rows = np.nonzero(rng.random(n) < 0.03)[0]
        f[nan_rows] = np.array([0x7FF0000000000001], np.uint64).view(
            np.float64)[0]
        d = (18000 + pick % 37).astype(np.int32)
        v = rng.integers(-1000, 1000, n)
        s = rng.normal(0, 100, n)
        s[rng.random(n) < 0.01] = np.nan
        cols = {"g": g, "f": f, "d": d, "v": v, "s": s}
        valids = {c: rng.random(n) > 0.04 for c in cols}
        row_mask = np.ones(n, bool)
        row_mask[-50:] = False
        out.append((cols, valids, row_mask))
    return out


def _group_dict(key_arrays, partials):
    """finalize() output -> {key tuple: partial tuple}, keys by their
    canonical bits (NaN groups compare equal)."""
    out = {}
    if not key_arrays:
        return out
    G = len(key_arrays[0][0])
    for gi in range(G):
        key = []
        for vals, valid in key_arrays:
            v = vals[gi]
            key.append(None if not valid[gi] else
                       ("nan" if isinstance(v, float) and math.isnan(v)
                        else v.item() if hasattr(v, "item") else v))
        out[tuple(key)] = tuple(np.asarray(p)[gi].item() for p in partials)
    return out


def _assert_same_groups(got, want):
    assert got.keys() == want.keys()
    for k in want:
        for a, b in zip(got[k], want[k]):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-12, nan_ok=True), k
            else:
                assert a == b, k


def _run_reference(plan, S, batches):
    key_dtypes = (np.dtype(np.int64), np.dtype(np.float64),
                  np.dtype(np.int32))
    fused = jax.jit(ref_hash.build_fused_hash_worker(plan, jnp, key_dtypes))
    state = jax.device_put(ref_hash.empty_hash_state(plan, S, key_dtypes))
    acc = RefAcc(len(plan.bound.group_keys), plan.partial_ops)
    key_fns = [ref_compile(k, np) for k in plan.bound.group_keys]
    arg_fns = [ref_compile(a, np) for a in plan.agg_args]
    spilled = 0
    for cols, valids, row_mask in batches:
        c = tuple(jnp.asarray(cols[n]) for n in plan.scan_columns)
        v = tuple(jnp.asarray(valids[n]) for n in plan.scan_columns)
        state, spill = fused(state, c, v, jnp.asarray(row_mask))
        spill = np.asarray(spill)
        spilled += int(spill.sum())
        env = {n: (cols[n], valids[n]) for n in plan.scan_columns}
        acc.add_batch(spill, [f(env) for f in key_fns],
                      [f(env) for f in arg_fns])
    fetched = jax.device_get(state)
    ref_hash.merge_hash_tables_into(acc, plan, fetched[0], fetched[1],
                                    fetched[2])
    keys, parts = acc.finalize([k.type for k in plan.bound.group_keys])
    return _group_dict(keys, parts), spilled


def _run_port(plan, S, batches, device="cpu"):
    key_dtypes = (np.dtype(np.int64), np.dtype(np.float64),
                  np.dtype(np.int32))
    fused = build_fused_hash_worker(plan, key_dtypes)
    table = empty_hash_state(plan, S, key_dtypes, device)
    acc = HostGroupAccumulator(len(plan.bound.group_keys), plan.partial_ops)
    key_fns = [compile_expr(k, np) for k in plan.bound.group_keys]
    arg_fns = [compile_expr(a, np) for a in plan.agg_args]
    spilled = 0
    for cols, valids, row_mask in batches:
        c = tuple(torch.from_numpy(cols[n]).to(device)
                  for n in plan.scan_columns)
        v = tuple(torch.from_numpy(valids[n]).to(device)
                  for n in plan.scan_columns)
        spill = fused(table, c, v,
                      torch.from_numpy(row_mask).to(device)).cpu().numpy()
        spilled += int(spill.sum())
        env = {n: (cols[n], valids[n]) for n in plan.scan_columns}
        acc.add_batch(spill, [f(env) for f in key_fns],
                      [f(env) for f in arg_fns])
    assert torch.equal(table.state, 2 * (table.rows > 0).to(torch.int32))
    merge_hash_tables_into(acc, plan, *table.to_host())
    keys, parts = acc.finalize([k.type for k in plan.bound.group_keys])
    return _group_dict(keys, parts), spilled, table


@pytest.mark.parametrize("S", [1024, 1000, 7])
def test_plain_insert_matches_reference_worker(plans, S):
    rp, pp = plans
    batches = _batches(S)
    want, ref_spilled = _run_reference(rp, S, batches)
    got, spilled, table = _run_port(pp, S, batches)
    _assert_same_groups(got, want)
    if S == 7:
        assert spilled > 0 and ref_spilled > 0
    # the invariants the card's kernel is also held to
    n_masked = 0
    for cols, valids, row_mask in batches:
        n_masked += int((row_mask & valids["v"]
                         & (cols["v"] > -900)).sum())
    assert int(table.rows.sum()) + spilled == n_masked
    occupied = (table.rows > 0).numpy()
    seen = set()
    for i in np.nonzero(occupied)[0]:
        k = tuple(kv[i].item() if kf[i] == 2 else None
                  for kv, kf in zip(table.key_values, table.key_flags))
        k = tuple("nan" if isinstance(x, float) and math.isnan(x) else x
                  for x in k)
        assert k not in seen  # each key sits in at most one slot
        seen.add(k)


def test_plain_insert_all_false_mask_and_bool_keys():
    """An all-false mask touches nothing; bool keys (one byte) group."""
    from citus_tpu_torch import types as T
    from citus_tpu_torch.ops.expr_codegen import FoldExprs
    from citus_tpu_torch.ops.hash_agg import HashTable
    from citus_tpu_torch.ops.scan_agg_fold import FoldOp, FoldProgram
    from citus_tpu_torch.planner.bound import BColumn
    S, n = 11, 500
    rng = np.random.default_rng(9)

    def table():
        return HashTable(
            [torch.full((S,), False), torch.full((S,), -2**31,
                                                 dtype=torch.int32)],
            [torch.zeros(S, dtype=torch.int8), torch.zeros(S, dtype=torch.int8)],
            [torch.zeros(S, dtype=torch.int64)],
            torch.zeros(S, dtype=torch.int64),
            torch.zeros(S, dtype=torch.int32))
    cols = {"b": (torch.from_numpy(rng.integers(0, 2, n).astype(bool)), None),
            "i": (torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)),
                  torch.from_numpy(rng.random(n) > 0.2))}
    prog = FoldProgram(
        FoldExprs(None, (BColumn("b", T.BOOL_T), BColumn("i", T.INT32_T)), ()),
        [FoldOp("count_star")], {"b": np.bool_, "i": np.int32}, {},
        key_dtypes=(np.bool_, np.int32))
    t = table()
    spill = hash_agg_insert(prog, t, cols, {}, torch.zeros(n, dtype=torch.bool))
    assert not spill.any() and int(t.rows.sum()) == 0
    spill = hash_agg_insert(prog, t, cols, {}, torch.ones(n, dtype=torch.bool))
    assert int(t.rows.sum()) + int(spill.sum()) == n
    assert int((t.rows > 0).sum()) <= 8  # 2 bools x (3 ids + NULL)
    keys = [(v, torch.ones(n, dtype=torch.bool) if m is None else m)
            for v, m in cols.values()]
    t2 = table()
    spill2 = hash_agg_insert_plain(t2, torch.ones(n, dtype=torch.bool), keys,
                                   [], [FoldOp("count_star")])
    assert torch.equal(t2.rows, t.rows) and torch.equal(spill2, spill)


# ------------------------------------------------- slice-level, via SQL


def _fill_groups(cl, n, groups, shards=4, table="t"):
    """tests/test_hash_agg_fused.py's table: keys far wider than
    direct_gid_limit, so the plan takes the hash_host group mode."""
    cl.execute(f"CREATE TABLE {table} "
               "(k bigint NOT NULL, g bigint, v bigint)")
    cl.execute(f"SELECT create_distributed_table('{table}', 'k', {shards})")
    rng = np.random.default_rng(groups)
    g = rng.integers(0, 10**12, groups)[rng.integers(0, groups, n)]
    v = rng.integers(0, 1000, n)
    cl.copy_from(table, columns={"k": np.arange(n, dtype=np.int64),
                                 "g": g, "v": v})
    return g, v


def _both(tmp_path, fill):
    ref = ct.Cluster(str(tmp_path / "ref"))
    port = ctt.Cluster(str(tmp_path / "port"), device="cpu")
    for cl in (ref, port):
        fill(cl)
    return ref, port


SQL = "SELECT g, count(*), sum(v), min(v), max(v) FROM t GROUP BY g"


@pytest.mark.parametrize("slots,groups", [
    (4096, 700),      # below the slot count
    (1024, 1024),     # at the slot count
    (1024, 3000),     # above: second-chance probes + spills
    (64, 6000),       # adversarial: nearly every row spills
])
def test_hash_groupby_matches_reference_across_cardinalities(
        tmp_path, slots, groups):
    n = 12_000
    drawn = []
    ref, port = _both(tmp_path,
                      lambda cl: drawn.append(_fill_groups(cl, n, groups)[0]))
    for cl in (ref, port):
        cl.execute(f"SET citus.hash_agg_slots = {slots}")
    c0 = GLOBAL_COUNTERS.snapshot()
    r = port.execute(SQL)
    c1 = GLOBAL_COUNTERS.snapshot()
    got = sorted(r.rows)
    assert got == sorted(ref.execute(SQL).rows)
    assert len(got) == len(np.unique(drawn[0]))
    assert r.explain["strategy"] == "hash_host"
    pipe = r.explain["pipeline"]
    batches = len(r.explain["tasks"])
    assert pipe["fused_dispatches"] == batches >= 1
    assert c1["hash_fused_dispatches"] - c0["hash_fused_dispatches"] == batches
    assert pipe["hash_slots"] == slots
    assert c1["hash_spill_rows"] - c0["hash_spill_rows"] \
        == pipe["hash_spilled_rows"]
    if groups > 2 * slots:
        assert pipe["hash_spilled_rows"] > 0
    port.close()
    ref.close()


def test_spill_heavy_keyset_stays_exact(tmp_path):
    """slots=64 against ~8000 groups: the exact host spill path carries
    the query; rows equal an independent count."""
    port = ctt.Cluster(str(tmp_path / "port"), device="cpu")
    g, v = _fill_groups(port, 16_000, 8000)
    port.execute("SET citus.hash_agg_slots = 64")
    r = port.execute("SELECT g, count(*), sum(v) FROM t GROUP BY g")
    assert r.explain["pipeline"]["hash_spilled_rows"] > 0
    truth = collections.defaultdict(lambda: [0, 0])
    for gi, vi in zip(g.tolist(), v.tolist()):
        truth[gi][0] += 1
        truth[gi][1] += vi
    assert sorted(r.rows) == sorted((gi, c, s) for gi, (c, s) in truth.items())
    port.close()


def test_float_keys_negative_zero_and_nan_group_once(tmp_path):
    """-0.0 groups with 0.0 and every NaN is ONE group, on the device
    table and the host spill alike, as in the reference."""
    base = [0.0, -0.0, float("nan"), 1.5, -1.5, float("nan"), 0.0, -0.0,
            2.5, float("-inf")]
    n = 4000
    fs = np.array([base[i % len(base)] for i in range(n)])
    fs[7::97] = np.array([0xFFF8000000000001], np.uint64).view(np.float64)[0]
    vs = np.arange(n, dtype=np.int64) % 13

    def fill(cl):
        cl.execute("CREATE TABLE f (k bigint NOT NULL, f double, v bigint)")
        cl.execute("SELECT create_distributed_table('f', 'k', 2)")
        cl.copy_from("f", columns={"k": np.arange(n, dtype=np.int64),
                                   "f": fs, "v": vs})
        cl.execute("SET citus.hash_agg_slots = 1024")
    ref, port = _both(tmp_path, fill)
    sql = "SELECT f, count(*), sum(v) FROM f GROUP BY f"
    ours = port.execute(sql).rows
    assert sorted(map(repr, ours)) == sorted(map(repr, ref.execute(sql).rows))
    assert len(ours) == 6
    port.execute("SET citus.hash_agg_slots = 2")  # most rows spill
    assert sorted(map(repr, port.execute(sql).rows)) == sorted(map(repr, ours))
    port.close()
    ref.close()


@pytest.fixture(scope="module")
def lineitem_pair(tmp_path_factory):
    """bench.py's lineitem at 12,000 rows and the events table.  At this
    scale l_orderkey's 3,000 values would fit the direct group mode, so
    citus.direct_gid_limit is lowered to 100 to plan them to hash_host,
    as ~1.5 M order keys do at SF1."""
    ref = ct.Cluster(str(tmp_path_factory.mktemp("ref")))
    port = ctt.Cluster(str(tmp_path_factory.mktemp("port")), device="cpu")
    for cl in (ref, port):
        _load_lineitem(cl, 12_000)
        _load_events(cl)
        cl.execute("SET citus.hash_agg_slots = auto")
        cl.execute("SET citus.direct_gid_limit = 100")
    yield ref, port
    port.close()
    ref.close()


BENCH_HASH_SQL = chip_smoke.BENCH_HASH

SLICE_HASH_QUERIES = [
    BENCH_HASH_SQL,
    chip_smoke.H1.replace("> 300", "> 60"),
    chip_smoke.H1,
    chip_smoke.H2,
    "SELECT l_orderkey, avg(l_discount), max(l_extendedprice), "
    "min(l_shipdate) FROM lineitem WHERE l_quantity < 20 GROUP BY l_orderkey "
    "ORDER BY l_orderkey LIMIT 50",
    # the host branch: exact value sets and a text key
    "SELECT kind, count(DISTINCT device) FROM events GROUP BY kind",
    "SELECT l_orderkey, count(DISTINCT l_returnflag) FROM lineitem "
    "GROUP BY l_orderkey ORDER BY l_orderkey LIMIT 40",
    "SELECT l_returnflag, l_orderkey, sum(l_tax) FROM lineitem "
    "WHERE l_orderkey < 300 GROUP BY l_returnflag, l_orderkey",
    "SELECT id % 1000 AS b, count(*) FROM events GROUP BY id % 1000 "
    "HAVING count(*) > 1",
    # float, boolean, date and NULL-bearing keys on the device table
    "SELECT score, count(*), max(qty) FROM events GROUP BY score",
    "SELECT l_quantity > 25, l_orderkey % 7, count(*) FROM lineitem "
    "GROUP BY l_quantity > 25, l_orderkey % 7",
    "SELECT device, d, count(*), min(qty), sum(score) FROM events "
    "GROUP BY device, d ORDER BY device NULLS FIRST, d LIMIT 60",
]


@pytest.mark.parametrize("sql", SLICE_HASH_QUERIES)
def test_slice_hash_queries_identical_to_reference(lineitem_pair, sql):
    ref, port = lineitem_pair
    r = port.execute(sql)
    assert r.explain["strategy"] == "hash_host"
    got, want = r.rows, ref.execute(sql).rows
    if "ORDER BY" not in sql:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert_same_rows(got, want)


def test_bench_hash_query_is_bench_py_and_plans_hash_mode(lineitem_pair):
    _, port = lineitem_pair
    import inspect
    assert BENCH_HASH_SQL.replace(" ", "") in \
        inspect.getsource(bench.bench_hash_agg).replace('"', "").replace(
            "\n", "").replace(" ", "")
    r = port.execute(BENCH_HASH_SQL)
    assert r.explain["strategy"] == "hash_host"
    assert r.explain["pipeline"]["hash_slots"] == 16384  # auto: 12,000 rows
    assert "host_merge_ms" in r.explain["pipeline"]


def test_cpu_backend_matches_device_backend(lineitem_pair):
    _, port = lineitem_pair
    queries = SLICE_HASH_QUERIES[:5]
    dev = [port.execute(q).rows for q in queries]
    port.execute("SET citus.task_executor_backend = 'cpu'")
    try:
        for q, d in zip(queries, dev):
            got, want = port.execute(q).rows, d
            if "ORDER BY" not in q:
                got, want = sorted(got, key=repr), sorted(want, key=repr)
            assert_same_rows(got, want)
    finally:
        port.execute("SET citus.task_executor_backend = 'gpu'")


def test_set_show_hash_agg_slots(lineitem_pair):
    _, port = lineitem_pair
    port.execute("SET citus.hash_agg_slots = 1000")
    try:
        assert port.execute("SHOW citus.hash_agg_slots").rows == [("1000",)]
        r = port.execute(BENCH_HASH_SQL)
        assert r.explain["pipeline"]["hash_slots"] == 1000
        with pytest.raises(Exception, match="invalid value"):
            port.execute("SET citus.hash_agg_slots = -3")
    finally:
        port.execute("SET citus.hash_agg_slots = auto")
    assert port.execute("SHOW hash_agg_slots").rows == [("0",)]


def test_chip_smoke_hash_oracles_match_port(tmp_path):
    """chip_smoke.py's numpy oracles of H1, H2 and P1 give the rows the
    port gives over the same generated lineitem."""
    n = 40_000
    port = ctt.Cluster(str(tmp_path / "db"), device="cpu")
    port.execute(chip_smoke.LINEITEM_DDL)
    port.execute("SELECT create_distributed_table('lineitem', 'l_orderkey', 4)")
    chunks = list(chip_smoke.lineitem_chunks(n))
    for c in chunks:
        port.copy_from("lineitem", columns=chip_smoke.copy_columns(c))
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    port.execute("SET citus.hash_agg_slots = auto")
    h1 = chip_smoke.H1.replace("> 300", "> 100")
    assert port.execute(h1).rows == chip_smoke.oracle_h1(cols, 100)
    assert port.execute(chip_smoke.H2).rows == chip_smoke.oracle_h2(cols)
    want = chip_smoke.oracle_p1(cols)
    assert port.execute(chip_smoke.P1).rows == want
    assert len(want) > 0
    port.close()


def test_chip_smoke_phase3_helpers_rehearse_on_cpu(tmp_path):
    """chip_smoke.py's phase-3 code paths at a tiny size on the CPU, with
    the plain version on both sides: the main path's hash inputs of one
    shard batch, the adversarial insert, the merged-group comparison and
    the invariants, and every filter program over its columns."""
    from citus_tpu_torch.ops.filter_mask import filter_mask_plain
    port = ctt.Cluster(str(tmp_path / "db"), device="cpu")
    port.execute(chip_smoke.LINEITEM_DDL)
    port.execute("SELECT create_distributed_table('lineitem', 'l_orderkey', 4)")
    for c in chip_smoke.lineitem_chunks(8000):
        port.copy_from("lineitem", columns=chip_smoke.copy_columns(c))
    port.execute("SET citus.direct_gid_limit = 100")
    call, n_real = chip_smoke.main_path_hash_call(port, "cpu")
    assert call[1].slots == 8192 and 0 < n_real <= call[-1].numel()
    cases = [call] + [chip_smoke.adversarial_hash_call("cpu", 5003, 1000, 3,
                                                       all_false)
                      for all_false in (False, True)]
    for case in cases:
        err = chip_smoke.compare_hash("rehearsal", case, hash_agg_insert,
                                      insert_plain)
        assert err == 0.0  # same plain version on both sides
    table = call[1]
    slot = sum(t.element_size() for t in table.key_values + table.key_flags
               + table.partials + [table.rows, table.state])
    inputs = chip_smoke.hash_bytes(call, 0)
    assert inputs > 2 * call[-1].numel()  # the mask in, the spill mask out
    assert chip_smoke.hash_bytes(call, 5) == inputs + 10 * slot
    port.close()
    plans = chip_smoke.smoke_plans("cpu", str(tmp_path), n=4096)
    line = chip_smoke.lineitem_filter_columns(plans["physical"])
    syn = chip_smoke.syn_columns(4096, 41)
    for name, cols in (("p1", line), ("q6", line), ("syn", syn)):
        prog, params = plans["filters"][name]
        args = chip_smoke.filter_call(prog, cols, params, "cpu", 4096)
        assert filter_mask_plain(prog, *args).shape == (4096,)
        assert chip_smoke.filter_bytes(args[0], args[2]) > 4096
        assert "fm_rows" in prog.predicate.source


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1024, 1000, 7])
def test_hash_kernel_matches_plain_on_card(plans, S):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    _, pp = plans
    batches = _batches(S)
    want, _, _ = _run_port(pp, S, batches, device="cpu")
    launches = hash_agg_insert.launches
    got, _, _ = _run_port(pp, S, batches, device="cuda")
    assert hash_agg_insert.launches == launches + len(batches)
    _assert_same_groups(got, want)


def test_insert_inputs_are_the_main_path_kernel_inputs(plans):
    """build_hash_insert_inputs gives the kernel its main-path inputs:
    the plan's hash program (keys of the table's dtypes, one op per
    partial), the table, the scan columns by name and the row mask; the
    plain version's keys come out in the table's key dtypes."""
    from citus_tpu_torch.ops.hash_agg_insert import plain_insert_inputs
    _, pp = plans
    key_dtypes = (np.dtype(np.int64), np.dtype(np.float64),
                  np.dtype(np.int32))
    cols, valids, row_mask = _batches(3, n_batches=1)[0]
    table = empty_hash_state(pp, 64, key_dtypes, "cpu")
    prog, t, tcols, params, mask = build_hash_insert_inputs(pp, key_dtypes)(
        table, tuple(torch.from_numpy(cols[n]) for n in pp.scan_columns),
        tuple(torch.from_numpy(valids[n]) for n in pp.scan_columns),
        torch.from_numpy(row_mask))
    assert t is table and mask.dtype == torch.bool and params == {}
    assert set(tcols) == set(pp.scan_columns)
    assert prog.key_dtypes == key_dtypes and prog.row.hashed
    assert len(prog.ops) == len(pp.partial_ops) == len(table.partials)
    _, keys, _ = plain_insert_inputs(prog, tcols, params, mask)
    assert [k[0].dtype for k in keys] == [torch.int64, torch.float64,
                                          torch.int32]
