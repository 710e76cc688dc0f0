"""Query megabatching of the port (executor/megabatch.py), held against
the JAX package.

SQL through ``Cluster.execute`` from several threads at once (the
barrier fan-out of tests/test_megabatch.py), on 2,000 rows in 4 shards,
backend ``gpu`` with ``device="cpu"`` (the batched kernels' plain
versions):

- the scalar (Q6-shaped), direct (Q1-shaped), hash_host (H2-shaped)
  and projection (P1-shaped) families coalesce, with occupancy above 1,
  and return rows identical to ``citus_tpu``'s serial and megabatched
  results for the same SQL over the same rows;
- divergent shard pruning sub-batches; window 0 and a coalescing window
  give the same rows over the oracle suite of tests/test_megabatch.py;
  a ``megabatch_finalize`` fault reaches only its own caller; a batched
  kernel that does not build or launch fails every rider, while an
  admission timeout or a shard-map change falls back serially; a WHERE the
  predicate generator refuses is counted as ineligible and runs serially;
  the batched runners record a device_round span per shard batch and
  the pipeline stats behind EXPLAIN; a group whose stacked hash tables
  pass the device budget runs in sub-batches; keys that reference a
  parameter raise (B5); the GUCs
  round-trip; an auto window leaves a sparse family serial; the stat
  views attribute each query; mixed families from more threads than
  cores stay exact.

Each batched kernel's plain version against the reference's ``jax.vmap``
of the same body (the ``batched:`` slots of
citus_tpu/executor/megabatch.py) on the same numpy inputs, seed 5, Q = 3
literal variants, two batches into the same registers or tables:
``filter_mask_batched`` (masks identical), ``scan_agg_fold_batched``
(int64 registers, counts, min/max and NaN positions identical, float64
sums within rel 1e-12: another summation order) and
``hash_agg_insert_batched`` (the groups after the host merge of each
query's table and spilled rows identical, float sums within rel 1e-12).
The generated batched row function also compiles with g++ and gives the
reference's masks.  chip_smoke.py's phase-3 helpers and phase-5
families rehearse here at 12,000 rows.  The tests count dispatches and
launches, never wall time.  ``test_batched_kernels_match_plain_on_card`` needs a card and
skips here.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest

import citus_tpu as ct
import jax
import jax.numpy as jnp
import torch

import citus_tpu_torch as ctt
from citus_tpu.executor.executor import (
    _empty_partials as ref_empty_partials, _hash_key_dtypes as ref_key_dtypes,
    encode_params as ref_encode,
)
from citus_tpu.executor.host_agg import HostGroupAccumulator as RefAcc
from citus_tpu.ops import hash_agg as ref_hash
from citus_tpu.ops.scan_agg import build_fused_worker_fn as ref_fused
from citus_tpu.planner import parse_sql as ref_parse
from citus_tpu.planner.auto_param import auto_parameterize as ref_auto_param
from citus_tpu.planner.bind import bind_select as ref_bind
from citus_tpu.planner.bound import (
    compile_expr as ref_compile, param_env_names as ref_param_names,
    predicate_mask as ref_predicate_mask,
)
from citus_tpu.planner.physical import plan_select as ref_plan
from citus_tpu_torch.errors import AdmissionTimeoutError
from citus_tpu_torch.executor import megabatch
from citus_tpu_torch.executor.device_cache import GLOBAL_CACHE
from citus_tpu_torch.executor.executor import (
    _build_filter_mask, _hash_key_dtypes, _params_env, encode_params,
)
from citus_tpu_torch.executor.host_agg import HostGroupAccumulator
from citus_tpu_torch.executor.megabatch import GLOBAL_MEGABATCH
from citus_tpu_torch.ops import cuda_build
from citus_tpu_torch.ops.filter_mask import (
    _FmBatch, _FmParams, filter_mask_batched, filter_mask_batched_plain,
    stack_params,
)
from citus_tpu_torch.ops.hash_agg import (
    empty_hash_state, hash_slot_bytes, merge_hash_tables_into,
)
from citus_tpu_torch.ops.hash_agg_insert import (
    hash_agg_insert_batched, hash_agg_insert_batched_plain,
)
from citus_tpu_torch.ops.scan_agg_fold import scan_agg_fold_batched
from citus_tpu_torch.observability.trace import Trace, activate
from citus_tpu_torch.planner import parse_sql
from citus_tpu_torch.planner.auto_param import auto_parameterize
from citus_tpu_torch.planner.bind import bind_select
from citus_tpu_torch.planner.bound import compile_expr
from citus_tpu_torch.planner.physical import plan_select
from citus_tpu_torch.testing.faults import FAULTS, FaultError

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_hash_agg import _assert_same_groups, _group_dict  # noqa: E402
from test_torch_slice import assert_same_rows  # noqa: E402

N_ROWS = 2000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fill(cl):
    cl.execute("CREATE TABLE t (k bigint NOT NULL, v bigint, s text, "
               "d decimal(8,2), f double)")
    cl.execute("SELECT create_distributed_table('t', 'k', 4)")
    rng = np.random.default_rng(5)
    f = np.round(rng.normal(0, 1, N_ROWS), 6)
    cl.copy_from("t", columns={
        "k": np.arange(N_ROWS), "v": np.arange(N_ROWS) % 50,
        "s": [f"n{i % 5}" for i in range(N_ROWS)],
        "d": np.arange(N_ROWS) / 4,
        "f": [None if i % 37 == 0 else float(x) for i, x in enumerate(f)]})


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    """One loaded data directory per package (the same rows)."""
    dirs = []
    for name, mod in (("ref", ct), ("port", None)):
        d = str(tmp_path_factory.mktemp(name))
        cl = ct.Cluster(d) if mod is ct else ctt.Cluster(d, device="cpu")
        _fill(cl)
        cl.close()
        dirs.append(d)
    return dirs


@pytest.fixture()
def clusters(data_dirs):
    """Fresh handles (settings, plan caches) on the loaded directories."""
    ref = ct.Cluster(data_dirs[0])
    port = ctt.Cluster(data_dirs[1], device="cpu")
    yield ref, port
    FAULTS.disarm()
    port.close()
    ref.close()


def _delta(c0, c1, key):
    return c1.get(key, 0) - c0.get(key, 0)


def _fanout(cl, sqls):
    """Run one SQL per thread, barrier-synced so they land inside one
    coalescing window.  -> (results, errors)."""
    results, errors = {}, {}
    bar = threading.Barrier(len(sqls))

    def run(i, sql):
        bar.wait()
        try:
            results[i] = cl.execute(sql).rows
        except Exception as e:  # noqa: BLE001 - recorded for assertions
            errors[i] = e
    ts = [threading.Thread(target=run, args=(i, s))
          for i, s in enumerate(sqls)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    return results, errors


K = 4
FAMILIES = {
    "scalar": ("scalar", [
        f"SELECT count(*), sum(d), min(v), max(f), count(f) FROM t "
        f"WHERE k < {500 + 300 * i} AND f > 0.{2 + 2 * i}5"
        for i in range(K)]),
    "direct": ("direct", [
        f"SELECT v, count(*), sum(d), min(f) FROM t WHERE v < {5 + i} "
        f"AND k < {1000 + 200 * i} GROUP BY v ORDER BY v"
        for i in range(K)]),
    "hash_host": ("hash_host", [
        f"SELECT k, sum(d), count(*), max(f) FROM t WHERE k < {600 + 100 * i}"
        f" AND v > {i} GROUP BY k ORDER BY k"
        for i in range(K)]),
    "projection": ("projection", [
        f"SELECT k, v, d, s FROM t WHERE d > {400 + 10 * i} AND s = 'n{i}' "
        "ORDER BY k" for i in range(K)]),
}


def _family_settings(cl, family):
    if family == "hash_host":
        # k's domain (2,000 values) past the direct limit: hash mode; a
        # 64-slot table so most rows spill and drain per rider
        cl.execute("SET citus.direct_gid_limit = 10")
        cl.execute("SET citus.hash_agg_slots = 64")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_coalesces_with_reference_rows(clusters, family):
    ref, port = clusters
    strategy, sqls = FAMILIES[family]
    for cl in (ref, port):
        _family_settings(cl, family)
    ref_serial = [ref.execute(s).rows for s in sqls]
    port_serial = [port.execute(s) for s in sqls]
    assert {r.explain["strategy"] for r in port_serial} == {strategy}
    for got, want in zip(port_serial, ref_serial):
        assert_same_rows(got.rows, want)
    for cl in (ref, port):
        cl.execute("SET citus.megabatch_window_ms = 1000")
        cl.execute(f"SET citus.megabatch_max_size = {K}")
    ref_mb, ref_err = _fanout(ref, sqls)
    assert ref_err == {}
    s0 = GLOBAL_MEGABATCH.stats()
    c0 = port.counters.snapshot()
    got, errors = _fanout(port, sqls)
    c1 = port.counters.snapshot()
    s1 = GLOBAL_MEGABATCH.stats()
    assert errors == {}
    for i in range(K):
        assert_same_rows(got[i], ref_serial[i])
        assert_same_rows(got[i], ref_mb[i])
    assert _delta(c0, c1, "megabatch_queries") == K
    assert _delta(c0, c1, "megabatch_fallbacks") == 0
    batches = s1["batches"] - s0["batches"]
    assert 1 <= batches < K          # occupancy above 1
    assert _delta(c0, c1, "wait_megabatch_ms") > 0
    view = port.execute("SELECT citus_megabatch_stats()")
    row = dict(zip(view.columns, view.rows[0]))
    assert row["avg_occupancy"] > 1 and row["queries"] >= K


@pytest.mark.parametrize("family", ["scalar", "direct", "hash_host"])
def test_coalesced_path_records_rounds_and_pipeline(clusters, family):
    """The batched runners stream through the serial path's device-batch
    stream: one device_round span per shard batch, and the pipeline
    stats behind EXPLAIN."""
    _, port = clusters
    _family_settings(port, family)
    sql = FAMILIES[family][1][0]
    port.execute("SET citus.megabatch_window_ms = 30")
    GLOBAL_CACHE.clear()   # stream the batches, not a cache replay
    tr = Trace()
    with activate(tr, tr.open_span("test", None)):
        r = port.execute(sql)
    rounds = tr.find_all("device_round")
    mb = r.explain["megabatch"]
    assert mb["occupancy"] == 1
    assert len(rounds) == mb["dispatches"] >= 1
    assert r.explain["pipeline"]["fused_dispatches"] == len(rounds)
    assert r.explain["pipeline"]["h2d_bytes"] > 0


def test_subbatches_by_shard_set(clusters):
    _, port = clusters
    keys = (7, 13, 42)   # three distinct shards of four
    sqls = [f"SELECT sum(v), count(*) FROM t WHERE k = {k}" for k in keys]
    base = [port.execute(s).rows for s in sqls]
    port.execute("SET citus.megabatch_window_ms = 1000")
    port.execute("SET citus.megabatch_max_size = 3")
    c0 = port.counters.snapshot()
    got, errors = _fanout(port, sqls)
    c1 = port.counters.snapshot()
    assert errors == {}
    assert [got[i] for i in range(3)] == base
    assert _delta(c0, c1, "megabatch_queries") == 3
    assert _delta(c0, c1, "megabatch_batches") >= 2
    assert _delta(c0, c1, "megabatch_fallbacks") == 0


ORACLE_SUITE = [
    "SELECT sum(v), count(*) FROM t WHERE k = 42",
    "SELECT v, s FROM t WHERE k = 13",
    "SELECT count(*) FROM t WHERE s = 'n3'",
    "SELECT sum(d), min(v) FROM t WHERE k BETWEEN 10 AND 20",
    "SELECT min(v), max(v) FROM t WHERE k >= 1990",
    "SELECT v, count(*) FROM t WHERE v < 5 AND k < 100 GROUP BY v ORDER BY v",
    "SELECT k, v FROM t WHERE k > 1995 ORDER BY k",
]


@pytest.mark.parametrize("sql", ORACLE_SUITE)
def test_window_zero_identical_to_coalesced_path(clusters, sql):
    ref, port = clusters
    want = ref.execute(sql).rows
    serial = port.execute(sql).rows
    port.execute("SET citus.megabatch_window_ms = 30")
    c0 = port.counters.snapshot()
    batched = port.execute(sql).rows
    c1 = port.counters.snapshot()
    assert serial == batched
    assert_same_rows(batched, want)
    # every query of the suite rode the batched runners (occupancy 1)
    assert _delta(c0, c1, "megabatch_queries") == 1


def test_finalize_fault_isolates_to_its_caller(clusters):
    _, port = clusters
    keys = (7, 13, 42)
    sqls = [f"SELECT sum(v) FROM t WHERE k = {k}" for k in keys]
    base = [port.execute(s).rows for s in sqls]
    port.execute("SET citus.megabatch_window_ms = 1000")
    port.execute("SET citus.megabatch_max_size = 3")
    FAULTS.arm("megabatch_finalize", error=FaultError("scatter boom"),
               match=":42", times=1)
    try:
        got, errors = _fanout(port, sqls)
    finally:
        FAULTS.disarm("megabatch_finalize")
    assert list(errors) == [2], (errors, got)
    assert isinstance(errors[2], FaultError)
    assert [got[0], got[1]] == base[:2]


@pytest.mark.parametrize("target, error, falls_back", [
    # a batched kernel that does not launch or build is this path's own
    # fault: every rider sees it, none quietly runs serially
    ("citus_tpu_torch.ops.scan_agg_fold.scan_agg_fold_batched",
     RuntimeError("scan_agg_fold_batched launch failed"), False),
    ("citus_tpu_torch.ops.filter_mask.filter_mask_batched",
     cuda_build.KernelBuildError("nvcc failed"), False),
    # shared infrastructure: the whole group retries serially
    ("citus_tpu_torch.executor.megabatch._batched_agg",
     AdmissionTimeoutError("task admission timed out"), True),
    ("citus_tpu_torch.executor.megabatch._batched_agg",
     megabatch.ShardMapChanged("megabatch: shard map changed"), True),
], ids=["launch", "build", "admission_timeout", "shard_map"])
def test_dispatch_failure_reaches_riders_or_falls_back(
        clusters, monkeypatch, target, error, falls_back):
    _, port = clusters
    sqls = [f"SELECT count(*), sum(v) FROM t WHERE v < {10 + i}"
            for i in range(3)]
    base = [port.execute(s).rows for s in sqls]
    port.execute("SET citus.megabatch_window_ms = 1000")
    port.execute("SET citus.megabatch_max_size = 3")

    def _fail(*args, **kwargs):
        raise error
    monkeypatch.setattr(target, _fail)
    c0 = port.counters.snapshot()
    got, errors = _fanout(port, sqls)
    c1 = port.counters.snapshot()
    if falls_back:
        assert errors == {}
        assert [got[i] for i in range(3)] == base
        assert _delta(c0, c1, "megabatch_fallbacks") == 3
        return
    assert got == {} and sorted(errors) == [0, 1, 2]
    for e in errors.values():
        assert type(e) is type(error) and str(e) == str(error)
        assert e.__cause__ is error
    assert len({id(e) for e in errors.values()}) == 3
    assert _delta(c0, c1, "megabatch_fallbacks") == 0
    assert _delta(c0, c1, "megabatch_queries") == 0


def test_refused_predicate_is_counted_and_runs_serially(clusters):
    ref, port = clusters
    # every node kind is generated; a predicate over more dictionary
    # tables than the parameter block holds (16) is still refused
    sql = "SELECT count(*) FROM t WHERE v > 40 AND (" + " OR ".join(
        f"s LIKE 'n{i % 5}%'" for i in range(17)) + ")"
    want = ref.execute(sql).rows
    port.execute("SET citus.megabatch_window_ms = 30")
    s0 = GLOBAL_MEGABATCH.stats()
    c0 = port.counters.snapshot()
    assert port.execute(sql).rows == want
    c1 = port.counters.snapshot()
    s1 = GLOBAL_MEGABATCH.stats()
    assert _delta(c0, c1, "megabatch_ineligible") == 1
    assert _delta(c0, c1, "megabatch_queries") == 0
    assert s1["ineligible"].get("predicate_codegen", 0) \
        == s0["ineligible"].get("predicate_codegen", 0) + 1
    view = port.execute("SELECT citus_megabatch_stats()")
    assert "predicate_codegen" in dict(zip(view.columns,
                                           view.rows[0]))["ineligible"]


def test_megabatch_gucs_round_trip(clusters):
    _, port = clusters
    port.execute("SET citus.megabatch_window_ms = 12.5")
    port.execute("SET citus.megabatch_max_size = 9")
    assert float(port.execute("SHOW citus.megabatch_window_ms").rows[0][0]) \
        == 12.5
    assert int(port.execute("SHOW citus.megabatch_max_size").rows[0][0]) == 9
    assert port.settings.executor.megabatch_window_ms == 12.5
    assert port.settings.executor.megabatch_max_size == 9
    port.execute("SET citus.megabatch_window_ms = auto")
    assert port.settings.executor.megabatch_window_ms == -1.0
    port.execute("SET citus.max_shared_pool_size = 3")
    assert port.execute("SHOW citus.max_shared_pool_size").rows == [("3",)]
    r = port.execute("SELECT citus_megabatch_stats()")
    assert r.columns[:5] == ["window_ms", "max_size", "batches", "queries",
                             "fallbacks"]
    assert r.rows[0][:2] == (-1.0, 9)
    port.execute("SET citus.megabatch_window_ms = 0")
    assert port.settings.executor.megabatch_window_ms == 0.0


def test_auto_window_sparse_family_stays_serial(clusters, monkeypatch):
    _, port = clusters
    sql = "SELECT sum(v) FROM t WHERE k = 7"
    want = port.execute(sql).rows
    port.execute("SET citus.megabatch_window_ms = auto")
    # a family arriving slower than the sparseness threshold: every
    # arrival is 0.1 s after the last on the dispatcher's clock
    ticks = iter(np.arange(1000.0, 2000.0, 0.1))
    monkeypatch.setattr(megabatch, "clock", lambda: next(ticks))
    s0 = GLOBAL_MEGABATCH.stats()
    for _ in range(5):
        assert port.execute(sql).rows == want
    s1 = GLOBAL_MEGABATCH.stats()
    assert s1["queries"] == s0["queries"]
    assert s1["batches"] == s0["batches"]


def test_hash_group_over_the_table_budget_runs_in_sub_batches(
        clusters, monkeypatch):
    """Q stacked tables past HASH_TABLES_BUDGET_BYTES split the group:
    each sub-batch scans the shards once with its own tables, and every
    rider still gets its own rows."""
    ref, port = clusters
    _, sqls = FAMILIES["hash_host"]
    for cl in (ref, port):
        _family_settings(cl, "hash_host")
    want = [ref.execute(s).rows for s in sqls]
    # room for the stacked tables of two queries, not four
    kd = (np.dtype(np.int64),)
    plan = port._cached_select_plan(parse_sql(sqls[0])[0], sqls[0])[1]
    monkeypatch.setattr(megabatch, "HASH_TABLES_BUDGET_BYTES",
                        2 * 64 * hash_slot_bytes(plan, kd))
    port.execute("SET citus.megabatch_window_ms = 1000")
    port.execute(f"SET citus.megabatch_max_size = {K}")
    s0 = GLOBAL_MEGABATCH.stats()
    got, errors = _fanout(port, sqls)
    s1 = GLOBAL_MEGABATCH.stats()
    assert errors == {}
    for i in range(K):
        assert_same_rows(got[i], want[i])
    assert s1["batches"] - s0["batches"] == 1
    # two sub-batches of two queries, 4 shard batches each
    assert s1["dispatches"] - s0["dispatches"] == 2 * 4


def test_parameter_in_group_keys_raises_naming_b5(clusters):
    """The batched kernels share keys and arguments across riders: a
    plan whose keys reference a parameter must raise, never slip onto
    the serial path."""
    import dataclasses
    from citus_tpu_torch.errors import UnsupportedFeatureError
    from citus_tpu_torch.planner.bound import BBinOp, BColumn, BParam, walk
    _, port = clusters
    sql = FAMILIES["direct"][1][0]
    bound, plan, values = port._cached_select_plan(parse_sql(sql)[0], sql)
    key = bound.group_keys[0]
    p0 = next(n for n in walk(bound.filter) if isinstance(n, BParam))
    skewed = BBinOp("+", BColumn("v", key.type), p0, key.type)
    bad = dataclasses.replace(bound, group_keys=[skewed])
    bad_plan = dataclasses.replace(plan, bound=bad)
    port.execute("SET citus.megabatch_window_ms = 5")
    params = encode_params(port.catalog, bound, values)
    with pytest.raises(UnsupportedFeatureError, match="B5"):
        megabatch.megabatch_eligible(port.catalog, bad, port.settings,
                                     bad_plan, params, port.device)
    assert megabatch.megabatch_eligible(port.catalog, bound, port.settings,
                                        plan, params, port.device)


def test_statements_and_tenants_attributed_per_query(clusters):
    _, port = clusters
    port.execute("SELECT citus_stat_statements_reset()")
    sqls = [f"SELECT count(*), sum(d) FROM t WHERE k < {100 * (i + 1)}"
            for i in range(K)]
    port.execute("SET citus.megabatch_window_ms = 1000")
    port.execute(f"SET citus.megabatch_max_size = {K}")
    _, errors = _fanout(port, sqls)
    assert errors == {}
    ss = port.execute("SELECT citus_stat_statements()").rows
    fam = [row for row in ss
           if row[0] == "select count(*), sum(d) from t where k < ?"]
    assert len(fam) == 1 and fam[0][3] == K         # one call per query
    view = port.execute("SELECT citus_stat_pool()")
    pool = dict(zip(view.columns, view.rows[0]))
    assert pool["coalesced"] >= K - 1 and pool["in_use"] == 0
    tenants = {r[0]: r for r in port.execute(
        "SELECT citus_stat_tenants()").rows}
    assert tenants["*"][7] >= K - 1                 # coalesced column
    port.execute("SELECT citus_stat_counters_reset()")
    assert [r[0] for r in port.execute("SELECT citus_stat_statements()").rows
            ] == ["select citus_stat_counters_reset()"]


def test_concurrent_mixed_families_stay_exact(clusters):
    """More threads than cores, a short switch interval, two families
    and the serial path interleaved: every caller gets its own rows."""
    _, port = clusters
    sqls = ([f"SELECT count(*), sum(d) FROM t WHERE k < {50 * (i + 1)}"
             for i in range(6)]
            + [f"SELECT k, v FROM t WHERE d > {480 + i} ORDER BY k"
               for i in range(6)]
            + [f"SELECT v, count(*) FROM t WHERE v < {3 + i} GROUP BY v "
               "ORDER BY v" for i in range(4)])
    want = [port.execute(s).rows for s in sqls]
    port.execute("SET citus.megabatch_window_ms = 20")
    port.execute("SET citus.megabatch_max_size = 5")
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for _ in range(2):
            got, errors = _fanout(port, sqls)
            assert errors == {}
            assert [got[i] for i in range(len(sqls))] == want
    finally:
        sys.setswitchinterval(prev)


def test_launch_counter_is_exact_under_threads():
    def fake():
        pass
    fake.launches = 0
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [
            cuda_build.count_launch(fake) for _ in range(2000)])
            for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in ts)
    assert fake.launches == 16 * 2000


# ------------------------------------------- batched kernels vs jax.vmap

N_PAD, N_PADDING = 4096, 17
KERNEL_FAMILIES = {
    "scalar": (
        "SELECT count(*), count(f), sum(d), sum(f), min(v), max(f), "
        "min(d), max(v) FROM t WHERE k < {a} AND f > {b}",
        [(2000, "0.25"), (500, "1.50"), (3500, "0.75")], 65536),
    "direct": (
        "SELECT v, count(*), sum(d), sum(f), max(f), min(d) FROM t "
        "WHERE k >= {a} AND d < {b} GROUP BY v",
        [(100, "100.50"), (1500, "250.25"), (0, "375.75")], 65536),
    "hash_host": (
        "SELECT v, count(*), sum(d), sum(f), min(f), max(d) FROM t "
        "WHERE k >= {a} AND d < {b} GROUP BY v",
        [(100, "100.50"), (1500, "250.25"), (0, "375.75")], 10),
}


@pytest.fixture(scope="module")
def catalogs(tmp_path_factory):
    """One data directory written by citus_tpu, opened by both packages:
    the key domains come from its stripe footers."""
    d = str(tmp_path_factory.mktemp("kernels"))
    ref = ct.Cluster(d)
    _fill(ref)
    port = ctt.Cluster(d, device="cpu")
    yield ref.catalog, port.catalog
    port.close()
    ref.close()


def _family(catalogs, name):
    """-> (reference plan, reference params per query, port plan, port
    params per query) of one literal family, bound and auto-parameterized
    as Cluster.execute does it."""
    rcat, pcat = catalogs
    sql, lits, limit = KERNEL_FAMILIES[name]
    rp = pp = None
    rparams, pparams = [], []
    for a, b in lits:
        text = sql.format(a=a, b=b)
        rb, rv = ref_auto_param(ref_bind(rcat, ref_parse(text)[0]))
        pb, pv = auto_parameterize(bind_select(pcat, parse_sql(text)[0]))
        rp = rp or ref_plan(rcat, rb, direct_limit=limit)
        pp = pp or plan_select(pcat, pb, direct_limit=limit)
        rparams.append(ref_encode(rcat, rb, rv))
        pparams.append(encode_params(pcat, pb, pv))
    assert rp.group_mode.kind == pp.group_mode.kind == name
    return rp, rparams, pp, pparams


def _batch(plan, seed):
    """numpy batch in the plan's scan columns with nulls, NaN, +-inf and
    -0.0; the last rows are padding."""
    rng = np.random.default_rng(seed)
    schema = plan.bound.table.schema
    cols, valids = {}, {}
    for c in plan.scan_columns:
        dt = schema.scan_dtype(c, device=True)
        if c == "k":
            v = rng.integers(0, 4000, N_PAD)
        elif c == "v":
            v = rng.integers(0, 50, N_PAD)
        elif c == "d":
            v = rng.integers(-50_000, 50_000, N_PAD)
        else:
            v = rng.standard_normal(N_PAD) * 2
            idx = rng.integers(0, N_PAD - N_PADDING, 40)
            v[idx[:10]] = np.nan
            v[idx[10:20]] = np.inf
            v[idx[20:25]] = -np.inf
            v[idx[25:]] = -0.0
        cols[c] = np.ascontiguousarray(v.astype(dt))
        valids[c] = rng.random(N_PAD) > (0 if c == "k" else 0.05)
    row_mask = np.ones(N_PAD, bool)
    row_mask[-N_PADDING:] = False
    return cols, valids, row_mask


def _ref_stack(params):
    n = len(params[0][0])
    return (tuple(np.stack([p[0][j] for p in params]) for j in range(n)),
            tuple(np.stack([p[1][j] for p in params]) for j in range(n)))


def _ref_masks(rp, rparams, cols, valids, row_mask):
    """The reference's ``batched:jit_filter``: jax.vmap of the
    projection filter over the stacked parameters."""
    pcols, pvalids = _ref_stack(rparams)
    names = tuple(rp.scan_columns) + tuple(
        ref_param_names(rp.bound.param_specs))
    axes = (None,) * len(rp.scan_columns) + (0,) * len(pcols)
    cfn = ref_compile(rp.bound.filter, jnp)

    def device_mask(cs, vs, rm):
        env = {n: (c, v) for n, c, v in zip(names, cs, vs)}
        return rm & ref_predicate_mask(jnp, cfn, env, rm)
    fn = jax.jit(jax.vmap(device_mask, in_axes=(axes, axes, None)))
    c = tuple(jnp.asarray(cols[n]) for n in rp.scan_columns) + pcols
    v = tuple(jnp.asarray(valids[n]) for n in rp.scan_columns) + pvalids
    return np.asarray(fn(c, v, jnp.asarray(row_mask)))


def _by_name(plan, cols, valids, dev="cpu"):
    """A numpy batch's scan columns as the kernels take them: name ->
    (values, validity) tensors on ``dev``."""
    return {n: (torch.from_numpy(cols[n]).to(dev),
                torch.from_numpy(valids[n]).to(dev))
            for n in plan.scan_columns}


def _port_masks(pp, pparams, cols, valids, row_mask, device="cpu"):
    prog = _build_filter_mask(pp, pparams[0])
    stacked = stack_params(prog, [_params_env(pp, p) for p in pparams],
                           device)
    tcols = {c: (torch.from_numpy(cols[c]).to(device),
                 torch.from_numpy(valids[c]).to(device))
             for c in prog.columns}
    return prog, stacked, tcols, torch.from_numpy(row_mask).to(device)


@pytest.mark.parametrize("name", list(KERNEL_FAMILIES))
def test_plain_batched_filter_matches_vmap(catalogs, name):
    rp, rparams, pp, pparams = _family(catalogs, name)
    cols, valids, row_mask = _batch(pp, 11)
    want = _ref_masks(rp, rparams, cols, valids, row_mask)
    prog, stacked, tcols, trm = _port_masks(pp, pparams, cols, valids,
                                            row_mask)
    got = filter_mask_batched(prog, tcols, stacked, trm)
    assert got.shape == (len(pparams), N_PAD)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any(axis=1).all() and not want.all(axis=1).any()
    # each query's row differs: the masks really are per query
    assert len({m.tobytes() for m in want}) == len(pparams)


def _assert_registers(name, ops, got, want):
    """int64 and counts identical, float min/max identical with NaN in
    the same places, float sums within rel 1e-12."""
    for op, g, w in zip(ops, got, want):
        g, w = np.asarray(g).reshape(w.shape), np.asarray(w)
        if op.kind == "sum" and w.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            fin = np.isfinite(w)
            np.testing.assert_array_equal(g[~fin & ~np.isnan(w)],
                                          w[~fin & ~np.isnan(w)])
            np.testing.assert_allclose(g[fin], w[fin], rtol=1e-12, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {op}")


@pytest.mark.parametrize("name", ["scalar", "direct"])
def test_plain_batched_fold_matches_vmap(catalogs, name):
    rp, rparams, pp, pparams = _family(catalogs, name)
    q = len(pparams)
    batches = [_batch(pp, s) for s in (21, 22)]
    # the reference: jax.vmap of the fused worker, registers mapped,
    # columns broadcast, parameters mapped (batched:jit_fused)
    pcols, pvalids = _ref_stack(rparams)
    axes = (None,) * len(rp.scan_columns) + (0,) * len(pcols)
    fn = jax.jit(jax.vmap(ref_fused(rp, jnp), in_axes=(0, axes, axes, None)))
    acc = tuple(jnp.asarray(np.stack([p] * q))
                for p in ref_empty_partials(rp, np))
    for cols, valids, row_mask in batches:
        acc = fn(acc, tuple(jnp.asarray(cols[n]) for n in rp.scan_columns)
                 + pcols,
                 tuple(jnp.asarray(valids[n]) for n in rp.scan_columns)
                 + pvalids, jnp.asarray(row_mask))
    want = [np.asarray(a) for a in acc]
    # the port: batched masks, shared keys and arguments, [Q, G] registers
    fold = megabatch._fold_program(pp, pparams[0], "cpu")
    ops = fold.ops
    regs, rows = megabatch._empty_stacked_partials(pp, q, "cpu")
    for cols, valids, row_mask in batches:
        prog, stacked, tcols, trm = _port_masks(pp, pparams, cols, valids,
                                                row_mask)
        masks = filter_mask_batched(prog, tcols, stacked, trm)
        scan_agg_fold_batched(fold, regs, rows, _by_name(pp, cols, valids),
                              masks)
    got = [r.numpy() for r in regs]
    if rows is not None:
        got.append(rows.numpy())
        np.testing.assert_array_equal(got[-1], want[-1])
        assert (want[-1].sum(axis=1) > 0).all()
    _assert_registers(name, pp.partial_ops, got[:len(ops)],
                      want[:len(ops)])


@pytest.mark.parametrize("S", [64, 7])
def test_plain_batched_hash_insert_matches_vmap(catalogs, S):
    rp, rparams, pp, pparams = _family(catalogs, "hash_host")
    q = len(pparams)
    batches = [_batch(pp, s) for s in (31, 32)]
    # the reference: jax.vmap of the fused hash worker over [Q, S]
    # tables (batched:jit_hash_fused), spills drained per query
    rkd = ref_key_dtypes(rp, {})
    pcols, pvalids = _ref_stack(rparams)
    axes = (None,) * len(rp.scan_columns) + (0,) * len(pcols)
    fn = jax.jit(jax.vmap(ref_hash.build_fused_hash_worker(rp, jnp, rkd),
                          in_axes=(0, axes, axes, None)))
    state = jax.device_put(jax.tree_util.tree_map(
        lambda a: np.stack([a] * q), ref_hash.empty_hash_state(rp, S, rkd)))
    raccs = [RefAcc(len(rp.bound.group_keys), rp.partial_ops)
             for _ in range(q)]
    rkey_fns = [ref_compile(k, np) for k in rp.bound.group_keys]
    rarg_fns = [ref_compile(a, np) for a in rp.agg_args]
    for cols, valids, row_mask in batches:
        state, spills = fn(
            state, tuple(jnp.asarray(cols[n]) for n in rp.scan_columns)
            + pcols, tuple(jnp.asarray(valids[n]) for n in rp.scan_columns)
            + pvalids, jnp.asarray(row_mask))
        spills = np.asarray(spills)
        env = {n: (cols[n], valids[n]) for n in rp.scan_columns}
        for qi in range(q):
            raccs[qi].add_batch(spills[qi], [f(env) for f in rkey_fns],
                                [f(env) for f in rarg_fns])
    fetched = jax.device_get(state)
    want = []
    for qi in range(q):
        ref_hash.merge_hash_tables_into(
            raccs[qi], rp, [(v[qi], f[qi]) for v, f in fetched[0]],
            [p[qi] for p in fetched[1]], fetched[2][qi])
        want.append(_group_dict(*raccs[qi].finalize(
            [k.type for k in rp.bound.group_keys])))
    # the port: batched masks, shared keys/arguments, Q stacked tables
    kd = _hash_key_dtypes(pp, {})
    insert = megabatch._fold_program(pp, pparams[0], "cpu", kd)
    table = empty_hash_state(pp, S, kd, "cpu", n_queries=q)
    accs = [HostGroupAccumulator(len(pp.bound.group_keys), pp.partial_ops)
            for _ in range(q)]
    key_fns = [compile_expr(k, np) for k in pp.bound.group_keys]
    arg_fns = [compile_expr(a, np) for a in pp.agg_args]
    spilled = np.zeros(q, np.int64)
    masked = np.zeros(q, np.int64)
    for cols, valids, row_mask in batches:
        prog, stacked, tcols, trm = _port_masks(pp, pparams, cols, valids,
                                                row_mask)
        masks = filter_mask_batched(prog, tcols, stacked, trm)
        sp = hash_agg_insert_batched(insert, table,
                                     _by_name(pp, cols, valids),
                                     masks).numpy()
        assert sp.shape == (q, N_PAD)
        spilled += sp.sum(axis=1)
        masked += masks.numpy().sum(axis=1)
        env = {n: (cols[n], valids[n]) for n in pp.scan_columns}
        for qi in range(q):
            accs[qi].add_batch(sp[qi], [f(env) for f in key_fns],
                               [f(env) for f in arg_fns])
    # placed + spilled = masked rows, per query; claim words mirror rows
    np.testing.assert_array_equal(table.rows.sum(dim=1).numpy() + spilled,
                                  masked)
    assert torch.equal(table.state, 2 * (table.rows > 0).to(torch.int32))
    if S == 7:
        assert (spilled > 0).all()
    key_tables, partials, rows = table.to_host()
    for qi in range(q):
        merge_hash_tables_into(accs[qi], pp,
                               [(v[qi], f[qi]) for v, f in key_tables],
                               [p[qi] for p in partials], rows[qi])
        got = _group_dict(*accs[qi].finalize(
            [k.type for k in pp.bound.group_keys]))
        _assert_same_groups(got, want[qi])


def test_stacked_table_slices_and_budget(catalogs):
    _, _, pp, _ = _family(catalogs, "hash_host")
    kd = _hash_key_dtypes(pp, {})
    t = empty_hash_state(pp, 16, kd, "cpu", n_queries=3)
    assert t.slots == 16 and t.rows.shape == (3, 16)
    t.query(1).rows[4] = 9        # a view into row 1 of the stack
    assert int(t.rows[1, 4]) == 9 and int(t.rows.sum()) == 9
    per_slot = sum(int(x.element_size()) for x in
                   t.key_values + t.key_flags + t.partials
                   + [t.rows, t.state])
    # one record a slot, its fields inside it, the Q records of a slot
    # side by side
    record = t.records.shape[-1] * t.records.element_size()
    assert t.records.shape[:2] == (16, 3)
    assert hash_slot_bytes(pp, kd) == record >= per_slot
    assert megabatch.HASH_TABLES_BUDGET_BYTES // ((1 << 20) * record) >= 32


def test_plain_batched_hash_insert_equals_per_query_inserts(catalogs):
    """One batched insert into Q stacked tables gives each query the
    table and spills of a one-table insert with its own mask."""
    from citus_tpu_torch.ops.hash_agg_insert import (
        hash_agg_insert_plain, plain_insert_inputs,
    )
    _, _, pp, pparams = _family(catalogs, "hash_host")
    kd = _hash_key_dtypes(pp, {})
    cols, valids, row_mask = _batch(pp, 41)
    prog, stacked, tcols, trm = _port_masks(pp, pparams, cols, valids,
                                            row_mask)
    masks = filter_mask_batched(prog, tcols, stacked, trm)
    insert = megabatch._fold_program(pp, pparams[0], "cpu", kd)
    _, keys, args = plain_insert_inputs(insert, _by_name(pp, cols, valids),
                                        {}, trm, with_filter=False)
    ops = insert.ops
    stack = empty_hash_state(pp, 32, kd, "cpu", n_queries=len(pparams))
    sp = hash_agg_insert_batched_plain(stack, masks, keys, args, ops)
    for qi in range(len(pparams)):
        one = empty_hash_state(pp, 32, kd, "cpu")
        sp1 = hash_agg_insert_plain(one, masks[qi], keys, args, ops)
        assert torch.equal(sp[qi], sp1)
        assert torch.equal(stack.rows[qi], one.rows)
        for a, b in zip(stack.partials, one.partials):
            torch.testing.assert_close(a[qi], b, rtol=0, atol=0,
                                       equal_nan=True)


# ------------------------------------------------- the g++ host harness


@pytest.mark.parametrize("name", list(KERNEL_FAMILIES))
def test_generated_batched_row_on_host_matches_vmap(catalogs, name,
                                                    tmp_path):
    """The generated ``fm_batched_rows`` (a thread of the batched
    kernel: its rows' columns loaded once, the predicate run per query
    with its row of the stacked parameters) compiled by g++ and run for
    every thread; masks identical to the reference's jax.vmap."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ (the native codec's compiler) found")
    rp, rparams, pp, pparams = _family(catalogs, name)
    cols, valids, row_mask = _batch(pp, 51)
    want = _ref_masks(rp, rparams, cols, valids, row_mask)
    prog, stacked, _, _ = _port_masks(pp, pparams, cols, valids, row_mask)
    (tmp_path / "pred.inc").write_text(prog.predicate.source)
    (tmp_path / "harness.cpp").write_text(
        '#include "pred.inc"\n'
        'extern "C" void run(const FmParams* p, const FmBatch* b) {\n'
        "    for (int64_t g = 0; g < fm_threads(p->n); ++g)\n"
        "        fm_batched_rows(*p, *b, g);\n"
        "}\n")
    so = tmp_path / "libharness.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", cuda_build.CSRC, "-I", str(tmp_path),
                    "-o", str(so), str(tmp_path / "harness.cpp")],
                   check=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.POINTER(_FmParams), ctypes.POINTER(_FmBatch)]
    lib.run.restype = None
    q = len(pparams)
    out = np.zeros((q, N_PAD), np.uint8)
    keep = []
    p = _FmParams()
    p.n = N_PAD
    p.row_mask = row_mask.ctypes.data
    p.out = 0
    for j, c in enumerate(prog.predicate.columns):
        v = np.ascontiguousarray(cols[c])
        m = np.ascontiguousarray(valids[c])
        keep += [v, m]
        p.cols[j], p.valids[j] = v.ctypes.data, m.ctypes.data
    bits = np.ascontiguousarray(stacked.bits.numpy())
    pvalid = np.ascontiguousarray(stacked.valid.numpy())
    b = _FmBatch()
    b.n_q, b.n_params = q, bits.shape[1]
    b.params, b.param_valid = bits.ctypes.data, pvalid.ctypes.data
    b.out = out.ctypes.data
    lib.run(ctypes.byref(p), ctypes.byref(b))
    np.testing.assert_array_equal(out.astype(bool), want)
    prog, stacked, tcols, trm = _port_masks(pp, pparams, cols, valids,
                                            row_mask)
    np.testing.assert_array_equal(
        filter_mask_batched_plain(prog, tcols, stacked, trm).numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(KERNEL_FAMILIES))
def test_batched_kernels_match_plain_on_card(catalogs, name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    _, _, pp, pparams = _family(catalogs, name)
    q = len(pparams)
    cols, valids, row_mask = _batch(pp, 61)
    got = {}
    for dev in ("cpu", "cuda"):
        prog, stacked, tcols, trm = _port_masks(pp, pparams, cols, valids,
                                                row_mask, dev)
        masks = filter_mask_batched(prog, tcols, stacked, trm)
        by_name = _by_name(pp, cols, valids, dev)
        if name == "hash_host":
            kd = _hash_key_dtypes(pp, {})
            insert = megabatch._fold_program(pp, pparams[0], dev, kd)
            table = empty_hash_state(pp, 64, kd, dev, n_queries=q)
            sp = hash_agg_insert_batched(insert, table, by_name, masks)
            got[dev] = (masks.cpu(), table.rows.sum(dim=1).cpu()
                        + sp.sum(dim=1).cpu())
        else:
            fold = megabatch._fold_program(pp, pparams[0], dev)
            regs, rows = megabatch._empty_stacked_partials(pp, q, dev)
            scan_agg_fold_batched(fold, regs, rows, by_name, masks)
            got[dev] = (masks.cpu(), [r.cpu() for r in regs])
    assert torch.equal(got["cpu"][0], got["cuda"][0])
    if name == "hash_host":
        assert torch.equal(got["cpu"][1], got["cuda"][1])
    else:
        _assert_registers(name, pp.partial_ops,
                          [r.numpy() for r in got["cuda"][1]],
                          [r.numpy() for r in got["cpu"][1]])


# ------------------------------------------- chip_smoke.py rehearsal


@pytest.fixture(scope="module")
def smoke_lineitem(tmp_path_factory):
    """chip_smoke.py's lineitem (bench.py's generator, 4 shards) at
    12,000 rows on the CPU."""
    import chip_smoke
    cl = ctt.Cluster(str(tmp_path_factory.mktemp("smoke")), device="cpu")
    cl.execute(chip_smoke.LINEITEM_DDL)
    cl.execute("SELECT create_distributed_table('lineitem', 'l_orderkey', 4)")
    chunks = list(chip_smoke.lineitem_chunks(12_000))
    for c in chunks:
        cl.copy_from("lineitem", columns=chip_smoke.copy_columns(c))
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    # at this scale l_orderkey's domain is small: force the hash mode the
    # H family takes at SF1
    cl.execute("SET citus.direct_gid_limit = 100")
    yield cl, cols
    cl.close()


@pytest.mark.parametrize("name", ["Q6", "H", "P", "Q1"])
def test_chip_smoke_phase5_rehearses_on_cpu(smoke_lineitem, name):
    """chip_smoke.py's phase-5 family at a small scale: every variant
    shares one plan family, the coalesced runs ride one batch of
    occupancy 8, and every query's rows equal the numpy oracle."""
    import chip_smoke
    cl, cols = smoke_lineitem
    kind, variants = chip_smoke.families()[name]
    assert len(variants) == chip_smoke.Q_BATCH
    fams = chip_smoke.family_plans(cl)
    assert fams[name][0].group_mode.kind == (
        kind if kind != "projection" else "scalar")
    s0 = GLOBAL_MEGABATCH.stats()
    launched = chip_smoke.run_family(cl, name, kind, variants, cols, 12_000)
    s1 = GLOBAL_MEGABATCH.stats()
    assert s1["queries"] - s0["queries"] == 2 * chip_smoke.Q_BATCH
    assert s1["batches"] - s0["batches"] == 2
    assert set(launched.values()) == {0}     # plain versions on the CPU


def test_chip_smoke_phase3_batched_helpers_rehearse_on_cpu(smoke_lineitem,
                                                           tmp_path):
    import chip_smoke
    cl, _ = smoke_lineitem
    plans = chip_smoke.smoke_plans("cpu", str(tmp_path), n=4096)
    for name in ("Q6", "Q1"):
        call = chip_smoke.batched_fold_call("cpu", plans, name)
        assert call[-1].shape == (chip_smoke.Q_BATCH, 4096)
        assert chip_smoke.compare_fold(name, call, scan_agg_fold_batched,
                                       scan_agg_fold_batched) >= 0.0
        assert chip_smoke.fold_bytes(call) > 4096 * chip_smoke.Q_BATCH
    call, n_real = chip_smoke.batched_hash_call(cl, "cpu")
    prog, table, cols, masks = call
    assert masks.shape[0] == chip_smoke.Q_BATCH and n_real > 0
    spill = hash_agg_insert_batched(prog, table, cols, masks)
    for q in range(chip_smoke.Q_BATCH):
        chip_smoke.check_hash_invariants(f"q{q}", table.query(q), spill[q],
                                         masks[q])
    # the bound charges each occupied slot, not the whole Q tables
    occupied = int((table.rows > 0).sum())
    assert 0 < occupied <= int(masks.sum())
    slot = sum(t.element_size() for t in table.key_values + table.key_flags
               + table.partials + [table.rows, table.state])
    inputs = chip_smoke.hash_bytes(call, 0)
    assert inputs > 2 * masks.numel()     # Q masks in, Q spill masks out
    assert chip_smoke.hash_bytes(call, occupied) == inputs + 2 * occupied * slot
