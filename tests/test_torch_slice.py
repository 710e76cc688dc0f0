"""The port's first slice end to end, held against the JAX package.

The same SQL over the same rows goes through ``citus_tpu.Cluster`` (the
reference, JAX on the CPU) and ``citus_tpu_torch.Cluster(device="cpu")``
(the port, torch on the CPU with the fold kernel's plain version); the
rows must be identical.  Covers bench.py's TPC-H Q1 and Q6, the
aggregate queries of tests/test_oracle.py that plan to the scalar and
direct group modes, an empty result, and a data directory written by
``citus_tpu`` opened by the port.  Also: the port imports neither JAX
nor the JAX package, and statements outside the slice raise
UnsupportedFeatureError.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import citus_tpu as ct  # noqa: F401  (flips JAX to 64 bits first)
import citus_tpu_torch as ctt
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402

from citus_tpu_torch.errors import UnsupportedFeatureError  # noqa: E402

LINEITEM_ROWS = 3000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _load_lineitem(cl, n):
    """bench.py's lineitem schema and generator (seed 7), 4 shards."""
    cl.execute("""CREATE TABLE lineitem (
        l_orderkey bigint NOT NULL, l_quantity decimal(12,2),
        l_extendedprice decimal(12,2), l_discount decimal(12,2),
        l_tax decimal(12,2), l_returnflag text, l_linestatus text,
        l_shipdate date)""")
    cl.execute("SELECT create_distributed_table('lineitem', 'l_orderkey', 4)")
    rng = np.random.default_rng(7)
    rf = np.array(["A", "N", "R"])
    ls = np.array(["F", "O"])
    cl.copy_from("lineitem", columns={
        "l_orderkey": rng.integers(0, n // 4, n),
        "l_quantity": (rng.integers(100, 5100, n) / 100.0),
        "l_extendedprice": (rng.integers(90_000, 10_500_000, n) / 100.0),
        "l_discount": (rng.integers(0, 11, n) / 100.0),
        "l_tax": (rng.integers(0, 9, n) / 100.0),
        "l_returnflag": rf[rng.integers(0, 3, n)].tolist(),
        "l_linestatus": ls[rng.integers(0, 2, n)].tolist(),
        "l_shipdate": (rng.integers(0, 2526, n) + 8036).astype(np.int32),
    })


def _events_rows():
    """tests/test_oracle.py's events rows (seed 11), at 2000 rows."""
    rng = np.random.default_rng(11)
    kinds = ["click", "view", "buy", None]
    rows = []
    for i in range(2000):
        rows.append((
            i,
            int(rng.integers(0, 50)) if rng.random() > 0.05 else None,
            kinds[int(rng.integers(0, 4))],
            round(float(rng.integers(0, 10000)) / 100, 2) if rng.random() > 0.1 else None,
            float(np.round(rng.random() * 100, 6)),
            f"202{int(rng.integers(0,4))}-0{int(rng.integers(1,10))}-1{int(rng.integers(0,10))}",
        ))
    return rows


def _load_events(cl):
    cl.execute("""CREATE TABLE events (
        id bigint NOT NULL, device bigint, kind text, qty decimal(12,2),
        score double, d date)""")
    cl.execute("SELECT create_distributed_table('events', 'id', 4)")
    cl.copy_from("events", rows=_events_rows())


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(reference cluster, port cluster) over the same rows, each in its
    own data directory."""
    ref = ct.Cluster(str(tmp_path_factory.mktemp("ref")))
    port = ctt.Cluster(str(tmp_path_factory.mktemp("port")), device="cpu")
    for cl in (ref, port):
        _load_lineitem(cl, LINEITEM_ROWS)
        _load_events(cl)
    yield ref, port
    port.close()
    ref.close()


# tests/test_oracle.py QUERIES that plan to the scalar or direct mode
ORACLE_AGG_QUERIES = [
    "SELECT count(*) FROM events",
    "SELECT count(device), count(kind), count(qty) FROM events",
    "SELECT sum(qty), min(qty), max(qty) FROM events",
    "SELECT avg(score) FROM events",
    "SELECT kind, count(*) FROM events GROUP BY kind ORDER BY kind NULLS LAST",
    "SELECT kind, sum(qty), avg(qty), min(score), max(score) FROM events GROUP BY kind ORDER BY kind NULLS LAST",
    "SELECT device, count(*) FROM events WHERE device IS NOT NULL GROUP BY device ORDER BY device LIMIT 10",
    "SELECT count(*) FROM events WHERE qty > 50 AND score < 40",
    "SELECT count(*) FROM events WHERE kind = 'click' OR kind = 'buy'",
    "SELECT count(*) FROM events WHERE d >= '2021-01-01' AND d < '2023-01-01'",
    "SELECT kind, count(*) FROM events WHERE device BETWEEN 10 AND 20 GROUP BY kind ORDER BY kind NULLS LAST",
    "SELECT device, kind, count(*), sum(qty) FROM events GROUP BY device, kind "
    "HAVING count(*) > 10 ORDER BY device NULLS LAST, kind NULLS LAST LIMIT 25",
    "SELECT count(*) FROM events WHERE kind IN ('click', 'view')",
    "SELECT count(*) FROM events WHERE kind LIKE 'c%'",
    "SELECT sum(qty * 2 + 1) FROM events WHERE device = 7",
    "SELECT count(*) FROM events WHERE NOT (score > 50)",
    "SELECT min(d), max(d) FROM events",
]

SLICE_QUERIES = [bench.Q1, bench.Q6] + ORACLE_AGG_QUERIES + [
    # empty results: a scalar aggregate over no rows, a grouped one
    "SELECT count(*), sum(l_quantity), min(l_discount) FROM lineitem "
    "WHERE l_shipdate < date '1900-01-01'",
    "SELECT l_returnflag, count(*) FROM lineitem "
    "WHERE l_quantity < 0 GROUP BY l_returnflag",
]


def assert_same_rows(got, want):
    """Identical rows, except that a float aggregate may differ in its
    last bits (rel 1e-12): float64 sums are taken in another order by
    the port (index_add_ here, atomics on a card) than by XLA.  Decimals
    (exact scaled int64), integers, text and dates must be identical."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float):
                assert a == pytest.approx(b, rel=1e-12, nan_ok=True), (g, w)
            else:
                assert type(a) is type(b) and a == b, (g, w)


@pytest.mark.parametrize("sql", SLICE_QUERIES)
def test_port_rows_identical_to_reference(pair, sql):
    ref, port = pair
    assert_same_rows(port.execute(sql).rows, ref.execute(sql).rows)


def test_q1_plans_direct_and_folds_once_per_batch(pair):
    _, port = pair
    r = port.execute(bench.Q1)
    assert r.explain["strategy"] == "direct"
    assert r.explain["pipeline"]["fused_dispatches"] == len(r.explain["tasks"])
    assert len(r.rows) == 6  # 3 return flags x 2 line statuses
    assert port.execute(bench.Q6).explain["strategy"] == "scalar"


def test_cpu_oracle_backend_matches_device_backend(pair):
    from citus_tpu_torch.config import ExecutorSettings, settings_override
    _, port = pair
    dev_rows = port.execute(bench.Q1).rows
    with settings_override(
            executor=ExecutorSettings(task_executor_backend="cpu")) as s:
        oracle = ctt.Cluster(port.catalog.data_dir, device="cpu", settings=s)
        assert oracle.execute(bench.Q1).rows == dev_rows
        oracle.close()


def test_opens_reference_data_directory(tmp_path):
    """State carried across: a data directory written by citus_tpu
    (catalog document, columnar stripes, shard hash) answers the same
    SQL with identical rows in the port."""
    d = str(tmp_path / "db")
    ref = ct.Cluster(d)
    _load_lineitem(ref, 2000)
    _load_events(ref)
    queries = [bench.Q1, bench.Q6, ORACLE_AGG_QUERIES[5],
               ORACLE_AGG_QUERIES[11]]
    want = [ref.execute(q).rows for q in queries]
    ref.close()
    port = ctt.Cluster(d, device="cpu")
    for q, w in zip(queries, want):
        assert_same_rows(port.execute(q).rows, w)
    # and the port's writes land where the reference reads them
    port.execute("INSERT INTO events VALUES (100000, 7, 'buy', 12.5, 1.0, "
                 "'2022-02-02')")
    port.close()
    ref2 = ct.Cluster(d)
    assert ref2.execute("SELECT count(*) FROM events WHERE id = 100000"
                        ).rows == [(1,)]
    ref2.close()


@pytest.mark.parametrize("sql", [
    "SELECT id, row_number() OVER (ORDER BY id) FROM events",
    "WITH w AS (SELECT id FROM events) SELECT count(*) FROM w",
    "SELECT e.id FROM events e JOIN events f ON e.id = f.id",
    "SET citus.enable_metadata_sync = off",
    "BEGIN",
    "DELETE FROM events WHERE id = 1",
    "UPDATE events SET qty = 1 WHERE id = 1",
    "CREATE TABLE p (a bigint PRIMARY KEY)",
])
def test_unported_statement_raises(pair, sql):
    _, port = pair
    with pytest.raises(UnsupportedFeatureError):
        port.execute(sql)


def test_default_device_is_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        cl = ctt.Cluster(str(tmp_path / "db"))
        assert cl.device.type == "cuda"
        cl.close()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ctt.Cluster(str(tmp_path / "db"))


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import sys, tempfile\n"
        "import citus_tpu_torch as ctt\n"
        "from citus_tpu_torch.ops import scan_agg_fold, xp_torch, cuda_build\n"
        "from citus_tpu_torch.ops import hash_agg, hash_agg_insert\n"
        "from citus_tpu_torch.ops import expr_codegen, filter_mask\n"
        "from citus_tpu_torch.executor import megabatch, admission\n"
        "from citus_tpu_torch import workload\n"
        "from citus_tpu_torch.observability import flight_recorder\n"
        "from citus_tpu_torch.executor import host_agg\n"
        "from citus_tpu_torch.commands import loader\n"
        "import chip_smoke\n"
        "loader.ensure_loaded()\n"
        "cl = ctt.Cluster(tempfile.mkdtemp(), device='cpu')\n"
        "cl.execute('CREATE TABLE t (k bigint, v decimal(10,2))')\n"
        "cl.execute(\"SELECT create_distributed_table('t', 'k', 2)\")\n"
        "cl.execute('INSERT INTO t VALUES (1, 2.5), (2, -1.25)')\n"
        "assert cl.execute('SELECT sum(v) FROM t').rows[0][0] == 1.25\n"
        "cl.execute('SET citus.direct_gid_limit = 1')\n"
        "assert len(cl.execute('SELECT k, sum(v) FROM t GROUP BY k').rows) == 2\n"
        "assert cl.execute('SELECT k FROM t WHERE v > 0').rows == [(1,)]\n"
        "cl.execute('SET citus.megabatch_window_ms = 5')\n"
        "assert cl.execute('SELECT count(*) FROM t WHERE v > 0').rows "
        "== [(1,)]\n"
        "assert cl.execute('SELECT citus_megabatch_stats()').rows[0][3] "
        "== 1\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'citus_tpu' "
        "or m.startswith('citus_tpu.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


def test_chip_smoke_runs_bench_queries_and_generator(tmp_path):
    """chip_smoke.py carries bench.py's Q1/Q6 text verbatim, and its
    numpy oracle gives the rows the port gives over the same generated
    lineitem."""
    import chip_smoke
    assert chip_smoke.Q1 == bench.Q1 and chip_smoke.Q6 == bench.Q6
    n = 30_000
    port = ctt.Cluster(str(tmp_path / "db"), device="cpu")
    port.execute(chip_smoke.LINEITEM_DDL)
    port.execute("SELECT create_distributed_table('lineitem', 'l_orderkey', 4)")
    chunks = list(chip_smoke.lineitem_chunks(n))
    for c in chunks:
        port.copy_from("lineitem", columns=chip_smoke.copy_columns(c))
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    assert port.execute(bench.Q1).rows == chip_smoke.oracle_q1(cols)
    assert port.execute(bench.Q6).rows == chip_smoke.oracle_q6(cols)
    port.close()


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_set_task_executor_backend(pair):
    """SET citus.task_executor_backend takes cpu | gpu, as the
    reference's takes cpu | tpu; both answer Q1 alike."""
    _, port = pair
    want = port.execute(bench.Q1).rows
    port.execute("SET citus.task_executor_backend = 'cpu'")
    try:
        assert port.execute("SHOW citus.task_executor_backend").rows == [("cpu",)]
        assert port.execute(bench.Q1).rows == want
        with pytest.raises(Exception, match="invalid value"):
            port.execute("SET citus.task_executor_backend = 'tpu'")
    finally:
        port.execute("SET citus.task_executor_backend = 'gpu'")
    assert port.execute("SHOW task_executor_backend").rows == [("gpu",)]


def test_int64_overflow_guard_fires_as_in_reference(tmp_path):
    """An int64 decimal sum whose float64 shadow reaches 2^62 is refused
    by both packages alike (finalize's overflow guard), though the exact
    sum would still fit: this is what stops bench.py's Q1 sum_charge at
    TPC-H SF1, and the port mirrors it."""
    from citus_tpu.errors import ExecutionError as RefExecutionError
    from citus_tpu_torch.errors import ExecutionError
    sql = "SELECT sum(v) FROM big"
    rows = [(i, 1.2e16) for i in range(4)]  # 4.8e18 at scale 2 < 2^63
    ref = ct.Cluster(str(tmp_path / "ref"))
    port = ctt.Cluster(str(tmp_path / "port"), device="cpu")
    for cl in (ref, port):
        cl.execute("CREATE TABLE big (k bigint, v decimal(18,2))")
        cl.copy_from("big", rows=rows)
    with pytest.raises(RefExecutionError, match="out of range"):
        ref.execute(sql)
    with pytest.raises(ExecutionError, match="out of range"):
        port.execute(sql)
    ok = "SELECT sum(v) FROM big WHERE k < 3"
    assert_same_rows(port.execute(ok).rows, ref.execute(ok).rows)
    port.close()
    ref.close()
