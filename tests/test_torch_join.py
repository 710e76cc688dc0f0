"""Joins through the port, held against the JAX package.

The same SQL over the same rows goes through ``citus_tpu.Cluster`` (its
default backend on tests/conftest.py's 8 virtual devices: the mesh's
device join) and ``citus_tpu_torch.Cluster(device="cpu")`` on its
``gpu`` backend (the one-card mesh, whose partition and sort-join
wrappers run their plain versions on CPU tensors) and on its ``cpu``
backend (host buckets, as the reference's cpu oracle): the rows must be
identical (sorted first where the SQL has no ORDER BY), and so must the
EXPLAIN strategy and shuffle mode.

- the query shapes of tests/test_device_join.py (many-to-many, two keys,
  a residual, projection order, GROUP BY after the join, an empty side,
  an outer join on the bucket path) and of
  tests/test_repartition_join.py (TPC-H Q12's shape, a projection, a
  left outer join, a reference table, a text key, the colocated case,
  three relations stepwise);
- every query above again with the port on an 8-member CPU mesh
  (``mesh_devices=["cpu"] * 8``), the reference's device count: both
  packages' device joins exchange over 8 members;
- bench.py's QJOIN (BASELINE.json config 5) over bench.py's lineitem
  and orders_b generators at test scale;
- TPC-H Q3's and Q10's shapes: distributed relations joined with
  reference tables and aggregated (BASELINE.json config 4);
- the device join's routing: outer joins and outputs over
  MAX_DEVICE_JOIN_CAP take the bucket path, whose packing is B7 too;
- a join over shards another coordinator hosts is refused, naming
  ROADMAP.md C21: the reference's join reads local placements only and
  loses the other host's rows without an error.
"""

import os
import sys

import numpy as np
import pytest
import torch

import citus_tpu as ct
import citus_tpu_torch as ctt
from citus_tpu_torch.errors import UnsupportedFeatureError
from citus_tpu_torch.executor import join_executor
from citus_tpu_torch.parallel.mesh import mesh_combine
from citus_tpu_torch.parallel.shuffle import (
    exchange_blocks, exchange_blocks_plain, pack_blocks, pack_blocks_plain,
    sorted_join, sorted_join_plain,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fill_device_join(cl):
    """tests/test_device_join.py's tables a and b (seed 11)."""
    cl.execute("""CREATE TABLE a (a_id bigint NOT NULL, a_k bigint,
        a_k2 bigint, a_v bigint)""")
    cl.execute("""CREATE TABLE b (b_id bigint NOT NULL, b_k bigint,
        b_k2 bigint, b_v bigint)""")
    cl.execute("SELECT create_distributed_table('a', 'a_id', 4)")
    cl.execute("SELECT create_distributed_table('b', 'b_id', 4)")
    rng = np.random.default_rng(11)
    na, nb = 3000, 5000
    cl.copy_from("a", columns={
        "a_id": np.arange(na), "a_k": rng.integers(0, 400, na),
        "a_k2": rng.integers(0, 3, na), "a_v": rng.integers(0, 100, na)})
    cl.copy_from("b", columns={
        "b_id": np.arange(nb), "b_k": rng.integers(0, 500, nb),
        "b_k2": rng.integers(0, 3, nb), "b_v": rng.integers(0, 100, nb)})


def _fill_repartition(cl):
    """tests/test_repartition_join.py's orders, lineitem and nation
    (seed 3), and its third distributed relation extra."""
    cl.execute("""CREATE TABLE orders (o_orderkey bigint NOT NULL,
        o_custkey bigint, o_flag bigint, o_tag text)""")
    cl.execute("""CREATE TABLE lineitem (l_linenumber bigint NOT NULL,
        l_orderkey bigint, l_qty bigint)""")
    cl.execute("CREATE TABLE nation (n_id bigint NOT NULL, n_name text)")
    cl.execute("SELECT create_distributed_table('orders', 'o_orderkey', 4)")
    cl.execute("SELECT create_distributed_table('lineitem', 'l_linenumber', "
               "4)")
    cl.execute("SELECT create_reference_table('nation')")
    rng = np.random.default_rng(3)
    n_o, n_l = 2000, 8000
    cl.copy_from("orders", columns={
        "o_orderkey": np.arange(n_o), "o_custkey": rng.integers(0, 200, n_o),
        "o_flag": rng.integers(0, 3, n_o),
        "o_tag": [f"t{i % 5}" for i in range(n_o)]})
    cl.copy_from("lineitem", columns={
        "l_linenumber": np.arange(n_l),
        "l_orderkey": rng.integers(0, n_o + 200, n_l),
        "l_qty": rng.integers(1, 50, n_l)})
    cl.copy_from("nation", columns={"n_id": np.arange(3),
                                    "n_name": ["aa", "bb", "cc"]})
    cl.execute("CREATE TABLE payments (p_orderkey bigint NOT NULL, "
               "p_amt bigint)")
    cl.execute("SELECT create_distributed_table('payments', 'p_orderkey', 4)")
    cl.copy_from("payments", columns={"p_orderkey": np.arange(500),
                                      "p_amt": np.ones(500, np.int64)})
    cl.execute("CREATE TABLE extra (e_id bigint NOT NULL, e_k bigint)")
    cl.execute("SELECT create_distributed_table('extra', 'e_id', 4)")
    cl.copy_from("extra", columns={"e_id": np.arange(100),
                                   "e_k": np.arange(100)})


QJOIN_ROWS = 40_000


def _fill_qjoin(cl):
    """bench.py's lineitem (seed 7) and orders_b (seed 11): every
    l_orderkey below QJOIN_ROWS // 4 has its order, a third of them
    flagged 'H'."""
    bench.ensure_data(cl, QJOIN_ROWS)
    bench.ensure_join_data(cl, QJOIN_ROWS // 4)


def _fill_tpch_refs(cl):
    """TPC-H's customer and nation as reference tables, orders and
    lineitem distributed and colocated on the order key (Q3 and Q10:
    BASELINE.json config 4)."""
    rng = np.random.default_rng(29)
    n_c, n_o, n_l = 300, 3000, 12_000
    cl.execute("CREATE TABLE nation (n_nationkey bigint NOT NULL, "
               "n_name text)")
    cl.execute("CREATE TABLE customer (c_custkey bigint NOT NULL, "
               "c_nationkey bigint, c_mktsegment text, c_acctbal "
               "decimal(12,2))")
    cl.execute("CREATE TABLE orders (o_orderkey bigint NOT NULL, o_custkey "
               "bigint, o_orderdate date, o_shippriority bigint)")
    cl.execute("CREATE TABLE lineitem (l_orderkey bigint NOT NULL, "
               "l_extendedprice decimal(12,2), l_discount decimal(12,2), "
               "l_returnflag text, l_shipdate date)")
    cl.execute("SELECT create_reference_table('nation')")
    cl.execute("SELECT create_reference_table('customer')")
    cl.execute("SELECT create_distributed_table('orders', 'o_orderkey', 4)")
    cl.execute("SELECT create_distributed_table('lineitem', 'l_orderkey', 4)")
    segs = np.array(["BUILDING", "AUTOMOBILE", "MACHINERY", "HOUSEHOLD"])
    cl.copy_from("nation", columns={
        "n_nationkey": np.arange(25),
        "n_name": [f"NATION{i:02d}" for i in range(25)]})
    cl.copy_from("customer", columns={
        "c_custkey": np.arange(n_c), "c_nationkey": rng.integers(0, 25, n_c),
        "c_mktsegment": segs[rng.integers(0, 4, n_c)].tolist(),
        "c_acctbal": rng.integers(-99_999, 999_999, n_c) / 100.0})
    day0 = 8035  # 1992-01-01
    cl.copy_from("orders", columns={
        "o_orderkey": np.arange(n_o), "o_custkey": rng.integers(0, n_c, n_o),
        "o_orderdate": (day0 + rng.integers(0, 2400, n_o)).astype(np.int32),
        "o_shippriority": rng.integers(0, 2, n_o)})
    flags = np.array(["A", "N", "R"])
    cl.copy_from("lineitem", columns={
        "l_orderkey": rng.integers(0, n_o, n_l),
        "l_extendedprice": rng.integers(90_000, 10_500_000, n_l) / 100.0,
        "l_discount": rng.integers(0, 11, n_l) / 100.0,
        "l_returnflag": flags[rng.integers(0, 3, n_l)].tolist(),
        "l_shipdate": (day0 + rng.integers(0, 2500, n_l)).astype(np.int32)})


FILLS = {"dj": _fill_device_join, "rj": _fill_repartition,
         "qjoin": _fill_qjoin, "tpch": _fill_tpch_refs}


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """{dataset: (reference cluster, port cluster)}, each pair over the
    same generated rows in its own data directories."""
    out = {}
    try:
        for name, fill in FILLS.items():
            ref = ct.Cluster(str(tmp_path_factory.mktemp(f"{name}_ref")))
            out[name] = (ref, None)
            port = ctt.Cluster(str(tmp_path_factory.mktemp(f"{name}_port")),
                               device="cpu")
            out[name] = (ref, port)
            fill(ref)
            fill(port)
        yield out
    finally:
        for ref, port in out.values():
            if port is not None:
                port.close()
            ref.close()


Q3 = """SELECT l.l_orderkey, sum(l.l_extendedprice * (1 - l.l_discount))
    AS revenue, o.o_orderdate, o.o_shippriority
FROM customer c JOIN orders o ON c.c_custkey = o.o_custkey
JOIN lineitem l ON l.l_orderkey = o.o_orderkey
WHERE c.c_mktsegment = 'BUILDING' AND o.o_orderdate < date '1995-03-15'
  AND l.l_shipdate > date '1995-03-15'
GROUP BY l.l_orderkey, o.o_orderdate, o.o_shippriority
ORDER BY revenue DESC, o.o_orderdate, l.l_orderkey LIMIT 10"""

Q10 = """SELECT c.c_custkey, n.n_name,
    sum(l.l_extendedprice * (1 - l.l_discount)) AS revenue, c.c_acctbal
FROM orders o JOIN lineitem l ON l.l_orderkey = o.o_orderkey
JOIN customer c ON c.c_custkey = o.o_custkey
JOIN nation n ON n.n_nationkey = c.c_nationkey
WHERE o.o_orderdate >= date '1993-10-01' AND o.o_orderdate < date '1994-01-01'
  AND l.l_returnflag = 'R'
GROUP BY c.c_custkey, n.n_name, c.c_acctbal
ORDER BY revenue DESC, c.c_custkey LIMIT 20"""

#: (dataset, id, sql)
QUERIES = [
    # tests/test_device_join.py
    ("dj", "many_to_many", "SELECT count(*), sum(a.a_v + b.b_v) FROM a "
     "JOIN b ON a.a_k = b.b_k"),
    ("dj", "multi_key", "SELECT count(*), sum(a.a_v) FROM a JOIN b "
     "ON a.a_k = b.b_k AND a.a_k2 = b.b_k2"),
    ("dj", "residual", "SELECT count(*) FROM a JOIN b ON a.a_k = b.b_k "
     "AND a.a_v < b.b_v"),
    ("dj", "projection_order", "SELECT a.a_id, b.b_id FROM a JOIN b "
     "ON a.a_k = b.b_k ORDER BY a.a_id, b.b_id LIMIT 50"),
    ("dj", "group_by_after_join", "SELECT a.a_k2, count(*), sum(b.b_v) "
     "FROM a JOIN b ON a.a_k = b.b_k GROUP BY a.a_k2 ORDER BY a.a_k2"),
    ("dj", "empty_side", "SELECT count(*) FROM a JOIN b ON a.a_k = b.b_k "
     "WHERE b.b_v < 0"),
    ("dj", "outer_bucket_path", "SELECT count(*), sum(a.a_v) FROM a "
     "LEFT JOIN b ON a.a_k = b.b_k"),
    ("dj", "projection_unordered", "SELECT a.a_id, b.b_v FROM a JOIN b "
     "ON a.a_k = b.b_k WHERE a.a_v < 3"),
    # tests/test_repartition_join.py
    ("rj", "q12_shape", "SELECT o.o_flag, count(*), sum(l.l_qty) "
     "FROM lineitem l JOIN orders o ON l.l_orderkey = o.o_orderkey "
     "WHERE l.l_qty < 40 GROUP BY o.o_flag ORDER BY o.o_flag"),
    ("rj", "projection_rows", "SELECT l.l_linenumber, o.o_custkey "
     "FROM lineitem l JOIN orders o ON l.l_orderkey = o.o_orderkey "
     "ORDER BY l.l_linenumber LIMIT 100"),
    ("rj", "left_outer", "SELECT count(*), sum(l.l_qty) FROM lineitem l "
     "LEFT JOIN orders o ON l.l_orderkey = o.o_orderkey"),
    ("rj", "reference_table", "SELECT n.n_name, count(*) FROM lineitem l "
     "JOIN orders o ON l.l_orderkey = o.o_orderkey "
     "JOIN nation n ON o.o_flag = n.n_id GROUP BY n.n_name ORDER BY n.n_name"),
    ("rj", "text_key", "SELECT count(*) FROM lineitem l JOIN orders o "
     "ON l.l_orderkey = o.o_orderkey WHERE o.o_tag = 't1'"),
    ("rj", "colocated", "SELECT count(*) FROM orders o JOIN payments p "
     "ON o.o_orderkey = p.p_orderkey"),
    ("rj", "three_rels_stepwise", "SELECT count(*) FROM lineitem l "
     "JOIN orders o ON l.l_orderkey = o.o_orderkey "
     "JOIN extra e ON e.e_k = l.l_qty"),
    ("rj", "text_output", "SELECT o.o_tag, count(*), sum(l.l_qty) "
     "FROM lineitem l JOIN orders o ON l.l_orderkey = o.o_orderkey "
     "GROUP BY o.o_tag ORDER BY o.o_tag"),
    # bench.py's QJOIN (BASELINE.json config 5) and its LEFT JOIN
    ("qjoin", "qjoin", bench.QJOIN),
    ("qjoin", "qjoin_left", "SELECT count(*), sum(l.l_quantity), "
     "count(o.o_orderkey), count(o.o_flag) FROM lineitem l "
     "LEFT JOIN orders_b o ON l.l_orderkey = o.o_orderkey"),
    # TPC-H Q3 and Q10 shapes (BASELINE.json config 4)
    ("tpch", "q3", Q3),
    ("tpch", "q10", Q10),
]


def _same_rows(got, want, ordered):
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert got == want


def _calls():
    return pack_blocks_plain.calls, sorted_join_plain.calls


def _backend(cl, backend):
    cl.execute(f"SET citus.task_executor_backend = '{backend}'")


@pytest.mark.parametrize("dataset,sql", [(d, s) for d, _, s in QUERIES],
                         ids=[i for _, i, _ in QUERIES])
def test_join_rows_identical_to_reference(clusters, dataset, sql):
    ref, port = clusters[dataset]
    ordered = "ORDER BY" in sql
    want = ref.execute(sql)
    c0 = _calls()
    got = port.execute(sql)
    c1 = _calls()
    _same_rows(got.rows, want.rows, ordered)
    assert got.explain["strategy"] == want.explain["strategy"]
    assert got.explain.get("shuffle") == want.explain.get("shuffle")
    # each device join step that had rows on both sides ran its two
    # packings and its join through the wrappers (their plain versions
    # on CPU tensors); the bucket path packed both sides of its steps
    steps = got.explain.get("device_join_steps", [])
    assert c1[1] - c0[1] == len(steps)
    if got.explain["strategy"] == "join:repartition":
        assert c1[0] - c0[0] >= 2 * len(steps) and c1[0] > c0[0] \
            or "devjoin" in got.explain["shuffle"] and not steps
    else:
        assert c1 == c0 and not steps
    assert pack_blocks.launches == sorted_join.launches == 0
    # the numpy cpu backend: host buckets, as the reference's oracle
    for cl in (ref, port):
        _backend(cl, "cpu")
    try:
        want_cpu, got_cpu = ref.execute(sql), port.execute(sql)
    finally:
        _backend(ref, "tpu")
        _backend(port, "gpu")
    _same_rows(got_cpu.rows, want.rows, ordered)
    assert got_cpu.explain["strategy"] == want_cpu.explain["strategy"]
    assert got_cpu.explain.get("shuffle") == want_cpu.explain.get("shuffle")


N_DEV = 8


@pytest.fixture(scope="module")
def mesh_ports(tmp_path_factory):
    """{dataset: port cluster on an 8-member CPU mesh}: the reference's
    device join runs over tests/conftest.py's 8 devices, the port's over
    8 members."""
    out = {}
    try:
        for name, fill in FILLS.items():
            out[name] = ctt.Cluster(
                str(tmp_path_factory.mktemp(f"{name}_mesh")), device="cpu",
                mesh_devices=["cpu"] * N_DEV)
            fill(out[name])
        yield out
    finally:
        for port in out.values():
            port.close()


@pytest.mark.parametrize("dataset,sql", [(d, s) for d, _, s in QUERIES],
                         ids=[i for _, i, _ in QUERIES])
def test_join_rows_over_8_members_identical_to_reference(clusters,
                                                         mesh_ports,
                                                         dataset, sql):
    """The same SQL through the reference's 8-device mesh and the port's
    8-member mesh: identical rows, strategy and shuffle (devjoin in
    both where the reference joins on its mesh).  Each device join step
    packs 2 x 8 times, exchanges twice and joins on each of the 8
    members; the bucket path packs and exchanges both sides."""
    ref, _ = clusters[dataset]
    port = mesh_ports[dataset]
    want = ref.execute(sql)
    c0 = _calls() + (exchange_blocks_plain.calls,)
    got = port.execute(sql)
    c1 = _calls() + (exchange_blocks_plain.calls,)
    _same_rows(got.rows, want.rows, "ORDER BY" in sql)
    assert got.explain["strategy"] == want.explain["strategy"]
    assert got.explain.get("shuffle") == want.explain.get("shuffle")
    steps = got.explain.get("device_join_steps", [])
    packs, joins, exchanges = (b - a for a, b in zip(c0, c1))
    assert joins == N_DEV * len(steps)
    if steps:
        assert "devjoin" in got.explain["shuffle"]
        assert packs >= 2 * N_DEV * len(steps) and exchanges >= 2 * len(steps)
    elif got.explain["strategy"] == "join:repartition" \
            and "devjoin" not in got.explain["shuffle"]:
        assert packs == 2 * N_DEV and exchanges == 2
    assert exchange_blocks.launches == mesh_combine.launches == 0


def test_pull_strategy_gives_the_same_rows(clusters):
    """With repartition joins off both packages pull, as the
    reference's tests check."""
    ref, port = clusters["rj"]
    sql = QUERIES[8][2]
    for cl in (ref, port):
        cl.execute("SET citus.enable_repartition_joins = off")
    try:
        want, got = ref.execute(sql), port.execute(sql)
    finally:
        for cl in (ref, port):
            cl.execute("SET citus.enable_repartition_joins = on")
    assert got.explain["strategy"] == want.explain["strategy"] == "join:pull"
    assert got.rows == want.rows
    assert got.rows == port.execute(sql).rows


def test_qjoin_explain_and_device_join_steps(clusters):
    """QJOIN at test scale: the o_flag filter is pushed into the
    orders_b scan, the one equi step joins on the device mesh, and the
    step's EXPLAIN entry carries its sizes and times."""
    _, port = clusters["qjoin"]
    r = port.execute(bench.QJOIN)
    assert r.explain["strategy"] == "join:repartition"
    assert r.explain["shuffle"] == "all_to_all+1-devjoin:1-step"
    (step,) = r.explain["device_join_steps"]
    assert step["rows_left"] == QJOIN_ROWS
    assert 0 < step["rows_right"] < QJOIN_ROWS // 4
    assert step["join_cap"] == r.rows[0][0]
    for k in ("gid_host_ms", "h2d_ms", "device_ms", "d2h_ms"):
        assert step[k] >= 0


def test_join_over_the_cap_takes_the_bucket_path(clusters, monkeypatch):
    """An output over MAX_DEVICE_JOIN_CAP goes to the bucket path (the
    reference's rule, kept): no sort join, both sides still packed by
    B7, the same rows."""
    ref, port = clusters["dj"]
    sql = QUERIES[0][2]
    want = ref.execute(sql).rows
    monkeypatch.setattr(join_executor, "MAX_DEVICE_JOIN_CAP", 64)
    c0 = _calls()
    r = port.execute(sql)
    c1 = _calls()
    assert r.rows == want
    assert r.explain["shuffle"] == "all_to_all:1-step"
    assert c1[1] == c0[1] and c1[0] - c0[0] == 2


def test_join_over_remote_hosted_shards_is_refused_naming_a13(tmp_path):
    """Two coordinators: a join whose relations have shards on the other
    one is refused, naming ROADMAP.md C21 (the reference answers it
    from the local placements only, next test)."""
    from test_torch_net import _open_pair
    a, b = _open_pair(tmp_path)
    try:
        _fill_device_join(a)
        with pytest.raises(UnsupportedFeatureError, match="C21"):
            a.execute(QUERIES[0][2])
    finally:
        b.close()
        a.close()


def test_c21_reference_join_over_remote_shards_loses_rows(tmp_path):
    """ROADMAP.md C21, a reference fault the port refuses: on a pair of
    citus_tpu coordinators a repartition join of two 4-shard tables,
    two shards on each, counts only the pairs of the rows on the
    coordinator that runs it, without an error."""
    from test_torch_net import _open_pair
    a, b = _open_pair(tmp_path, ct, ct)
    try:
        n = 400
        a.execute("CREATE TABLE o (ok bigint NOT NULL, ck bigint, v bigint)")
        a.execute("SELECT create_distributed_table('o', 'ok', 4)")
        a.execute("CREATE TABLE l (lk bigint NOT NULL, ok bigint, q bigint)")
        a.execute("SELECT create_distributed_table('l', 'lk', 4)")
        a.copy_from("o", columns={"ok": np.arange(n), "ck": np.arange(n) % 7,
                                  "v": np.arange(n)})
        a.copy_from("l", columns={"lk": np.arange(2 * n),
                                  "ok": np.arange(2 * n) % n,
                                  "q": np.ones(2 * n, np.int64)})
        assert a.execute("SELECT count(*) FROM l").rows == [(2 * n,)]
        r = a.execute("SELECT count(*) FROM o JOIN l ON o.ok = l.ok")
        assert 0 < r.rows[0][0] < 2 * n
    finally:
        b.close()
        a.close()


def test_reference_table_udf_replicates_one_shard(clusters):
    _, port = clusters["rj"]
    t = port.catalog.table("nation")
    assert t.is_reference and len(t.shards) == 1
    assert port.execute("SELECT count(*) FROM nation").rows == [(3,)]


# ------------------------------------------------- chip_smoke.py, rehearsed

import chip_smoke  # noqa: E402


@pytest.fixture()
def smoke_lineitem(tmp_path):
    """chip_smoke.py's lineitem (bench.py's generator) at 20,000 rows on
    the CPU: -> (cluster, generated columns, rows)."""
    n = 20_000
    cl = ctt.Cluster(str(tmp_path / "sf"), device="cpu")
    cl.execute(chip_smoke.LINEITEM_DDL)
    cl.execute("SELECT create_distributed_table('lineitem', 'l_orderkey', "
               f"{chip_smoke.SHARDS})")
    chunks = list(chip_smoke.lineitem_chunks(n))
    for c in chunks:
        cl.copy_from("lineitem", columns=chip_smoke.copy_columns(c))
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    yield cl, cols, n
    cl.close()


def test_chip_smoke_phase8_rehearses_on_cpu(smoke_lineitem, tmp_path,
                                            monkeypatch):
    """chip_smoke.py's phase 8 on the CPU at a small size: orders_b,
    QJOIN cold and warm through the device join, its LEFT JOIN through
    the bucket path, C1's five projections against numpy, the coalesced
    C1 family and the pushed projections between two coordinators."""
    monkeypatch.setattr(chip_smoke, "PAIR_C1_ROWS", 8000)
    cl, cols, n = smoke_lineitem
    launches = dict.fromkeys(chip_smoke.launch_counters(), 0)
    c0 = _calls()
    chip_smoke.run_join_phase(ctt, cl, cols, str(tmp_path), n, launches,
                              "cpu")
    c1 = _calls()
    assert all(v == 0 for v in launches.values())  # plain versions only
    assert c1[1] - c0[1] == 2                      # QJOIN cold and warm
    assert c1[0] - c0[0] == 6                      # and the LEFT JOIN


def test_chip_smoke_phase3_join_helpers_rehearse_on_cpu(tmp_path,
                                                        monkeypatch):
    """chip_smoke.py's phase-3 cases of partition_pack, sorted_join and
    the predicates over every C1 node at a small size on the CPU, timing
    stubbed out (CUDA events need a card): their inputs build, the
    plain versions agree with themselves, and the JSON rows carry every
    key."""
    monkeypatch.setattr(chip_smoke, "time_cuda", lambda fn, **kw: 0.0)
    monkeypatch.setattr(chip_smoke, "FOLD_N", 4096)
    dev = torch.device("cpu")
    rows: list = []
    sides = chip_smoke.qjoin_sides(20_000, dev)
    (lgid, _, cap_l), (rgid, _, cap_r), U = sides
    assert cap_l == 20_000 and cap_r == rgid.numel() and U <= 5000
    chip_smoke.phase3_partition_pack(dev, 20_000, rows, sides)
    chip_smoke.phase3_sorted_join(dev, rows, sides, n=1 << 14)
    plans = chip_smoke.smoke_plans(dev, str(tmp_path), n=4096)
    chip_smoke.phase3_filter(dev, plans, rows)
    chip_smoke.phase3_batched_filter(dev, plans, rows)
    assert [r["name"] for r in rows] == ["partition_pack", "sorted_join",
                                         "filter_mask",
                                         "filter_mask_batched"]
    for r in rows:
        assert r["bound_ms"] > 0 and r["route"] == "cuda"
    prog, params = plans["filters"]["c1_all"]
    args = chip_smoke.filter_call(prog, plans["events"], params, dev, 4096)
    from citus_tpu_torch.ops.filter_mask import filter_mask_plain
    kept = int(filter_mask_plain(prog, *args).sum())
    assert 0 < kept < 4096
    for kind in ("BExtract", "BCase", "BDictRemap", "BDictLookup",
                 "BMathFunc", "BDateTrunc", "BDateTruncCivil", "BAddMonths"):
        assert kind in repr(prog.expr)
