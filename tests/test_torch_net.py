"""Two coordinators of the port, and of the port with the JAX package:
the RPC and data planes (net/), the task codec and the pushed worker
tasks (executor/worker_tasks.py), held against citus_tpu.

- Frames: ``encode_frame``/``encode_batch``/``encode_partials``/
  ``encode_hash_partials`` and the sketch-word arrays are byte-identical
  in both packages for the same seeded arrays, and each package decodes
  the other's; RPC messages (with and without the HMAC secret and a
  binary attachment) are byte-identical, and a server of one package
  answers a client (blocking or event-loop) of the other.
- Tasks: ``encode_task`` gives identical JSON for Q1-, Q6-, hash-,
  projection- and S1-shaped plans, with and without parameters.
- A port pair (A the metadata authority hosting node 0, B attached and
  hosting node 1, both ``device="cpu"``): the reference's
  ``test_push_hash_partials_byte_identical_to_pull`` and
  ``test_task_version_2_peer_falls_back_to_pull``, pushed ``agg`` tasks
  with sketch registers and pushed ``projection`` tasks; pushed rows =
  pulled rows = the reference's single-coordinator rows.  DDL on A is
  seen by B through the invalidation and the metadata sync engine; rows
  copied in later are seen by warm pushed and pulled queries.
- Mixed pairs, both ways (a port A with a citus_tpu B, a citus_tpu A
  with a port B): the same rows — one data format, one catalog
  document, one wire.
- ``chip_smoke.py``'s phase 7 rehearsed on the CPU at a small size.

Every pair closes both coordinators in ``finally``; ports are
ephemeral (0).  Float aggregates within rel 1e-12, all else identical.
"""

import json
import os
import sys

import numpy as np
import pytest

import citus_tpu as ct
import torch

import citus_tpu_torch as ctt
from citus_tpu.executor.executor import encode_params as ref_encode_params
from citus_tpu.executor import worker_tasks as ref_wt
from citus_tpu.net import data_plane as ref_dp
from citus_tpu.net import rpc as ref_rpc
from citus_tpu.net.event_loop import RpcEventLoop as RefLoop
from citus_tpu.planner import parse_sql as ref_parse
from citus_tpu.planner.auto_param import auto_parameterize as ref_auto
from citus_tpu.planner.bind import bind_select as ref_bind
from citus_tpu.planner.physical import plan_select as ref_plan
from citus_tpu_torch.executor import worker_tasks as wt
from citus_tpu_torch.executor.device_cache import GLOBAL_CACHE
from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
from citus_tpu_torch.executor.executor import encode_params
from citus_tpu_torch.net import data_plane as dp
from citus_tpu_torch.net import rpc
from citus_tpu_torch.net.event_loop import RpcEventLoop
from citus_tpu_torch.ops.hash_agg_merge import hash_agg_merge
from citus_tpu_torch.planner import parse_sql
from citus_tpu_torch.planner.auto_param import auto_parameterize
from citus_tpu_torch.planner.bind import bind_select
from citus_tpu_torch.planner.physical import plan_select

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402
import chip_smoke  # noqa: E402
from test_torch_slice import _load_lineitem, assert_same_rows  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------- frames

def _arrays(seed: int) -> dict:
    """Every frame dtype, 0-d scalars, a 2-d array and an empty one."""
    rng = np.random.default_rng(seed)
    out = {}
    for code, dt in ref_dp._FRAME_DTYPES.items():
        n = int(rng.integers(4, 300))
        if dt == np.dtype(np.bool_):
            a = rng.integers(0, 2, n).astype(bool)
        elif dt.kind == "f":
            a = rng.standard_normal(n).astype(dt)
            a[:3] = [np.nan, -0.0, np.inf]
        else:
            info = np.iinfo(dt)
            a = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
        out[f"c{code}"] = a
    out["scalar_i"] = np.int64(-7)
    out["scalar_f"] = np.asarray(2.5)
    out["matrix"] = rng.integers(0, 9, (3, 128)).astype(np.int32)
    out["empty"] = np.zeros(0, np.float64)
    return out


def _assert_arrays_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_frames_byte_identical_and_cross_decode(seed):
    arrays = _arrays(seed)
    blob = dp.encode_frame(arrays)
    assert blob == ref_dp.encode_frame(arrays)
    _assert_arrays_equal(ref_dp.decode_frame(blob), arrays)
    _assert_arrays_equal(dp.decode_frame(ref_dp.encode_frame(arrays)), arrays)

    rng = np.random.default_rng(seed)
    values = {"a": rng.integers(0, 99, 50), "b": rng.standard_normal(50),
              "c": rng.integers(0, 5, 50).astype(np.int32)}
    validity = {c: rng.random(50) > 0.2 for c in values}
    for wire in ("frame", "npz"):
        ours = dp.encode_batch(values, validity, wire)
        theirs = ref_dp.encode_batch(values, validity, wire)
        if wire == "frame":
            assert ours == theirs
        for v, m in (dp.decode_batch(theirs), ref_dp.decode_batch(ours)):
            _assert_arrays_equal(v, values)
            _assert_arrays_equal(m, validity)

    partials = (np.int64(5), np.asarray(1.5), rng.integers(0, 9, 128)
                .astype(np.int32), rng.integers(0, 9, 2048))
    assert dp.encode_partials(partials) == ref_dp.encode_partials(partials)
    for got in (dp.decode_partials(ref_dp.encode_partials(partials)),
                ref_dp.decode_partials(dp.encode_partials(partials))):
        assert len(got) == len(partials)
        for g, w in zip(got, partials):
            assert np.asarray(g).tobytes() == np.asarray(w).tobytes()

    S = 64
    table = ([(rng.integers(-9, 9, S), rng.integers(0, 3, S).astype(np.int8)),
              (rng.standard_normal(S), rng.integers(0, 3, S).astype(np.int8))],
             (rng.integers(0, 9, S), rng.standard_normal(S)),
             rng.integers(0, 4, S))
    spilled = ([(rng.integers(-9, 9, 5), np.full(5, 2, np.int8)),
                (rng.standard_normal(5), np.full(5, 2, np.int8))],
               (rng.integers(0, 9, 5), rng.standard_normal(5)),
               np.ones(5, np.int64))
    for t, sp in ((table, spilled), (table, None), (None, spilled),
                  (None, None)):
        blob = dp.encode_hash_partials(t, sp)
        assert blob == ref_dp.encode_hash_partials(t, sp)
        for got, want in zip(ref_dp.decode_hash_partials(blob), (t, sp)):
            if want is None:
                assert got is None
                continue
            for (gv, gf), (wv, wf) in zip(got[0], want[0]):
                assert gv.tobytes() == np.asarray(wv).tobytes()
                assert gf.tobytes() == np.asarray(wf, np.int8).tobytes()
            assert [p.tobytes() for p in got[1]] \
                == [np.asarray(p).tobytes() for p in want[1]]
            assert got[2].tobytes() == np.asarray(want[2], np.int64).tobytes()

    words = ["hll:1:QUJD", None, "ddsk:1:", "topk:1:eHl6"]
    ours = dp.sketch_words_to_arrays("s", words)
    _assert_arrays_equal(ours, ref_dp.sketch_words_to_arrays("s", words))
    assert ref_dp.arrays_to_sketch_words(ours, "s") == words
    assert dp.arrays_to_sketch_words(ours, "s") == words


@pytest.mark.parametrize("secret", [None, b"pg_dist_authinfo"])
def test_rpc_messages_identical_and_servers_interoperate(secret):
    msg = {"id": 3, "method": "m", "payload": {"x": [1, 2.5, "y"]}}
    for blob in (None, b"\x00\x01binary"):
        assert rpc.encode_message(msg, secret, blob) \
            == ref_rpc.encode_message(msg, secret, blob)
    pairs = [(rpc.RpcServer, ref_rpc.RpcClient, RefLoop),
             (ref_rpc.RpcServer, rpc.RpcClient, RpcEventLoop)]
    for server_cls, client_cls, loop_cls in pairs:
        srv = server_cls(port=0, secret=secret)
        srv.register("echo", lambda p, b=None: ({"got": p}, (b or b"") + b"!"))
        srv.start()
        cl = loop = None
        try:
            cl = client_cls("127.0.0.1", srv.port, secret=secret)
            r, b = cl.call_binary("echo", {"k": 1}, blob=b"abc")
            assert r == {"got": {"k": 1}} and b == b"abc!"
            loop = loop_cls(secret=secret)
            r, b = loop.submit(("127.0.0.1", srv.port), "echo",
                               {"k": 2}).result(timeout=10)
            assert r == {"got": {"k": 2}} and b == b"!"
            if secret is not None:
                bad = client_cls("127.0.0.1", srv.port, secret=b"wrong")
                try:
                    with pytest.raises((rpc.RpcError, ref_rpc.RpcError)):
                        bad.call("echo", {})
                finally:
                    bad.close()
        finally:
            if loop is not None:
                loop.close()
            if cl is not None:
                cl.close()
            srv.stop()


# --------------------------------------------------------- task codec

HASH_SQL = "SELECT l_extendedprice, count(*), sum(l_quantity), " \
           "min(l_tax) FROM lineitem GROUP BY l_extendedprice"
PROJ_SQL = "SELECT l_orderkey, l_quantity FROM lineitem " \
           "WHERE l_quantity > 30 AND l_returnflag = 'R' LIMIT 40"


@pytest.fixture(scope="module")
def codec_dirs(tmp_path_factory):
    """Data directories written by citus_tpu: bench.py's lineitem and
    phase 4's sketch table."""
    d1 = str(tmp_path_factory.mktemp("codec_li"))
    d2 = str(tmp_path_factory.mktemp("codec_sk"))
    ref = ct.Cluster(d1)
    try:
        _load_lineitem(ref, 2000)
    finally:
        ref.close()
    ref = ct.Cluster(d2)
    try:
        ref.execute(chip_smoke.S_DDL)
        ref.execute("SELECT create_distributed_table('lineitem', "
                    "'l_suppkey', 4)")
        ref.copy_from("lineitem", columns=chip_smoke.sketch_copy_columns(
            next(chip_smoke.sketch_chunks(3000, 3, 3000))))
    finally:
        ref.close()
    return d1, d2


def _tasks(d, sql, auto: bool):
    """encode_task of one SQL in each package over the same catalog."""
    ref = ct.Cluster(d)
    port = ctt.Cluster(d, device="cpu")
    try:
        out = []
        for cl, parse, bind, aparam, plan_fn, enc_params, codec in (
                (ref, ref_parse, ref_bind, ref_auto, ref_plan,
                 ref_encode_params, ref_wt),
                (port, parse_sql, bind_select, auto_parameterize, plan_select,
                 encode_params, wt)):
            bound = bind(cl.catalog, parse(sql)[0])
            values = None
            if auto:
                ap = aparam(bound)
                if ap is not None:
                    bound, values = ap
            plan = plan_fn(cl.catalog, bound,
                           direct_limit=cl.settings.planner.direct_gid_limit)
            task = codec.encode_task(plan, enc_params(cl.catalog, bound,
                                                      values))
            out.append((plan.group_mode.kind if bound.has_aggs
                        else "projection", task))
        return out
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("auto", [False, True])
@pytest.mark.parametrize("shape", ["q1", "q6", "hash", "projection", "s1"])
def test_encode_task_json_identical(codec_dirs, shape, auto):
    sql, d = {"q1": (bench.Q1, 0), "q6": (bench.Q6, 0),
              "hash": (HASH_SQL, 0), "projection": (PROJ_SQL, 0),
              "s1": (chip_smoke.S1, 1)}[shape]
    (rmode, rtask), (pmode, ptask) = _tasks(codec_dirs[d], sql, auto)
    assert rmode == pmode
    assert ptask is not None and rtask is not None
    assert json.dumps(ptask, sort_keys=True) == json.dumps(rtask, sort_keys=True)
    assert ptask["v"] == wt.TASK_VERSION == 3
    assert ptask["kind"] == {"q1": "agg", "q6": "agg", "hash": "hash",
                             "projection": "projection", "s1": "agg"}[shape]


# ------------------------------------------------------------ the pairs

def _make(pkg, d, **kw):
    if pkg is ctt:
        kw["device"] = "cpu"
    return pkg.Cluster(d, **kw)


def _open_pair(tmp_path, a_pkg=ctt, b_pkg=ctt):
    """A: metadata authority hosting node 0; B: attached, hosting node 1."""
    a = _make(a_pkg, str(tmp_path / "a"), serve_port=0, data_port=0,
              hosted_nodes=set(), n_nodes=0)
    b = None
    try:
        a.register_node()
        b = _make(b_pkg, str(tmp_path / "b"), data_port=0, hosted_nodes=set(),
                  coordinator=("127.0.0.1", a.control_port), n_nodes=0)
        b.register_node()
        a._maybe_reload_catalog(force_sync=True)
    except BaseException:
        if b is not None:
            b.close()
        a.close()
        raise
    return a, b


@pytest.fixture()
def pair(tmp_path):
    a, b = _open_pair(tmp_path)
    try:
        yield a, b
    finally:
        b.close()
        a.close()


N = 12_000


def _columns(n=N, seed=5, groups=1500):
    rng = np.random.default_rng(seed)
    return {"k": np.arange(n, dtype=np.int64),
            "g": rng.integers(0, 10**12, groups)[rng.integers(0, groups, n)],
            "v": rng.integers(0, 1000, n),
            "f": rng.standard_normal(n),
            "c": [f"w{i % 7}" for i in range(n)]}


def _load(cl, cols, peer=None):
    """Create and fill t through ``cl``.  A ``peer`` (a citus_tpu node,
    whose COPY ingest can outrun the DDL's invalidation, ROADMAP.md C)
    reloads its catalog before the COPY."""
    cl.execute("CREATE TABLE t (k bigint NOT NULL, g bigint, v bigint, "
               "f double, c text)")
    cl.execute("SELECT create_distributed_table('t', 'k', 4)")
    if peer is not None:
        peer._reload_catalog()
    cl.copy_from("t", columns=cols)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The reference's single-coordinator rows of every query below."""
    ref = ct.Cluster(str(tmp_path_factory.mktemp("single")))
    try:
        _load(ref, _columns())
        yield {sql: ref.execute(sql).rows for sql in QUERIES}
    finally:
        ref.close()


HASH_Q = "SELECT g, count(*), sum(v), min(v), max(v) FROM t GROUP BY g ORDER BY g"
AGG_Q = ("SELECT count(*), sum(v), approx_count_distinct(g), "
         "approx_percentile(0.5) WITHIN GROUP (ORDER BY f), "
         "approx_top_k(v, 3) FROM t WHERE v < 900")
PROJ_Q = "SELECT k, v, c FROM t WHERE v < 25 AND c <> 'w3' ORDER BY k"
FLOAT_Q = "SELECT g, sum(f), min(f) FROM t GROUP BY g ORDER BY g"
QUERIES = (HASH_Q, AGG_Q, PROJ_Q, FLOAT_Q)


def _run(a, sql, mode):
    a.execute(f"SET citus.remote_task_execution = {mode}")
    GLOBAL_CACHE.clear()
    c0 = GLOBAL_COUNTERS.snapshot()
    rows = a.execute(sql).rows
    c1 = GLOBAL_COUNTERS.snapshot()
    return rows, {k: c1.get(k, 0) - c0.get(k, 0) for k in c1}


def _remote_shards(a, table="t"):
    t = a.catalog.table(table)
    return sum(a.catalog.is_remote_node(s.placements[0]) for s in t.shards)


def test_push_hash_partials_byte_identical_to_pull(pair, single):
    """A hash GROUP BY ships the peer's hash tables (TASK_VERSION 3 hash
    tasks) and merges each through hash_agg_merge: pushes rise, no
    fallback, no placement sync; the rows are the pull path's and the
    single reference coordinator's."""
    a, b = pair
    _load(a, _columns())
    n_remote = _remote_shards(a)
    assert n_remote == 2
    launches = hash_agg_merge.launches
    pushed, d = _run(a, HASH_Q, "auto")
    assert d["remote_tasks_pushed"] == n_remote
    assert d["remote_task_fallbacks"] == 0
    assert d["hash_partials_pushed"] == n_remote
    assert d.get("placement_sync_bytes", 0) == 0
    # on the CPU the wrapper runs its plain version: no kernel launch
    assert hash_agg_merge.launches == launches
    pulled, d = _run(a, HASH_Q, "pull")
    assert d["remote_tasks_pushed"] == 0 and d["hash_partials_pushed"] == 0
    assert d["placement_sync_bytes"] > 0
    assert pushed == pulled == single[HASH_Q]


def test_task_version_2_peer_falls_back_to_pull(pair, monkeypatch):
    """A peer refuses a task of another TASK_VERSION; the coordinator
    counts the fallback and scans the shard through the pull path."""
    a, b = pair
    cols = _columns()
    _load(a, cols)
    real = wt.encode_task

    def stale(plan, params=((), ())):
        t = real(plan, params)
        return dict(t, v=2) if t is not None else None
    monkeypatch.setattr(wt, "encode_task", stale)
    rows, d = _run(a, "SELECT g, count(*), sum(v) FROM t GROUP BY g", "auto")
    assert d["remote_task_fallbacks"] == 2
    assert d["hash_partials_pushed"] == 0
    truth = {}
    for g, v in zip(cols["g"].tolist(), cols["v"].tolist()):
        c, s = truth.get(g, (0, 0))
        truth[g] = (c + 1, s + v)
    assert sorted(rows) == sorted((g, c, s) for g, (c, s) in truth.items())


@pytest.mark.parametrize("sql", [AGG_Q, PROJ_Q, FLOAT_Q],
                         ids=["agg_sketch", "projection", "float_hash"])
def test_pushed_tasks_equal_pulled_and_single(pair, single, sql):
    a, b = pair
    _load(a, _columns())
    pushed, d = _run(a, sql, "auto")
    assert d["remote_tasks_pushed"] == 2 and d["remote_task_fallbacks"] == 0
    pulled, d = _run(a, sql, "pull")
    assert d["remote_tasks_pushed"] == 0
    assert_same_rows(pushed, single[sql])
    assert_same_rows(pulled, single[sql])


def test_ddl_on_a_is_seen_by_b_through_the_invalidation(pair):
    """B plans against A's DDL: the catalog_changed push marks it stale,
    and its next statement pulls the divergent objects (metadata sync)."""
    a, b = pair
    _load(a, _columns(n=400))
    c0 = GLOBAL_COUNTERS.snapshot()
    a.execute("CREATE TABLE u (k bigint NOT NULL, w bigint)")
    a.execute("SELECT create_distributed_table('u', 'k', 2)")
    a.copy_from("u", columns={"k": np.arange(50), "w": np.arange(50) * 2})
    assert b.execute("SELECT count(*), sum(w) FROM u").rows == [(50, 2450)]
    c1 = GLOBAL_COUNTERS.snapshot()
    assert c1["metadata_stale_reads"] > c0.get("metadata_stale_reads", 0)
    assert c1["metadata_sync_rounds"] > c0.get("metadata_sync_rounds", 0)
    # B's own DDL reaches A the same way (through the authority's lease)
    b.execute("CREATE TABLE w (k bigint NOT NULL)")
    a._maybe_reload_catalog(force_sync=True)
    assert a.catalog.has_table("w")


def test_copy_reaches_peer_before_its_invalidation(pair):
    """A COPY's batch for B can arrive before the catalog_changed push of
    the DDL just before it (two sockets): B's ingest then fetches the
    catalog itself.  Here B never sees the push."""
    a, b = pair
    # B drops every invalidation: its dirty flag reads False, writes vanish
    b.__class__ = type("DeafCluster", (type(b),), {"_catalog_dirty": property(
        lambda self: False, lambda self, value: None)})
    cols = _columns(n=2000)
    _load(a, cols)
    assert b.catalog.has_table("t")
    assert a.execute("SELECT count(*), sum(v) FROM t").rows == \
        [(2000, int(cols["v"].sum()))]


def test_warm_queries_see_rows_copied_later(pair):
    """After more rows are copied through A (part of them to B's shards),
    warm pushed and pulled queries see them: B's device cache is keyed
    by its table version, A's placement mirrors expire on data_changed."""
    a, b = pair
    cols = _columns(n=6000)
    _load(a, cols)
    sql = "SELECT count(*), sum(v) FROM t"
    for mode in ("auto", "pull"):
        a.execute(f"SET citus.remote_task_execution = {mode}")
        assert a.execute(sql).rows == [(6000, int(cols["v"].sum()))]
    more = _columns(n=3000, seed=9)
    more["k"] = more["k"] + 6000
    a.copy_from("t", columns=more)
    want = [(9000, int(cols["v"].sum() + more["v"].sum()))]
    for mode in ("auto", "pull", "auto"):
        a.execute(f"SET citus.remote_task_execution = {mode}")
        assert a.execute(sql).rows == want  # warm: no cache clear
    h = a.execute("SELECT g, count(*) FROM t GROUP BY g").rows
    assert sum(c for _g, c in h) == 9000


@pytest.mark.parametrize("a_pkg,b_pkg", [(ctt, ct), (ct, ctt)],
                         ids=["port_a_ref_b", "ref_a_port_b"])
def test_mixed_pair_gives_the_single_reference_rows(tmp_path, single,
                                                    a_pkg, b_pkg):
    """A port node and a citus_tpu node in one cluster: catalog, stripes,
    frames and tasks are shared, so pushed and pulled rows equal the
    single reference coordinator's."""
    a, b = _open_pair(tmp_path, a_pkg, b_pkg)
    try:
        _load(a, _columns(), peer=b if b_pkg is ct else None)
        for sql in QUERIES:
            for mode in ("auto", "pull"):
                a.execute(f"SET citus.remote_task_execution = {mode}")
                assert_same_rows(a.execute(sql).rows, single[sql])
        # the pushes happened: the peer ran the worker half
        counters = GLOBAL_COUNTERS if a_pkg is ctt else \
            __import__("citus_tpu.executor.executor",
                       fromlist=["GLOBAL_COUNTERS"]).GLOBAL_COUNTERS
        assert counters.snapshot()["remote_tasks_pushed"] > 0
    finally:
        b.close()
        a.close()


def test_cross_host_dml_raises_with_its_roadmap_item(pair, tmp_path):
    """Cross-host DML, and the statements that would read or move only
    the local placements of a table another coordinator hosts shards of
    (COPY TO, the redistributions: ROADMAP.md C18), raise naming A13
    and leave the table and the file system as they were."""
    a, b = pair
    _load(a, _columns(n=200))
    from citus_tpu_torch.errors import UnsupportedFeatureError
    out = tmp_path / "t.out"
    for sql in ("DELETE FROM t WHERE k = 1", "UPDATE t SET v = 0",
                "TRUNCATE t", "MERGE INTO t USING t s ON t.k = s.k "
                "WHEN MATCHED THEN DELETE",
                f"COPY t TO '{out}'",
                f"COPY t TO '{out}' WITH (format binary)",
                "SELECT alter_distributed_table('t', 8)",
                "SELECT alter_distributed_table('t', 4, 'g')",
                "SELECT undistribute_table('t')"):
        with pytest.raises(UnsupportedFeatureError, match="A13"):
            a.execute(sql)
    assert not out.exists()
    assert a.execute("SELECT count(*), sum(v) FROM t").rows == [
        (200, int(_columns(n=200)["v"].sum()))]
    assert len(a.catalog.table("t").shards) == 4
    with pytest.raises(rpc.RpcError, match="A13"):
        a.catalog.remote_data.call(a.catalog.node_endpoint(1),
                                   "execute_sql", {"sql": "SELECT 1"})


def test_c18_reference_export_and_redistribution_drop_remote_rows(
        tmp_path):
    """ROADMAP.md C18, a reference fault the port refuses: on a pair of
    citus_tpu coordinators, COPY TO writes only the rows of the local
    placements and alter_distributed_table re-ingests only those, so
    rows are lost without an error."""
    a, b = _open_pair(tmp_path, ct, ct)
    try:
        _load(a, _columns(n=200), peer=b)
        assert a.execute("SELECT count(*) FROM t").rows == [(200,)]
        a.execute(f"COPY t TO '{tmp_path / 't.csv'}'")
        with open(tmp_path / "t.csv") as fh:
            assert 0 < sum(1 for _ in fh) < 200
        a.execute("SELECT alter_distributed_table('t', 8)")
        b._reload_catalog()
        assert a.execute("SELECT count(*) FROM t").rows[0][0] < 200
    finally:
        b.close()
        a.close()


def test_insert_select_into_remote_shards_raises_with_its_roadmap_item(
        pair):
    """INSERT ... SELECT into a table with shards another coordinator
    hosts is refused naming ROADMAP.md A13 (its array path writes local
    placements only; the pull path's routing is not ported for it)."""
    a, b = pair
    _load(a, _columns(n=200))
    from citus_tpu_torch.errors import UnsupportedFeatureError
    for sql in ("INSERT INTO t SELECT * FROM t WHERE k < 10",
                "INSERT INTO t (k, v) SELECT k, count(*) FROM t GROUP BY k"):
        with pytest.raises(UnsupportedFeatureError, match="A13"):
            a.execute(sql)


def test_chip_smoke_phase7_rehearses_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phase 7 on the CPU at a small size: the pair, the
    load through A, R1/S1/R3 pushed and pulled against the numpy
    oracle, the extra COPY and the warm reruns."""
    monkeypatch.setattr(chip_smoke, "PAIR_DELTA_ROWS", 4000)
    launches = dict.fromkeys(chip_smoke.launch_counters(), 0)
    launches["scan_agg_fold[sketch]"] = 0
    chip_smoke.run_pair_phase(ctt, str(tmp_path), 20_000, launches, "cpu",
                              device="cpu")
    assert all(v == 0 for v in launches.values())  # plain versions only


def test_cte_intermediate_distributes_over_both_coordinators(pair):
    """An intermediate result of 4,096 rows or more is hash-distributed
    over every active node, as the reference does it: its COPY ships the
    rows of B's shards to B, the CTE's body pushes its tasks there, and
    the table is gone from both catalogs after the statement."""
    a, b = pair
    cols = _columns()
    _load(a, cols)
    sql = ("WITH big AS (SELECT k, v FROM t WHERE v < 900) "
           "SELECT count(*), sum(v) FROM big")
    rows, d = _run(a, sql, "auto")
    keep = cols["v"] < 900
    assert rows == [(int(keep.sum()), int(cols["v"][keep].sum()))]
    assert d["rows_ingested_remote"] > 0
    assert d["remote_tasks_pushed"] >= 2 and d["remote_task_fallbacks"] == 0
    b._reload_catalog()
    for cl in (a, b):
        assert not [n for n in cl.catalog.tables if n.startswith("__")]
