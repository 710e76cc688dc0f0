"""The port's mesh (B6 and the mesh branch of the executor), held against
the JAX package at tests/conftest.py's 8 virtual devices.

- ``mesh_combine_plain`` (``citus_tpu_torch/parallel/mesh.py``) against
  the reference's ``sharded_partial_agg`` on the same numpy-made stacked
  partials: every combine kind (sum, min, max, none) and register dtype
  (int64, float64, int32 HLL registers, float32), 0-d and vector registers, with
  NaN, +-inf sentinels, +-0.0 and a member that saw no row.  Integers
  and min/max are identical (the sign of a zero too); float sums agree
  within rel 1e-12: the port adds in member order, XLA's psum in its
  own.
- The SQL of ``__graft_entry__.py dryrun_multichip`` and TPC-H Q1/Q6
  through ``citus_tpu.Cluster`` (its mesh path over 8 devices) and
  ``citus_tpu_torch.Cluster(device="cpu", mesh_devices=["cpu"] * 8)``:
  direct-mode GROUP BY, stddev, approx_percentile,
  approx_count_distinct, a parameterised router query, min/max over
  NaN-holding floats; 13 shards, so the last round is partial.  Both
  sides' traces show the mesh rounds (``device_round`` spans of a
  round's batches), or the single stream where there is one batch.
- The port's mesh cache entry (warm runs read no disk), its exact
  device-memory accounting, and streaming past the cache.
"""

import decimal

import numpy as np
import pytest
import torch

import citus_tpu as ct
import jax.numpy as jnp  # noqa: F401  (citus_tpu first: x64 on)
import citus_tpu_torch as ctt
from citus_tpu.observability import trace as ref_trace
from citus_tpu.parallel.mesh import default_mesh as ref_default_mesh
from citus_tpu.parallel.mesh import sharded_partial_agg as ref_sharded
from citus_tpu_torch.cluster import resolve_mesh
from citus_tpu.executor.device_cache import GLOBAL_CACHE as REF_CACHE
from citus_tpu_torch.executor.device_cache import GLOBAL_CACHE
from citus_tpu_torch.observability import trace as port_trace
from citus_tpu_torch.parallel import mesh as pmesh
from citus_tpu_torch.parallel.mesh import (
    DeviceMesh, mesh_combine, mesh_combine_plain, sharded_partial_agg,
)

N_DEV = 8
I64 = np.iinfo(np.int64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ B6 plain


def _members(kind, dtype, shape, seed):
    """[N_DEV, *shape] partials of one position: random values, NaN,
    +-inf, +-0.0 where the dtype has them, and member 5 as one that saw
    no row (the fold's seeds: 0 for sums, the +-inf / int extremes for
    min / max)."""
    rng = np.random.default_rng(seed)
    full = (N_DEV,) + shape
    if dtype in (np.float64, np.float32):
        a = rng.normal(0, 1e3, full).astype(dtype)
        flat = a.reshape(N_DEV, -1)
        k = flat.shape[1]
        if k >= 8:
            flat[0, 0] = np.nan                  # one member NaN
            flat[:, 1] = np.nan                  # every member NaN
            flat[:, 2] = -0.0                    # all -0.0
            flat[:4, 3], flat[4:, 3] = 0.0, -0.0  # +0.0 then -0.0
            flat[:4, 4], flat[4:, 4] = -0.0, 0.0  # -0.0 then +0.0
            flat[2, 5] = np.inf
            flat[3, 6] = -np.inf
            flat[6, 7] = 1e300
        elif k >= 1:
            flat[1, 0] = -0.0
            flat[2, 0] = 0.0
    else:
        a = rng.integers(-1000, 1000, full).astype(dtype)
        if kind == "sum" and dtype == np.int64:
            a.reshape(N_DEV, -1)[:, 0] = I64.max // 3   # wraps, as psum does
    empty = {"sum": 0, "none": 0,
             "min": np.inf if a.dtype.kind == "f" else np.iinfo(dtype).max,
             "max": -np.inf if a.dtype.kind == "f" else np.iinfo(dtype).min}
    a[5] = empty[kind]
    if dtype == np.int32 and kind == "max":           # HLL registers
        a = np.abs(a) % 40
        a[5] = 0
    return a


COMBINE_CASES = [
    # (kind, dtype, register shape)
    ("sum", np.int64, (12,)),
    ("sum", np.int64, ()),
    ("sum", np.float64, (12,)),
    ("sum", np.float64, ()),
    ("sum", np.int64, (2048,)),        # DDSketch buckets
    ("min", np.int64, (12,)),
    ("min", np.float64, (12,)),
    ("min", np.float64, ()),
    ("max", np.int64, (12,)),
    ("max", np.float64, (12,)),
    ("max", np.float64, ()),
    ("max", np.int32, (128,)),         # HLL registers
    ("max", np.int64, (64,)),          # top-k values
    ("min", np.float32, (12,)),        # min/max of a real column
    ("max", np.float32, ()),
    ("sum", np.int32, (12,)),
    ("none", np.float64, (12,)),
    ("none", np.int64, ()),
]


def _ref_combine(kinds, stacks):
    """The reference's sharded_partial_agg of an identity worker over
    the stacked partials: its psum / all_gather + min / max."""
    def worker(cols, valids, row_mask):
        return cols
    run = ref_sharded(worker, list(kinds), ref_default_mesh())
    dummy = np.zeros((N_DEV, 1), bool)
    return [np.asarray(o) for o in run(tuple(stacks), (dummy,), dummy)]


def _assert_combined(kind, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    if kind == "none":
        want = want.reshape(got.shape)
    assert got.shape == want.shape
    if got.dtype.kind != "f":
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if kind == "sum":
        # summation order: the port adds in member order
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
        ok = ~np.isnan(got)
        np.testing.assert_array_equal(np.signbit(got[ok]), np.signbit(want[ok]))


@pytest.mark.parametrize("kind,dtype,shape", COMBINE_CASES,
                         ids=[f"{k}-{np.dtype(d).name}-{len(s) and s[0]}"
                              for k, d, s in COMBINE_CASES])
def test_combine_plain_matches_reference_sharded_partial_agg(kind, dtype,
                                                             shape):
    stack = _members(kind, dtype, shape, seed=len(shape) * 7 + len(kind))
    (want,) = _ref_combine([kind], [stack])
    (got,) = mesh_combine_plain(
        [kind], [(torch.from_numpy(np.array(stack[m])),) for m in range(N_DEV)])
    _assert_combined(kind, got.numpy(), want)


def test_combine_of_every_position_at_once_matches_reference():
    """Q1's layout: 12 groups, sums, counts, min, max, the row counts;
    one call combines every position, and the wrapper on CPU tensors is
    the plain version (no launch)."""
    kinds = ["sum"] * 8 + ["min", "max", "min", "max", "sum"]
    dtypes = [np.int64, np.float64] * 4 + [np.int64, np.int64, np.float64,
                                           np.float64, np.int64]
    stacks = [_members(k, d, (12,), seed=i)
              for i, (k, d) in enumerate(zip(kinds, dtypes))]
    want = _ref_combine(kinds, stacks)
    members = [tuple(torch.from_numpy(np.array(s[m])) for s in stacks)
               for m in range(N_DEV)]
    pmesh.mesh_combine.launches = 0
    got = mesh_combine(kinds, members)
    plain = mesh_combine_plain(kinds, members)
    assert pmesh.mesh_combine.launches == 0
    for k, g, p, w in zip(kinds, got, plain, want):
        assert torch.equal(g.nan_to_num(), p.nan_to_num())
        _assert_combined(k, g.numpy(), w)


def _layout_case(n):
    """Q1's positions and a sketch's, a none position, and registers
    whose ends are off the 16-byte vectors: (kinds, [member registers])
    of n members, numpy-made."""
    shapes = [((12,), np.int64, "sum"), ((12,), np.float64, "sum"),
              ((), np.int64, "sum"), ((13,), np.float64, "min"),
              ((7,), np.int32, "max"), ((128,), np.int32, "max"),
              ((3,), np.float32, "min"), ((5,), np.int64, "none"),
              ((), np.float64, "max"), ((2048,), np.int64, "sum")]
    kinds = [k for _, _, k in shapes]
    stacks = [_members(k, d, shp, seed=i)[:n]
              for i, (shp, d, k) in enumerate(shapes)]
    return kinds, stacks


def test_register_layout_is_one_allocation_a_member():
    """Each position a view of one member's arena at a 16-byte aligned
    offset; the output one allocation, a none position [n, ...] in it;
    packed seeds, views and host outputs agree."""
    kinds, stacks = _layout_case(N_DEV)
    regs = [tuple(torch.from_numpy(np.array(s[m])) for s in stacks)
            for m in range(N_DEV)]
    layout = pmesh.RegisterLayout(kinds, [r.dtype for r in regs[0]],
                                  [r.shape for r in regs[0]], N_DEV)
    assert all(o % 16 == 0 for o in layout.in_offsets + layout.out_offsets)
    arena = torch.from_numpy(layout.pack([r.numpy() for r in regs[0]]))
    assert arena.dtype == torch.uint8 and arena.shape == (layout.nbytes,)
    base = arena.data_ptr()
    for v, r, o in zip(layout.views(arena), regs[0], layout.in_offsets):
        assert v.data_ptr() == base + o and v.shape == r.shape
        assert torch.equal(v.nan_to_num(), r.nan_to_num())
    out = torch.zeros(layout.out_nbytes, dtype=torch.uint8)
    views = layout.out_views(out)
    assert views[kinds.index("none")].shape == (N_DEV, 5)
    for v in views:
        v.fill_(3)
    for h, v in zip(layout.host_outputs(out.numpy()), views):
        assert h.shape == tuple(v.shape) and (h == 3).all()
        assert np.shares_memory(h, out.numpy())


def test_combine_of_arenas_matches_reference():
    """``mesh_combine_arenas`` over 8 members' arenas on the CPU: every
    position as the reference's sharded_partial_agg gives it, the output
    one allocation split by the layout."""
    kinds, stacks = _layout_case(N_DEV)
    want = _ref_combine(kinds, stacks)
    regs = [tuple(torch.from_numpy(np.array(s[m])) for s in stacks)
            for m in range(N_DEV)]
    layout = pmesh.RegisterLayout(kinds, [r.dtype for r in regs[0]],
                                  [r.shape for r in regs[0]], N_DEV)
    arenas = [torch.from_numpy(layout.pack([r.numpy() for r in m]))
              for m in regs]
    out = pmesh.mesh_combine_arenas(layout, arenas)
    assert out.shape == (layout.out_nbytes,)
    for k, g, w in zip(kinds, layout.host_outputs(out.numpy()), want):
        _assert_combined(k, g, w)


def test_general_layouts_are_cached_by_register_shapes():
    """``mesh_combine``'s layout is built once per kinds, members and
    register shapes; more positions than the old 24 a launch fit one
    parameter block, and a block too large for one launch is refused."""
    kinds = ["sum"] * 48
    regs = [tuple(torch.zeros(12, dtype=torch.int64) for _ in kinds)
            for _ in range(16)]
    a = pmesh._layout_of(kinds, regs)
    assert pmesh._layout_of(kinds, regs) is a
    assert a.general_words.shape[0] == pmesh._HEADER_WORDS + 48 * (4 + 16)
    with pytest.raises(ValueError):
        pmesh.RegisterLayout(["sum"] * 400, [torch.int64] * 400,
                             [(1,)] * 400, 16)


def test_general_parameter_block_has_a_pointer_a_position_and_member(
        monkeypatch):
    """``mesh_combine``'s general path (registers as separate tensors):
    the parameter block is the layout's segment table, then member m's
    pointer of position i at [i][m]; a position with a register off the
    16-byte vectors loses its aligned flag; the output is one
    allocation, every position a view of it."""
    seen = []
    monkeypatch.setattr(pmesh, "_launch_words",
                        lambda words, dev: seen.append(words.copy()))
    kinds = ["sum", "max", "none"]
    members = [(torch.zeros(12, dtype=torch.int64),
                torch.zeros(13, dtype=torch.int32)[1:],   # 4 bytes in
                torch.zeros((), dtype=torch.float64)) for _ in range(3)]
    out = pmesh._combine_launch(kinds, members)
    (words,) = seen
    layout = pmesh._layout_of(kinds, members)
    h, p, n = pmesh._HEADER_WORDS, 3, 3
    assert words[0] == n | p << 32 and words[1] & 1 == 1
    table = words[h + 4 * p:].reshape(p, n)
    for i in range(p):
        assert list(table[i]) == [m[i].data_ptr() for m in members]
    # position 1: a register 4 bytes into its buffer; position 2: a none
    # position whose member rows are 8 bytes, off the vectors
    aligned = [bool(words[h + 4 * i] & pmesh._ALIGNED) for i in range(p)]
    assert aligned == [True, False, False]
    assert out[2].shape == (3,) and out[0].shape == (12,)
    assert len({o.untyped_storage().data_ptr() for o in out}) == 1
    assert words[2] == out[0].untyped_storage().data_ptr()
    assert layout.out_nbytes == 96 + 48 + 32


def test_combine_takes_the_first_members_order_for_float_sums():
    """Member order, member 0 first: the result is one fixed
    left-to-right sum, whatever the run."""
    vals = [1e16, 1.0, -1e16, 1.0]
    members = [(torch.tensor([v], dtype=torch.float64),) for v in vals]
    (got,) = mesh_combine_plain(["sum"], members)
    assert got.item() == ((1e16 + 1.0) - 1e16) + 1.0


def test_sharded_partial_agg_runs_the_worker_per_member():
    """The port's sharded_partial_agg over an 8-member CPU mesh: the
    worker sees member m's row, the combine is mesh_combine's."""
    mesh = DeviceMesh(["cpu"] * N_DEV)
    seen = []

    def worker(cols, valids, row_mask):
        seen.append(cols[0].shape)
        x = torch.where(row_mask, cols[0], 0)
        return (x.sum(), torch.where(row_mask, cols[0], 10**9).min())
    run = sharded_partial_agg(worker, ["sum", "min"], mesh)
    x = torch.arange(N_DEV * 5, dtype=torch.int64).reshape(N_DEV, 5)
    mask = torch.ones_like(x, dtype=torch.bool)
    mask[3] = False
    s, mn = run((x,), (mask,), mask)
    assert seen == [(5,)] * N_DEV
    assert s.item() == int(x[mask].sum()) and mn.item() == 0


# ----------------------------------------------------------- the mesh


def test_device_mesh_takes_n_members_and_repeats():
    mesh = DeviceMesh(["cpu"] * 3)
    assert mesh.shape["shard"] == 3 and mesh.device == torch.device("cpu")
    assert [mesh.device_of(i) for i in range(3)] == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        DeviceMesh([])
    with pytest.raises(ValueError):
        DeviceMesh(["cpu"] * (pmesh.MAX_MEMBERS + 1))


def test_cluster_mesh_defaults_to_one_member_on_the_cpu(tmp_path):
    cl = ctt.Cluster(str(tmp_path / "a"), device="cpu")
    assert cl.mesh.shape["shard"] == 1
    cl.close()
    cl = ctt.Cluster(str(tmp_path / "b"), device="cpu",
                     mesh_devices=["cpu"] * 4)
    assert cl.mesh.shape["shard"] == 4
    cl.close()
    assert resolve_mesh(torch.device("cpu")).devices == (torch.device("cpu"),)


# ------------------------------------------------------ SQL, 8 members

SHARDS = 13          # 8 + 5: the last round is partial
LINEITEM_ROWS = 4000


def _load_lineitem(cl, n, shards):
    """bench.py's lineitem schema and generator (seed 7)."""
    cl.execute("""CREATE TABLE lineitem (
        l_orderkey bigint NOT NULL, l_quantity decimal(12,2),
        l_extendedprice decimal(12,2), l_discount decimal(12,2),
        l_tax decimal(12,2), l_returnflag text, l_linestatus text,
        l_shipdate date)""")
    cl.execute(f"SELECT create_distributed_table('lineitem', 'l_orderkey', "
               f"{shards})")
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


def _load_floats(cl):
    """Floats with NaN, +-inf and +-0.0 over 13 shards, and a one-shard
    table (one batch)."""
    rng = np.random.default_rng(13)
    n = 3000
    f = rng.normal(0, 100, n)
    f[rng.random(n) < 0.01] = np.nan
    f[17], f[1017], f[2017], f[29] = np.inf, -np.inf, -0.0, 0.0
    g = rng.normal(0, 1, n)     # no NaN: its min/max are real values
    g[5] = -0.0
    cols = {"k": np.arange(n), "grp": rng.integers(0, 5, n), "f": f, "g": g}
    cl.execute("CREATE TABLE fl (k bigint NOT NULL, grp bigint, f double "
               "precision, g double precision)")
    cl.execute(f"SELECT create_distributed_table('fl', 'k', {SHARDS})")
    cl.copy_from("fl", columns=cols)
    cl.execute("CREATE TABLE one (k bigint NOT NULL, grp bigint, f double "
               "precision, g double precision)")
    cl.execute("SELECT create_distributed_table('one', 'k', 1)")
    cl.copy_from("one", columns=cols)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(reference cluster on 8 devices, port cluster on an 8-member CPU
    mesh) over the same rows."""
    ref = ct.Cluster(str(tmp_path_factory.mktemp("ref")))
    port = ctt.Cluster(str(tmp_path_factory.mktemp("port")), device="cpu",
                       mesh_devices=["cpu"] * N_DEV)
    for cl in (ref, port):
        _load_lineitem(cl, LINEITEM_ROWS, SHARDS)
        _load_floats(cl)
    yield ref, port
    port.close()
    ref.close()


Q1 = """SELECT l_returnflag, l_linestatus, sum(l_quantity) AS sum_qty,
    sum(l_extendedprice) AS sum_base_price,
    sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
    sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
    avg(l_quantity) AS avg_qty, avg(l_extendedprice) AS avg_price,
    avg(l_discount) AS avg_disc, count(*) AS count_order
FROM lineitem WHERE l_shipdate <= date '1998-12-01' - interval '90' day
GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus"""

Q6 = """SELECT sum(l_extendedprice * l_discount) AS revenue FROM lineitem
WHERE l_shipdate >= date '1994-01-01' AND l_shipdate < date '1995-01-01'
  AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24"""

#: (id, sql, params) through both packages over 13 shards (the mesh)
MESH_QUERIES = [
    ("q1", Q1, None),
    ("q6", Q6, None),
    ("direct_group_by", "SELECT l_returnflag, count(*), sum(l_quantity), "
     "min(l_discount), max(l_tax) FROM lineitem GROUP BY l_returnflag "
     "ORDER BY l_returnflag", None),
    ("stddev", "SELECT l_returnflag, stddev(l_quantity), "
     "variance(l_extendedprice) FROM lineitem GROUP BY l_returnflag "
     "ORDER BY l_returnflag", None),
    ("approx_percentile", "SELECT approx_percentile(0.5) WITHIN GROUP "
     "(ORDER BY l_quantity) FROM lineitem", None),
    ("approx_count_distinct", "SELECT approx_count_distinct(l_orderkey), "
     "count(*) FROM lineitem", None),
    ("scalar_min_max", "SELECT min(l_extendedprice), max(l_quantity), "
     "sum(l_tax), count(*) FROM lineitem WHERE l_discount > 0.03", None),
    ("nan_min_max", "SELECT min(f), max(f), sum(f), count(f) FROM fl", None),
    ("nan_min_max_grouped", "SELECT grp, min(f), max(f), min(g), max(g) "
     "FROM fl GROUP BY grp ORDER BY grp", None),
    ("signed_zeros", "SELECT min(g), max(g) FROM fl WHERE g = 0", None),
    ("empty_scalar", "SELECT count(*), sum(l_quantity), min(l_discount) "
     "FROM lineitem WHERE l_shipdate < date '1900-01-01'", None),
    ("empty_grouped", "SELECT l_returnflag, count(*) FROM lineitem WHERE "
     "l_quantity < 0 GROUP BY l_returnflag", None),
    # literals the plan cache turns into parameters, one of them a
    # router key, and the same filters as $n values
    ("parameterised", "SELECT count(*), sum(l_quantity) FROM lineitem "
     "WHERE l_discount = 0.05 AND l_tax < 0.04", None),
    ("router", "SELECT count(*), sum(l_tax) FROM lineitem "
     "WHERE l_orderkey = 7", None),
    ("dollar_params", "SELECT count(*), sum(l_quantity) FROM lineitem "
     "WHERE l_discount = $1 AND l_tax < $2",
     [decimal.Decimal("0.05"), decimal.Decimal("0.04")]),
    ("dollar_router", "SELECT count(*), sum(l_tax) FROM lineitem "
     "WHERE l_orderkey = $1", [7]),
]


def assert_same_rows(got, want):
    """Identical rows, except that a float aggregate may differ in its
    last bits (rel 1e-12): the port's per-member sums and the member
    order of the combine differ from XLA's summation order.  Decimals
    (exact scaled int64), integers and text must be identical."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float):
                assert a == pytest.approx(b, rel=1e-12, nan_ok=True), (g, w)
                if a == 0.0:
                    assert np.signbit(a) == np.signbit(b), (g, w)
            else:
                assert type(a) is type(b) and a == b, (g, w)


def _traced(trace_mod, cl, sql, params):
    tr = trace_mod.Trace()
    with trace_mod.activate(tr, tr.open_span("test", None)):
        r = cl.execute(sql, params=params)
    return r, tr.find_all("device_round")


def _mesh_rounds(rounds):
    """The batches of each mesh round (a single stream's spans carry a
    shard index instead)."""
    return [s.attrs["batches"] for s in rounds if "batches" in s.attrs]


@pytest.mark.parametrize("sql,params", [(s, p) for _, s, p in MESH_QUERIES],
                         ids=[i for i, _, _ in MESH_QUERIES])
def test_mesh_rows_identical_to_reference(pair, sql, params):
    ref, port = pair
    # both start cold: a query of the same scan as an earlier case
    # would replay that case's cache entry
    GLOBAL_CACHE.clear()
    REF_CACHE.clear()
    want, ref_rounds = _traced(ref_trace, ref, sql, params)
    got, port_rounds = _traced(port_trace, port, sql, params)
    assert_same_rows(got.rows, want.rows)
    # the same path on both sides: 13 one-batch shards take two mesh
    # rounds (8, then 5 and three empty members); a router query's one
    # shard is one batch, on the single stream; a WHERE that prunes
    # every chunk scans no batch
    assert _mesh_rounds(port_rounds) == _mesh_rounds(ref_rounds)
    if "l_orderkey = " in sql:
        assert _mesh_rounds(port_rounds) == [] and len(port_rounds) == 1
        assert got.explain["router"] is True
    elif "1900" in sql or "l_quantity < 0" in sql:
        assert port_rounds == ref_rounds == []
    else:
        assert _mesh_rounds(port_rounds) == [N_DEV, SHARDS - N_DEV]
        pl = got.explain["pipeline"]
        assert pl["mesh_members"] == N_DEV and pl["mesh_rounds"] == 2
        assert pl["fused_dispatches"] == 2 * N_DEV


@pytest.mark.parametrize("sql", [
    "SELECT grp, count(*), sum(f), min(g), max(g) FROM one GROUP BY grp "
    "ORDER BY grp",
    "SELECT count(*), min(f), max(f) FROM one"])
def test_one_batch_table_takes_the_single_stream_in_both(pair, sql):
    ref, port = pair
    GLOBAL_CACHE.clear()
    want, ref_rounds = _traced(ref_trace, ref, sql, None)
    got, port_rounds = _traced(port_trace, port, sql, None)
    assert_same_rows(got.rows, want.rows)
    assert _mesh_rounds(ref_rounds) == _mesh_rounds(port_rounds) == []
    assert len(port_rounds) == len(ref_rounds) == 1
    assert "mesh_rounds" not in got.explain["pipeline"]


def test_warm_mesh_query_replays_the_mesh_cache_entry(pair, monkeypatch):
    """The second run reads no disk: the mesh entry (keyed ``("mesh",
    n, members)``) holds each member's device batches of every round,
    its bytes exactly the tensors', and each member folds once per
    round again."""
    _, port = pair
    GLOBAL_CACHE.clear()
    cold = port.execute(Q1)
    (key,) = GLOBAL_CACHE._entries
    assert "mesh" in key and N_DEV in key
    rounds, nbytes, _ = GLOBAL_CACHE._entries[key]
    assert [len(r) for r in rounds] == [N_DEV, N_DEV]
    held = sum(t.numel() * t.element_size() for r in rounds for b in r
               for t in (*b.cols, *b.valids, b.row_mask))
    assert nbytes == held == GLOBAL_CACHE.memory_view()["live_bytes"]
    assert cold.explain["pipeline"]["h2d_bytes"] == held

    from citus_tpu_torch.executor import executor as ex

    def no_disk(*a, **k):
        raise AssertionError("a warm mesh query read the disk")
    monkeypatch.setattr(ex, "load_shard_batches", no_disk)
    h0 = GLOBAL_CACHE.hits
    warm = port.execute(Q1)
    assert GLOBAL_CACHE.hits == h0 + 1
    assert warm.rows == cold.rows
    assert warm.explain["pipeline"]["fused_dispatches"] == 2 * N_DEV


def test_mesh_streams_past_the_cache(pair, monkeypatch):
    """Working set over the cache's capacity: the rounds stream, nothing
    is pinned, the rows are the reference's."""
    ref, port = pair
    GLOBAL_CACHE.clear()
    monkeypatch.setattr(GLOBAL_CACHE, "capacity", 1)
    want = ref.execute(Q1).rows
    got = port.execute(Q1)
    assert_same_rows(got.rows, want)
    assert GLOBAL_CACHE._entries == {}
    assert got.explain["pipeline"]["mesh_rounds"] == 2


def test_mesh_combines_once_per_query(pair, monkeypatch):
    """The port keeps each member's registers across rounds and
    combines once per query (the reference combines each round in the
    mesh, then the rounds on the host)."""
    _, port = pair
    calls = []
    real = pmesh.mesh_combine_plain

    def counting(kinds, members):
        calls.append(len(members))
        return real(kinds, members)
    monkeypatch.setattr(pmesh, "mesh_combine_plain", counting)
    GLOBAL_CACHE.clear()
    for _ in range(2):                       # cold, then warm
        port.execute(Q6)
    assert calls == [N_DEV, N_DEV]


#: more partial positions than the parent's 24 a launch: 5 columns x
#: sum, min, max, count, min and max of a date, the group row counts
WIDE = ("SELECT l_returnflag, " + ", ".join(
    f"sum({c}), min({c}), max({c}), count({c})"
    for c in ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
              "l_orderkey")) + ", min(l_shipdate), max(l_shipdate) "
    "FROM lineitem "
    "GROUP BY l_returnflag ORDER BY l_returnflag")


def test_plan_caches_its_register_layout(pair, monkeypatch):
    """A plan of more than 24 positions over 8 members: rows identical
    to the reference's; the layout (its segment table) is built once for
    the plan and reused warm; each member's registers are views of one
    arena; one combine a query, whose output is split on the host."""
    ref, port = pair
    built, arenas_seen, split = [], [], []
    real_init = pmesh.RegisterLayout.__init__
    real_combine = pmesh.mesh_combine_arenas
    real_host = pmesh.RegisterLayout.host_outputs

    def init(self, kinds, *a, **k):
        built.append(len(kinds))
        real_init(self, kinds, *a, **k)

    def combine(layout, arenas):
        arenas_seen.append((layout, list(arenas)))
        return real_combine(layout, arenas)

    def host(self, out):
        split.append(out.shape)
        return real_host(self, out)
    monkeypatch.setattr(pmesh.RegisterLayout, "__init__", init)
    monkeypatch.setattr(pmesh.RegisterLayout, "host_outputs", host)
    monkeypatch.setattr(pmesh, "mesh_combine_arenas", combine)
    GLOBAL_CACHE.clear()
    want = ref.execute(WIDE).rows
    for _ in range(2):                       # cold, then warm
        assert_same_rows(port.execute(WIDE).rows, want)
    assert len(built) == 1 and built[0] > 24
    assert len(arenas_seen) == 2 and arenas_seen[0][0] is arenas_seen[1][0]
    layout, arenas = arenas_seen[1]
    assert len(arenas) == N_DEV
    assert all(a.dtype == torch.uint8 and a.shape == (layout.nbytes,)
               for a in arenas)
    assert len({a.data_ptr() for a in arenas}) == N_DEV
    assert split == [(layout.out_nbytes,)] * 2


def test_one_member_mesh_takes_the_single_stream(tmp_path):
    """A Cluster whose mesh has one member runs today's single stream:
    one fold per batch, no mesh round, no combine."""
    cl = ctt.Cluster(str(tmp_path / "db"), device="cpu")
    _load_lineitem(cl, 1000, SHARDS)
    tr = port_trace.Trace()
    with port_trace.activate(tr, tr.open_span("test", None)):
        r = cl.execute(Q6)
    rounds = tr.find_all("device_round")
    assert _mesh_rounds(rounds) == [] and len(rounds) == SHARDS
    assert "mesh_rounds" not in r.explain["pipeline"]
    cl.close()


def test_partial_last_round_books_only_real_shards(pair, monkeypatch):
    """Attribution of a round goes to its real shards: the pad members
    (shard index -1) of the partial round book nothing, and the bytes
    booked add up to the bytes the rounds moved."""
    from citus_tpu_torch.executor import executor as ex
    _, port = pair
    booked, moved = [], []
    real = ex._book_mesh_round

    def spy(buf, nb, task_bytes):
        real(buf, nb, task_bytes)
        booked[:] = task_bytes
        moved.append(nb)
    monkeypatch.setattr(ex, "_book_mesh_round", spy)
    GLOBAL_CACHE.clear()
    r = port.execute("SELECT count(*), sum(l_quantity) FROM lineitem "
                     "WHERE l_tax > 0")
    assert sorted(si for si, _ in booked) == list(range(SHARDS))
    assert sum(b for _, b in booked) == sum(moved) \
        == r.explain["pipeline"]["h2d_bytes"]
    assert len(moved) == 2


# ------------------------------------------------- chip_smoke.py, rehearsed

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


def test_chip_smoke_phase3_mesh_helpers_rehearse_on_cpu(tmp_path,
                                                        monkeypatch):
    """chip_smoke.py's phase-3 cases of mesh_combine and exchange_blocks
    at a small size on the CPU, timing stubbed out (CUDA events need a
    card): the members' registers fold, the blocks pack, the plain
    versions agree with themselves, and the JSON rows carry every key."""
    monkeypatch.setattr(chip_smoke, "time_cuda", lambda fn, **kw: 0.0)
    monkeypatch.setattr(chip_smoke, "device_time",
                        lambda fn, **kw: (fn(), (None, {}))[1])
    monkeypatch.setattr(chip_smoke, "FOLD_N", 4096)
    dev = torch.device("cpu")
    rows: list = []
    plans = chip_smoke.smoke_plans(dev, str(tmp_path), n=4096)
    splans = chip_smoke.sketch_plans(dev, str(tmp_path), n=4096)
    chip_smoke.phase3_mesh_combine(dev, plans, splans, rows)
    chip_smoke.phase3_mesh_exchange(dev, rows,
                                    chip_smoke.qjoin_sides(20_000, dev))
    assert [r["name"] for r in rows] == ["mesh_combine", "exchange_blocks"]
    for r in rows:
        assert r["bound_ms"] > 0 and r["route"] == "cuda"
        assert {"replaces", "source", "library_ms", "plain_ms"} <= set(r)


def test_chip_smoke_phase9_rehearses_on_cpu(tmp_path):
    """chip_smoke.py's phase 9 on the CPU at a small size: a second
    Cluster over the same lineitem with a 4-member mesh answers Q6 and Q1
    cold and warm with the numpy oracle's rows, over mesh rounds."""
    n = 20_000
    path = str(tmp_path / "sf")
    cl = ctt.Cluster(path, device="cpu")
    cl.execute(chip_smoke.LINEITEM_DDL)
    cl.execute("SELECT create_distributed_table('lineitem', 'l_orderkey', "
               f"{chip_smoke.SHARDS})")
    chunks = list(chip_smoke.lineitem_chunks(n))
    for c in chunks:
        cl.copy_from("lineitem", columns=chip_smoke.copy_columns(c))
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    launches = dict.fromkeys(chip_smoke.launch_counters(), 0)
    mcl = chip_smoke.mesh_cluster(ctt, path, torch.device("cpu"))
    try:
        for q, sql, want in (("Q6", chip_smoke.Q6, chip_smoke.oracle_q6(cols)),
                             ("Q1", chip_smoke.Q1, chip_smoke.oracle_q1(cols))):
            for run_kind in ("cold", "warm"):
                chip_smoke.run_mesh_query(mcl, q, sql, want, n, run_kind,
                                          launches, "cpu")
    finally:
        mcl.close()
        cl.close()
    assert all(v == 0 for v in launches.values())  # plain versions only
