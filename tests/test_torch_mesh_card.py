"""The mesh's kernels on the card: the combine (B6, ``csrc/mesh_combine.cu``)
and the exchange (``csrc/mesh_exchange.cu``) against their plain
versions, and a Cluster whose mesh has four members on one card against
its own ``cpu`` backend.

- ``mesh_combine``: every kind (sum, min, max, none) and register dtype
  (int64, float64, int32, float32), 0-d and vector registers, registers
  whose ends are off the 16-byte vectors, NaN, +-inf, +-0.0 and a member
  that saw no row, 1, 2, 3, 4 and 16 members, 64 positions in one launch,
  from separate tensors (views one element into their buffers too) and
  from one allocation a member (``mesh_combine_arenas``, the executor's
  call): identical bits, NaN where the plain version has NaN;
- ``exchange_blocks``: 1, 4 and 16 members, columns of 1, 4 and 8 bytes,
  capacities 16 does not divide (and QJOIN's at SF1, 376,388), more
  columns than one launch takes (26): identical outputs, one launch per
  24 columns for every destination on the card, each destination's
  receive columns rows of one stacked [n, n * C] tensor;
- Q1 and Q6 over 13 shards (four rounds of four members, the last one
  partial) and a repartition join, on a 4-member mesh of the card: rows
  equal to the numpy backend's, one fold per member per round, one
  combine and one device-to-host copy per query, and per device join
  step 8 packs, 2 exchanges of one launch, 4 sort-joins and the
  overflow's combine.

The kernels have no CPU mode: these tests need a card and skip without
one.  This module imports no JAX, so it runs on a machine without the
JAX package, past the suite's ``conftest.py``:
``python -m pytest --noconftest tests/test_torch_mesh_card.py``.
"""

import time

import numpy as np
import pytest
import torch

import citus_tpu_torch as ctt
from citus_tpu_torch.ops.scan_agg_fold import scan_agg_fold
from citus_tpu_torch.parallel import mesh as pmesh
from citus_tpu_torch.parallel import shuffle
from citus_tpu_torch.parallel.mesh import DeviceMesh


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _register(kind, dtype, shape, n, rng, empty_member):
    """n members' registers of one position, numpy-made."""
    full = (n,) + shape
    if dtype in (np.float64, np.float32):
        a = rng.normal(0, 1e3, full).astype(dtype)
        flat = a.reshape(n, -1)
        if flat.shape[1] >= 6:
            flat[0, 0] = np.nan
            flat[:, 1] = -0.0
            flat[: n // 2, 2], flat[n // 2:, 2] = 0.0, -0.0
            flat[: n // 2, 3], flat[n // 2:, 3] = -0.0, 0.0
            flat[-1, 4] = np.inf
            flat[0, 5] = -np.inf
    else:
        a = rng.integers(-10**6, 10**6, full).astype(dtype)
    if empty_member is not None:
        a[empty_member] = {"sum": 0, "none": 0,
                           "min": np.inf if a.dtype.kind == "f"
                           else np.iinfo(dtype).max,
                           "max": -np.inf if a.dtype.kind == "f"
                           else np.iinfo(dtype).min}[kind]
    return a


def _same(g, w):
    """Identical bits; NaN where the other has NaN (any payload)."""
    assert g.dtype == w.dtype and g.shape == w.shape
    if g.dtype.is_floating_point:
        nan = torch.isnan(w)
        assert torch.equal(torch.isnan(g), nan)
        bits = torch.int64 if g.element_size() == 8 else torch.int32
        g, w = g[~nan].view(bits), w[~nan].view(bits)
    assert torch.equal(g, w)


def _positions(n, rng):
    """64 positions: every kind, dtype and shape, n members' registers
    (numpy) of each."""
    kinds, stacks = [], []
    for kind in ("sum", "min", "max", "none"):
        for dtype in (np.int64, np.float64, np.int32, np.float32):
            for shape in ((), (12,), (13,), (65_539,)):
                kinds.append(kind)
                stacks.append(_register(kind, dtype, shape, n, rng,
                                        n // 2 if n > 1 else None))
    return kinds, stacks


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 4, 16])
def test_combine_kernel_matches_plain_on_card(card, n):
    rng = np.random.default_rng(n)
    kinds, stacks = _positions(n, rng)
    members = [tuple(torch.from_numpy(np.array(s[m])).to(card)
                     for s in stacks) for m in range(n)]
    pmesh.mesh_combine.launches = 0
    got = pmesh.mesh_combine(kinds, members)
    torch.cuda.synchronize()
    # 64 positions: one launch
    assert pmesh.mesh_combine.launches == 1
    want = pmesh.mesh_combine_plain(kinds, members)
    for g, w in zip(got, want):
        if g.dim() == 0:
            g, w = g.reshape(1), w.reshape(1)
        _same(g, w)
    assert len({g.untyped_storage().data_ptr() for g in got}) == 1
    # registers one element into their buffers: no 16-byte vectors
    odd = [tuple(torch.cat([r.reshape(-1)[:1], r.reshape(-1)])[1:]
                 .view(r.shape) for r in m) for m in members]
    for g, w in zip(pmesh.mesh_combine(kinds, odd), want):
        _same(g.reshape(-1), w.reshape(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 4, 16])
def test_combine_of_arenas_matches_plain_on_card(card, n):
    """The executor's call: each member's registers one allocation, one
    launch into one output allocation."""
    rng = np.random.default_rng(100 + n)
    kinds, stacks = _positions(n, rng)
    members = [tuple(torch.from_numpy(np.array(s[m])).to(card)
                     for s in stacks) for m in range(n)]
    layout = pmesh.RegisterLayout(kinds, [r.dtype for r in members[0]],
                                  [r.shape for r in members[0]], n)
    arenas = [torch.from_numpy(layout.pack([r.cpu().numpy() for r in m]))
              .to(card) for m in members]
    pmesh.mesh_combine.launches = 0
    out = pmesh.mesh_combine_arenas(layout, arenas)
    torch.cuda.synchronize()
    assert pmesh.mesh_combine.launches == 1
    want = pmesh.mesh_combine_plain(kinds, members)
    for g, h, w in zip(layout.out_views(out),
                       layout.host_outputs(out.cpu().numpy()), want):
        _same(g.reshape(-1), w.reshape(-1))
        _same(torch.from_numpy(np.ascontiguousarray(h)).reshape(-1),
              w.cpu().reshape(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("n,C,cols", [(1, 7, 3), (4, 1000, 5),
                                      (4, 376_388, 6), (16, 4097, 26)])
def test_exchange_kernel_matches_plain_on_card(card, n, C, cols):
    rng = np.random.default_rng(C)
    makers = [lambda: rng.integers(0, 10**12, (n, C)),
              lambda: rng.integers(-9, 9, (n, C)).astype(np.int32),
              lambda: rng.random((n, C)) > 0.5]
    blocks = [tuple(torch.from_numpy(makers[c % 3]()).to(card)
                    for c in range(cols)) for _ in range(n)]
    mesh = DeviceMesh([card] * n)
    shuffle.exchange_blocks.launches = 0
    got = shuffle.exchange_blocks(blocks, mesh)
    torch.cuda.synchronize()
    assert shuffle.exchange_blocks.launches == -(-cols // 24)
    want = shuffle.exchange_blocks_plain(blocks, mesh)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
    for c in range(cols):
        stacked = got[0][c]._base
        assert stacked is not None and stacked.shape == (n, n * C)
        for d in range(n):
            assert got[d][c]._base is stacked
            assert got[d][c].data_ptr() == stacked[d].data_ptr()
    if n == 1:
        return
    # what build_repartition takes: the kernel's own receive tensors,
    # with no stack copy after the launch
    shuffle.exchange_blocks.launches = 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "stack", None)
        cols_got = shuffle._received_stacked(mesh, blocks)
    torch.cuda.synchronize()
    assert shuffle.exchange_blocks.launches == -(-cols // 24)
    for c, g in enumerate(cols_got):
        assert g.shape == (n, n * C) and g.is_contiguous()
        assert torch.equal(g, torch.stack([w[c] for w in want]))


SHARDS = 13
N_MEMBERS = 4

Q1 = """SELECT l_returnflag, l_linestatus, sum(l_quantity), sum(l_extendedprice),
    avg(l_discount), min(l_tax), max(l_extendedprice), count(*)
FROM lineitem GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus"""
Q6 = """SELECT sum(l_extendedprice * l_discount), count(*) FROM lineitem
WHERE l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24"""
QJ = """SELECT o.o_flag, count(*), sum(l.l_quantity) FROM lineitem l
JOIN orders o ON l.l_orderkey = o.o_orderkey GROUP BY o.o_flag
ORDER BY o.o_flag"""


@pytest.fixture(scope="module")
def mesh_cluster(card, tmp_path_factory):
    cl = ctt.Cluster(str(tmp_path_factory.mktemp("mesh")),
                     mesh_devices=[card] * N_MEMBERS)
    n = 40_000
    rng = np.random.default_rng(7)
    cl.execute("""CREATE TABLE lineitem (l_orderkey bigint NOT NULL,
        l_quantity decimal(12,2), l_extendedprice decimal(12,2),
        l_discount decimal(12,2), l_tax decimal(12,2), l_returnflag text,
        l_linestatus text)""")
    cl.execute(f"SELECT create_distributed_table('lineitem', 'l_orderkey', "
               f"{SHARDS})")
    cl.copy_from("lineitem", columns={
        "l_orderkey": rng.integers(0, n // 4, n),
        "l_quantity": rng.integers(100, 5100, n) / 100.0,
        "l_extendedprice": rng.integers(90_000, 10_500_000, n) / 100.0,
        "l_discount": rng.integers(0, 11, n) / 100.0,
        "l_tax": rng.integers(0, 9, n) / 100.0,
        "l_returnflag": np.array(["A", "N", "R"])[rng.integers(0, 3, n)]
        .tolist(),
        "l_linestatus": np.array(["F", "O"])[rng.integers(0, 2, n)].tolist()})
    cl.execute("""CREATE TABLE orders (o_orderkey bigint NOT NULL,
        o_custkey bigint, o_flag text)""")
    cl.execute("SELECT create_distributed_table('orders', 'o_custkey', 4)")
    cl.copy_from("orders", columns={
        "o_orderkey": np.arange(n // 4), "o_custkey": np.arange(n // 4) % 97,
        "o_flag": np.array(["H", "L", "M"])[np.arange(n // 4) % 3].tolist()})
    yield cl
    cl.close()


def _cpu_rows(cl, sql):
    cl.execute("SET citus.task_executor_backend = 'cpu'")
    try:
        return cl.execute(sql).rows
    finally:
        cl.execute("SET citus.task_executor_backend = 'gpu'")


def _reset():
    for f in (scan_agg_fold, pmesh.mesh_combine, shuffle.exchange_blocks,
              shuffle.pack_blocks, shuffle.sorted_join):
        f.launches = 0


@pytest.mark.cuda
@pytest.mark.parametrize("sql", [Q1, Q6], ids=["q1", "q6"])
def test_four_member_mesh_aggregate_on_card(mesh_cluster, sql):
    cl = mesh_cluster
    assert cl.mesh.shape["shard"] == N_MEMBERS
    want = _cpu_rows(cl, sql)
    for _ in ("cold", "warm"):
        _reset()
        r = cl.execute(sql)
        torch.cuda.synchronize()
        assert r.rows == want or all(
            a == pytest.approx(b, rel=1e-12) for g, w in zip(r.rows, want)
            for a, b in zip(g, w))
        pl = r.explain["pipeline"]
        assert pl["mesh_members"] == N_MEMBERS and pl["mesh_rounds"] == 4
        assert scan_agg_fold.launches == 4 * N_MEMBERS
        assert pmesh.mesh_combine.launches == 1
    # warm: the combined registers come to the host in one copy (a
    # profiler session may lose its record: up to 3 sessions, until one
    # records the combine)
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.5)
            cl.execute(sql)
            torch.cuda.synchronize()
            time.sleep(0.5)
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if any("mc_kernel" in k for k in names):
            break
    else:
        pytest.fail("torch.profiler recorded no combine in 3 sessions")
    assert sum("DtoH" in k for k in names) == 1


@pytest.mark.cuda
def test_four_member_mesh_device_join_on_card(mesh_cluster):
    cl = mesh_cluster
    want = _cpu_rows(cl, QJ)
    _reset()
    r = cl.execute(QJ)
    torch.cuda.synchronize()
    assert r.rows == want
    assert "devjoin" in r.explain["shuffle"]
    assert shuffle.pack_blocks.launches == 2 * N_MEMBERS
    assert shuffle.exchange_blocks.launches == 2
    assert shuffle.sorted_join.launches == N_MEMBERS
    assert pmesh.mesh_combine.launches == 1
