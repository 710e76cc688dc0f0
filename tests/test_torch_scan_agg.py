"""The port's scan -> filter -> partial-aggregate fold against the JAX
package's fused worker.

One numpy-seeded batch and one plan go through
``citus_tpu.ops.scan_agg.build_fused_worker_fn(plan, jnp)`` (jitted on
the CPU) and through the port's ``build_fused_worker_fn`` on a CPU
torch namespace, which folds with ``scan_agg_fold``'s plain version.
Two batches are folded into the same registers, so the running merge is
covered.  Cases: scalar mode, direct mode with G = 12 (the reference's
one-hot regime) and direct mode with G > 8192 (its scatter regime), each
over nulls, NaN, +-inf and +-0.0, and with an all-false row mask.

int64 registers must be identical, float min/max identical with NaN in
the same places, float sums within rel 1e-12 (another summation order).
The kernel itself runs only on a card: ``test_kernel_matches_plain_on_card``
holds it against the plain version there and skips here.
"""

import numpy as np
import pytest

import citus_tpu as ct
import jax
import jax.numpy as jnp
import torch

import citus_tpu_torch as ctt
from citus_tpu.executor.executor import _empty_partials as ref_empty_partials
from citus_tpu.ops.scan_agg import build_fused_worker_fn as ref_fused
from citus_tpu.planner import parse_sql as ref_parse
from citus_tpu.planner.bind import bind_select as ref_bind
from citus_tpu.planner.physical import plan_select as ref_plan
from citus_tpu_torch.ops.scan_agg import (
    build_fused_worker_fn, build_worker_fn, empty_device_partials,
)
from citus_tpu_torch.ops.scan_agg_fold import (
    FoldKey, FoldOp, scan_agg_fold, scan_agg_fold_plain,
)
from citus_tpu_torch.ops.xp_torch import TorchNamespace
from citus_tpu_torch.planner import parse_sql
from citus_tpu_torch.planner.bind import bind_select
from citus_tpu_torch.planner.physical import plan_select

N_PAD, N_REAL = 4096, 3000

QUERIES = {
    "scalar": (
        "SELECT count(*), count(score), sum(price), sum(score), min(price), "
        "max(price), min(score), max(score), min(f), max(f), min(d), "
        "max(d), avg(qty), sum(f) FROM t WHERE d >= '1999-06-01'"),
    "direct_g12": (
        "SELECT g, count(*), count(f), sum(price), sum(score), min(score), "
        "max(f), min(d), max(price), avg(qty) FROM t GROUP BY g"),
    "direct_large": (
        "SELECT k, count(*), sum(price), sum(score), min(score), "
        "max(score), min(f) FROM t WHERE price > -5000 GROUP BY k"),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def catalogs(tmp_path_factory):
    """One data directory written by citus_tpu, opened by both packages:
    column bounds (the key domains) come from its stripe footers."""
    d = str(tmp_path_factory.mktemp("db"))
    ref = ct.Cluster(d)
    ref.execute("CREATE TABLE t (k bigint, g bigint, price decimal(12,2), "
                "score double, f real, d date, qty bigint)")
    ref.execute("SELECT create_distributed_table('t', 'k', 2)")
    rng = np.random.default_rng(3)
    n = 400
    k = rng.integers(0, 10000, n)
    k[:2] = [0, 9999]
    g = rng.integers(0, 11, n)
    g[:2] = [0, 10]
    ref.copy_from("t", columns={
        "k": k, "g": g, "price": rng.integers(-100000, 100000, n) / 100.0,
        "score": rng.random(n), "f": rng.random(n).astype(np.float32),
        "d": rng.integers(9000, 12000, n).astype(np.int32),
        "qty": rng.integers(-50, 50, n)})
    port = ctt.Cluster(d, device="cpu")
    yield ref.catalog, port.catalog
    port.close()
    ref.close()


def _plans(catalogs, sql):
    rcat, pcat = catalogs
    rp = ref_plan(rcat, ref_bind(rcat, ref_parse(sql)[0]))
    pp = plan_select(pcat, bind_select(pcat, parse_sql(sql)[0]))
    return rp, pp


def _batch(plan, seed, mask_case):
    """numpy batch in the plan's scan columns, with nulls and special
    floats; padding rows are zero, valid, and masked out."""
    rng = np.random.default_rng(seed)
    schema = plan.bound.table.schema
    cols, valids = [], []
    for c in plan.scan_columns:
        dt = schema.scan_dtype(c, device=True)
        if c == "k":
            v = rng.integers(0, 10000, N_PAD)
        elif c == "g":
            v = rng.integers(0, 11, N_PAD)
        elif c == "d":
            v = rng.integers(9000, 12000, N_PAD)
        elif np.issubdtype(dt, np.floating):
            v = rng.standard_normal(N_PAD) * 100
            v[rng.integers(0, N_REAL, 8)] = np.nan
            v[rng.integers(0, N_REAL, 4)] = np.inf
            v[rng.integers(0, N_REAL, 4)] = -np.inf
            v[rng.integers(0, N_REAL, 8)] = 0.0
            v[rng.integers(0, N_REAL, 8)] = -0.0
        else:
            v = rng.integers(-10**7, 10**7, N_PAD)
        v = v.astype(dt)
        m = rng.random(N_PAD) > 0.1
        v[N_REAL:] = 0
        m[N_REAL:] = True
        cols.append(v)
        valids.append(m)
    row_mask = np.zeros(N_PAD, bool)
    if mask_case == "rows":
        row_mask[:N_REAL] = True
    return tuple(cols), tuple(valids), row_mask


def _run_ref(plan, batches):
    fused = jax.jit(ref_fused(plan, jnp))
    acc = tuple(jnp.asarray(p) for p in ref_empty_partials(plan, np))
    for cols, valids, mask in batches:
        acc = fused(acc, cols, valids, mask)
    return [np.asarray(a) for a in acc]


def _run_port(plan, batches):
    xp = TorchNamespace("cpu")
    fused = build_fused_worker_fn(plan, xp)
    acc = empty_device_partials(plan, "cpu")
    for cols, valids, mask in batches:
        acc = fused(acc, tuple(torch.from_numpy(c) for c in cols),
                    tuple(torch.from_numpy(v) for v in valids),
                    torch.from_numpy(mask))
    return [a.numpy() for a in acc]


def _assert_same_partials(plan, got, want):
    kinds = [op.kind for op in plan.partial_ops] + (
        ["count"] if plan.group_mode.kind == "direct" else [])
    assert len(got) == len(want)
    for kind, g, w in zip(kinds, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (kind, g, w)
        if np.issubdtype(w.dtype, np.floating) and kind == "sum":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
        else:
            # identical (NaN positions included; 0.0 == -0.0)
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mask_case", ["rows", "all_false"])
@pytest.mark.parametrize("case", sorted(QUERIES))
def test_fused_fold_matches_jax(catalogs, case, mask_case):
    rp, pp = _plans(catalogs, QUERIES[case])
    want_mode = "scalar" if case == "scalar" else "direct"
    assert rp.group_mode.kind == pp.group_mode.kind == want_mode
    if case == "direct_g12":
        assert pp.group_mode.n_groups == 12
    if case == "direct_large":
        assert pp.group_mode.n_groups > 8192
    batches = [_batch(rp, seed, mask_case) for seed in (1, 2)]
    _assert_same_partials(rp, _run_port(pp, batches), _run_ref(rp, batches))


def test_worker_fn_returns_fresh_partials(catalogs):
    """build_worker_fn on a torch namespace: one batch into fresh
    registers, equal to one fused fold from the empty seed."""
    rp, pp = _plans(catalogs, QUERIES["direct_g12"])
    cols, valids, mask = _batch(rp, 5, "rows")
    worker = build_worker_fn(pp, TorchNamespace("cpu"))
    out = worker(tuple(torch.from_numpy(c) for c in cols),
                 tuple(torch.from_numpy(v) for v in valids),
                 torch.from_numpy(mask))
    _assert_same_partials(rp, [o.numpy() for o in out],
                          _run_ref(rp, [(cols, valids, mask)]))


def test_int64_sum_wraps_like_xla(catalogs):
    """An int64 sum that overflows wraps in two's complement in both
    packages (the float64 shadow sum then lets finalize reject it)."""
    rp, pp = _plans(catalogs, "SELECT sum(price) FROM t")
    cols, valids, mask = _batch(rp, 7, "rows")
    cols = (np.full(N_PAD, 2**62, np.int64),)
    valids = (np.ones(N_PAD, bool),)
    got, want = _run_port(pp, [(cols, valids, mask)]), \
        _run_ref(rp, [(cols, valids, mask)])
    _assert_same_partials(rp, got, want)
    assert abs(got[-1]) >= 2**62  # the shadow sum sees the overflow


def _fold_case(device, G, n, seed):
    """Inputs of one fold at the kernel's interface, all op kinds and
    accumulator types, with nulls, NaN and a broadcast constant."""
    g = torch.Generator().manual_seed(seed)
    mask = torch.rand(n, generator=g) < 0.8
    key = torch.randint(0, max(G - 1, 1), (n,), generator=g)
    key_valid = torch.rand(n, generator=g) < 0.95
    ints = torch.randint(-10**9, 10**9, (n,), generator=g)
    floats = torch.randn(n, generator=g, dtype=torch.float64)
    floats[::997] = float("nan")
    floats[1::991] = float("inf")
    i32 = torch.randint(-1000, 1000, (n,), generator=g, dtype=torch.int32)
    f32 = torch.randn(n, generator=g, dtype=torch.float32)
    valid = torch.rand(n, generator=g) < 0.9
    args = [(ints, valid), (floats, None), (i32, valid), (f32, valid),
            (torch.tensor([3], dtype=torch.int64), None)]
    ops = [FoldOp("count_star"), FoldOp("count", 0), FoldOp("sum", 0),
           FoldOp("sum", 1), FoldOp("min", 0), FoldOp("max", 1),
           FoldOp("min", 2), FoldOp("max", 3), FoldOp("sum", 2),
           FoldOp("min", 1), FoldOp("sum", 4), FoldOp("sum", 3)]
    dts = [torch.int64, torch.int64, torch.int64, torch.float64,
           torch.int64, torch.float64, torch.int32, torch.float32,
           torch.int64, torch.float64, torch.int64, torch.float64]
    keys = [FoldKey(key, key_valid, 0, 1, 1)] if G > 1 else []

    def to(t):
        return None if t is None else t.to(device)

    acc = []
    for op, dt in zip(ops, dts):
        fill = 0
        if op.kind in ("min", "max"):
            info = torch.finfo(dt) if dt.is_floating_point else torch.iinfo(dt)
            fill = (float("inf") if op.kind == "min" else float("-inf")) \
                if dt.is_floating_point else \
                (info.max if op.kind == "min" else info.min)
        acc.append(torch.full((G,), fill, dtype=dt, device=device))
    rows = torch.zeros(G, dtype=torch.int64, device=device) if G > 1 else None
    return (acc, rows, to(mask),
            [FoldKey(to(k.values), to(k.valid), k.lo, k.step, k.stride)
             for k in keys],
            [(to(v), to(m)) for v, m in args], ops)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 12, 65536])
def test_kernel_matches_plain_on_card(G):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    n = (1 << 20) + 3  # not a multiple of the block size
    acc_k, rows_k, mask, keys, args, ops = _fold_case("cuda", G, n, 11)
    acc_p, rows_p, *_ = _fold_case("cuda", G, n, 11)
    launches = scan_agg_fold.launches
    scan_agg_fold(acc_k, rows_k, mask, keys, args, ops, G)
    assert scan_agg_fold.launches == launches + 1
    scan_agg_fold_plain(acc_p, rows_p, mask, keys, args, ops, G)
    torch.cuda.synchronize()
    for op, k, p in zip(ops, acc_k, acc_p):
        k, p = k.cpu().numpy(), p.cpu().numpy()
        if op.kind == "sum" and np.issubdtype(k.dtype, np.floating):
            np.testing.assert_array_equal(np.isnan(k), np.isnan(p))
            np.testing.assert_allclose(k, p, rtol=1e-12 if k.dtype == np.float64
                                       else 1e-4, atol=0)
        else:
            np.testing.assert_array_equal(k, p)
    if rows_k is not None:
        assert torch.equal(rows_k, rows_p)


def test_plain_fold_matches_numpy_scatter():
    """The plain version on the CPU against numpy's ufunc.at scatter
    (the reference's host oracle), for the fold case the card test uses."""
    G, n = 12, 5000
    acc, rows, mask, keys, args, ops = _fold_case("cpu", G, n, 5)
    want = [a.numpy().copy() for a in acc]
    scan_agg_fold(acc, rows, mask, keys, args, ops, G)
    m = mask.numpy()
    k = keys[0]
    code = np.where(k.valid.numpy(), k.values.numpy() - k.lo + 1, 0)
    gid = np.clip(np.where(m, code, 0), 0, G - 1)
    for i, op in enumerate(ops):
        if op.kind == "count_star":
            np.add.at(want[i], gid[m], 1)
            continue
        v, valid = args[op.arg]
        v = np.broadcast_to(v.numpy(), (n,))
        ok = m & (np.ones(n, bool) if valid is None else valid.numpy())
        if op.kind == "count":
            np.add.at(want[i], gid[ok], 1)
        elif op.kind == "sum":
            np.add.at(want[i], gid[ok], v[ok].astype(want[i].dtype))
        else:
            f = np.minimum if op.kind == "min" else np.maximum
            f.at(want[i], gid[ok], v[ok].astype(want[i].dtype))
    for op, got, w in zip(ops, acc, want):
        if op.kind == "sum" and np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=0)
        else:
            np.testing.assert_array_equal(got.numpy(), w)
    assert rows.sum().item() == int(m.sum())
