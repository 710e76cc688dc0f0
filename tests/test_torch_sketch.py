"""The port's sketch aggregates (approx_count_distinct, approx_percentile,
approx_top_k) on the device fold, held against the JAX package.

- The port's torch bucket functions (``ops/sketch_buckets.py``, the
  plain versions' and the kernels' definition) against the reference's
  jitted ``hll_rho_buckets`` / ``ddsk_bucket_indexes`` / ``topk_buckets``
  on adversarial inputs: NaN, +-inf, +-0.0, 1e-300, the smallest
  subnormal, INT64_MIN/MAX bits, and every DDSketch bucket edge
  ``exp(DDSK_LOG_MIN + k * DDSK_LNG)`` with its float neighbours.
  Identical.  The reference's own numpy oracle divides by DDSK_LNG
  where XLA multiplies by its reciprocal: at 156 of those 6,192 edge
  values the two reference backends disagree by one bucket (ROADMAP.md
  C); the port's device path follows XLA, its cpu backend numpy, and
  the test holds each to its own.
- The constants of ``csrc/sketch.cuh`` read back equal to the planner's.
- The port's plain serial fold and plain batched fold, with sketch ops,
  against ``citus_tpu.ops.scan_agg.build_fused_worker_fn(plan, jnp)``
  on the same seeded numpy batches (two batches into the same
  registers; the batched fold per query mask).  Registers identical.
- SQL through both packages: S1-shaped scalar sketch queries over int,
  float, decimal, text and date arguments with nulls, and a sketch
  family sent from four threads coalesces (occupancy above 1) with the
  serial rows.
``test_sketch_fold_matches_plain_on_card`` needs a card and skips here.
"""

import os
import re
import sys
import threading

import numpy as np
import pytest

import citus_tpu as ct
import jax
import jax.numpy as jnp
import torch

import citus_tpu_torch as ctt
from citus_tpu.executor.executor import _empty_partials as ref_empty_partials
from citus_tpu.ops.scan_agg import build_fused_worker_fn as ref_fused
from citus_tpu.planner import aggregates as ref_agg
from citus_tpu.planner import parse_sql as ref_parse
from citus_tpu.planner.bind import bind_select as ref_bind
from citus_tpu.planner.physical import plan_select as ref_plan
from citus_tpu_torch.executor import megabatch
from citus_tpu_torch.executor.megabatch import GLOBAL_MEGABATCH
from citus_tpu_torch.ops import sketch_buckets as sb
from citus_tpu_torch import types as T
from citus_tpu_torch.ops.expr_codegen import FoldExprs
from citus_tpu_torch.ops.scan_agg import (
    build_fused_worker_fn, empty_device_partials,
)
from citus_tpu_torch.ops.scan_agg_fold import (
    FoldOp, FoldProgram, SKETCH_M, fold_batched_plain, fold_plain,
    scan_agg_fold, scan_agg_fold_batched, scan_agg_fold_plain,
)
from citus_tpu_torch.planner.bound import BColumn
from citus_tpu_torch.ops.xp_torch import TorchNamespace
from citus_tpu_torch.planner import aggregates as port_agg
from citus_tpu_torch.planner import parse_sql
from citus_tpu_torch.planner.bind import bind_select
from citus_tpu_torch.planner.physical import plan_select

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_slice import assert_same_rows  # noqa: E402

N_PAD, N_REAL = 4096, 3000
I64 = np.iinfo(np.int64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------ bucket functions


def _edge_values() -> np.ndarray:
    e = np.exp(ref_agg.DDSK_LOG_MIN + np.arange(-2, 1030) * ref_agg.DDSK_LNG)
    near = np.concatenate([e, np.nextafter(e, 0), np.nextafter(e, np.inf)])
    return np.concatenate([near, -near])


def _adversarial_floats() -> np.ndarray:
    rng = np.random.default_rng(13)
    special = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-300,
                        -1e-300, 5e-324, -5e-324, 1e300, 1e-12, 1e12,
                        np.finfo(np.float64).max, np.finfo(np.float64).tiny])
    return np.concatenate([special, _edge_values(),
                           rng.standard_normal(2000) * 10.0 ** rng.integers(
                               -20, 20, 2000)])


def _adversarial_bits() -> np.ndarray:
    rng = np.random.default_rng(17)
    special = np.array([I64.min, I64.max, 0, -1, 1, 1 << 57, (1 << 63) - 1,
                        -(1 << 62)], np.int64)
    return np.concatenate([special, rng.integers(I64.min, I64.max, 4000),
                           _adversarial_floats().view(np.int64)])


def test_hll_buckets_identical_to_reference():
    bits = _adversarial_bits()
    ok = np.random.default_rng(1).random(bits.size) > 0.2
    rb, rr = jax.jit(lambda b, m: ref_agg.hll_rho_buckets(jnp, b, m))(bits, ok)
    pb, pr = sb.hll_rho_buckets(torch.from_numpy(bits), torch.from_numpy(ok))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(rr))
    assert pr.numpy()[ok].min() >= 1 and pr.numpy()[~ok].max() == 0


def test_topk_buckets_identical_to_reference():
    bits = _adversarial_bits()
    want = jax.jit(lambda b: ref_agg.topk_buckets(jnp, b))(bits)
    got = sb.topk_buckets(torch.from_numpy(bits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the numpy oracle's uint64 arithmetic gives the same buckets
    np.testing.assert_array_equal(got.numpy(),
                                  port_agg.topk_buckets(np, bits))


def test_ddsk_buckets_identical_to_reference():
    v = _adversarial_floats()
    want = np.asarray(jax.jit(lambda x: ref_agg.ddsk_bucket_indexes(jnp, x))(v))
    got = sb.ddsk_bucket_indexes(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[0] == want[1] == ref_agg.DDSK_HALF - 1  # NaN: zero bucket
    assert want[2] == ref_agg.DDSK_M - 1 and want[3] == 0  # +-inf


def test_ddsk_bucket_edges_split_the_reference_backends():
    """ROADMAP.md C: the reference's numpy oracle divides by DDSK_LNG,
    its jitted body multiplies by the reciprocal XLA folds the constant
    into.  On the bucket edges the two disagree by one bucket in 156 of
    6,192 values; the port's cpu backend (the copied numpy functions)
    matches the reference's numpy, its device path XLA."""
    v = _edge_values()
    xla = np.asarray(jax.jit(lambda x: ref_agg.ddsk_bucket_indexes(jnp, x))(v))
    ref_np = ref_agg.ddsk_bucket_indexes(np, v)
    np.testing.assert_array_equal(port_agg.ddsk_bucket_indexes(np, v), ref_np)
    np.testing.assert_array_equal(
        sb.ddsk_bucket_indexes(torch.from_numpy(v)).numpy(), xla)
    split = xla != ref_np
    assert int(split.sum()) == 156
    assert np.abs(xla.astype(np.int64) - ref_np)[split].max() == 1
    assert v[np.argmax(split)] == 1.5678788438269684e-05


def test_sketch_header_constants_match_the_planner():
    with open(os.path.join(os.path.dirname(sb.__file__), "..", "csrc",
                           "sketch.cuh")) as f:
        src = f.read()

    def const(name):
        m = re.search(rf"#define {name} \(?([-0-9a-fx.p+]+)\)?", src)
        return m.group(1)
    assert float.fromhex(const("DDSK_LOG_MIN")) == port_agg.DDSK_LOG_MIN
    assert float.fromhex(const("DDSK_INV_LNG")) == sb.DDSK_INV_LNG
    assert int(const("HLL_M")) == port_agg.HLL_M == SKETCH_M["hll"]
    assert int(const("DDSK_M")) == port_agg.DDSK_M == SKETCH_M["ddsk"]
    assert int(const("TOPK_M")) == port_agg.TOPK_M == SKETCH_M["topk"]


# ----------------------------------------------------------- the folds

SKETCH_QUERIES = {
    "s1_int_decimal": (
        "SELECT count(*), approx_count_distinct(k), approx_percentile(0.5) "
        "WITHIN GROUP (ORDER BY p), approx_top_k(sk, 10) FROM t "
        "WHERE d >= date '1995-01-01' AND d < date '1996-01-01'"),
    "float_text_date": (
        "SELECT approx_count_distinct(f), approx_count_distinct(s), "
        "approx_count_distinct(d), approx_percentile(0.9) WITHIN GROUP "
        "(ORDER BY f), sum(f), count(f) FROM t"),
    "real_nulls": (
        "SELECT approx_count_distinct(r), approx_percentile(0.1) WITHIN "
        "GROUP (ORDER BY r), approx_top_k(q, 3), min(q) FROM t WHERE f > 0"),
}


@pytest.fixture(scope="module")
def catalogs(tmp_path_factory):
    """One data directory written by citus_tpu, opened by both packages."""
    d = str(tmp_path_factory.mktemp("db"))
    ref = ct.Cluster(d)
    _fill(ref, 600)
    port = ctt.Cluster(d, device="cpu")
    yield ref.catalog, port.catalog
    port.close()
    ref.close()


def _fill(cl, n):
    cl.execute("CREATE TABLE t (k bigint, sk bigint, p decimal(12,2), "
               "f double, r real, s text, d date, q int)")
    cl.execute("SELECT create_distributed_table('t', 'k', 4)")
    rng = np.random.default_rng(3)
    f = rng.standard_normal(n) * 100
    f[:6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-300]
    cl.copy_from("t", columns={
        "k": rng.integers(0, 10_000, n), "sk": rng.integers(1, 40, n),
        "p": rng.integers(90_000, 10_500_000, n) / 100.0,
        "f": [None if i % 29 == 0 else float(x) for i, x in enumerate(f)],
        "r": [None if i % 31 == 0 else float(x) for i, x in
              enumerate(rng.random(n).astype(np.float32))],
        "s": [None if i % 23 == 0 else f"w{i % 41}" for i in range(n)],
        "d": (rng.integers(0, 2526, n) + 8036).astype(np.int32),
        "q": [None if i % 19 == 0 else int(x) for i, x in
              enumerate(rng.integers(-5, 50, n))]})


def _plans(catalogs, sql):
    rcat, pcat = catalogs
    rp = ref_plan(rcat, ref_bind(rcat, ref_parse(sql)[0]))
    pp = plan_select(pcat, bind_select(pcat, parse_sql(sql)[0]))
    return rp, pp


def _batch(plan, seed, mask_case="rows"):
    """numpy batch in the plan's scan columns with nulls and special
    floats; padding rows are zero, valid, and masked out."""
    rng = np.random.default_rng(seed)
    schema = plan.bound.table.schema
    cols, valids = [], []
    for c in plan.scan_columns:
        dt = schema.scan_dtype(c, device=True)
        if np.issubdtype(dt, np.floating):
            v = rng.standard_normal(N_PAD) * 10.0 ** rng.integers(-3, 6, N_PAD)
            idx = rng.integers(0, N_REAL, 40)
            v[idx[:10]] = np.nan
            v[idx[10:18]] = np.inf
            v[idx[18:24]] = -np.inf
            v[idx[24:32]] = -0.0
            v[idx[32:]] = 1e-300
        elif c == "d":
            v = rng.integers(8036, 10562, N_PAD)
        elif c == "sk":
            v = rng.integers(1, 40, N_PAD)
        else:
            v = rng.integers(-10**7, 10**7, N_PAD)
            v[:2] = [0, -1]
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


def _tensors(cols, valids):
    return (tuple(torch.from_numpy(c) for c in cols),
            tuple(torch.from_numpy(v) for v in valids))


def _assert_same_registers(plan, got, want):
    for op, g, w in zip(plan.partial_ops, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (op, g.shape, w.shape)
        if op.kind == "sum" and np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(op))


@pytest.mark.parametrize("mask_case", ["rows", "all_false"])
@pytest.mark.parametrize("case", sorted(SKETCH_QUERIES))
def test_sketch_fold_matches_jax(catalogs, case, mask_case):
    rp, pp = _plans(catalogs, SKETCH_QUERIES[case])
    assert rp.group_mode.kind == pp.group_mode.kind == "scalar"
    assert {"hll", "ddsk", "topk", "topkv"} & {op.kind for op in pp.partial_ops}
    batches = [_batch(rp, seed, mask_case) for seed in (1, 2)]
    fused = build_fused_worker_fn(pp, TorchNamespace("cpu"))
    acc = empty_device_partials(pp, "cpu")
    for cols, valids, mask in batches:
        acc = fused(acc, *_tensors(cols, valids), torch.from_numpy(mask))
    got = [a.numpy() for a in acc]
    want = _run_ref(rp, batches)
    _assert_same_registers(rp, got, want)
    if mask_case == "rows":
        assert any(g.any() for op, g in zip(pp.partial_ops, got)
                   if op.kind in ("hll", "ddsk", "topk"))


@pytest.mark.parametrize("case", sorted(SKETCH_QUERIES))
def test_batched_sketch_fold_matches_jax_per_query(catalogs, case):
    """The batched fold's row q equals the reference's fused worker run
    with query q's mask as its row mask (the per-query filter result
    the batched predicate kernel hands the batched fold)."""
    sql = SKETCH_QUERIES[case].split(" WHERE ")[0]
    rp, pp = _plans(catalogs, sql)
    q = 3
    batches = [_batch(rp, seed) for seed in (3, 4)]
    rng = np.random.default_rng(9)
    masks = [rng.random((q, N_PAD)) > 0.4 for _ in batches]
    for m in masks:
        m[:, N_REAL:] = False
    prog = FoldProgram.of_plan(pp, {})
    regs, rows = megabatch._empty_stacked_partials(pp, q, "cpu")
    assert rows is None and prog.n_groups == 1
    for (cols, valids, _), m in zip(batches, masks):
        tcols, tvalids = _tensors(cols, valids)
        scan_agg_fold_batched(prog, regs, rows,
                              dict(zip(pp.scan_columns, zip(tcols, tvalids))),
                              torch.from_numpy(m))
    for qi in range(q):
        want = _run_ref(rp, [(cols, valids, m[qi])
                             for (cols, valids, _), m in zip(batches, masks)])
        got = [r[qi].numpy() if op.kind in SKETCH_M else r[qi, 0].numpy()
               for op, r in zip(pp.partial_ops, regs)]
        _assert_same_registers(rp, got, want)


def _sketch_call(device, n, q=None, seed=0):
    """One fold's inputs with every sketch op over int and float
    arguments (NaN, +-inf, +-0.0, 1e-300, bucket edges, INT64_MIN/MAX
    bits, nulls), n not a multiple of the block."""
    rng = np.random.default_rng(seed)
    f = rng.integers(90_000, 10_500_000, n) / 100.0
    special = np.concatenate([[np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-300,
                               5e-324], _edge_values()[:64]])
    f[:special.size] = special
    i = rng.integers(1, 10_001, n)
    i[:4] = [I64.min, I64.max, 0, -1]
    valid = rng.random(n) > 0.05

    def to(a):
        return torch.from_numpy(a).to(device)
    args = [(to(f), to(valid)), (to(i), None)]
    ops = [FoldOp("count_star"), FoldOp("hll", 1), FoldOp("ddsk", 0),
           FoldOp("topk", 1), FoldOp("topkv", 1), FoldOp("hll", 0),
           FoldOp("sum", 0), FoldOp("count", 0)]
    pre = () if q is None else (q,)
    acc = []
    for op in ops:
        if op.kind in SKETCH_M:
            fill = I64.min if op.kind == "topkv" else 0
            dt = torch.int32 if op.kind == "hll" else torch.int64
            acc.append(torch.full(pre + (SKETCH_M[op.kind],), fill,
                                  dtype=dt, device=device))
        else:
            dt = torch.float64 if op.kind == "sum" else torch.int64
            acc.append(torch.zeros(pre + (1,), dtype=dt, device=device))
    shape = (n,) if q is None else (q, n)
    mask = to(rng.random(shape) > 0.3)
    return acc, mask, args, ops


def test_plain_sketch_fold_matches_numpy_oracle():
    """The plain version's registers against the port's numpy bucket
    functions with ufunc.at scatters (the cpu backend's oracle), away
    from the bucket edges where the two backends may part."""
    acc, mask, args, ops = _sketch_call("cpu", 5003, seed=4)
    (f, fv), (i, _) = args
    f[:71] = 1.0
    scan_agg_fold_plain(acc, None, mask, [], args, ops, 1)
    m, f, fv, i = mask.numpy(), f.numpy(), fv.numpy(), i.numpy()
    ok = m & fv
    b, rho = port_agg.hll_rho_buckets(np, i, m)
    hll = np.zeros(128, np.int32)
    np.maximum.at(hll, b, rho)
    np.testing.assert_array_equal(acc[1].numpy(), hll)
    ddsk = np.bincount(port_agg.ddsk_bucket_indexes(np, f)[ok], minlength=2048)
    np.testing.assert_array_equal(acc[2].numpy(), ddsk)
    tb = port_agg.topk_buckets(np, i)
    np.testing.assert_array_equal(acc[3].numpy(),
                                  np.bincount(tb[m], minlength=1024))
    tv = np.full(1024, I64.min)
    np.maximum.at(tv, tb[m], i[m])
    np.testing.assert_array_equal(acc[4].numpy(), tv)
    assert acc[0].item() == m.sum() and acc[7].item() == ok.sum()


@pytest.mark.cuda
@pytest.mark.parametrize("q", [None, 2, 8])
def test_sketch_fold_matches_plain_on_card(q):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    n = (1 << 20) + 3
    acc_k, mask, args, ops = _sketch_call("cuda", n, q, seed=11)
    acc_p, *_ = _sketch_call("cuda", n, q, seed=11)
    prog = FoldProgram(
        FoldExprs(None, (), (BColumn("f", T.FLOAT64_T),
                             BColumn("i", T.INT64_T))),
        ops, {"f": np.float64, "i": np.int64}, {})
    cols = dict(zip(("f", "i"), args))
    if q is None:
        scan_agg_fold(prog, acc_k, None, cols, {}, mask)
        fold_plain(prog, acc_p, None, cols, {}, mask)
    else:
        scan_agg_fold_batched(prog, acc_k, None, cols, mask)
        fold_batched_plain(prog, acc_p, None, cols, mask)
    torch.cuda.synchronize()
    for op, k, p in zip(ops, acc_k, acc_p):
        if op.kind == "sum":
            torch.testing.assert_close(k, p, rtol=1e-12, atol=0,
                                       equal_nan=True)
        else:
            assert torch.equal(k, p), op


# ------------------------------------------------------------------ SQL

SQL_QUERIES = list(SKETCH_QUERIES.values()) + [
    "SELECT approx_top_k(k, 5), approx_percentile(0.25) WITHIN GROUP "
    "(ORDER BY k), approx_count_distinct(p) FROM t WHERE f > 0",
    "SELECT approx_percentile(0.99) WITHIN GROUP (ORDER BY p), "
    "approx_count_distinct(q) FROM t WHERE s = 'w3'",
    "SELECT count(*), approx_count_distinct(k) FROM t WHERE k < 0",
    "SELECT sk % 3, approx_count_distinct(k), approx_top_k(q, 2) FROM t "
    "GROUP BY sk % 3 ORDER BY 1",
]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The same rows loaded by each package into its own directory."""
    ref = ct.Cluster(str(tmp_path_factory.mktemp("ref")))
    port = ctt.Cluster(str(tmp_path_factory.mktemp("port")), device="cpu")
    for cl in (ref, port):
        _fill(cl, 2000)
    yield ref, port
    port.close()
    ref.close()


@pytest.mark.parametrize("sql", SQL_QUERIES)
def test_sketch_sql_identical_to_reference(pair, sql):
    ref, port = pair
    got = port.execute(sql)
    assert_same_rows(got.rows, ref.execute(sql).rows)
    if "GROUP BY" not in sql:
        assert got.explain["strategy"] == "scalar"


def _fanout(cl, sqls):
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


def test_sketch_family_coalesces_with_serial_rows(pair):
    ref, port = pair
    sqls = [f"SELECT count(*), approx_count_distinct(k), approx_percentile"
            f"(0.5) WITHIN GROUP (ORDER BY p), approx_top_k(sk, 10) FROM t "
            f"WHERE d >= date '{y}-01-01' AND d < date '{y + 1}-01-01'"
            for y in (1993, 1994, 1995, 1996)]
    serial = [port.execute(s).rows for s in sqls]
    for got, s in zip(serial, sqls):
        assert_same_rows(got, ref.execute(s).rows)
    port.execute("SET citus.megabatch_window_ms = 1000")
    port.execute(f"SET citus.megabatch_max_size = {len(sqls)}")
    try:
        s0 = GLOBAL_MEGABATCH.stats()
        got, errors = _fanout(port, sqls)
        s1 = GLOBAL_MEGABATCH.stats()
    finally:
        port.execute("SET citus.megabatch_window_ms = 0")
    assert errors == {}
    for i, want in enumerate(serial):
        assert_same_rows(got[i], want)
    assert 1 <= s1["batches"] - s0["batches"] < len(sqls)
    view = port.execute("SELECT citus_megabatch_stats()")
    row = dict(zip(view.columns, view.rows[0]))
    assert row["avg_occupancy"] > 1
    assert "sketch_partials" not in row["ineligible"]


def test_chip_smoke_sketch_helpers_rehearse_on_cpu(tmp_path):
    """chip_smoke.py's sketch code paths at a tiny size on the CPU, with
    the plain version on both sides: S1's fold inputs, the adversarial
    case and the S family's batched inputs through compare_fold; the S1
    oracle against the port's rows; the rollup oracle and the routed
    dashboard check against a rollup the port built and refreshed."""
    import chip_smoke as cs
    from citus_tpu_torch.executor.megabatch import _empty_stacked_partials
    from citus_tpu_torch.ops.filter_mask import filter_mask_batched
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    splans = cs.sketch_plans("cpu", str(tmp_path), n=4096)
    plan, params = splans["family"]
    assert len(params) == 8 and plan.group_mode.kind == "scalar"
    cols, valids, row_mask = cs.padded_batch("cpu", plan, splans["physical"])
    prog, stacked = cs.family_filter("cpu", plan, params)
    masks = filter_mask_batched(
        prog, cs.predicate_columns(plan, prog, cols, valids), stacked,
        row_mask)
    regs, rows = _empty_stacked_partials(plan, 8, "cpu")
    batched = (FoldProgram.of_plan(plan, {}), regs, rows,
               dict(zip(plan.scan_columns, zip(cols, valids))), masks)
    for name, call, kernel, plain in (
            ("S1", splans["s1_call"], scan_agg_fold, fold_plain),
            ("adversarial", cs.adversarial_sketch_call("cpu", 8003),
             scan_agg_fold, fold_plain),
            ("adversarial Q=2", cs.adversarial_sketch_call("cpu", 8003, q=2),
             scan_agg_fold_batched, fold_batched_plain),
            ("S family", batched, scan_agg_fold_batched,
             fold_batched_plain)):
        assert cs.compare_fold(name, call, kernel, plain) == 0.0
        assert cs.sketch_fold_ops(call) > cs.fold_masks(call).numel()
    port = ctt.Cluster(str(tmp_path / "s"), device="cpu")
    try:
        port.execute(cs.S_DDL)
        port.execute("SELECT create_distributed_table('lineitem', "
                     "'l_suppkey', 4)")
        chunks = list(cs.sketch_chunks(6000, 11, 6000))
        for c in chunks:
            port.copy_from("lineitem", columns=cs.sketch_copy_columns(c))
        data = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
        assert port.execute(cs.S1).rows == cs.oracle_s1(data)
        lo, hi = cs.S_RANGES[-1]
        assert port.execute(cs.s_variant(lo, hi)).rows == \
            cs.oracle_s1(data, lo, hi)
        port.execute("SET citus.enable_change_data_capture = on")
        port.execute(f"SELECT citus_create_rollup('li_r', 'lineitem', "
                     f"'l_suppkey', '{cs.ROLLUP_AGGS}')")
        delta = list(cs.sketch_chunks(2000, 12, 6000))
        port.copy_from("lineitem", columns=cs.sketch_copy_columns(delta[0]))
        assert port.execute("SELECT citus_refresh_rollups()").rows == [(2000,)]
        allc = {k: np.concatenate([data[k], delta[0][k]]) for k in data}
        groups, dash = cs.check_rollup_state(port, allc)
        assert groups == dash == len(np.unique(allc["suppkey"]))
    finally:
        port.close()
