"""The port's CDC-fed rollups (rollup/), held against the JAX package.

The same seeded rows go through both packages' ``citus_create_rollup``
(backfill) -> COPY (CDC inserts) -> ``citus_refresh_rollups`` ->
``citus_drop_rollup``, each on its own data directory, backend ``gpu``
with ``device="cpu"`` (the rollup kernel's plain version):

- the rollup tables hold identical rows: counts, integer sums and every
  sketch word identical, float sums within rel 1e-12 (another summation
  order); the routed dashboard queries answer identically; both with
  the DDSketch and the t-digest percentile backend;
- updates and deletes are counted, not folded (the append-only
  contract), in both packages alike;
- a refresh killed between its upsert and its watermark commit (fault
  point ``rollup_refresh``) rolls both back, and the next refresh folds
  the batch exactly once;
- the port's plain ``delta_partials`` against the reference's for all
  six kinds, with G not a power of two, n = 1 and an all-false ``ok``;
- a rollup created by ``citus_tpu`` in a data directory is refreshed by
  ``citus_tpu_torch`` in the same directory, and the reverse: the state
  carries across;
- top-k's table as one record a cell with strided (counts, values)
  views and one host copy, the regime's choice and its bounds, the
  batch staged as views of one buffer.
``test_rollup_delta_matches_plain_on_card`` needs a card and skips here
(``tests/test_torch_rollup_card.py`` holds the kernel on the card without
JAX).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import citus_tpu as ct
import torch

import citus_tpu_torch as ctt
from citus_tpu.rollup import kernels as ref_kernels
from citus_tpu_torch.config import Settings
from citus_tpu_torch.rollup import kernels
from citus_tpu_torch.rollup.sketches import decode_sketch
from citus_tpu_torch.testing.faults import FAULTS

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_slice import assert_same_rows  # noqa: E402

AGGS = ("count(*), sum(q), sum(f), approx_count_distinct(pk), "
        "approx_percentile(pr), approx_top_k(pk), approx_count_distinct(s)")
DASH = [
    "SELECT sk, count(*), approx_count_distinct(pk) FROM li GROUP BY sk "
    "ORDER BY sk",
    "SELECT sk, sum(q), approx_percentile(0.5) WITHIN GROUP (ORDER BY pr), "
    "approx_top_k(pk, 5) FROM li WHERE sk < 20 GROUP BY sk ORDER BY sk",
    "SELECT count(*), approx_count_distinct(s), sum(f) FROM li",
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    FAULTS.disarm()


def _open(mod, d):
    if mod is ct:
        from citus_tpu.config import Settings as RefSettings
        return ct.Cluster(d, settings=RefSettings(
            enable_change_data_capture=True, start_maintenance_daemon=False))
    return ctt.Cluster(d, device="cpu",
                       settings=Settings(enable_change_data_capture=True))


def _ingest(cl, n, seed, groups=50):
    rng = np.random.default_rng(seed)
    cl.copy_from("li", columns={
        "sk": rng.integers(0, groups, n), "pk": rng.integers(0, 40 * groups, n),
        "q": rng.integers(1, 51, n),
        "pr": rng.integers(90_000, 10_500_000, n) / 100.0,
        "f": [None if i % 13 == 0 else float(x) for i, x in
              enumerate(rng.standard_normal(n))],
        "s": [None if i % 11 == 0 else f"t{int(x)}" for i, x in
              enumerate(rng.integers(0, 300, n))]})


def _make(mod, d, n=1500):
    cl = _open(mod, d)
    cl.execute("CREATE TABLE li (sk bigint NOT NULL, pk bigint, q bigint, "
               "pr decimal(12,2), f double, s text)")
    cl.execute("SELECT create_distributed_table('li', 'sk', 4)")
    _ingest(cl, n, seed=1)
    return cl


def _rollup_rows(cl, table="li_r"):
    return sorted(cl.execute(f"SELECT * FROM {table}").rows,
                  key=lambda r: r[0])


def _lifecycle(cl, backend):
    cl.execute(f"SET citus.percentile_backend = {backend}")
    cl.execute(f"SELECT citus_create_rollup('li_r', 'li', 'sk', '{AGGS}')")
    backfill = _rollup_rows(cl)
    for seed in (2, 3, 4):
        _ingest(cl, 400, seed)
    cl.execute("UPDATE li SET q = q + 1 WHERE sk = 3")
    cl.execute("DELETE FROM li WHERE sk = 4")
    folded = cl.execute("SELECT citus_refresh_rollups()").rows
    return {"backfill": backfill, "folded": folded,
            "refreshed": _rollup_rows(cl),
            "dash": [cl.execute(q) for q in DASH],
            "view": cl.execute("SELECT citus_rollups()").rows,
            "skipped": cl.counters.snapshot().get("rollup_skipped_changes",
                                                  0)}


@pytest.mark.parametrize("backend", ["ddsketch", "tdigest"])
def test_rollup_lifecycle_identical_to_reference(tmp_path, backend):
    ref = _make(ct, str(tmp_path / "ref"))
    port = _make(ctt, str(tmp_path / "port"))
    try:
        r_skip0 = ref.counters.snapshot().get("rollup_skipped_changes", 0)
        p_skip0 = port.counters.snapshot().get("rollup_skipped_changes", 0)
        want, got = _lifecycle(ref, backend), _lifecycle(port, backend)
        assert got["folded"] == want["folded"] == [(1200,)]
        for key in ("backfill", "refreshed"):
            assert_same_rows(got[key], want[key])
            assert len(got[key]) == 50
        # updates and deletes are counted, not folded
        assert got["skipped"] - p_skip0 == want["skipped"] - r_skip0 == 2
        for g, w in zip(got["dash"], want["dash"]):
            assert g.explain["strategy"] == w.explain["strategy"] == "rollup"
            assert_same_rows(g.rows, w.rows)
        (g,), (w,) = got["view"], want["view"]
        assert g[:4] == w[:4] and g[6] == w[6] == 0
        assert g[4] == g[5]  # drained to the CDC head
        words = [r[5] for r in got["refreshed"]]
        assert all(str(x).startswith(("ddsk:", "tdg:")) for x in words)
        for cl in (ref, port):
            cl.execute("SELECT citus_drop_rollup('li_r')")
            assert cl.execute("SELECT citus_rollups()").rows == []
            assert not cl.catalog.has_table("li_r")
    finally:
        port.close()
        ref.close()


def test_refreshed_registers_equal_a_raw_scan(tmp_path):
    """The stored sketch words decode to exactly the registers the scan
    aggregates' fold builds over the same rows (rollup and raw-scan
    estimates agree)."""
    port = _make(ctt, str(tmp_path / "port"))
    try:
        port.execute("SELECT citus_create_rollup('li_r', 'li', 'sk', "
                      "'count(*), approx_count_distinct(pk), "
                      "approx_top_k(pk)')")
        _ingest(port, 700, seed=9)
        port.execute("SELECT citus_refresh_rollups()")
        port.execute("SET citus.enable_rollup_routing = off")
        for sk, n, acd, topk in _rollup_rows(port):
            raw = port.execute(
                f"SELECT count(*), approx_count_distinct(pk), approx_top_k"
                f"(pk, 64) FROM li WHERE sk = {sk}").rows[0]
            assert n == raw[0]
            from citus_tpu_torch.rollup.sketches import finalize_sketch
            assert finalize_sketch(*decode_sketch(acd))[0] == raw[1]
            assert finalize_sketch(*decode_sketch(topk), 64)[0] == raw[2]
    finally:
        port.close()


_CHILD = r"""
import os, sys
import citus_tpu_torch as ctt
from citus_tpu_torch.config import Settings
from citus_tpu_torch.testing.faults import FAULTS
db = sys.argv[1]
FAULTS.arm("rollup_refresh", kill=True)
cl = ctt.Cluster(db, device="cpu",
                 settings=Settings(enable_change_data_capture=True))
cl.execute("INSERT INTO li VALUES (1, 5, 3, 10.00, 1.0, 'kx'), "
           "(2, 6, 4, 20.00, 2.0, 'ky'), (1, 7, 3, 30.00, NULL, 'kz')")
try:
    cl.rollup_manager.run_once()
except BaseException:
    pass
os._exit(7)  # the fault never fired: the parent fails on this exit code
"""


def test_refresh_kill_between_apply_and_watermark_is_exactly_once(tmp_path):
    d = str(tmp_path / "port")
    port = _make(ctt, d, n=300)
    port.execute(f"SELECT citus_create_rollup('li_r', 'li', 'sk', '{AGGS}')")
    wm0 = port.rollup_manager.watermark("li_r")
    before = _rollup_rows(port)
    port.close()
    r = subprocess.run([sys.executable, "-c", _CHILD, d],
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       timeout=300, capture_output=True)
    assert r.returncode == 1, (r.returncode, r.stderr[-2000:])
    port = _open(ctt, d)
    try:
        # the torn transaction rolled back whole
        assert port.rollup_manager.watermark("li_r") == wm0
        assert_same_rows(_rollup_rows(port), before)
        assert port.rollup_manager.run_once() == 3
        assert port.rollup_manager.run_once() == 0
        got = {row[0]: row[1] for row in _rollup_rows(port)}
        port.execute("SET citus.enable_rollup_routing = off")
        truth = dict(port.execute(
            "SELECT sk, count(*) FROM li GROUP BY sk").rows)
        assert got == truth
    finally:
        port.close()


@pytest.mark.parametrize("mod_create,mod_refresh", [(ct, ctt), (ctt, ct)])
def test_rollup_state_carries_across_packages(tmp_path, mod_create,
                                              mod_refresh):
    """A rollup created by one package is refreshed by the other in the
    same data directory; the result equals one package doing both."""
    d, solo = str(tmp_path / "shared"), str(tmp_path / "solo")
    a = _make(mod_create, d)
    a.execute(f"SELECT citus_create_rollup('li_r', 'li', 'sk', '{AGGS}')")
    _ingest(a, 500, seed=5)
    a.close()
    b = _open(mod_refresh, d)
    try:
        assert b.execute("SELECT citus_refresh_rollups()").rows == [(500,)]
        got = _rollup_rows(b)
        dash = [b.execute(q).rows for q in DASH]
    finally:
        b.close()
    c = _make(mod_refresh, solo)
    try:
        c.execute(f"SELECT citus_create_rollup('li_r', 'li', 'sk', '{AGGS}')")
        _ingest(c, 500, seed=5)
        c.execute("SELECT citus_refresh_rollups()")
        assert_same_rows(got, _rollup_rows(c))
        for q, rows in zip(DASH, dash):
            assert_same_rows(rows, c.execute(q).rows)
    finally:
        c.close()


# ------------------------------------------------------------ the kernel


def _delta_inputs(kind, n, groups, seed, all_false=False):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, groups, n)
    ok = np.zeros(n, bool) if all_false else rng.random(n) > 0.2
    if kind == "count":
        return g, ok, None
    if kind in ("sum_float", "ddsk"):
        v = rng.standard_normal(n) * 1e3
        v[:min(n, 5)] = [np.nan, np.inf, -np.inf, -0.0, 1e-300][:min(n, 5)]
        return g, ok, v
    v = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n)
    if kind == "sum_int":
        v //= 1 << 20
    return g, ok, v


@pytest.mark.parametrize("n,groups,all_false", [
    (1, 1, False), (1000, 37, False), (4097, 300, False), (64, 5, True)])
@pytest.mark.parametrize("kind", list(kernels.KINDS))
def test_plain_delta_partials_match_reference(kind, n, groups, all_false):
    g, ok, v = _delta_inputs(kind, n, groups, 3, all_false)
    want = ref_kernels.delta_partials(kind, g, ok, groups, v)
    got = kernels.delta_partials(kind, g, ok, groups, v, device="cpu")
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, p in zip(want, got):
        w = np.asarray(w)
        assert p.dtype == w.dtype and p.shape == w.shape
        if kind == "sum_float":
            np.testing.assert_array_equal(np.isnan(p), np.isnan(w))
            np.testing.assert_allclose(p, w, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(p, w)
    if all_false:  # every table keeps its empty state
        empty = [0, np.iinfo(np.int64).min]
        for i, p in enumerate(got):
            assert (p == empty[i]).all()


def test_topk_table_is_one_record_a_cell():
    """rollup_delta's top-k pair: strided views of one [G, M, 2] int64
    record table (count, then the maximum value, adjacent), equal to the
    reference's two tables; delta_partials copies the record once and
    returns its host views."""
    g, ok, v = _delta_inputs("topk", 3000, 37, 5)
    gp = kernels._pad_to(37)
    counts, vals = kernels.rollup_delta(
        "topk", torch.from_numpy(v.astype(np.int64)),
        torch.from_numpy(g.astype(np.int32)), torch.from_numpy(ok), gp)
    assert counts.shape == vals.shape == (gp, kernels.TOPK_M)
    assert counts.stride() == vals.stride() == (2 * kernels.TOPK_M, 2)
    assert vals.data_ptr() == counts.data_ptr() + 8
    assert counts.untyped_storage().data_ptr() \
        == vals.untyped_storage().data_ptr()
    want_c, want_v = ref_kernels.delta_partials("topk", g, ok, 37, v)
    np.testing.assert_array_equal(counts.numpy()[:37], want_c)
    np.testing.assert_array_equal(vals.numpy()[:37], want_v)
    hc, hv = kernels.delta_partials("topk", g, ok, 37, v, device="cpu")
    assert hv.ctypes.data == hc.ctypes.data + 8 and hc.strides[1] == 16
    np.testing.assert_array_equal(hc, want_c)
    np.testing.assert_array_equal(hv, want_v)


@pytest.mark.parametrize("n,groups,private", [
    (32 * 16_384 - 1, 16_384, False), (32 * 16_384, 16_384, True),
    (1 << 30, 16_385, False)])
@pytest.mark.parametrize("kind", list(kernels.KINDS))
def test_regime_at_its_bounds(kind, n, groups, private):
    """The privatized regime starts at PRIVATE_MIN_ROWS_PER_GROUP rows a
    group and stops past PRIVATE_MAX_GROUPS groups (the most a block's
    shared memory holds), for count and sums only."""
    want = private and kind in kernels.PRIVATE_KINDS
    assert kernels.regime(kind, n, groups) == ("private" if want
                                               else "direct")


def test_regime_takes_the_privatized_table_for_a_backfill():
    """Count and sums of a backfill batch (2^23 rows into 16,384
    groups) fold in shared memory; a refresh batch, the sketch kinds and
    tables past a block's shared memory take global atomics."""
    G = kernels._pad_to(10_000)
    for kind in kernels.KINDS:
        assert kernels.regime(kind, 65_536, G) == "direct"
        assert kernels.regime(kind, 1 << 23, G) == (
            "private" if kind in kernels.PRIVATE_KINDS
            else "direct")
    assert kernels.regime("count", 1 << 30, 2 * G) == "direct"


def test_delta_batch_is_staged_in_one_buffer():
    """delta_partials' padded batch: values, group ids and ok flags are
    views of one buffer (on a card, one pinned host-to-device copy)."""
    g, ok, v = _delta_inputs("sum_int", 1000, 37, 3)
    vals, tg, tok = kernels._staged("sum_int", g, ok, v, 1000, 1024,
                                    torch.device("cpu"))
    base = vals.untyped_storage().data_ptr()
    assert tg.untyped_storage().data_ptr() == tok.untyped_storage(
        ).data_ptr() == base
    assert (vals.shape, tg.shape, tok.shape) == ((1024,),) * 3
    assert tg.data_ptr() - base == 8 * 1024 and tg.data_ptr() % 16 == 0
    np.testing.assert_array_equal(vals.numpy()[:1000], v)
    np.testing.assert_array_equal(tg.numpy()[:1000], g)
    assert not tok.numpy()[1000:].any()


def test_rollup_delta_refuses_bad_inputs():
    g = torch.zeros(4, dtype=torch.int32)
    ok = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        kernels.rollup_delta("ddsk", torch.zeros(4, dtype=torch.int64), g,
                             ok, 8)
    with pytest.raises(ValueError):
        kernels.rollup_delta("count", None, g.to(torch.int64), ok, 8)
    with pytest.raises(ValueError):
        kernels.rollup_delta("median", None, g, ok, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65_536, 65_531, 1_000_003, 1 << 23])
@pytest.mark.parametrize("kind", list(kernels.KINDS))
def test_rollup_delta_matches_plain_on_card(kind, n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    groups = 10_000
    g, ok, v = _delta_inputs(kind, n, groups, 7)
    dev = torch.device("cuda")
    tg = torch.from_numpy(g.astype(np.int32)).to(dev)
    tok = torch.from_numpy(ok).to(dev)
    tv = None if v is None else torch.from_numpy(
        v if kind in ("sum_float", "ddsk") else v.astype(np.int64)).to(dev)
    launches = kernels.rollup_delta.launches
    got = kernels.rollup_delta(kind, tv, tg, tok, kernels._pad_to(groups))
    assert kernels.rollup_delta.launches == launches + 1
    assert kernels.rollup_delta.last_regime == kernels.regime(
        kind, n, kernels._pad_to(groups))
    out, out2 = kernels._tables(kind, kernels._pad_to(groups), dev)
    kernels.rollup_delta_plain(kind, tv, tg, tok, out, out2)
    got = got if isinstance(got, tuple) else (got,)
    for k, p in zip(got, (out, out2)):
        if kind == "sum_float":
            torch.testing.assert_close(k, p, rtol=1e-12, atol=0)
        else:
            assert torch.equal(k, p)
