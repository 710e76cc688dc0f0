"""The device merge of a peer's hash table (``hash_agg_merge``), held
against the JAX package's ``build_fused_entry_merge``.

A pushed hash GROUP BY task ships back the peer's whole hash table
(key values, int8 key flags, partial registers, row counts); the
coordinator re-inserts its occupied entries into its own running table.

- ``hash_agg_merge_plain`` against the reference's jitted
  ``build_fused_entry_merge`` on the same seeded table and entries (both
  tables filled by the reference's insert, so the entries are in the
  reference's layout: dtype-minimum keys and flag 0 in empty slots).
  The plain version claims exactly as the reference does, so the merged
  tables and entry spill masks must be identical (float sums within rel
  1e-12); the groups after the host merge of table, the coordinator's
  spilled rows and the spilled entries must be equal too.
- The same with the peer's table filled by the port's own insert (the
  port's layout), compared by merged groups.
- Cases: overlapping and disjoint groups; 1,000 slots with most entries
  spilling; -0.0, NaN and NULL keys; NaN min/max partials; a mostly
  empty shipped table; an all-empty one.
- Invariants: each key sits in at most one slot, the claim words mirror
  the rows, and the rows of table plus spilled entries are conserved.
- The wrapper's parameter block on CPU tensors (what a card launch
  gets) and ``chip_smoke.py``'s phase-3 merge helpers rehearsed on the
  CPU.  ``test_merge_kernel_matches_plain_on_card`` needs a card and
  skips here.

Float sums within rel 1e-12 (added in another order), everything else
identical.
"""

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
from citus_tpu_torch.executor.host_agg import HostGroupAccumulator
from citus_tpu_torch.ops.hash_agg import (
    HashTable, build_fused_hash_worker, empty_hash_state,
    merge_hash_tables_into,
)
from citus_tpu_torch.ops.hash_agg_merge import (
    _MergeParams, _block, hash_agg_merge, hash_agg_merge_plain,
)
from citus_tpu_torch.planner import parse_sql
from citus_tpu_torch.planner.bind import bind_select
from citus_tpu_torch.planner.bound import compile_expr
from citus_tpu_torch.planner.physical import plan_select

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

MERGE_SQL = ("SELECT g, f, d, count(*), count(v), sum(v), sum(s), min(s), "
             "max(s), max(v), min(d) FROM t WHERE v > -900 GROUP BY g, f, d")
KEY_DTYPES = (np.dtype(np.int64), np.dtype(np.float64), np.dtype(np.int32))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    """A hash-mode plan of each package over one table citus_tpu wrote."""
    d = str(tmp_path_factory.mktemp("merge_plans"))
    ref = ct.Cluster(d)
    ref.execute("CREATE TABLE t (k bigint NOT NULL, g bigint, f double, "
                "d date, v bigint, s double)")
    ref.execute("SELECT create_distributed_table('t', 'k', 2)")
    ref.execute("INSERT INTO t VALUES (0, 1, 0.5, '2020-01-01', 1, 1.0), "
                "(1, 1000000000000, -1.5, '2024-01-01', -5, 2.0)")
    port = ctt.Cluster(d, device="cpu")
    rp = ref_plan(ref.catalog, ref_bind(ref.catalog, ref_parse(MERGE_SQL)[0]))
    pp = plan_select(port.catalog, bind_select(port.catalog,
                                               parse_sql(MERGE_SQL)[0]))
    assert rp.group_mode.kind == pp.group_mode.kind == "hash_host"
    assert [op.kind for op in pp.partial_ops] \
        == [op.kind for op in rp.partial_ops]
    yield rp, pp
    port.close()
    ref.close()


def _batches(seed, groups, pool_seed, n_batches=2, n=2500):
    """Batches of (g, f, d, v, s) drawn from a pool of ``groups`` keys
    (``pool_seed`` picks the pool: one seed for overlapping groups,
    two for disjoint ones), with NULL, -0.0 and NaN keys and NaN
    arguments."""
    pool = np.random.default_rng(pool_seed)
    gk = pool.integers(0, 10**12, groups)
    fk = pool.normal(0, 10, groups)
    fk[:6] = [0.0, -0.0, np.nan, np.nan, 1.5, -1.5]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        pick = rng.integers(0, groups, n)
        f = fk[pick].copy()
        f[rng.random(n) < 0.05] = -0.0
        f[rng.random(n) < 0.03] = np.array(
            [0x7FF0000000000001], np.uint64).view(np.float64)[0]
        s = rng.normal(0, 100, n)
        s[rng.random(n) < 0.02] = np.nan
        cols = {"g": gk[pick], "f": f,
                "d": (18000 + pick % 37).astype(np.int32),
                "v": rng.integers(-1000, 1000, n), "s": s}
        valids = {c: rng.random(n) > 0.04 for c in cols}
        row_mask = np.ones(n, bool)
        row_mask[-40:] = False
        out.append((cols, valids, row_mask))
    return out


def _ref_insert(plan, S, batches):
    """The reference's streaming insert.  -> (its state (key tables,
    partials, rows) as numpy, the spill mask of each batch)."""
    fused = jax.jit(ref_hash.build_fused_hash_worker(plan, jnp, KEY_DTYPES))
    state = jax.device_put(ref_hash.empty_hash_state(plan, S, KEY_DTYPES))
    spills = []
    for cols, valids, row_mask in batches:
        state, spill = fused(
            state, tuple(jnp.asarray(cols[c]) for c in plan.scan_columns),
            tuple(jnp.asarray(valids[c]) for c in plan.scan_columns),
            jnp.asarray(row_mask))
        spills.append(np.asarray(spill))
    keys, parts, rows = jax.device_get(state)
    return ([(np.asarray(v), np.asarray(f)) for v, f in keys],
            [np.asarray(p) for p in parts], np.asarray(rows)), spills


def _add_spills(acc, plan, compile_fn, batches, spills) -> None:
    """Spilled rows of an insert into a host accumulator."""
    key_fns = [compile_fn(k, np) for k in plan.bound.group_keys]
    arg_fns = [compile_fn(a, np) for a in plan.agg_args]
    for (cols, valids, _), spill in zip(batches, spills):
        env = {c: (cols[c], valids[c]) for c in plan.scan_columns}
        acc.add_batch(spill, [f(env) for f in key_fns],
                      [f(env) for f in arg_fns])


def _port_insert(plan, S, batches, acc):
    """The port's streaming insert (plain version); spilled rows into
    ``acc``.  -> its HashTable."""
    fused = build_fused_hash_worker(plan, KEY_DTYPES)
    table = empty_hash_state(plan, S, KEY_DTYPES, "cpu")
    key_fns = [compile_expr(k, np) for k in plan.bound.group_keys]
    arg_fns = [compile_expr(a, np) for a in plan.agg_args]
    for cols, valids, row_mask in batches:
        spill = fused(table,
                      tuple(torch.from_numpy(cols[c]) for c in plan.scan_columns),
                      tuple(torch.from_numpy(valids[c])
                            for c in plan.scan_columns),
                      torch.from_numpy(row_mask)).numpy()
        env = {c: (cols[c], valids[c]) for c in plan.scan_columns}
        acc.add_batch(spill, [f(env) for f in key_fns],
                      [f(env) for f in arg_fns])
    return table


def _as_table(state) -> HashTable:
    """A reference state as the port's HashTable (the same layout plus
    the claim words)."""
    keys, parts, rows = state
    rows = torch.from_numpy(rows.copy())
    return HashTable([torch.from_numpy(v.copy()) for v, _ in keys],
                     [torch.from_numpy(f.copy()) for _, f in keys],
                     [torch.from_numpy(p.copy()) for p in parts], rows,
                     2 * (rows > 0).to(torch.int32))


def _entries(state):
    """A shipped table (host arrays) as the merge's torch inputs."""
    keys, parts, rows = state
    return ([(torch.from_numpy(np.array(v)), torch.from_numpy(np.array(f)))
             for v, f in keys],
            [torch.from_numpy(np.array(p)) for p in parts],
            torch.from_numpy(np.array(rows)))


def _group_dict(acc, plan):
    keys, parts = acc.finalize([k.type for k in plan.bound.group_keys])
    out = {}
    if not keys:
        return out
    for gi in range(len(keys[0][0])):
        key = []
        for vals, valid in keys:
            v = vals[gi]
            key.append(None if not valid[gi] else
                       ("nan" if isinstance(v, float) and math.isnan(v)
                        else v.item() if hasattr(v, "item") else v))
        out[tuple(key)] = tuple(np.asarray(p)[gi].item() for p in parts)
    return out


def _assert_same_groups(got, want):
    assert got.keys() == want.keys()
    for k in want:
        for a, b in zip(got[k], want[k]):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-12, nan_ok=True), k
            else:
                assert a == b, k


def _assert_invariants(table, before_rows: int, entry_rows, spill):
    assert torch.equal(table.state, 2 * (table.rows > 0).to(torch.int32))
    shipped = int(entry_rows.sum())
    assert int(table.rows.sum()) + int(entry_rows[spill].sum()) \
        == before_rows + shipped
    occ = (table.rows > 0).numpy()
    seen = set()
    for i in np.nonzero(occ)[0]:
        k = tuple("nan" if kf[i] == 2 and isinstance(kv[i].item(), float)
                  and math.isnan(kv[i].item())
                  else (kv[i].item() if kf[i] == 2 else None)
                  for kv, kf in zip(table.key_values, table.key_flags))
        assert k not in seen  # each key sits in at most one slot
        seen.add(k)


#: (name, coordinator slots, peer slots, groups, pool seed of each side)
CASES = [
    ("overlap", 1024, 1024, 600, (1, 1)),
    ("disjoint", 1024, 1024, 300, (2, 3)),
    ("spill", 1000, 1000, 5000, (4, 4)),
    ("mostly_empty", 1024, 4099, 50, (5, 5)),
]


def _ref_merge(rp, coord, peer):
    """The reference's merge door, jitted as its executor jits it.
    -> ((key tables, partials, rows), entry spill) as numpy."""
    merge = jax.jit(ref_hash.build_fused_entry_merge(rp, jnp, KEY_DTYPES))
    (rk, rpart, rrows), spill = merge(
        jax.device_put((tuple(tuple(k) for k in coord[0]), tuple(coord[1]),
                        coord[2])),
        tuple((jnp.asarray(v), jnp.asarray(f)) for v, f in peer[0]),
        tuple(jnp.asarray(p) for p in peer[1]), jnp.asarray(peer[2]))
    return (([(np.asarray(v), np.asarray(f)) for v, f in rk],
             [np.asarray(p) for p in rpart], np.asarray(rrows)),
            np.asarray(spill))


def _ref_groups(rp, coord_batches, coord_spills, merged, peer, ref_spill):
    """Groups of the reference: merged table, the coordinator's spilled
    rows and the peer's spilled entries, through its host accumulator."""
    acc = RefAcc(len(rp.bound.group_keys), rp.partial_ops)
    _add_spills(acc, rp, ref_compile, coord_batches, coord_spills)
    ref_hash.merge_hash_tables_into(acc, rp, *merged)
    ref_hash.merge_hash_tables_into(acc, rp, *peer, entry_mask=ref_spill)
    return _group_dict(acc, rp)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_merge_matches_reference_entry_merge(plans, case):
    name, S, S_peer, groups, (pa, pb) = case
    rp, pp = plans
    cb = _batches(10 + S, groups, pa)
    coord, coord_spills = _ref_insert(rp, S, cb)
    peer, _ = _ref_insert(rp, S_peer, _batches(20 + S, groups, pb))
    assert int(peer[2].sum()) > 0
    merged, ref_spill = _ref_merge(rp, coord, peer)
    # the port's merge (its plain version on CPU tensors) on the same
    # table and entries: the same claims, so the same table and spill
    table = _as_table(coord)
    before = int(table.rows.sum())
    keys, parts, rows = _entries(peer)
    spill = hash_agg_merge(table, keys, parts, rows,
                           [op.kind for op in pp.partial_ops])
    np.testing.assert_array_equal(spill.numpy(), ref_spill)
    np.testing.assert_array_equal(table.rows.numpy(), merged[2])
    for (kv, kf), tv, tf in zip(merged[0], table.key_values, table.key_flags):
        np.testing.assert_array_equal(tv.numpy().view(np.uint8),
                                      kv.view(np.uint8))
        np.testing.assert_array_equal(tf.numpy(), kf)
    for op, want, got in zip(pp.partial_ops, merged[1], table.partials):
        if op.kind == "sum" and want.dtype.kind == "f":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                       equal_nan=True)
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    _assert_invariants(table, before, rows, spill)
    if name == "spill":
        assert int(spill.sum()) > int((rows > 0).sum()) // 2
    if name == "mostly_empty":
        assert int((rows == 0).sum()) > 0.9 * rows.numel()
    # merged groups: table + coordinator spill + spilled entries
    acc = HostGroupAccumulator(len(pp.bound.group_keys), pp.partial_ops)
    _add_spills(acc, pp, compile_expr, cb, coord_spills)
    merge_hash_tables_into(acc, pp, *table.to_host())
    merge_hash_tables_into(acc, pp, *peer, entry_mask=spill.numpy())
    _assert_same_groups(_group_dict(acc, pp),
                        _ref_groups(rp, cb, coord_spills, merged, peer,
                                    ref_spill))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_merge_of_port_layout_peer_matches_reference_groups(plans, case):
    """Both tables filled by the port's own insert (the port's layout and
    claims): the groups after the merge equal the reference's merge of
    its own tables over the same rows."""
    _name, S, S_peer, groups, (pa, pb) = case
    rp, pp = plans
    cb, pbat = _batches(10 + S, groups, pa), _batches(20 + S, groups, pb)
    coord, coord_spills = _ref_insert(rp, S, cb)
    peer, peer_spills = _ref_insert(rp, S_peer, pbat)
    merged, ref_spill = _ref_merge(rp, coord, peer)
    want = _ref_groups(rp, cb + pbat, coord_spills + peer_spills, merged,
                       peer, ref_spill)

    acc = HostGroupAccumulator(len(pp.bound.group_keys), pp.partial_ops)
    table = _port_insert(pp, S, cb, acc)
    peer_table = _port_insert(pp, S_peer, pbat, acc)
    shipped = peer_table.to_host()
    before = int(table.rows.sum())
    keys, parts, rows = _entries(shipped)
    spill = hash_agg_merge_plain(table, keys, parts, rows,
                                 [op.kind for op in pp.partial_ops])
    _assert_invariants(table, before, rows, spill)
    merge_hash_tables_into(acc, pp, *table.to_host())
    merge_hash_tables_into(acc, pp, *shipped, entry_mask=spill.numpy())
    _assert_same_groups(_group_dict(acc, pp), want)


def test_all_empty_entries_touch_nothing(plans):
    """A shipped table with no occupied entry (an empty shard) — even
    with garbage keys under flag 0 — leaves the table as it was."""
    _, pp = plans
    acc = HostGroupAccumulator(len(pp.bound.group_keys), pp.partial_ops)
    table = _port_insert(pp, 64, _batches(3, 40, 3, n_batches=1), acc)
    snap = [t.clone() for t in table.key_values + table.key_flags
            + table.partials + [table.rows, table.state]]
    M = 301
    rng = np.random.default_rng(0)
    keys = [(torch.from_numpy(rng.integers(-9, 9, M)), torch.zeros(M, dtype=torch.int8)),
            (torch.from_numpy(rng.normal(0, 1, M)), torch.zeros(M, dtype=torch.int8)),
            (torch.from_numpy(rng.integers(-9, 9, M).astype(np.int32)),
             torch.zeros(M, dtype=torch.int8))]
    parts = [torch.from_numpy(rng.integers(0, 9, M).astype(p.numpy().dtype))
             for p in table.partials]
    spill = hash_agg_merge(table, keys, parts, torch.zeros(M, dtype=torch.int64),
                           [op.kind for op in pp.partial_ops])
    assert not spill.any()
    for a, b in zip(snap, table.key_values + table.key_flags
                    + table.partials + [table.rows, table.state]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_merge_param_block_checks_and_layout(plans):
    """The card launch's parameter block, built on CPU tensors: one key
    and flag column per key table, one partial column per register, the
    kinds' codes; mismatched dtypes and shapes raise before a launch."""
    _, pp = plans
    table = empty_hash_state(pp, 128, KEY_DTYPES, "cpu")
    M = 77
    keys = [(torch.zeros(M, dtype=torch.int64), torch.zeros(M, dtype=torch.int8)),
            (torch.zeros(M, dtype=torch.float64), torch.zeros(M, dtype=torch.int8)),
            (torch.zeros(M, dtype=torch.int32), torch.zeros(M, dtype=torch.int8))]
    parts = [torch.zeros(M, dtype=p.dtype) for p in table.partials]
    rows = torch.zeros(M, dtype=torch.int64)
    kinds = [op.kind for op in pp.partial_ops]
    spill = torch.zeros(M, dtype=torch.bool)
    mp = _block(table, keys, parts, rows, kinds, spill)
    assert isinstance(mp, _MergeParams)
    assert (mp.t.n, mp.t.slots, mp.t.n_keys, mp.t.n_ops) == (
        M, 128, 3, len(kinds))
    assert mp.entry_rows == rows.data_ptr()
    assert [mp.entry_flags[i] for i in range(3)] == [f.data_ptr()
                                                     for _, f in keys]
    assert [mp.t.op_arg[i] for i in range(len(kinds))] == list(range(len(kinds)))
    bad = [(torch.zeros(M, dtype=torch.int32), keys[0][1])] + keys[1:]
    with pytest.raises(ValueError):
        _block(table, bad, parts, rows, kinds, spill)
    with pytest.raises(ValueError):
        _block(table, keys, parts[:-1], rows, kinds[:-1], spill)
    with pytest.raises(ValueError):
        _block(table, keys, parts, rows.to(torch.int32), kinds, spill)
    with pytest.raises(ValueError):
        _block(table, keys, parts, rows, ["hll"] + kinds[1:], spill)


@pytest.mark.parametrize("which", ["main_path", "adversarial"])
def test_chip_smoke_phase3_merge_helpers_rehearse_on_cpu(tmp_path, which):
    """chip_smoke.py's phase-3 merge cases at a small size on the CPU
    (the kernel wrapper takes its plain version here): the coordinator's
    and the peer's tables built by the insert, the merge compared with
    the plain version by merged groups, the invariants checked."""
    from citus_tpu_torch.ops.hash_agg_merge import hash_agg_merge_plain
    dev = torch.device("cpu")
    if which == "main_path":
        call, n = chip_smoke.main_path_merge_call(dev, str(tmp_path),
                                                  n=3000, slots=4096)
        assert n == 3000
    else:
        call = chip_smoke.adversarial_merge_call(dev, 5000, 1000, 1003, 7)
    err = chip_smoke.compare_merge(which, call, hash_agg_merge,
                                   hash_agg_merge_plain)
    assert err >= 0.0
    table, keys, parts, rows, kinds = call
    assert rows.shape[0] % 256 != 0 or which == "main_path"
    # one flag byte marks emptiness in both layouts; a claim moves more
    # than a match, which moves more than an entry that spills
    occupied = int((rows > 0).sum())
    entry = sum(t.element_size() for kv in keys for t in kv) \
        + sum(p.element_size() for p in parts) + 8 - 1
    assert chip_smoke.merge_bytes(call, 0, 0) == \
        rows.numel() * 2 + occupied * entry
    assert chip_smoke.merge_bytes(call, 10, 0) > \
        chip_smoke.merge_bytes(call, 0, 10) > chip_smoke.merge_bytes(call, 0, 0)
    bare = (call[0], [(keys[0][0], torch.full_like(keys[0][1], 2))]
            + list(keys[1:]), parts, rows, kinds)
    assert chip_smoke.merge_bytes(bare, 0, 0) == \
        rows.numel() * 9 + occupied * (entry + 1 - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["main_path", "adversarial"])
def test_merge_kernel_matches_plain_on_card(tmp_path, which):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    if which == "main_path":
        call, _ = chip_smoke.main_path_merge_call(dev, str(tmp_path),
                                                  n=200_000)
    else:
        call = chip_smoke.adversarial_merge_call(dev, 200_003, 1000, 1003, 7)
    launches = hash_agg_merge.launches
    chip_smoke.compare_merge(which, call, hash_agg_merge,
                             hash_agg_merge_plain)
    assert hash_agg_merge.launches == launches + 1


def test_nan_extrema_of_hash_groups_mirror_the_reference(tmp_path):
    """The reference merges a device hash table into its host
    accumulator with Python's min/max, which keep the first of a NaN and
    a number, so a hash group's min/max over NaN come out as the +-inf
    sentinels where PostgreSQL gives NaN or the number (ROADMAP.md C).
    The port mirrors it: identical rows on both backends."""
    cols = {"k": np.arange(6), "g": np.array([10**12] * 3 + [5] * 3),
            "f": np.array([np.nan, np.nan, np.nan, 1.0, np.nan, 3.0])}
    sql = "SELECT g, min(f), max(f), count(*) FROM t GROUP BY g ORDER BY g"
    got = {}
    for pkg, backends in ((ct, ("tpu", "cpu")), (ctt, ("gpu", "cpu"))):
        kw = {"device": "cpu"} if pkg is ctt else {}
        cl = pkg.Cluster(str(tmp_path / pkg.__name__), **kw)
        try:
            cl.execute("CREATE TABLE t (k bigint NOT NULL, g bigint, "
                       "f double)")
            cl.execute("SELECT create_distributed_table('t', 'k', 2)")
            cl.copy_from("t", columns=cols)
            for be in backends:
                cl.execute(f"SET citus.task_executor_backend = {be}")
                got[pkg.__name__, be == "cpu"] = cl.execute(sql).rows
        finally:
            cl.close()
    for on_cpu in (False, True):
        assert repr(got["citus_tpu_torch", on_cpu]) \
            == repr(got["citus_tpu", on_cpu])
    assert got["citus_tpu", False] == [(5, math.inf, -math.inf, 3),
                                       (10**12, math.inf, -math.inf, 3)]


def _accumulate(acc_cls, seed: int, ops):
    """Seeded merges of partial tables (keys repeating across and within
    them, NULL, -0.0 and NaN keys) with raw-row batches between them,
    through one accumulator; -> its finalized keys and partials."""
    acc = acc_cls(2, ops)
    rng = np.random.default_rng(seed)
    for step in range(6):
        n = int(rng.integers(1, 400))
        mask = rng.random(n) < 0.8
        keys = [(rng.integers(-20, 20, n), rng.random(n) < 0.9),
                (rng.choice([0.0, -0.0, 1.5, np.nan, -2.25], n),
                 rng.random(n) < 0.9)]
        if step % 3 == 2:
            acc.add_batch(mask, keys, [
                (rng.integers(-10**12, 10**12, n), rng.random(n) < 0.9),
                (rng.normal(0, 1e6, n), rng.random(n) < 0.9),
                (rng.integers(-100, 100, n).astype(np.int32), True)])
            continue
        parts = [rng.integers(-2**62, 2**62, n), rng.integers(0, 1000, n),
                 rng.normal(0, 1e9, n) * rng.choice([1, 1e-9], n),
                 rng.integers(-10**15, 10**15, n),
                 rng.integers(-10**15, 10**15, n),
                 rng.integers(-1000, 1000, n).astype(np.int32),
                 rng.normal(0, 1, n) * rng.choice([1.0, -0.0, np.nan], n)]
        acc.merge_partials(mask, keys, parts[:len(ops)],
                           np.ones(n, np.int64))
    kt = [type("K", (), {"device_dtype": np.dtype(d)})()
          for d in ("int64", "float64")]
    return acc.finalize(kt)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("float_max", [False, True],
                         ids=["array_fold", "entry_loop"])
def test_bulk_merge_of_partials_matches_the_reference_accumulator(
        seed, float_max):
    """``merge_partials`` folds sum / count and integer min / max states
    as arrays, and a float min / max entry by entry: either way the
    finalized groups are the reference accumulator's bit for bit, in the
    same order."""
    from citus_tpu.planner.physical import PartialOp as RefOp
    from citus_tpu_torch.planner.physical import PartialOp
    spec = [("sum", 0, "int64"), ("count", -1, "int64"),
            ("sum", 1, "float64"), ("min", 0, "int64"),
            ("max", 0, "int64"), ("min", 2, "int32")]
    spec += [("max", 1, "float64")] if float_max else []
    acc = HostGroupAccumulator(2, [PartialOp(*x) for x in spec])
    assert acc._bulk_merge_applies(
        [np.zeros(1, np.dtype(x[2])) for x in spec]) is not float_max
    got = _accumulate(HostGroupAccumulator, seed,
                      [PartialOp(*s) for s in spec])
    want = _accumulate(RefAcc, seed, [RefOp(*s) for s in spec])
    for (gv, gm), (wv, wm) in zip(got[0], want[0]):
        np.testing.assert_array_equal(gv.view(np.uint8), wv.view(np.uint8))
        np.testing.assert_array_equal(gm, wm)
    for g, w in zip(got[1], want[1]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
