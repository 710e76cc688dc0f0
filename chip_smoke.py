"""Chip smoke test of citus_tpu_torch on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py [--rows N]

Phases, each on its own lines; any failure exits non-zero and prints no
result line:

1. the card (``nvidia-smi`` name and power limit) and the torch, CUDA
   and nvcc versions;
2. build of every CUDA kernel of the port from ``citus_tpu_torch/csrc``
   (the fold kernels with their sketch registers, the hash inserts and
   ``rollup_delta``) and of the predicate kernels generated for Q6, P1
   and the phase-5 families (one nvcc per source, all started together),
   then one more generated predicate alone, for the cold build time of
   one predicate;
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes:
   - ``scan_agg_fold`` for TPC-H Q6 (scalar mode) and Q1 (direct mode,
     G = 12, the shared-memory regime) on 2^21 generated lineitem rows
     (the padded batch of one SF1 shard of four), and a direct
     G = 65,536 fold (the global-atomics regime) with nulls, NaN, +-inf,
     +-0.0, an all-false mask and N not a multiple of the block;
   - ``hash_agg_insert`` for bench.py's ``GROUP BY l_orderkey`` (count
     and an int64 sum) on the first padded shard batch of the loaded
     lineitem into 2^20 slots (what citus.hash_agg_slots = auto gives at
     SF1), and an adversarial insert: three keys (int64; float64 with
     -0.0, NaN payloads and nulls; int32) on 1,000 slots, so most rows
     spill, a float64 sum/min/max, an all-false mask, N not a multiple
     of the block.  The merged groups (table and spilled rows through
     HostGroupAccumulator) must agree, and each key must sit in at most
     one slot with placed + spilled rows = masked rows;
   - ``filter_mask``, the predicate kernels generated from Q6's and P1's
     WHERE and from a synthetic predicate with nulls, NaN, zero divisors
     and three-valued AND/OR, on 2^21 rows: identical masks;
   - the batched kernels of the megabatch path at Q = 8 on one padded
     2^21-row batch: ``filter_mask_batched`` for the predicate of each
     phase-5 family under its 8 parameter sets (identical [Q, N] masks),
     ``scan_agg_fold_batched`` for the Q6 (scalar) and Q1 (direct)
     families (and Q1 at Q = 32, whose shared-memory table passes the
     48 KB default, and a G = 65,536 fold of 3 queries in the
     global-atomics regime), ``hash_agg_insert_batched`` for the H
     family on the first
     SF1 shard batch into 8 tables of 2^20 slots and of 1,000 slots
     (most rows spill): per query the merged groups agree, each key sits
     in at most one slot, placed + spilled = masked rows.
   - the sketch registers (approx_count_distinct, approx_percentile,
     approx_top_k) of ``scan_agg_fold`` for S1's ops on one padded
     2^21-row batch of the generated sketch table, and an adversarial
     case (NaN, +-inf, +-0.0, 1e-300, a subnormal, every DDSketch bucket
     edge and its neighbours, INT64_MIN/MAX, nulls, an all-false mask,
     N not a multiple of the block); of ``scan_agg_fold_batched`` for
     the S family at Q = 8 (global atomics) and Q = 6 (shared memory);
   - ``rollup_delta`` for all six kinds at n = 65,536 (one refresh
     batch) and n = 2^23 (SF1's backfill, padded) into 10,000 groups.
   int64 registers, keys, counts, min/max and NaN positions must be
   identical, float64 sums within rel 1e-12 (atomics add in another
   order).  Each kernel is timed (CUDA events, median) beside its bound,
   its plain version and a one-op library yardstick;
4. the main path through the port's entry points: ``Cluster(tmpdir)``
   on CUDA, bench.py's lineitem (schema, generator, seed 7) at TPC-H SF1
   (6,001,215 rows) in 4 shards, each query cold and then a second
   time: bench.py's Q6 (the second run served from the device cache);
   with ``SET citus.hash_agg_slots = auto`` as bench.py sets it, H1
   (TPC-H Q18's inner aggregate: ~1.47 M groups, more than the 2^20
   slots, so rows spill and merge on the host) and H2 (Q3's per-order
   revenue over one ship year, without its joins); and P1, a drill-down
   projection.  At SF1, bench.py's Q1 trips the engine's int64 overflow
   guard on sum_charge (a decimal(38,8) sum whose float64 shadow passes
   2^62; citus_tpu refuses it the same way): the script checks that the
   guard fires exactly where the oracle says it must, then runs Q1 cold
   and warm on 5,000,000 rows, the largest round scale the guard admits.
   Rows must equal those computed straight from the generated numpy
   arrays (exact int64 cents grouped with np.unique), each query's
   kernel must launch once per batch and no other kernel may launch;
5. literal families through ``Cluster.execute``: 8 variants of one
   query, first one after another (``citus.megabatch_window_ms = 0``,
   cold then warm), then from 8 threads at once with
   ``citus.megabatch_window_ms = 1000`` and ``megabatch_max_size = 8``
   (cold then warm): Q6 with 8 of TPC-H's substitution parameter sets,
   H2's shape over one 1995 ship month each and P1 over one ship day
   each at SF1, Q1 with DELTA 60-120 at 5,000,000 rows.  Every query's
   rows must equal the numpy oracle, the coalesced queries must ride
   batches of occupancy above 1, each of the family's batched kernels
   must launch once per shard batch per group and no other kernel.
   Wall time and queries per second of the serial and coalesced runs.
   Then, on a second SF1 table of TPC-H's sketch columns (l_orderkey,
   l_partkey, l_suppkey, l_quantity, l_extendedprice, l_shipdate; 10,000
   suppliers; distributed by l_suppkey, as a rollup by supplier needs):
   phase 4's S1 (count, approx_count_distinct, approx_percentile and
   approx_top_k over one ship year) cold and warm, one sketch fold per
   shard batch and no other kernel, rows equal to a numpy oracle built
   with the port's numpy bucket functions; phase 5's S family (S1 over
   each ship year 1992-1998 and 1995-H2), serial and coalesced;
6. rollups with change data capture on: ``citus_create_rollup`` by
   l_suppkey of count(*), sum(l_quantity), approx_count_distinct
   (l_partkey), approx_percentile(l_extendedprice) and approx_top_k
   (l_partkey) (its backfill timed), 262,144 more generated rows by COPY
   in 4 batches, ``citus_refresh_rollups()`` to the CDC head: the stored
   counts, sums and sketch registers must equal numpy's over every
   generated row, the routed dashboard query must return the oracle's
   rows, and ``rollup_delta`` must launch once per aggregate per fold.

Then a JSON line of the kernels, the card line, and as the last line
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import datetime
import decimal
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SF1_ROWS = 6_001_215
#: Q1's rows at SF1 trip the engine's int64 overflow guard (see
#: q1_guard_fires); below it Q1 answers, so its rows run at this scale
Q1_ROWS = 5_000_000
SHARDS = 4
FOLD_N = 1 << 21

# bench.py's Q1 and Q6, verbatim (tests/test_torch_slice.py holds them
# equal to bench.py's)
Q1 = """SELECT l_returnflag, l_linestatus,
  sum(l_quantity) AS sum_qty,
  sum(l_extendedprice) AS sum_base_price,
  sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
  sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
  avg(l_quantity) AS avg_qty, avg(l_extendedprice) AS avg_price,
  avg(l_discount) AS avg_disc, count(*) AS count_order
FROM lineitem WHERE l_shipdate <= date '1998-12-01' - interval '90' day
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus"""

Q6 = """SELECT sum(l_extendedprice * l_discount) AS revenue
FROM lineitem
WHERE l_shipdate >= date '1994-01-01'
  AND l_shipdate < date '1995-01-01'
  AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24"""

# TPC-H Q18's inner aggregate (H1), Q3's per-order revenue over one ship
# year without its joins (H2), and a drill-down projection (P1)
H1 = """SELECT l_orderkey, sum(l_quantity) FROM lineitem
GROUP BY l_orderkey HAVING sum(l_quantity) > 300 ORDER BY l_orderkey"""

H2 = """SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM lineitem
WHERE l_shipdate >= date '1994-01-01' AND l_shipdate < date '1995-01-01'
GROUP BY l_orderkey ORDER BY revenue DESC, l_orderkey LIMIT 10"""

P1 = """SELECT l_orderkey, l_quantity, l_extendedprice FROM lineitem
WHERE l_shipdate = date '1994-06-01' AND l_discount >= 0.09
ORDER BY l_orderkey, l_quantity, l_extendedprice"""

# phase 5: Q_BATCH literal variants of one query, the way dashboard and
# multi-tenant sessions send them: TPC-H Q6's substitution parameters
# (DATE = Jan 1 of 1993-1997, DISCOUNT 0.02-0.09, QUANTITY 24-25), Q1's
# DELTA, H2's shape over one ship month of 1995 each, P1 over one ship
# day each
Q_BATCH = 8
Q1_DELTAS = (60, 69, 78, 87, 96, 105, 114, 120)


def q6_variant(year: int, disc: int, qty: int) -> str:
    """Q6 with DATE = Jan 1 of ``year``, DISCOUNT ``disc`` cents."""
    return ("SELECT sum(l_extendedprice * l_discount) AS revenue\n"
            "FROM lineitem\n"
            f"WHERE l_shipdate >= date '{year}-01-01'\n"
            f"  AND l_shipdate < date '{year + 1}-01-01'\n"
            f"  AND l_discount BETWEEN 0.{disc - 1:02d} AND 0.{disc + 1:02d}"
            f" AND l_quantity < {qty}")


def q1_variant(delta: int) -> str:
    return Q1.replace("interval '90' day", f"interval '{delta}' day")


def h_variant(month: int) -> str:
    return ("SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) "
            "AS revenue\nFROM lineitem\n"
            f"WHERE l_shipdate >= date '1995-{month:02d}-01' AND l_shipdate "
            f"< date '1995-{month:02d}-01' + interval '1' month\n"
            "GROUP BY l_orderkey ORDER BY revenue DESC, l_orderkey LIMIT 10")


def p_variant(day: int) -> str:
    return P1.replace("1994-06-01", f"1994-06-{day:02d}")


def families() -> dict:
    """name -> (kind, [(sql, oracle(cols) -> rows)]) of phase 5."""
    def q6(i):
        year, disc, qty = 1993 + i % 5, 2 + i, 24 + i % 2
        return (q6_variant(year, disc, qty),
                lambda c: oracle_q6(c, year, disc, qty))

    def q1(i):
        delta = Q1_DELTAS[i]
        return q1_variant(delta), lambda c: oracle_q1(c, delta)

    def h(i):
        m = i + 1
        lo = _day(1995, m, 1)
        hi = _day(1995 + m // 12, m % 12 + 1, 1)
        return h_variant(m), lambda c: oracle_h2(c, lo, hi)

    def p(i):
        return p_variant(i + 1), lambda c: oracle_p1(c, i + 1)
    return {name: (kind, [make(i) for i in range(Q_BATCH)])
            for name, kind, make in (("Q6", "scalar", q6),
                                     ("H", "hash_host", h),
                                     ("P", "projection", p),
                                     ("Q1", "direct", q1))}


LINEITEM_DDL = """CREATE TABLE lineitem (
        l_orderkey bigint NOT NULL, l_quantity decimal(12,2),
        l_extendedprice decimal(12,2), l_discount decimal(12,2),
        l_tax decimal(12,2), l_returnflag text, l_linestatus text,
        l_shipdate date)"""

RF = np.array(["A", "N", "R"])
LS = np.array(["F", "O"])

#: H100 SXM device-memory rate (NVIDIA data sheet), for the bound
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores, for the operations
#: bound of integer and float64 folds (a lower bound on their time)
SIMT_OPS_PER_S = 67e12


def say(*parts) -> None:
    print(*parts, flush=True)


def lineitem_chunks(n_rows: int):
    """bench.py's ensure_data generator (seed 7, 1M-row chunks), as the
    integer arrays it draws: cents, flag indexes, day numbers."""
    rng = np.random.default_rng(7)
    chunk = 1_000_000
    for start in range(0, n_rows, chunk):
        n = min(chunk, n_rows - start)
        yield {
            "orderkey": rng.integers(0, n_rows // 4, n),
            "qty": rng.integers(100, 5100, n),
            "price": rng.integers(90_000, 10_500_000, n),
            "disc": rng.integers(0, 11, n),
            "tax": rng.integers(0, 9, n),
            "rf": rng.integers(0, 3, n),
            "ls": rng.integers(0, 2, n),
            "ship": (rng.integers(0, 2526, n) + 8036).astype(np.int32),
        }


def copy_columns(c: dict) -> dict:
    """The generator's values as bench.py hands them to copy_from."""
    return {
        "l_orderkey": c["orderkey"],
        "l_quantity": c["qty"] / 100.0,
        "l_extendedprice": c["price"] / 100.0,
        "l_discount": c["disc"] / 100.0,
        "l_tax": c["tax"] / 100.0,
        "l_returnflag": RF[c["rf"]].tolist(),
        "l_linestatus": LS[c["ls"]].tolist(),
        "l_shipdate": c["ship"],
    }


def _day(y, m, d) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _dec(v: int, scale: int) -> decimal.Decimal:
    return decimal.Decimal(int(v)).scaleb(-scale)


def _avg(total: int, count: int, scale: int) -> decimal.Decimal:
    """The engine's exact decimal average: scale + 6, half up."""
    q = decimal.Decimal(int(total)) * 1_000_000 / decimal.Decimal(int(count))
    return _dec(int(q.to_integral_value(rounding=decimal.ROUND_HALF_UP)),
                scale + 6)


def oracle_q1(cols: dict, delta: int = 90) -> list[tuple]:
    """Q1 with ``date '1998-12-01' - interval 'delta' day``."""
    keep = cols["ship"] <= _day(1998, 12, 1) - delta
    gid = (cols["rf"] * 2 + cols["ls"])[keep]
    groups, inv = np.unique(gid, return_inverse=True)
    qty, price = cols["qty"][keep], cols["price"][keep]
    disc, tax = cols["disc"][keep], cols["tax"][keep]
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)

    def total(v):
        out = np.zeros(len(groups), np.int64)
        np.add.at(out, inv, v.astype(np.int64))
        return out
    cnt = np.bincount(inv, minlength=len(groups))
    s_qty, s_price, s_disc = total(qty), total(price), total(disc)
    s_dp, s_ch = total(disc_price), total(charge)
    rows = []
    for i, g in enumerate(groups):
        rows.append((str(RF[g // 2]), str(LS[g % 2]),
                     _dec(s_qty[i], 2), _dec(s_price[i], 2),
                     _dec(s_dp[i], 4), _dec(s_ch[i], 6),
                     _avg(s_qty[i], cnt[i], 2), _avg(s_price[i], cnt[i], 2),
                     _avg(s_disc[i], cnt[i], 2), int(cnt[i])))
    return sorted(rows, key=lambda r: (r[0], r[1]))


def oracle_q6(cols: dict, year: int = 1994, disc: int = 6,
              qty: int = 24) -> list[tuple]:
    """Q6 with its substitution parameters: ship year, discount in
    cents, quantity."""
    keep = ((cols["ship"] >= _day(year, 1, 1))
            & (cols["ship"] < _day(year + 1, 1, 1))
            & (cols["disc"] >= disc - 1) & (cols["disc"] <= disc + 1)
            & (cols["qty"] < qty * 100))
    rev = int((cols["price"][keep].astype(np.int64)
               * cols["disc"][keep]).sum())
    return [(_dec(rev, 4),)]


def oracle_h1(cols: dict, threshold: int = 300) -> list[tuple]:
    """H1: per-order quantity sums above ``threshold``, by order key."""
    keys, inv = np.unique(cols["orderkey"], return_inverse=True)
    qty = np.zeros(len(keys), np.int64)
    np.add.at(qty, inv, cols["qty"].astype(np.int64))
    keep = qty > threshold * 100
    return [(int(k), _dec(q, 2)) for k, q in zip(keys[keep], qty[keep])]


def oracle_h2(cols: dict, lo: int = None, hi: int = None) -> list[tuple]:
    """H2: the ten largest per-order revenues of ship days [lo, hi)
    (default: 1994)."""
    lo = _day(1994, 1, 1) if lo is None else lo
    hi = _day(1995, 1, 1) if hi is None else hi
    keep = (cols["ship"] >= lo) & (cols["ship"] < hi)
    keys, inv = np.unique(cols["orderkey"][keep], return_inverse=True)
    rev = np.zeros(len(keys), np.int64)
    np.add.at(rev, inv, cols["price"][keep].astype(np.int64)
              * (100 - cols["disc"][keep]))
    order = np.lexsort((keys, -rev))[:10]
    return [(int(keys[i]), _dec(rev[i], 4)) for i in order]


def oracle_p1(cols: dict, day: int = 1) -> list[tuple]:
    """P1: the lines shipped on 1994-06-<day> with a discount of 9 % or
    more."""
    keep = (cols["ship"] == _day(1994, 6, day)) & (cols["disc"] >= 9)
    rows = sorted(zip(cols["orderkey"][keep].tolist(),
                      cols["qty"][keep].tolist(),
                      cols["price"][keep].tolist()))
    return [(k, _dec(q, 2), _dec(p, 2)) for k, q, p in rows]


# ------------------------------------------------------------- phase 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


# ------------------------------------------------------------- phase 3


def time_cuda(fn, reps: int = 25, rounds: int = 3) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``reps``
    back-to-back calls, the median over ``rounds`` such runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def fold_bytes(call) -> int:
    """Bytes one fold must move: each distinct input read once, each
    register read and written once."""
    regs, rows, mask, keys, args, _ops, _g = call
    seen, total = set(), 0
    tensors = [mask] + [t for k in keys for t in (k.values, k.valid)] \
        + [t for a in args for t in a]
    for t in tensors:
        if t is not None and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()
    outs = list(regs) + ([rows] if rows is not None else [])
    total += 2 * sum(t.numel() * t.element_size() for t in outs)
    return total


def fold_ops(call) -> int:
    regs, _rows, mask, keys, _args, ops, _g = call
    return mask.numel() * (len(ops) + 4 * len(keys) + 1)


def clone_call(call):
    regs, rows, mask, keys, args, ops, g = call
    return ([r.clone() for r in regs],
            None if rows is None else rows.clone(), mask, keys, args, ops, g)


def compare_fold(name: str, call, kernel, plain) -> float:
    """Kernel vs plain on one input; -> max abs error of float sums."""
    import torch
    kc, pc = clone_call(call), clone_call(call)
    kernel(*kc)
    plain(*pc)
    if call[2].is_cuda:
        torch.cuda.synchronize()
    max_err = 0.0
    for i, (op, k, p) in enumerate(zip(call[5], kc[0], pc[0])):
        k, p = k.cpu().numpy(), p.cpu().numpy()
        if op.kind == "sum" and np.issubdtype(k.dtype, np.floating):
            if not np.array_equal(np.isnan(k), np.isnan(p)):
                raise AssertionError(f"{name}: op {i} NaN positions differ")
            fin = np.isfinite(k) & np.isfinite(p)
            if not np.array_equal(k[~fin & ~np.isnan(k)],
                                  p[~fin & ~np.isnan(p)]):
                raise AssertionError(f"{name}: op {i} infinities differ")
            err = np.abs(k[fin] - p[fin])
            tol = 1e-12 * np.abs(p[fin])
            if (err > tol).any():
                raise AssertionError(
                    f"{name}: op {i} float sum beyond rel 1e-12: "
                    f"max err {err.max()}")
            if err.size:
                max_err = max(max_err, float(err.max()))
        elif not np.array_equal(k, p, equal_nan=np.issubdtype(
                k.dtype, np.floating)):
            raise AssertionError(f"{name}: op {i} ({op.kind}) differs")
    if kc[1] is not None and not torch.equal(kc[1], pc[1]):
        raise AssertionError(f"{name}: group row counts differ")
    return max_err


def synthetic_global_case(device, n: int, G: int, seed: int, all_false: bool):
    """A direct fold past the shared-memory table: G groups, every op
    kind and register type, nulls, NaN, +-inf, +-0.0."""
    import torch
    from citus_tpu_torch.ops.scan_agg_fold import FoldKey, FoldOp
    g = torch.Generator().manual_seed(seed)
    mask = (torch.rand(n, generator=g) < 0.8) & (not all_false)
    key = torch.randint(0, G - 1, (n,), generator=g)
    key_valid = torch.rand(n, generator=g) < 0.97
    ints = torch.randint(-10**12, 10**12, (n,), generator=g)
    pos = torch.rand(n, generator=g, dtype=torch.float64) * 1000
    mixed = torch.randn(n, generator=g, dtype=torch.float64)
    for t in (pos, mixed):
        idx = torch.randint(0, n, (64,), generator=g)
        t[idx[:16]] = float("nan")
        t[idx[16:32]] = float("inf")
        t[idx[32:40]] = float("-inf")
        t[idx[40:52]] = 0.0
        t[idx[52:]] = -0.0
    i32 = torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                        dtype=torch.int32)
    f32 = mixed.to(torch.float32)
    valid = torch.rand(n, generator=g) < 0.9
    args = [(ints, valid), (pos, valid), (mixed, None), (i32, valid),
            (f32, None)]
    ops = [FoldOp("count_star"), FoldOp("count", 0), FoldOp("sum", 0),
           FoldOp("sum", 1), FoldOp("min", 0), FoldOp("max", 0),
           FoldOp("min", 2), FoldOp("max", 2), FoldOp("min", 3),
           FoldOp("max", 3), FoldOp("min", 4), FoldOp("max", 4),
           FoldOp("count", 1)]
    dts = [torch.int64, torch.int64, torch.int64, torch.float64,
           torch.int64, torch.int64, torch.float64, torch.float64,
           torch.int32, torch.int32, torch.float32, torch.float32,
           torch.int64]
    regs = []
    for op, dt in zip(ops, dts):
        fill = 0
        if op.kind in ("min", "max"):
            if dt.is_floating_point:
                fill = float("inf") if op.kind == "min" else float("-inf")
            else:
                info = torch.iinfo(dt)
                fill = info.max if op.kind == "min" else info.min
        regs.append(torch.full((G,), fill, dtype=dt, device=device))
    rows = torch.zeros(G, dtype=torch.int64, device=device)
    keys = [FoldKey(key.to(device), key_valid.to(device), 0, 1, 1)]
    dargs = [(v.to(device), None if m is None else m.to(device))
             for v, m in args]
    return (regs, rows, mask.to(device), keys, dargs, ops, G)


SYN_DDL = """CREATE TABLE syn (k bigint NOT NULL, a bigint, b int,
        s double, f real, p decimal(12,2))"""

#: a synthetic predicate over nulls, NaN, zero divisors and three-valued
#: AND/OR (filter_mask's adversarial case)
SYN_WHERE = ("(a / b > 1 OR s > 0.5) AND (NOT (f < 0.25) OR a % b = 1) "
             "OR (s <> s AND b = 0) OR (p * 2 > 90 AND s IS NULL)")

BENCH_HASH = ("SELECT l_orderkey, count(*), sum(l_quantity) "
              "FROM lineitem GROUP BY l_orderkey")


def plan_as_cluster_does(cl, sql: str):
    """-> (plan, encoded parameters) of one SELECT, bound, auto-
    parameterized and planned as ``Cluster.execute`` does it."""
    from citus_tpu_torch.executor.executor import encode_params
    from citus_tpu_torch.planner import parse_sql
    from citus_tpu_torch.planner.auto_param import auto_parameterize
    from citus_tpu_torch.planner.bind import bind_select
    from citus_tpu_torch.planner.physical import plan_select
    bound = bind_select(cl.catalog, parse_sql(sql)[0])
    values = None
    ap = auto_parameterize(bound)
    if ap is not None:
        bound, values = ap
    plan = plan_select(cl.catalog, bound,
                       direct_limit=cl.settings.planner.direct_gid_limit)
    return plan, encode_params(cl.catalog, bound, values)


def filter_program(cl, sql: str):
    """-> (FilterProgram, host parameter env) of a query's WHERE, as the
    executor builds it."""
    from citus_tpu_torch.executor.executor import (
        _build_filter_mask, _params_env,
    )
    plan, params = plan_as_cluster_does(cl, sql)
    return _build_filter_mask(plan, params), _params_env(plan, params)


def smoke_plans(device, tmp: str, n: int = FOLD_N):
    """The port's plans over a small lineitem (for the key domains) and a
    synthetic table, the main path's fold inputs for Q6 and Q1 applied
    to one padded batch of ``n`` generated rows, and the filter
    programs of Q6, P1 and the synthetic predicate.  -> dict."""
    import torch
    import citus_tpu_torch as ctt
    from citus_tpu_torch.executor.batches import pad_to_batch
    from citus_tpu_torch.ops.scan_agg import (
        build_fold_inputs, empty_device_partials,
    )
    from citus_tpu_torch.ops.xp_torch import TorchNamespace
    from citus_tpu_torch.planner import parse_sql
    from citus_tpu_torch.planner.bind import bind_select
    from citus_tpu_torch.planner.physical import plan_select
    cl = ctt.Cluster(os.path.join(tmp, "plans"), device=device)
    cl.execute(LINEITEM_DDL)
    cl.execute(f"SELECT create_distributed_table('lineitem', 'l_orderkey', {SHARDS})")
    cl.copy_from("lineitem", columns=copy_columns(next(lineitem_chunks(20_000))))
    cl.execute(SYN_DDL)
    cl.execute("SELECT create_distributed_table('syn', 'k', 2)")

    def ids(col, words):
        return np.array([cl.catalog.lookup_string_id("lineitem", col, w)
                         for w in words], np.int32)
    chunks = list(lineitem_chunks(n))
    c = {k: np.concatenate([ch[k] for ch in chunks]) for k in chunks[0]}
    physical = {  # the engine's encoding: cents, dictionary ids, days
        "l_orderkey": c["orderkey"], "l_quantity": c["qty"],
        "l_extendedprice": c["price"], "l_discount": c["disc"],
        "l_tax": c["tax"], "l_returnflag": ids("l_returnflag", RF)[c["rf"]],
        "l_linestatus": ids("l_linestatus", LS)[c["ls"]],
        "l_shipdate": c["ship"],
    }
    xp = TorchNamespace(device)
    calls = {}
    for name, sql in (("q6", Q6), ("q1", Q1)):
        plan = plan_select(cl.catalog,
                           bind_select(cl.catalog, parse_sql(sql)[0]))
        values = {k: physical[k] for k in plan.scan_columns}
        masks = {k: np.ones(n, bool) for k in plan.scan_columns}
        hb = pad_to_batch(plan.bound.table, plan, values, masks, n, n, 0)
        dcols = tuple(torch.from_numpy(a).to(device) for a in hb.cols)
        dvalids = tuple(torch.from_numpy(a).to(device) for a in hb.valids)
        dmask = torch.from_numpy(hb.row_mask).to(device)
        acc = empty_device_partials(plan, device)
        calls[name] = build_fold_inputs(plan, xp)(acc, dcols, dvalids, dmask)
    filters = {
        "q6": filter_program(cl, Q6),
        "p1": filter_program(cl, P1),
        "syn": filter_program(cl, f"SELECT k FROM syn WHERE {SYN_WHERE}"),
    }
    fams = family_plans(cl)
    cl.close()
    return {"fold_calls": calls, "physical": physical, "filters": filters,
            "families": fams}


def family_plans(cl) -> dict:
    """name -> (plan of the first variant, encoded parameters of every
    variant) of each phase-5 family; every variant must share the plan
    family (one ``plan_fingerprint``), or the family cannot coalesce."""
    from citus_tpu_torch.executor.kernel_cache import plan_fingerprint
    out = {}
    for name, (_kind, variants) in families().items():
        planned = [plan_as_cluster_does(cl, sql) for sql, _ in variants]
        fps = {plan_fingerprint(plan) for plan, _ in planned}
        if len(fps) != 1:
            raise AssertionError(f"family {name}: {len(fps)} plan families")
        out[name] = (planned[0][0], [p for _, p in planned])
    return out


def syn_columns(n: int, seed: int) -> dict:
    """Columns of the synthetic table, device dtypes, with nulls, NaN,
    +-inf, +-0.0 and zero divisors: {name: (values, valid)}."""
    rng = np.random.default_rng(seed)
    s = rng.normal(0.3, 1, n)
    f = rng.normal(0.2, 0.5, n).astype(np.float32)
    for v in (s, f):
        idx = rng.integers(0, n, 4096)
        v[idx[:1024]] = np.nan
        v[idx[1024:1536]] = np.inf
        v[idx[1536:2048]] = -np.inf
        v[idx[2048:3072]] = 0.0
        v[idx[3072:]] = -0.0
    cols = {"a": rng.integers(-1000, 1000, n), "b": rng.integers(-3, 4, n),
            "s": s, "f": f, "p": rng.integers(-10_000, 10_000, n)}
    return {k: (v, rng.random(n) > 0.1) for k, v in cols.items()}


def lineitem_filter_columns(physical: dict) -> dict:
    return {k: (v, np.ones(v.shape[0], bool)) for k, v in physical.items()}


def filter_call(prog, columns: dict, params: dict, device, n: int):
    """-> (cols, params, row_mask) of one filter_mask launch over
    ``columns`` with the last 1,000 rows padding."""
    import torch
    cols = {c: (torch.from_numpy(np.ascontiguousarray(
                    columns[c][0][:n].astype(prog.col_dtypes[c]))).to(device),
                torch.from_numpy(np.ascontiguousarray(
                    columns[c][1][:n])).to(device))
            for c in prog.columns}
    mask = np.ones(n, bool)
    mask[-1000:] = False
    return cols, params, torch.from_numpy(mask).to(device)


def filter_bytes(cols: dict, row_mask) -> int:
    """Bytes one predicate launch must move: each column and validity
    read once, the row mask read once, the mask written once."""
    total = 2 * row_mask.numel()
    for v, m in cols.values():
        total += v.numel() * v.element_size() + m.numel()
    return total


# ------------------------------------------------------------- hash phase


def clone_table(t):
    from citus_tpu_torch.ops.hash_agg import HashTable
    return HashTable([v.clone() for v in t.key_values],
                     [f.clone() for f in t.key_flags],
                     [p.clone() for p in t.partials], t.rows.clone(),
                     t.state.clone())


def copy_table_(dst, src) -> None:
    for a, b in zip(dst.key_values + dst.key_flags + dst.partials
                    + [dst.rows, dst.state],
                    src.key_values + src.key_flags + src.partials
                    + [src.rows, src.state]):
        a.copy_(b)


def hash_partial_ops(table, ops):
    """HostGroupAccumulator ops of one insert's partial tables."""
    from citus_tpu_torch.planner.physical import PartialOp
    out = []
    for op, t in zip(ops, table.partials):
        if op.kind == "count_star":
            out.append(PartialOp("count", -1, "int64"))
        else:
            out.append(PartialOp(op.kind, op.arg,
                                 str(t.dtype).replace("torch.", "")))
    return out


def host_groups(table, spill, mask, keys, args, ops) -> dict:
    """The merged groups of one insert: the table's occupied slots and
    the spilled rows through HostGroupAccumulator (executor/host_agg.py),
    -> {canonical key bytes: partial values}."""
    from citus_tpu_torch.executor.host_agg import HostGroupAccumulator
    acc = HostGroupAccumulator(len(keys), hash_partial_ops(table, ops))
    n = mask.shape[0]

    def host(t):
        if t is None:
            return np.ones(n, bool)
        a = t.cpu().numpy()
        return np.broadcast_to(a, (n,)) if a.shape[0] != n else a
    acc.add_batch(spill.cpu().numpy(),
                  [(host(kv), host(kvm)) for kv, kvm in keys],
                  [(host(v), host(valid)) for v, valid in args])
    key_tables, partials, rows = table.to_host()
    acc.merge_partials(rows > 0, [(kv, kf == 2) for kv, kf in key_tables],
                       list(partials), rows)
    return {kb: tuple(acc._accs[gi]) for kb, gi in acc._groups.items()}


def compare_groups(name: str, got: dict, want: dict, pops) -> float:
    """Identical groups; int64 partials identical, float sums within rel
    1e-12 (atomics add in another order), float min/max identical.
    -> max abs error of float sums."""
    if got.keys() != want.keys():
        raise AssertionError(
            f"{name}: {len(got)} groups, the plain version {len(want)}; "
            f"{len(got.keys() ^ want.keys())} differ")
    max_err = 0.0
    for kb, w in want.items():
        for op, a, b in zip(pops, got[kb], w):
            a, b = np.asarray(a), np.asarray(b)
            if op.kind == "sum" and b.dtype.kind == "f":
                if np.isnan(a) != np.isnan(b) or (
                        np.isinf(b) and a != b):
                    raise AssertionError(f"{name}: sum {a} vs {b}")
                if np.isfinite(b):
                    err = abs(float(a) - float(b))
                    if err > 1e-12 * abs(float(b)):
                        raise AssertionError(
                            f"{name}: float sum {a} vs {b} beyond rel 1e-12")
                    max_err = max(max_err, err)
            elif not np.array_equal(a, b, equal_nan=b.dtype.kind == "f"):
                raise AssertionError(f"{name}: {op.kind} {a} vs {b}")
    return max_err


def check_hash_invariants(name: str, table, spill, mask) -> None:
    """Each key sits in at most one slot; every masked row is placed or
    spilled exactly once; the claim words mirror the occupancy."""
    import torch
    placed, spilled = int(table.rows.sum()), int(spill.sum())
    if placed + spilled != int(mask.sum()):
        raise AssertionError(f"{name}: {placed} placed + {spilled} spilled "
                             f"!= {int(mask.sum())} masked rows")
    if not torch.equal(table.state, 2 * (table.rows > 0).to(torch.int32)):
        raise AssertionError(f"{name}: claim words disagree with rows")
    occ = (table.rows > 0).cpu().numpy()
    parts = []
    for kv, kf in zip(table.key_values, table.key_flags):
        a = kv.cpu().numpy()[occ]
        if a.dtype == np.float64:
            a = a.view(np.int64)
        elif a.dtype == np.float32:
            a = a.view(np.int32)
        parts += [a.astype(np.int64), kf.cpu().numpy()[occ].astype(np.int64)]
    if occ.any() and len(np.unique(np.stack(parts, 1), axis=0)) != occ.sum():
        raise AssertionError(f"{name}: a key sits in more than one slot")


def hash_bytes(call, occupied: int) -> int:
    """Bytes one insert into a fresh table must move: each input read
    once, the spill mask written once, and each of the ``occupied``
    slots it fills read and written once (claim word, keys, flags,
    partials, rows).  A row that spills only probes slots already
    occupied, so no other slot needs to be touched."""
    table, mask, keys, args, _ops = call
    seen, total = set(), mask.numel()
    for t in [mask] + [t for kv in keys for t in kv] \
            + [t for a in args for t in a]:
        if t is not None and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()
    slot = sum(t.element_size() for t in table.key_values + table.key_flags
               + table.partials + [table.rows, table.state])
    return total + 2 * occupied * slot


def main_path_hash_call(cl, device):
    """The kernel inputs of bench.py's hash GROUP BY for the first padded
    shard batch of the loaded lineitem, on a fresh table sized as the
    main path sizes it (citus.hash_agg_slots = auto)."""
    import torch
    from citus_tpu_torch.executor.executor import (
        _hash_key_dtypes, _hash_slots, _iter_padded_batches,
    )
    from citus_tpu_torch.ops.hash_agg import (
        build_hash_insert_inputs, empty_hash_state,
    )
    from citus_tpu_torch.ops.xp_torch import TorchNamespace
    cl.execute("SET citus.hash_agg_slots = auto")
    plan, _ = plan_as_cluster_does(cl, BENCH_HASH)
    if plan.group_mode.kind != "hash_host":
        raise AssertionError(f"{BENCH_HASH} plans to {plan.group_mode.kind}")
    S = _hash_slots(cl.catalog, plan, cl.settings)
    key_dtypes = _hash_key_dtypes(plan, {})
    batches = _iter_padded_batches(cl.catalog, plan, cl.settings)
    hb = next(batches)
    batches.close()
    table = empty_hash_state(plan, S, key_dtypes, device)
    call = build_hash_insert_inputs(plan, TorchNamespace(device), key_dtypes)(
        table, tuple(torch.from_numpy(a).to(device) for a in hb.cols),
        tuple(torch.from_numpy(a).to(device) for a in hb.valids),
        torch.from_numpy(hb.row_mask).to(device))
    return call, hb.n_rows


def adversarial_hash_call(device, n: int, S: int, seed: int,
                          all_false: bool):
    """Three keys (int64; float64 with +-0.0, NaN payloads, +-inf; int32),
    each 5 % NULL, a float64 sum, min and max with NaN and +-inf, on S
    slots (S = 1000: most rows spill)."""
    import torch
    from citus_tpu_torch.ops.hash_agg import HashTable
    from citus_tpu_torch.ops.scan_agg_fold import FoldOp
    rng = np.random.default_rng(seed)
    nan_bits = np.array([0x7FF8000000000000, 0x7FF0000000000001,
                         0xFFF8000000000000, 0x7FFFFFFFFFFFFFFF], np.uint64)
    fpool = np.concatenate([[0.0, -0.0, np.inf, -np.inf, 1.5, -2.25],
                            nan_bits.view(np.float64),
                            rng.normal(0, 100, 6)])
    k1 = rng.integers(-2**62, 2**62, 600)[rng.integers(0, 600, n)]
    k2 = fpool[rng.integers(0, fpool.size, n)]
    k3 = rng.integers(-2**31, 2**31 - 1, 5, dtype=np.int64).astype(
        np.int32)[rng.integers(0, 5, n)]
    v = rng.uniform(0, 1000, n)
    idx = rng.integers(0, n, 64)
    v[idx[:16]] = np.nan
    v[idx[16:40]] = np.inf
    v[idx[40:]] = -np.inf
    mask = (rng.random(n) < 0.9) & (not all_false)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    keys = [(t(k), t(rng.random(n) > 0.05)) for k in (k1, k2, k3)]
    args = [(t(v), t(rng.random(n) > 0.1))]
    ops = [FoldOp("count_star"), FoldOp("count", 0), FoldOp("sum", 0),
           FoldOp("min", 0), FoldOp("max", 0)]
    i64 = torch.int64
    table = HashTable(
        [torch.full((S,), -2**63, dtype=i64, device=device),
         torch.full((S,), float("-inf"), dtype=torch.float64, device=device),
         torch.full((S,), -2**31, dtype=torch.int32, device=device)],
        [torch.zeros(S, dtype=torch.int8, device=device) for _ in range(3)],
        [torch.zeros(S, dtype=i64, device=device),
         torch.zeros(S, dtype=i64, device=device),
         torch.zeros(S, dtype=torch.float64, device=device),
         torch.full((S,), float("inf"), dtype=torch.float64, device=device),
         torch.full((S,), float("-inf"), dtype=torch.float64,
                    device=device)],
        torch.zeros(S, dtype=i64, device=device),
        torch.zeros(S, dtype=torch.int32, device=device))
    return table, t(mask), keys, args, ops


def compare_hash(name: str, call, kernel, plain) -> float:
    """Kernel vs plain on fresh copies of one insert's table; -> max abs
    error of float sums in the merged groups."""
    import torch
    table, mask, keys, args, ops = call
    kt, pt = clone_table(table), clone_table(table)
    ks = kernel(kt, mask, keys, args, ops)
    ps = plain(pt, mask, keys, args, ops)
    if mask.is_cuda:
        torch.cuda.synchronize()
    check_hash_invariants(f"{name} kernel", kt, ks, mask)
    check_hash_invariants(f"{name} plain", pt, ps, mask)
    pops = hash_partial_ops(table, ops)
    return compare_groups(name, host_groups(kt, ks, mask, keys, args, ops),
                          host_groups(pt, ps, mask, keys, args, ops), pops)


def time_cuda_fresh(fn, reset, reps: int = 10) -> float:
    """Milliseconds of one call of ``fn`` on state that ``reset`` restores
    before each call (outside the timed events); the median of ``reps``."""
    import torch
    reset()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        reset()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ------------------------------------------------------------- phase 4


def q1_max_charge(cols: dict) -> int:
    """Largest per-group sum of Q1's sum_charge argument at its bound
    scale (8: price x (1 - discount) x (1 + tax), decimal(38,8))."""
    keep = cols["ship"] <= _day(1998, 9, 2)
    gid = (cols["rf"] * 2 + cols["ls"])[keep]
    charge = (cols["price"][keep].astype(np.int64) * (100 - cols["disc"][keep])
              * (100 + cols["tax"][keep]))
    sums = np.zeros(6, np.int64)
    np.add.at(sums, gid, charge)  # scale 6; fits int64 at SF1
    return int(sums.max()) * 100


def q1_guard_fires(cols: dict) -> bool:
    """Whether the engine's overflow guard rejects Q1 on these rows: it
    refuses an int64 sum whose float64 shadow reaches 2^62."""
    return q1_max_charge(cols) >= 2 ** 62


def load_lineitem(ctt, path: str, n_rows: int):
    """-> (Cluster on CUDA, generated integer columns)."""
    t0 = time.perf_counter()
    cl = ctt.Cluster(path)
    if cl.device.type != "cuda":
        raise AssertionError(f"Cluster runs on {cl.device}, not CUDA")
    cl.execute(LINEITEM_DDL)
    cl.execute(f"SELECT create_distributed_table('lineitem', 'l_orderkey', {SHARDS})")
    chunks = []
    for c in lineitem_chunks(n_rows):
        cl.copy_from("lineitem", columns=copy_columns(c))
        chunks.append(c)
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    say(f"phase 4 load: {n_rows} rows in {SHARDS} shards in "
        f"{time.perf_counter() - t0:.3f} s")
    return cl, cols


def launch_counters() -> dict:
    """The launch counter of every kernel of the port, by name."""
    from citus_tpu_torch.ops.filter_mask import (
        filter_mask, filter_mask_batched,
    )
    from citus_tpu_torch.ops.hash_agg_insert import (
        hash_agg_insert, hash_agg_insert_batched,
    )
    from citus_tpu_torch.ops.scan_agg_fold import (
        scan_agg_fold, scan_agg_fold_batched,
    )
    from citus_tpu_torch.rollup.kernels import rollup_delta
    return {"scan_agg_fold": scan_agg_fold,
            "hash_agg_insert": hash_agg_insert, "filter_mask": filter_mask,
            "filter_mask_batched": filter_mask_batched,
            "scan_agg_fold_batched": scan_agg_fold_batched,
            "hash_agg_insert_batched": hash_agg_insert_batched,
            "rollup_delta": rollup_delta}


#: the batched kernels each phase-5 family's coalesced run must launch,
#: once per shard batch of its one group
FAMILY_KERNELS = {
    "scalar": ("filter_mask_batched", "scan_agg_fold_batched"),
    "direct": ("filter_mask_batched", "scan_agg_fold_batched"),
    "hash_host": ("filter_mask_batched", "hash_agg_insert_batched"),
    "projection": ("filter_mask_batched",),
}


def fanout(cl, sqls) -> tuple[dict, dict]:
    """Run one SQL per thread, all released together by a barrier so they
    land inside one coalescing window.  -> (results, errors)."""
    import threading
    results, errors = {}, {}
    bar = threading.Barrier(len(sqls))

    def run(i, sql):
        bar.wait()
        try:
            results[i] = cl.execute(sql)
        except Exception as e:  # noqa: BLE001 - reported by the caller
            errors[i] = e
    ts = [threading.Thread(target=run, args=(i, q)) for i, q in
          enumerate(sqls)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    if any(t.is_alive() for t in ts):
        raise AssertionError("a coalesced query did not finish in 600 s")
    return results, errors


def run_family(cl, name: str, kind: str, variants: list, cols: dict,
               n_rows: int, card: str = "") -> dict:
    """Phase 5 for one family: its Q_BATCH variants run serially (window
    0, one after another) and then coalesced (8 threads at once with
    citus.megabatch_window_ms = 1000, megabatch_max_size = 8), cold and
    warm.  Every query's rows must equal the numpy oracle; the coalesced
    runs must ride batches with occupancy above 1, launch each of the
    family's batched kernels once per shard batch per group and no other
    kernel.  -> the batched kernels' launches of the coalesced runs."""
    import torch
    from citus_tpu_torch.executor.megabatch import GLOBAL_MEGABATCH
    on_card = cl.device.type == "cuda"
    sqls = [sql for sql, _ in variants]
    wants = [oracle(cols) for _, oracle in variants]
    counters = launch_counters()
    cl.execute("SET citus.megabatch_window_ms = 0")
    serial_s = {}
    for run_kind in ("cold", "warm"):
        t0 = time.perf_counter()
        for sql, want in zip(sqls, wants):
            r = cl.execute(sql)
            if r.rows != want:
                raise AssertionError(
                    f"phase 5 {name} serial: rows differ from the numpy "
                    f"oracle:\n{r.rows[:5]}\n{want[:5]}")
        if on_card:
            torch.cuda.synchronize()
        serial_s[run_kind] = time.perf_counter() - t0
        say(f"phase 5 {name} serial {run_kind} (window 0, one query after "
            f"another): {len(sqls)} queries in {serial_s[run_kind]:.4f} s, "
            f"{len(sqls) / serial_s[run_kind]:.3f} queries/s, "
            f"{len(sqls) * n_rows / serial_s[run_kind]:.1f} rows/s ({card})")
    cl.execute("SET citus.megabatch_window_ms = 1000")
    cl.execute(f"SET citus.megabatch_max_size = {Q_BATCH}")
    launched = dict.fromkeys(counters, 0)
    try:
        for run_kind in ("cold", "warm"):
            for f in counters.values():
                f.launches = 0
            s0 = GLOBAL_MEGABATCH.stats()
            t0 = time.perf_counter()
            results, errors = fanout(cl, sqls)
            if on_card:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = {k: f.launches for k, f in counters.items()}
            s1 = GLOBAL_MEGABATCH.stats()
            if errors:
                raise AssertionError(f"phase 5 {name} {run_kind}: {errors}")
            for i, want in enumerate(wants):
                if results[i].rows != want:
                    raise AssertionError(
                        f"phase 5 {name} {run_kind}: query {i} rows differ "
                        f"from the numpy oracle:\n{results[i].rows[:5]}\n"
                        f"{want[:5]}")
                if results[i].explain["strategy"] != kind:
                    raise AssertionError(
                        f"phase 5 {name}: strategy "
                        f"{results[i].explain['strategy']}, not {kind}")
            queries = s1["queries"] - s0["queries"]
            batches = s1["batches"] - s0["batches"]
            dispatches = s1["dispatches"] - s0["dispatches"]
            if queries != len(sqls) or not 1 <= batches < queries:
                raise AssertionError(
                    f"phase 5 {name} {run_kind}: {queries} queries rode "
                    f"{batches} batches (occupancy must be above 1)")
            if dispatches == 0:
                raise AssertionError(f"phase 5 {name}: no shard batch")
            if on_card:
                for k, v in got.items():
                    want_n = dispatches if k in FAMILY_KERNELS[kind] else 0
                    if v != want_n:
                        raise AssertionError(
                            f"phase 5 {name} {run_kind}: {k} launched {v} "
                            f"times for {dispatches} shard batches of "
                            f"{batches} groups")
            for k in launched:
                launched[k] += got[k]
            occ = sorted({r.explain["megabatch"]["occupancy"]
                          for r in results.values()})
            say(f"phase 5 {name} coalesced {run_kind}: {queries} queries in "
                f"{batches} batches (occupancy {occ}), {dispatches} shard "
                f"batches, launches "
                f"{ {k: v for k, v in got.items() if v} }, rows equal the "
                f"numpy oracle; {dt:.4f} s, {queries / dt:.3f} queries/s, "
                f"{queries * n_rows / dt:.1f} rows/s, "
                f"{serial_s[run_kind] / dt:.3f}x the serial {run_kind} rate "
                f"({card})")
    finally:
        cl.execute("SET citus.megabatch_window_ms = 0")
    return launched


def run_checked(cl, qname: str, sql: str, want: list, n_rows: int,
                run_kind: str, kernel: str = "scan_agg_fold") -> int:
    """Run one query; its rows must equal the oracle's, ``kernel`` must
    launch once per batch of the query and no other kernel may launch.
    -> kernel launches."""
    import torch
    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    r = cl.execute(sql)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = {k: f.launches for k, f in counters.items()}
    pipe = r.explain["pipeline"]
    batches = pipe["filter_dispatches" if kernel == "filter_mask"
                   else "fused_dispatches"]
    if got[kernel] != batches or got[kernel] == 0:
        raise AssertionError(f"{qname} {run_kind}: {got[kernel]} {kernel} "
                             f"launches for {batches} batches")
    others = {k: v for k, v in got.items() if k != kernel and v}
    if others:
        raise AssertionError(f"{qname} {run_kind}: other kernels launched: "
                             f"{others}")
    if r.rows != want:
        raise AssertionError(f"{qname} {run_kind}: rows differ from the "
                             f"numpy oracle:\n{r.rows[:20]}\n{want[:20]}")
    extra = ""
    if kernel == "hash_agg_insert":
        extra = (f", hash_slots {pipe['hash_slots']}, hash_occupancy_pct "
                 f"{pipe['hash_occupancy_pct']}, hash_spilled_rows "
                 f"{pipe['hash_spilled_rows']}, host merge of the table "
                 f"{pipe['host_merge_ms']} ms, host merge of spilled rows "
                 f"{pipe['hash_spill_merge_ms']} ms")
    say(f"phase 4 {qname} {run_kind} at {n_rows} rows: {len(r.rows)} rows "
        f"equal the numpy oracle; {n_rows / dt:.1f} rows/s ({dt:.4f} s), "
        f"{kernel} launches {got[kernel]} for {batches} batches, "
        f"stream_window_peak_bytes {pipe.get('stream_window_peak_bytes', 0)}, "
        f"host_decode_ms {pipe.get('host_decode_ms', 0)}, "
        f"device_ms {pipe.get('device_ms', 0)}{extra}")
    return got[kernel]


# ------------------------------------------------------------- main


def phase3_fold(device, plans, rows: list) -> None:
    """scan_agg_fold against its plain version; appends its JSON row."""
    import torch
    from citus_tpu_torch.ops.scan_agg_fold import (
        scan_agg_fold, scan_agg_fold_plain,
    )
    calls = plans["fold_calls"]
    cases = [("q6 scalar G=1", calls["q6"]), ("q1 direct G=12", calls["q1"])]
    for all_false in (False, True):
        cases.append((f"direct G=65536{' all-false mask' if all_false else ''}",
                      synthetic_global_case(device, FOLD_N + 3, 65536, 21,
                                            all_false)))
    max_err, main = 0.0, None
    for name, call in cases:
        err = compare_fold(name, call, scan_agg_fold, scan_agg_fold_plain)
        max_err = max(max_err, err)
        regime = {1: "shared-memory table", 0: "global atomics"}.get(
            scan_agg_fold.last_regime, "none")
        kc = clone_call(call)
        ms = time_cuda(lambda: scan_agg_fold(*kc))
        pc = clone_call(call)
        plain_ms = time_cuda(lambda: scan_agg_fold_plain(*pc))
        nbytes, nops = fold_bytes(call), fold_ops(call)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / SIMT_OPS_PER_S) * 1e3
        # yardstick: ONE index_add_ of one int64 sum at the same N, G
        G = call[6]
        acc = torch.zeros(G, dtype=torch.int64, device=device)
        n = call[2].numel()
        gid = torch.randint(0, G, (n,), device=device)
        val = torch.randint(0, 1000, (n,), device=device)
        lib_ms = time_cuda(lambda: acc.index_add_(0, gid, val))
        if name.startswith("q1"):
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        say(f"phase 3 scan_agg_fold [{name}]: N={n} G={G} "
            f"ops={len(call[5])} regime={regime} agrees "
            f"(max abs err of float sums {err!r}); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({nbytes} B at 3.35 TB/s), library yardstick "
            f"(one int64 index_add_, one op) {lib_ms:.4f} ms")
    rows.append({"name": "scan_agg_fold", "route": "cuda",
                 "source": "citus_tpu_torch/csrc/scan_agg_fold.cu",
                 "replaces": "citus_tpu/ops/scan_agg.py:277",
                 "max_abs_err": max_err, **main, "bound_by": "bytes",
                 "library_ms": None})


def phase3_hash(device, cl, rows: list) -> None:
    """hash_agg_insert against its plain version: the main path's first
    SF1 shard batch of bench.py's hash GROUP BY on 2^20 slots, and the
    adversarial case; appends its JSON row."""
    import torch
    from citus_tpu_torch.ops.hash_agg_insert import (
        hash_agg_insert, hash_agg_insert_plain,
    )
    main_call, n_real = main_path_hash_call(cl, device)
    cases = [(f"bench hash GROUP BY l_orderkey, one shard ({n_real} rows)",
              main_call)]
    for all_false in (False, True):
        cases.append((f"adversarial 3 keys S=1000"
                      f"{' all-false mask' if all_false else ''}",
                      adversarial_hash_call(device, FOLD_N + 3, 1000, 31,
                                            all_false)))
    max_err, main = 0.0, None
    for name, call in cases:
        err = compare_hash(name, call, hash_agg_insert, hash_agg_insert_plain)
        max_err = max(max_err, err)
        table, mask, keys, args, ops = call
        work = clone_table(table)
        ms = time_cuda_fresh(
            lambda: hash_agg_insert(work, mask, keys, args, ops),
            lambda: copy_table_(work, table))
        plain_ms = time_cuda_fresh(
            lambda: hash_agg_insert_plain(work, mask, keys, args, ops),
            lambda: copy_table_(work, table), reps=3)
        copy_table_(work, table)
        spill = hash_agg_insert(work, mask, keys, args, ops)
        torch.cuda.synchronize()
        placed = int(work.rows.sum())
        occupied = int((work.rows > 0).sum())
        nbytes = hash_bytes(call, occupied)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # slot traffic: every placed row touches its claim word, each key
        # and flag, every partial register and rows[slot] at random
        sectors = 2 + 2 * len(keys) + len(ops)
        S = table.slots
        acc = torch.zeros(S, dtype=torch.int64, device=device)
        n = mask.numel()
        slot = torch.randint(0, S, (n,), device=device)
        val = torch.randint(0, 1000, (n,), device=device)
        lib_ms = time_cuda(lambda: acc.index_add_(0, slot, val))
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        say(f"phase 3 hash_agg_insert [{name}]: N={n} S={S} "
            f"keys={len(keys)} ops={len(ops)} agrees (merged groups of "
            f"table and spill; max abs err of float sums {err!r}); placed "
            f"{placed}, spilled {int(spill.sum())}, occupied "
            f"{occupied} slots; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B at "
            f"3.35 TB/s: inputs once, the spill mask, each occupied slot "
            f"read and written once); slot traffic {placed * sectors * 32} B in 32-byte "
            f"sectors ({sectors} a placed row); library yardstick (one int64 "
            f"index_add_ into S slots, one op) {lib_ms:.4f} ms")
    rows.append({"name": "hash_agg_insert", "route": "cuda",
                 "source": "citus_tpu_torch/csrc/hash_agg_insert.cu",
                 "replaces": "citus_tpu/ops/hash_agg.py:179",
                 "max_abs_err": max_err, **main, "bound_by": "bytes",
                 "library_ms": None})


def phase3_filter(device, plans, rows: list) -> None:
    """filter_mask against its plain version on FOLD_N rows: Q6's and
    P1's predicates over generated lineitem, and the synthetic one;
    appends its JSON row."""
    import torch
    from citus_tpu_torch.ops.filter_mask import filter_mask, filter_mask_plain
    line = lineitem_filter_columns(plans["physical"])
    syn = syn_columns(FOLD_N, 41)
    main = None
    for name, cols in (("p1", line), ("q6", line), ("syn", syn)):
        prog, params = plans["filters"][name]
        call = filter_call(prog, cols, params, device, FOLD_N)
        got = filter_mask(prog, *call)
        want = filter_mask_plain(prog, *call)
        if not torch.equal(got, want):
            raise AssertionError(f"filter_mask [{name}]: masks differ in "
                                 f"{int((got != want).sum())} rows")
        ms = time_cuda(lambda: filter_mask(prog, *call))
        plain_ms = time_cuda(lambda: filter_mask_plain(prog, *call))
        nbytes = filter_bytes(call[0], call[2])
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        first = next(iter(call[0].values()))[0]
        lib_ms = time_cuda(lambda: torch.ge(first, 1))
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        say(f"phase 3 filter_mask [{name}]: N={FOLD_N} columns "
            f"{list(prog.columns)} params {len(params)}: masks identical "
            f"({int(got.sum())} rows pass); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B at "
            f"3.35 TB/s), library yardstick (one torch.ge over one column, "
            f"one op) {lib_ms:.4f} ms")
    rows.append({"name": "filter_mask", "route": "cuda",
                 "source": "citus_tpu_torch/ops/expr_codegen.py",
                 "replaces": "citus_tpu/executor/executor.py:971",
                 "max_abs_err": 0.0, **main, "bound_by": "bytes",
                 "library_ms": None})


# ------------------------------------------------------------- phase 3, B5


def family_filter(device, plan, params):
    """-> (FilterProgram, StackedParams) of one family's WHERE, as the
    megabatch path builds them."""
    from citus_tpu_torch.executor.executor import _build_filter_mask, _params_env
    from citus_tpu_torch.ops.filter_mask import stack_params
    prog = _build_filter_mask(plan, params[0])
    return prog, stack_params(prog, [_params_env(plan, p) for p in params],
                              device)


def padded_batch(device, plan, physical: dict):
    """One batch of the generated rows (FOLD_N on the card) in the plan's
    scan columns on ``device``: (cols, valids, row_mask)."""
    import torch
    from citus_tpu_torch.executor.batches import pad_to_batch
    n = len(physical["l_orderkey"])
    values = {k: physical[k] for k in plan.scan_columns}
    masks = {k: np.ones(n, bool) for k in plan.scan_columns}
    hb = pad_to_batch(plan.bound.table, plan, values, masks, n, n, 0)
    return (tuple(torch.from_numpy(a).to(device) for a in hb.cols),
            tuple(torch.from_numpy(a).to(device) for a in hb.valids),
            torch.from_numpy(hb.row_mask).to(device))


def predicate_columns(plan, prog, cols, valids) -> dict:
    env = dict(zip(plan.scan_columns, zip(cols, valids)))
    return {c: env[c] for c in prog.columns}


def batched_fold_call(device, plans, name: str, repeat: int = 1):
    """The batched fold's main-path inputs for family ``name`` (Q6 or Q1)
    on one FOLD_N-row batch: every variant's mask from the
    batched predicate kernel, the shared keys and arguments, fresh
    [Q, G] registers.  ``repeat`` > 1 sends each variant that many
    times (Q = 8 * repeat)."""
    from citus_tpu_torch.executor.megabatch import _empty_stacked_partials
    from citus_tpu_torch.ops.filter_mask import filter_mask_batched
    from citus_tpu_torch.ops.scan_agg import build_shared_fold_inputs
    from citus_tpu_torch.ops.xp_torch import TorchNamespace
    plan, params = plans["families"][name]
    params = params * repeat
    cols, valids, row_mask = padded_batch(device, plan, plans["physical"])
    prog, stacked = family_filter(device, plan, params)
    masks = filter_mask_batched(
        prog, predicate_columns(plan, prog, cols, valids), stacked, row_mask)
    shared, ops, G = build_shared_fold_inputs(plan, TorchNamespace(device))
    keys, args = shared(cols, valids)
    regs, rows = _empty_stacked_partials(plan, len(params), device)
    return (regs, rows, masks, keys, args, ops, G)


def phase3_batched_filter(device, plans, rows: list) -> None:
    """filter_mask_batched against its plain version: each phase-5
    family's predicate under its Q_BATCH parameter sets over FOLD_N
    generated lineitem rows; appends its JSON row."""
    import torch
    from citus_tpu_torch.ops.filter_mask import (
        filter_mask_batched, filter_mask_batched_plain,
    )
    main = None
    for name in ("Q6", "Q1", "H", "P"):
        plan, params = plans["families"][name]
        cols, valids, row_mask = padded_batch(device, plan,
                                              plans["physical"])
        prog, stacked = family_filter(device, plan, params)
        fcols = predicate_columns(plan, prog, cols, valids)
        got = filter_mask_batched(prog, fcols, stacked, row_mask)
        want = filter_mask_batched_plain(prog, fcols, stacked, row_mask)
        if not torch.equal(got, want):
            raise AssertionError(f"filter_mask_batched [{name}]: masks "
                                 f"differ in {int((got != want).sum())} "
                                 "places")
        ms = time_cuda(lambda: filter_mask_batched(prog, fcols, stacked,
                                                   row_mask))
        plain_ms = time_cuda(lambda: filter_mask_batched_plain(
            prog, fcols, stacked, row_mask), reps=3)
        q, n = got.shape
        # the predicate's columns and the row mask read once, Q masks out
        nbytes = filter_bytes(fcols, row_mask) - n + q * n
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        first = next(iter(fcols.values()))[0]
        thr = torch.arange(q, device=device, dtype=first.dtype)
        lib_ms = time_cuda(lambda: torch.ge(first.unsqueeze(0),
                                            thr.unsqueeze(1)))
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        say(f"phase 3 filter_mask_batched [{name} family]: Q={q} N={n} "
            f"columns {list(prog.columns)}: masks identical "
            f"({got.sum(dim=1).tolist()} rows pass); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B "
            f"at 3.35 TB/s), library yardstick (one broadcast torch.ge of "
            f"one column against Q thresholds, [Q, N] out) {lib_ms:.4f} ms")
    rows.append({"name": "filter_mask_batched", "route": "cuda",
                 "source": "citus_tpu_torch/ops/expr_codegen.py",
                 "replaces": "citus_tpu/executor/megabatch.py:518",
                 "max_abs_err": 0.0, **main, "bound_by": "bytes",
                 "library_ms": None})


def synthetic_batched_global_case(device, q: int = 3):
    """The G = 65,536 fold of ``synthetic_global_case`` for ``q``
    queries with different masks: the batched fold's global-atomics
    regime."""
    import torch
    regs, rows, mask, keys, args, ops, G = synthetic_global_case(
        device, FOLD_N + 3, 65536, 21, False)
    masks = torch.stack([mask, ~mask] + [mask] * (q - 2)).contiguous()
    return ([r.unsqueeze(0).repeat(q, 1).contiguous() for r in regs],
            rows.unsqueeze(0).repeat(q, 1).contiguous(), masks, keys, args,
            ops, G)


def phase3_batched_fold(device, plans, rows: list) -> None:
    """scan_agg_fold_batched against its plain version: the Q6 (scalar)
    and Q1 (direct, G = 12) families at Q = Q_BATCH on one padded
    FOLD_N-row batch, the Q1 family at Q = 32 (a 52 KB shared-memory
    table, past the 48 KB default), and a G = 65,536 fold of 3 queries
    (global atomics); appends its JSON row."""
    import torch
    from citus_tpu_torch.ops.scan_agg_fold import (
        scan_agg_fold_batched, scan_agg_fold_batched_plain,
    )
    max_err, main = 0.0, None
    cases = [("Q6 family", lambda: batched_fold_call(device, plans, "Q6"), 1),
             ("Q1 family", lambda: batched_fold_call(device, plans, "Q1"), 1),
             ("Q1 family x4 (Q=32)",
              lambda: batched_fold_call(device, plans, "Q1", repeat=4), 1),
             ("synthetic direct G=65536",
              lambda: synthetic_batched_global_case(device), 0)]
    for name, make, want_regime in cases:
        call = make()
        err = compare_fold(f"{name} batched", call, scan_agg_fold_batched,
                           scan_agg_fold_batched_plain)
        max_err = max(max_err, err)
        if scan_agg_fold_batched.last_regime != want_regime:
            raise AssertionError(
                f"scan_agg_fold_batched [{name}]: regime "
                f"{scan_agg_fold_batched.last_regime}, not {want_regime}")
        regime = {1: "shared-memory table", 0: "global atomics"}.get(
            scan_agg_fold_batched.last_regime, "none")
        kc = clone_call(call)
        ms = time_cuda(lambda: scan_agg_fold_batched(*kc))
        pc = clone_call(call)
        plain_ms = time_cuda(lambda: scan_agg_fold_batched_plain(*pc),
                             reps=3)
        nbytes = fold_bytes(call)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        masks, G = call[2], call[6]
        q, n = masks.shape
        acc = torch.zeros(q * G, dtype=torch.int64, device=device)
        gid = torch.randint(0, q * G, (n,), device=device)
        val = torch.randint(0, 1000, (n,), device=device)
        lib_ms = time_cuda(lambda: acc.index_add_(0, gid, val))
        if name == "Q1 family":
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        say(f"phase 3 scan_agg_fold_batched [{name}]: Q={q} N={n} "
            f"G={G} ops={len(call[5])} regime={regime} agrees (max abs err "
            f"of float sums {err!r}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B at "
            f"3.35 TB/s: shared columns once, Q x N masks, registers), "
            f"library yardstick (one int64 index_add_ into Q x G slots, one "
            f"op) {lib_ms:.4f} ms")
    rows.append({"name": "scan_agg_fold_batched", "route": "cuda",
                 "source": "citus_tpu_torch/csrc/scan_agg_fold_batched.cu",
                 "replaces": "citus_tpu/executor/megabatch.py:343",
                 "max_abs_err": max_err, **main, "bound_by": "bytes",
                 "library_ms": None})


def batched_hash_call(cl, device):
    """The batched insert's main-path inputs for the H family: the first
    padded SF1 shard batch, every variant's mask from the batched
    predicate kernel, the shared keys and arguments, Q_BATCH fresh
    tables of the size citus.hash_agg_slots = auto gives."""
    import torch
    from citus_tpu_torch.executor.executor import (
        _hash_key_dtypes, _hash_slots, _iter_padded_batches,
    )
    from citus_tpu_torch.ops.filter_mask import filter_mask_batched
    from citus_tpu_torch.ops.hash_agg import (
        build_shared_hash_inputs, empty_hash_state,
    )
    from citus_tpu_torch.ops.xp_torch import TorchNamespace
    cl.execute("SET citus.hash_agg_slots = auto")
    planned = [plan_as_cluster_does(cl, sql) for sql, _ in
               families()["H"][1]]
    plan, params = planned[0][0], [p for _, p in planned]
    if plan.group_mode.kind != "hash_host":
        raise AssertionError(f"H family plans to {plan.group_mode.kind}")
    S = _hash_slots(cl.catalog, plan, cl.settings)
    key_dtypes = _hash_key_dtypes(plan, {})
    batches = _iter_padded_batches(cl.catalog, plan, cl.settings)
    hb = next(batches)
    batches.close()
    cols = tuple(torch.from_numpy(a).to(device) for a in hb.cols)
    valids = tuple(torch.from_numpy(a).to(device) for a in hb.valids)
    row_mask = torch.from_numpy(hb.row_mask).to(device)
    prog, stacked = family_filter(device, plan, params)
    masks = filter_mask_batched(
        prog, predicate_columns(plan, prog, cols, valids), stacked, row_mask)
    shared, ops = build_shared_hash_inputs(plan, TorchNamespace(device),
                                           key_dtypes)
    keys, args = shared(cols, valids, row_mask)
    table = empty_hash_state(plan, S, key_dtypes, device,
                             n_queries=len(params))
    return (table, masks, keys, args, ops), hb.n_rows


def phase3_batched_hash(device, cl, rows: list) -> None:
    """hash_agg_insert_batched against its plain version: the H family
    at Q = Q_BATCH on the first SF1 shard batch into Q tables of 2^20
    slots.  Per query: the merged groups of table and spill agree, each
    key sits in at most one slot, placed + spilled = masked rows.
    Appends its JSON row."""
    import torch
    from citus_tpu_torch.ops.hash_agg_insert import (
        hash_agg_insert_batched, hash_agg_insert_batched_plain,
    )
    from citus_tpu_torch.ops.hash_agg import HashTable
    call, n_real = batched_hash_call(cl, device)
    table, masks, keys, args, ops = call
    q = masks.shape[0]
    # and the same inputs into Q tables of 1,000 slots: most rows spill
    small = HashTable([v[:, :1000].contiguous() for v in table.key_values],
                      [f[:, :1000].contiguous() for f in table.key_flags],
                      [p[:, :1000].contiguous() for p in table.partials],
                      table.rows[:, :1000].contiguous(),
                      table.state[:, :1000].contiguous())
    pops = hash_partial_ops(table, ops)
    max_err = 0.0
    for case, tab in (("S=2^20", table), ("S=1000", small)):
        kt, pt = clone_table(tab), clone_table(tab)
        ks = hash_agg_insert_batched(kt, masks, keys, args, ops)
        ps = hash_agg_insert_batched_plain(pt, masks, keys, args, ops)
        torch.cuda.synchronize()
        for qi in range(q):
            for what, t, sp in (("kernel", kt, ks), ("plain", pt, ps)):
                check_hash_invariants(f"H family {case} q{qi} {what}",
                                      t.query(qi), sp[qi], masks[qi])
            max_err = max(max_err, compare_groups(
                f"H family {case} q{qi}",
                host_groups(kt.query(qi), ks[qi], masks[qi], keys, args,
                            ops),
                host_groups(pt.query(qi), ps[qi], masks[qi], keys, args,
                            ops), pops))
        say(f"phase 3 hash_agg_insert_batched [H family, {case}]: per query "
            f"placed {kt.rows.sum(dim=1).tolist()}, spilled "
            f"{ks.sum(dim=1).tolist()}, masked "
            f"{masks.sum(dim=1).tolist()}: agrees with the plain version")
        del kt, pt
    work = clone_table(table)
    ms = time_cuda_fresh(
        lambda: hash_agg_insert_batched(work, masks, keys, args, ops),
        lambda: copy_table_(work, table))
    plain_ms = time_cuda_fresh(
        lambda: hash_agg_insert_batched_plain(work, masks, keys, args, ops),
        lambda: copy_table_(work, table), reps=3)
    copy_table_(work, table)
    hash_agg_insert_batched(work, masks, keys, args, ops)
    occupied = int((work.rows > 0).sum())
    nbytes = hash_bytes(call, occupied)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    S = table.slots
    n = masks.shape[1]
    acc = torch.zeros(q * S, dtype=torch.int64, device=device)
    slot = torch.randint(0, q * S, (n,), device=device)
    val = torch.randint(0, 1000, (n,), device=device)
    lib_ms = time_cuda(lambda: acc.index_add_(0, slot, val))
    say(f"phase 3 hash_agg_insert_batched [H family, one SF1 shard batch "
        f"({n_real} rows)]: Q={q} N={n} S={S} keys={len(keys)} "
        f"ops={len(ops)} agrees per query (merged groups of table and "
        f"spill; max abs err of float sums {max_err!r}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({nbytes} B at 3.35 TB/s: keys and "
        f"arguments once, Q masks and Q spill masks, each of the "
        f"{occupied} occupied slots of the Q tables read and written "
        f"once), kernel at {ms / bound_ms:.1f}x its bound, library yardstick (one int64 index_add_ into Q x S "
        f"slots, one op) {lib_ms:.4f} ms")
    rows.append({"name": "hash_agg_insert_batched", "route": "cuda",
                 "source": "citus_tpu_torch/csrc/hash_agg_insert_batched.cu",
                 "replaces": "citus_tpu/executor/megabatch.py:435",
                 "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": "bytes",
                 "library_ms": None})


# ------------------------------------------- sketch aggregates and rollups

#: TPC-H: S = SF * 10,000 suppliers, P = SF * 200,000 parts
SUPPLIERS, PARTS = 10_000, 200_000
#: the sketch table: TPC-H lineitem's columns of the sketch queries and
#: the rollup, distributed by l_suppkey (a rollup's group columns must
#: hold the source's distribution column); l_quantity holds TPC-H's
#: integral quantities as bigint, the type a rollup sum takes
S_DDL = """CREATE TABLE lineitem (
        l_orderkey bigint NOT NULL, l_partkey bigint,
        l_suppkey bigint NOT NULL, l_quantity bigint,
        l_extendedprice decimal(12,2), l_shipdate date)"""

S1 = """SELECT count(*), approx_count_distinct(l_orderkey),
       approx_percentile(0.5) WITHIN GROUP (ORDER BY l_extendedprice),
       approx_top_k(l_suppkey, 10)
FROM lineitem
WHERE l_shipdate >= date '1995-01-01' AND l_shipdate < date '1996-01-01'"""

#: phase 5's S family: S1 over one ship year each, 1992-1998, and 1995-H2
S_RANGES = [((y, 1, 1), (y + 1, 1, 1)) for y in range(1992, 1999)] \
    + [((1995, 7, 1), (1996, 1, 1))]

ROLLUP_AGGS = ("count(*), sum(l_quantity), approx_count_distinct(l_partkey), "
               "approx_percentile(l_extendedprice), approx_top_k(l_partkey)")
DASHBOARD = ("SELECT l_suppkey, count(*), approx_count_distinct(l_partkey) "
             "FROM lineitem GROUP BY l_suppkey")
#: rows COPYed after the backfill, in DELTA_BATCHES batches of the
#: default citus.rollup_max_batch_rows
DELTA_ROWS, DELTA_BATCHES = 262_144, 4
I64_MIN = np.iinfo(np.int64).min


def s_variant(lo: tuple, hi: tuple) -> str:
    head, _ = S1.split("WHERE")
    return (f"{head}WHERE l_shipdate >= date '{'%d-%02d-%02d' % lo}' "
            f"AND l_shipdate < date '{'%d-%02d-%02d' % hi}'")


def sketch_chunks(n_rows: int, seed: int, key_rows: int):
    """TPC-H dbgen's rules for these columns (spec 4.2.3): L_PARTKEY
    uniform in [1, P]; L_SUPPKEY one of the part's 4 suppliers,
    (partkey + i * (S/4 + (partkey - 1) / S)) mod S + 1; L_QUANTITY
    1..50; L_EXTENDEDPRICE = quantity * P_RETAILPRICE (cents:
    90000 + (partkey / 10) mod 20001 + 100 * (partkey mod 1000)); ship
    date = order date (1992-01-01 .. 1998-08-02) + 1..121 days; order
    keys as bench.py draws them.  Integer arrays, 1M-row chunks."""
    rng = np.random.default_rng(seed)
    lo, hi = _day(1992, 1, 1), _day(1998, 8, 2)
    for start in range(0, n_rows, 1_000_000):
        n = min(1_000_000, n_rows - start)
        pk = rng.integers(1, PARTS + 1, n)
        i = rng.integers(0, 4, n)
        sk = (pk + i * (SUPPLIERS // 4 + (pk - 1) // SUPPLIERS)) \
            % SUPPLIERS + 1
        qty = rng.integers(1, 51, n)
        retail = 90_000 + (pk // 10) % 20_001 + 100 * (pk % 1000)
        order = rng.integers(lo, hi + 1, n)
        yield {"orderkey": rng.integers(0, max(key_rows // 4, 1), n),
               "partkey": pk, "suppkey": sk, "qty": qty,
               "price": qty * retail,
               "ship": (order + rng.integers(1, 122, n)).astype(np.int32)}


def sketch_copy_columns(c: dict) -> dict:
    return {"l_orderkey": c["orderkey"], "l_partkey": c["partkey"],
            "l_suppkey": c["suppkey"], "l_quantity": c["qty"],
            "l_extendedprice": c["price"] / 100.0, "l_shipdate": c["ship"]}


def sketch_physical(c: dict) -> dict:
    """The engine's encoding of the generated rows (cents, days)."""
    return {"l_orderkey": c["orderkey"], "l_partkey": c["partkey"],
            "l_suppkey": c["suppkey"], "l_quantity": c["qty"],
            "l_extendedprice": c["price"], "l_shipdate": c["ship"]}


def load_sketch_table(ctt, path: str, n_rows: int):
    t0 = time.perf_counter()
    cl = ctt.Cluster(path)
    cl.execute(S_DDL)
    cl.execute("SELECT create_distributed_table('lineitem', 'l_suppkey', "
               f"{SHARDS})")
    chunks = []
    for c in sketch_chunks(n_rows, 11, n_rows):
        cl.copy_from("lineitem", columns=sketch_copy_columns(c))
        chunks.append(c)
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    say(f"phase 4 load of the sketch table: {n_rows} rows (TPC-H "
        f"l_orderkey, l_partkey, l_suppkey, l_quantity, l_extendedprice, "
        f"l_shipdate; {SUPPLIERS} suppliers) in {SHARDS} shards by "
        f"l_suppkey in {time.perf_counter() - t0:.3f} s")
    return cl, cols


def _hll_regs(bits, ok, flat_base=None, groups=1):
    from citus_tpu_torch.planner import aggregates as agg
    b, rho = agg.hll_rho_buckets(np, bits.astype(np.int64), ok)
    regs = np.zeros(groups * agg.HLL_M, np.int32)
    np.maximum.at(regs, b if flat_base is None else flat_base * agg.HLL_M + b,
                  rho)
    return regs.reshape(groups, agg.HLL_M)


def oracle_s1(cols: dict, lo: tuple = (1995, 1, 1),
              hi: tuple = (1996, 1, 1)) -> list[tuple]:
    """S1's row from the generated arrays with the port's numpy bucket
    functions (planner/aggregates.py, the cpu backend's oracle)."""
    import math
    from citus_tpu_torch.planner import aggregates as agg
    m = (cols["ship"] >= _day(*lo)) & (cols["ship"] < _day(*hi))
    n = int(m.sum())
    if n == 0:
        return [(0, 0, None, None)]
    acd = agg.hll_estimate(_hll_regs(cols["orderkey"][m], np.ones(n, bool))[0])
    counts = np.bincount(agg.ddsk_bucket_indexes(np, cols["price"][m] / 100.0),
                         minlength=agg.DDSK_M)
    cum = np.cumsum(counts)
    pct = float(agg.ddsk_bucket_values()[int(np.searchsorted(
        cum, int(math.floor(0.5 * (n - 1))) + 1, side="left"))])
    sk = cols["suppkey"][m].astype(np.int64)
    tb = agg.topk_buckets(np, sk)
    tc = np.bincount(tb, minlength=agg.TOPK_M)
    tv = np.full(agg.TOPK_M, I64_MIN)
    np.maximum.at(tv, tb, sk)
    order = sorted(np.nonzero(tc)[0], key=lambda b: (-int(tc[b]), int(tv[b])))
    topk = json.dumps([{"value": int(tv[b]), "count": int(tc[b])}
                       for b in order[:10]])
    return [(n, acd, pct, topk)]


def sketch_families() -> dict:
    return {"S": ("scalar", [
        (s_variant(lo, hi), lambda c, lo=lo, hi=hi: oracle_s1(c, lo, hi))
        for lo, hi in S_RANGES])}


def sketch_plans(device, tmp: str, n: int = FOLD_N) -> dict:
    """The S1 plan over a small sketch table, its fold inputs on one
    padded batch of ``n`` generated rows (the main path's shapes: one
    SF1 shard of four pads to 2^21), and the S family's plan and
    parameters.  -> dict."""
    import torch
    import citus_tpu_torch as ctt
    from citus_tpu_torch.executor.batches import pad_to_batch
    from citus_tpu_torch.executor.kernel_cache import plan_fingerprint
    from citus_tpu_torch.ops.scan_agg import (
        build_fold_inputs, empty_device_partials,
    )
    from citus_tpu_torch.ops.xp_torch import TorchNamespace
    from citus_tpu_torch.planner import parse_sql
    from citus_tpu_torch.planner.bind import bind_select
    from citus_tpu_torch.planner.physical import plan_select
    cl = ctt.Cluster(os.path.join(tmp, "sketch_plans"), device=device)
    cl.execute(S_DDL)
    cl.execute("SELECT create_distributed_table('lineitem', 'l_suppkey', "
               f"{SHARDS})")
    cl.copy_from("lineitem", columns=sketch_copy_columns(
        next(sketch_chunks(20_000, 3, 20_000))))
    chunks = list(sketch_chunks(n, 5, SF1_ROWS))
    physical = sketch_physical(
        {k: np.concatenate([ch[k] for ch in chunks]) for k in chunks[0]})
    plan = plan_select(cl.catalog, bind_select(cl.catalog, parse_sql(S1)[0]))
    if plan.group_mode.kind != "scalar":
        raise AssertionError(f"S1 plans to {plan.group_mode.kind}")
    values = {k: physical[k] for k in plan.scan_columns}
    masks = {k: np.ones(n, bool) for k in plan.scan_columns}
    hb = pad_to_batch(plan.bound.table, plan, values, masks, n, n, 0)
    call = build_fold_inputs(plan, TorchNamespace(device))(
        empty_device_partials(plan, device),
        tuple(torch.from_numpy(a).to(device) for a in hb.cols),
        tuple(torch.from_numpy(a).to(device) for a in hb.valids),
        torch.from_numpy(hb.row_mask).to(device))
    planned = [plan_as_cluster_does(cl, sql)
               for sql, _ in sketch_families()["S"][1]]
    if len({plan_fingerprint(p) for p, _ in planned}) != 1:
        raise AssertionError("the S family spans several plan families")
    cl.close()
    return {"s1_call": call, "physical": physical,
            "family": (planned[0][0], [p for _, p in planned])}


def adversarial_sketch_call(device, n: int, q=None, all_false=False):
    """Every sketch op (and count/sum) over a float argument holding NaN,
    +-inf, +-0.0, 1e-300, the smallest subnormal, every DDSketch bucket
    edge and its neighbours, and nulls, and an int argument holding
    INT64_MIN/MAX, 0 and -1; n not a multiple of the block.  Registers
    [M] (one query) or [q, M]."""
    import torch
    from citus_tpu_torch.ops.scan_agg_fold import SKETCH_M, FoldOp
    from citus_tpu_torch.planner import aggregates as agg
    rng = np.random.default_rng(23)
    e = np.exp(agg.DDSK_LOG_MIN + np.arange(-2, 1030) * agg.DDSK_LNG)
    edges = np.concatenate([e, np.nextafter(e, 0), np.nextafter(e, np.inf)])
    special = np.concatenate([[np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-300,
                               5e-324], edges, -edges])
    f = rng.standard_normal(n) * 10.0 ** rng.integers(-12, 12, n)
    f[:special.size] = special
    i = rng.integers(I64_MIN, np.iinfo(np.int64).max, n)
    i[:4] = [I64_MIN, np.iinfo(np.int64).max, 0, -1]

    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    args = [(to(f), to(rng.random(n) > 0.05)), (to(i), None)]
    ops = [FoldOp("count_star"), FoldOp("hll", 0), FoldOp("ddsk", 0),
           FoldOp("hll", 1), FoldOp("topk", 1), FoldOp("topkv", 1),
           FoldOp("count", 0), FoldOp("sum", 1)]
    pre = () if q is None else (q,)
    regs = []
    for op in ops:
        if op.kind in SKETCH_M:
            regs.append(torch.full(
                pre + (SKETCH_M[op.kind],), I64_MIN if op.kind == "topkv"
                else 0, dtype=torch.int32 if op.kind == "hll"
                else torch.int64, device=device))
        else:
            regs.append(torch.zeros(pre + (1,), dtype=torch.int64,
                                    device=device))
    shape = (n,) if q is None else (q, n)
    mask = to((rng.random(shape) > 0.3) & (not all_false))
    return (regs, None, mask, [], args, ops, 1)


def sketch_fold_ops(call) -> int:
    """Operations of a sketch fold on this call's data: one to read each
    mask entry, and per (query, row) the mask passes a few for a count or
    sum and ~40 for a sketch (splitmix64, the leading-zero count or a
    float64 log, the bucket and its atomic)."""
    from citus_tpu_torch.ops.scan_agg_fold import SKETCH_M
    _regs, _rows, mask, _keys, _args, ops, _g = call
    per_row = sum(40 if op.kind in SKETCH_M else 2 for op in ops)
    return mask.numel() + int(mask.sum()) * per_row


def phase3_sketch_folds(device, splans, rows: list) -> None:
    """scan_agg_fold and scan_agg_fold_batched with the sketch ops against
    their plain versions: S1's ops on one padded 2^21-row batch of the
    generated sketch table, the adversarial case (and an all-false
    mask), the S family at Q = 8 (global atomics: ~264 KB of registers)
    and at Q = 6 (the shared-memory table).  Registers identical, float
    sums within rel 1e-12.  Appends the two sketch rows of the JSON."""
    import torch
    from citus_tpu_torch.executor.megabatch import _empty_stacked_partials
    from citus_tpu_torch.ops.filter_mask import filter_mask_batched
    from citus_tpu_torch.ops.scan_agg import build_shared_fold_inputs
    from citus_tpu_torch.ops.scan_agg_fold import (
        scan_agg_fold, scan_agg_fold_batched, scan_agg_fold_batched_plain,
        scan_agg_fold_plain,
    )
    from citus_tpu_torch.ops.xp_torch import TorchNamespace
    plan, params = splans["family"]
    cols, valids, row_mask = padded_batch(device, plan, splans["physical"])
    prog, stacked = family_filter(device, plan, params)
    masks = filter_mask_batched(
        prog, predicate_columns(plan, prog, cols, valids), stacked, row_mask)
    shared, ops, G = build_shared_fold_inputs(plan, TorchNamespace(device))
    keys, args = shared(cols, valids)

    def family_call(q):
        regs, rr = _empty_stacked_partials(plan, q, device)
        return (regs, rr, masks[:q].contiguous(), keys, args, ops, G)
    n = FOLD_N + 3
    for batched, cases in (
            (False, [("S1", lambda: splans["s1_call"], 1),
                     ("adversarial", lambda: adversarial_sketch_call(
                         device, n), 1),
                     ("adversarial all-false mask",
                      lambda: adversarial_sketch_call(device, n,
                                                      all_false=True), 1)]),
            (True, [("S family Q=8", lambda: family_call(8), 0),
                    ("S family Q=6", lambda: family_call(6), 1),
                    ("adversarial Q=2", lambda: adversarial_sketch_call(
                        device, n, q=2), 1)])):
        kernel = scan_agg_fold_batched if batched else scan_agg_fold
        plain = scan_agg_fold_batched_plain if batched \
            else scan_agg_fold_plain
        name = "scan_agg_fold_batched" if batched else "scan_agg_fold"
        max_err, main = 0.0, None
        for case, make, want_regime in cases:
            call = make()
            err = compare_fold(f"{name} [{case}]", call, kernel, plain)
            max_err = max(max_err, err)
            if kernel.last_regime != want_regime:
                raise AssertionError(f"{name} [{case}]: regime "
                                     f"{kernel.last_regime}, not "
                                     f"{want_regime}")
            kc, pc = clone_call(call), clone_call(call)
            ms = time_cuda(lambda: kernel(*kc))
            plain_ms = time_cuda(lambda: plain(*pc), reps=3)
            nbytes, nops = fold_bytes(call), sketch_fold_ops(call)
            by = "bytes" if nbytes / HBM_BYTES_PER_S >= \
                nops / SIMT_OPS_PER_S else "operations"
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           nops / SIMT_OPS_PER_S) * 1e3
            if main is None:
                main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=by)
            mask = call[2]
            # yardstick: ONE index_add_ of the passing (query, row) pairs
            # into the DDSketch registers, buckets drawn beforehand
            ddsk = next(r for r, op in zip(call[0], call[5])
                        if op.kind == "ddsk")
            flat = torch.zeros(ddsk.numel(), dtype=torch.int64,
                               device=device)
            hits = int(mask.sum())
            idx = torch.randint(0, flat.numel(), (hits,), device=device)
            ones = torch.ones(hits, dtype=torch.int64, device=device)
            lib_ms = time_cuda(lambda: flat.index_add_(0, idx, ones))
            say(f"phase 3 {name} [{case}, sketch ops]: N={mask.shape[-1]}"
                f"{f' Q={mask.shape[0]}' if batched else ''} "
                f"ops={[op.kind for op in call[5]]} regime="
                f"{'shared-memory table' if kernel.last_regime else 'global atomics'}: "
                f"registers identical (max abs err of float sums {err!r}); "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({nbytes} B at 3.35 TB/s, {nops} "
                f"operations at 67 TFLOP/s: {by}), library yardstick (one "
                f"int64 index_add_ of the {hits} passing rows into the "
                f"DDSketch registers, one op) {lib_ms:.4f} ms")
        rows.append({"name": f"{name}[sketch]", "route": "cuda",
                     "source": f"citus_tpu_torch/csrc/{name}.cu",
                     "replaces": "citus_tpu/ops/scan_agg.py:84",
                     "max_abs_err": max_err, **main, "library_ms": None})


def phase3_rollup_delta(device, rows: list) -> None:
    """rollup_delta against its plain version for all six kinds, one
    delta batch of the default citus.rollup_max_batch_rows (65,536) and
    one of SF1's backfill (2^23 padded) into 10,000 groups (16,384
    padded), times beside the bytes bound and a one-op yardstick into
    the same tables.  Appends its JSON row: one 65,536-row refresh batch
    of phase 6's five aggregates (count, sum_int, hll, ddsk, topk)."""
    import torch
    from citus_tpu_torch.rollup import kernels as K
    rng = np.random.default_rng(31)
    G = K._pad_to(SUPPLIERS)
    main = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    max_err = 0.0
    for n in (65_536, 1 << 23):
        g = torch.from_numpy(rng.integers(0, SUPPLIERS, n).astype(np.int32)
                             ).to(device)
        ok = torch.from_numpy(rng.random(n) > 0.01).to(device)
        prices = rng.integers(90_000, 10_500_000, n) / 100.0
        prices[:7] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-300, 5e-324]
        fvals = torch.from_numpy(prices).to(device)
        ivals = torch.from_numpy(rng.integers(1, PARTS + 1, n)).to(device)
        for kind in K.KINDS:
            vals = None if kind == "count" else \
                fvals if kind in ("sum_float", "ddsk") else ivals
            got = K.rollup_delta(kind, vals, g, ok, G)
            want = K._tables(kind, G, device)
            K.rollup_delta_plain(kind, vals, g, ok, *want)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            for k, p in zip(got, want):
                if kind == "sum_float":
                    fin = torch.isfinite(p)
                    if not torch.equal(torch.isnan(k), torch.isnan(p)) \
                            or not torch.equal(k[~fin & ~torch.isnan(p)],
                                               p[~fin & ~torch.isnan(p)]):
                        raise AssertionError("rollup_delta sum_float: "
                                             "non-finite sums differ")
                    err = (k[fin] - p[fin]).abs()
                    if (err > 1e-12 * p[fin].abs()).any():
                        raise AssertionError("rollup_delta sum_float beyond "
                                             "rel 1e-12")
                    max_err = max(max_err, float(err.max()))
                elif not torch.equal(k, p):
                    raise AssertionError(f"rollup_delta {kind} n={n}: "
                                         "tables differ")
            ms = time_cuda(lambda: K.rollup_delta(kind, vals, g, ok, G),
                           reps=5)
            plain_ms = time_cuda(lambda: K.rollup_delta_plain(
                kind, vals, g, ok, *K._tables(kind, G, device)), reps=2)
            out_bytes = sum(t.numel() * t.element_size() for t in want
                            if t is not None)
            in_bytes = g.numel() * 4 + ok.numel() + (
                0 if vals is None else vals.numel() * 8)
            bound_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
            # yardstick: one index_add_ (scatter_reduce amax for hll) of
            # the rows into a table of the same size
            flat = torch.zeros(want[0].numel(), dtype=want[0].dtype,
                               device=device)
            idx = (g.to(torch.int64) * (flat.numel() // G)
                   + (ivals % (flat.numel() // G)))
            src = ok.to(flat.dtype)
            if kind == "hll":
                lib_ms = time_cuda(lambda: flat.scatter_reduce_(
                    0, idx, src, "amax"), reps=5)
            else:
                lib_ms = time_cuda(lambda: flat.index_add_(0, idx, src),
                                   reps=5)
            if n == 65_536 and kind != "sum_float":
                main["ms"] += ms
                main["plain_ms"] += plain_ms
                main["bound_ms"] += bound_ms
            say(f"phase 3 rollup_delta [{kind}, n={n}, G={SUPPLIERS} "
                f"({G} padded)]: tables identical"
                f"{' (sum within rel 1e-12)' if kind == 'sum_float' else ''}; "
                f"kernel {ms:.4f} ms (tables allocated and filled, then the "
                f"fold), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({in_bytes} B in, {out_bytes} B of tables out, at 3.35 "
                f"TB/s), library yardstick (one "
                f"{'scatter_reduce_ amax' if kind == 'hll' else 'index_add_'}"
                f" into a table of the same size, one op) {lib_ms:.4f} ms")
    rows.append({"name": "rollup_delta", "route": "cuda",
                 "source": "citus_tpu_torch/csrc/rollup_delta.cu",
                 "replaces": "citus_tpu/rollup/kernels.py:47",
                 "max_abs_err": max_err, **main, "bound_by": "bytes",
                 "library_ms": None})


def run_sketch_phases(ctt, tmp: str, n_rows: int, launches: dict,
                      card: str) -> None:
    """Phases 4 (S1), 5 (the S family) and 6 (rollups) on the sketch
    table; adds the main path's launches of the sketch fold, the
    batched sketch fold, the batched predicate and the rollup kernel."""
    import torch
    from citus_tpu_torch.ops.scan_agg_fold import (
        scan_agg_fold, scan_agg_fold_batched,
    )
    from citus_tpu_torch.rollup import kernels as K
    cl, cols = load_sketch_table(ctt, os.path.join(tmp, "sketch"), n_rows)
    try:
        # ---- phase 4: S1, cold then warm
        want = oracle_s1(cols)
        for run_kind in ("cold", "warm"):
            launches["scan_agg_fold[sketch]"] += run_checked(
                cl, "S1", S1, want, n_rows, run_kind)
        # ---- phase 5: the S family, serial and coalesced
        kind, variants = sketch_families()["S"]
        got = run_family(cl, "S", kind, variants, cols, n_rows, card)
        launches["scan_agg_fold_batched[sketch]"] += \
            got.pop("scan_agg_fold_batched")
        for k, v in got.items():
            launches[k] += v
        run_rollup_phase(cl, cols, n_rows, launches)
    finally:
        cl.close()


def rollup_oracle(cols: dict) -> dict:
    """Per supplier: count, sum(l_quantity) and the HLL, DDSketch and
    top-k registers over all generated rows, with the port's numpy
    bucket functions.  -> {name: [S + 1, ...] arrays}."""
    from citus_tpu_torch.planner import aggregates as agg
    sk = cols["suppkey"].astype(np.int64)
    G = SUPPLIERS + 1
    n = sk.size
    out = {"count": np.bincount(sk, minlength=G),
           "sum": np.bincount(sk, weights=cols["qty"], minlength=G
                              ).astype(np.int64)}
    pk = cols["partkey"].astype(np.int64)
    out["hll"] = _hll_regs(pk, np.ones(n, bool), sk, G)
    out["ddsk"] = np.bincount(
        sk * agg.DDSK_M + agg.ddsk_bucket_indexes(np, cols["price"] / 100.0),
        minlength=G * agg.DDSK_M).reshape(G, agg.DDSK_M)
    flat = sk * agg.TOPK_M + agg.topk_buckets(np, pk)
    out["topk"] = np.bincount(flat, minlength=G * agg.TOPK_M
                              ).reshape(G, agg.TOPK_M)
    tv = np.full(G * agg.TOPK_M, I64_MIN)
    np.maximum.at(tv, flat, pk)
    out["topkv"] = tv.reshape(G, agg.TOPK_M)
    return out


def run_rollup_phase(cl, cols: dict, n_rows: int, launches: dict) -> None:
    """Phase 6: a CDC-fed rollup of the sketch table by l_suppkey, its
    backfill, DELTA_ROWS more rows by COPY and a refresh to the CDC
    head; the stored registers and the routed dashboard must equal the
    numpy oracle over every generated row, and rollup_delta must launch
    once per aggregate per fold."""
    import torch
    from citus_tpu_torch.rollup import kernels as K
    n_aggs = len(ROLLUP_AGGS.split(","))
    cl.execute("SET citus.enable_change_data_capture = on")
    K.rollup_delta.launches = 0
    t0 = time.perf_counter()
    cl.execute(f"SELECT citus_create_rollup('li_r', 'lineitem', 'l_suppkey',"
               f" '{ROLLUP_AGGS}')")
    torch.cuda.synchronize()
    backfill_s = time.perf_counter() - t0
    if K.rollup_delta.launches != n_aggs:
        raise AssertionError(f"backfill: {K.rollup_delta.launches} "
                             f"rollup_delta launches for {n_aggs} aggregates")
    launches["rollup_delta"] += K.rollup_delta.launches
    say(f"phase 6 backfill of li_r over {n_rows} rows: {backfill_s:.3f} s, "
        f"{n_rows / backfill_s:.1f} rows folded/s, rollup_delta launches "
        f"{K.rollup_delta.launches}")
    t0 = time.perf_counter()
    delta = list(sketch_chunks(DELTA_ROWS, 12, n_rows))
    dcols = {k: np.concatenate([c[k] for c in delta]) for k in delta[0]}
    per = DELTA_ROWS // DELTA_BATCHES
    for b in range(DELTA_BATCHES):
        cl.copy_from("lineitem", columns=sketch_copy_columns(
            {k: v[b * per:(b + 1) * per] for k, v in dcols.items()}))
    say(f"phase 6 COPY of {DELTA_ROWS} more rows in {DELTA_BATCHES} batches "
        f"with change data capture on: {time.perf_counter() - t0:.3f} s")
    K.rollup_delta.launches = 0
    t0 = time.perf_counter()
    folded = cl.execute("SELECT citus_refresh_rollups()").rows[0][0]
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    folds = -(-DELTA_ROWS // cl.settings.rollup.rollup_max_batch_rows)
    if folded != DELTA_ROWS or K.rollup_delta.launches != n_aggs * folds:
        raise AssertionError(f"refresh folded {folded} rows with "
                             f"{K.rollup_delta.launches} rollup_delta "
                             f"launches ({folds} folds of {n_aggs})")
    launches["rollup_delta"] += K.rollup_delta.launches
    view = cl.execute("SELECT citus_rollups()").rows[0]
    if view[4] != view[5] or view[6] != 0:
        raise AssertionError(f"refresh stopped short of the CDC head: {view}")
    say(f"phase 6 refresh to the CDC head: {folded} rows in {folds} folds, "
        f"{refresh_s:.3f} s, {folded / refresh_s:.1f} rows folded/s, "
        f"rollup_delta launches {K.rollup_delta.launches}")
    allc = {k: np.concatenate([cols[k], dcols[k]]) for k in cols}
    n_groups, n_dash = check_rollup_state(cl, allc)
    say(f"phase 6 li_r: {n_groups} groups (count, sum, and the HLL, "
        f"DDSketch and top-k registers decoded from the sketch words) "
        f"equal the numpy oracle over all {allc['suppkey'].size} rows; the "
        f"routed dashboard ({n_dash} rows) equals it too")


def check_rollup_state(cl, allc: dict) -> tuple[int, int]:
    """li_r's stored counts, sums and sketch registers, and the routed
    dashboard's rows, against the numpy oracle over ``allc`` (every
    generated row).  -> (groups, dashboard rows)."""
    from citus_tpu_torch.planner.aggregates import TOPK_M, hll_estimate
    from citus_tpu_torch.rollup.sketches import decode_sketch
    want = rollup_oracle(allc)
    got = cl.execute("SELECT l_suppkey, n_rows, sum_l_quantity, "
                     "acd_l_partkey, apct_l_extendedprice, atopk_l_partkey "
                     "FROM li_r").rows
    present = np.nonzero(want["count"])[0]
    if sorted(r[0] for r in got) != present.tolist():
        raise AssertionError("li_r holds other suppliers than the oracle")
    for sk, n, s, hll, ddsk, topk in got:
        state = decode_sketch(topk)[1]
        if n != want["count"][sk] or s != want["sum"][sk] \
                or not np.array_equal(decode_sketch(hll)[1], want["hll"][sk]) \
                or not np.array_equal(decode_sketch(ddsk)[1],
                                      want["ddsk"][sk]) \
                or not np.array_equal(state[:TOPK_M], want["topk"][sk]) \
                or not np.array_equal(state[TOPK_M:], want["topkv"][sk]):
            raise AssertionError(f"li_r row of supplier {sk} differs from "
                                 "the numpy oracle")
    r = cl.execute(DASHBOARD)
    if r.explain.get("strategy") != "rollup":
        raise AssertionError(f"the dashboard query was not routed: "
                             f"{r.explain.get('strategy')}")
    oracle_rows = [(int(sk), int(want["count"][sk]),
                    hll_estimate(want["hll"][sk])) for sk in present]
    if sorted(r.rows) != oracle_rows:
        raise AssertionError("the routed dashboard differs from the oracle")
    return len(got), len(r.rows)


def run(args) -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import citus_tpu_torch as ctt
    from citus_tpu_torch import errors as ctt_errors
    from citus_tpu_torch.executor.device_cache import GLOBAL_CACHE
    from citus_tpu_torch.ops import cuda_build
    from citus_tpu_torch.ops.scan_agg_fold import scan_agg_fold

    # ---- phase 1: card and versions
    card = card_line()
    say("phase 1 card:", card)
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    say(f"phase 1 versions: python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda} nvcc {nvcc}")
    device = torch.device("cuda", 0)

    tmp = tempfile.mkdtemp(prefix="citus_tpu_torch_smoke_")
    try:
        plans = smoke_plans(device, tmp)
        splans = sketch_plans(device, tmp)
        # ---- phase 2: build every kernel, all nvcc processes at once;
        # then one more generated predicate alone, for its cold build time
        t0 = time.perf_counter()
        kernels = ["scan_agg_fold", "hash_agg_insert", "scan_agg_fold_batched",
                   "hash_agg_insert_batched", "rollup_delta"]
        # the predicates of Q6 and P1 and of the phase-5 families (each
        # generated source holds the one-query and the batched kernel);
        # Q6's and P's families share Q6's and P1's sources
        sources = [plans["filters"][q][0].predicate.source
                   for q in ("q6", "p1")]
        for fplan, fparams in list(plans["families"].values()) \
                + [splans["family"]]:
            src = family_filter("cpu", fplan, fparams)[0].predicate.source
            if src not in sources:
                sources.append(src)
        jobs = [cuda_build.start_generated("filter_mask", src)
                for src in sources]
        cuda_build.build_all(kernels)
        for job in jobs:
            cuda_build.finish_generated(job)
        say(f"phase 2 build: {len(kernels)} kernels and {len(jobs)} "
            f"generated predicates in {time.perf_counter() - t0:.3f} s")
        for k in kernels:
            for line in cuda_build.build_log(k).splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    say(f"phase 2 ptxas {k}: {line.strip()}")
        t0 = time.perf_counter()
        plans["filters"]["syn"][0].library()
        say(f"phase 2 cold nvcc build of one generated predicate (the "
            f"synthetic one) alone: {time.perf_counter() - t0:.3f} s")

        # ---- phase 3: kernel vs plain version at the main path's shapes
        n_rows = args.rows
        if n_rows != SF1_ROWS:
            say(f"phase 4 NOTE: scale cut to {n_rows} rows (SF1 is {SF1_ROWS})")
        torch.cuda.reset_peak_memory_stats(device)
        hits0 = GLOBAL_CACHE.hits
        cl, cols = load_lineitem(ctt, os.path.join(tmp, "sf"), n_rows)
        kernel_rows: list = []
        phase3_fold(device, plans, kernel_rows)
        phase3_hash(device, cl, kernel_rows)
        phase3_filter(device, plans, kernel_rows)
        phase3_batched_filter(device, plans, kernel_rows)
        phase3_batched_fold(device, plans, kernel_rows)
        phase3_batched_hash(device, cl, kernel_rows)
        phase3_sketch_folds(device, splans, kernel_rows)
        phase3_rollup_delta(device, kernel_rows)
        launches = dict.fromkeys(launch_counters(), 0)
        launches.update({"scan_agg_fold[sketch]": 0,
                         "scan_agg_fold_batched[sketch]": 0})
        fams = families()

        def phase5(cl, name, cols, n_rows):
            kind, variants = fams[name]
            for k, v in run_family(cl, name, kind, variants, cols,
                                   n_rows, card).items():
                launches[k] += v

        # ---- phase 4: the main path through the port's entry points
        for run_kind in ("cold", "warm"):
            launches["scan_agg_fold"] += run_checked(
                cl, "Q6", Q6, oracle_q6(cols), n_rows, run_kind)
        cl.execute("SET citus.hash_agg_slots = auto")
        for qname, sql, want in (("H1", H1, oracle_h1(cols)),
                                 ("H2", H2, oracle_h2(cols))):
            for run_kind in ("cold", "warm"):
                launches["hash_agg_insert"] += run_checked(
                    cl, qname, sql, want, n_rows, run_kind,
                    "hash_agg_insert")
        want_p1 = oracle_p1(cols)
        for run_kind in ("cold", "warm"):
            launches["filter_mask"] += run_checked(
                cl, "P1", P1, want_p1, n_rows, run_kind, "filter_mask")
        # ---- phase 5: literal families coalesced, on the SF1 lineitem
        for name in ("Q6", "H", "P"):
            phase5(cl, name, cols, n_rows)
        q1_rows = n_rows
        if q1_guard_fires(cols):
            # the engine's int64 overflow guard (executor/finalize.py
            # _check_sum_overflow, as in citus_tpu) rejects Q1's
            # sum_charge here: it must raise, after folding every batch
            scan_agg_fold.launches = 0
            try:
                cl.execute(Q1)
            except ctt_errors.ExecutionError as e:
                if "out of range" not in str(e):
                    raise
            else:
                raise AssertionError(
                    "Q1 answered where the int64 overflow guard must fire")
            if scan_agg_fold.launches != SHARDS:
                raise AssertionError(
                    f"Q1 at {n_rows} rows: {scan_agg_fold.launches} kernel "
                    f"launches for {SHARDS} one-batch shards")
            launches["scan_agg_fold"] += scan_agg_fold.launches
            say(f"phase 4 Q1 at {n_rows} rows: the int64 overflow guard "
                f"fires as the oracle predicts (largest group sum_charge "
                f"{q1_max_charge(cols)} at scale 8 >= 2^62), after "
                f"{scan_agg_fold.launches} kernel launches")
            cl.close()
            q1_rows = Q1_ROWS
            cl, cols = load_lineitem(ctt, os.path.join(tmp, "q1"), q1_rows)
        for run_kind in ("cold", "warm"):
            launches["scan_agg_fold"] += run_checked(
                cl, "Q1", Q1, oracle_q1(cols), q1_rows, run_kind)
        phase5(cl, "Q1", cols, q1_rows)
        cl.close()
        # ---- phases 4-6 of the sketch aggregates and rollups
        run_sketch_phases(ctt, tmp, n_rows, launches, card)
        say(f"phase 4 device cache hits {GLOBAL_CACHE.hits - hits0}, "
            f"peak device memory {torch.cuda.max_memory_allocated(device)} B")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for row in kernel_rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} never launched on the "
                                 "main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {
        "card": card,
        "kernels": [{k: row[k] for k in keys} for row in kernel_rows],
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=SF1_ROWS,
                    help="lineitem rows of the main path (default: SF1)")
    args = ap.parse_args()
    out = run(args)
    say(json.dumps({"kernels": out["kernels"]}))
    say(out["card"])
    print(json.dumps({"ok": True, "device": out["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
