"""Chip smoke test of citus_tpu_torch on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py [--rows N]

Phases, each on its own lines; any failure exits non-zero and prints no
result line:

1. the card (``nvidia-smi`` name and power limit) and the torch, CUDA
   and nvcc versions;
2. build of every CUDA kernel of the port from ``citus_tpu_torch/csrc``
   (one nvcc per source, all started together);
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes: ``scan_agg_fold`` for TPC-H Q6 (scalar mode) and
   Q1 (direct mode, G = 12, the shared-memory regime) on 2^21 generated
   lineitem rows (the padded batch of one SF1 shard of four), and a
   direct G = 65,536 fold (the global-atomics regime) with nulls, NaN,
   +-inf, +-0.0, an all-false mask and N not a multiple of the block.
   int64 registers, min/max and NaN positions must be identical, float64
   sums within rel 1e-12 (atomics add in another order).  Each kernel is
   timed (CUDA events around 25 launches, median of 3) beside its bound, its plain
   version and a one-op library yardstick;
4. the main path through the port's entry points: ``Cluster(tmpdir)``
   on CUDA, bench.py's lineitem (schema, generator, seed 7) at TPC-H SF1
   (6,001,215 rows) in 4 shards, bench.py's Q6 cold and warm (served from
   the device cache).  At SF1, bench.py's Q1 trips the engine's int64
   overflow guard on sum_charge (a decimal(38,8) sum whose float64
   shadow passes 2^62; citus_tpu refuses it the same way): the script
   checks that the guard fires exactly where the oracle says it must,
   then runs Q1 cold and warm on 5,000,000 rows, the largest round scale
   the guard admits.  Rows must equal those computed straight from the
   generated numpy arrays (exact int64 cents grouped with np.unique),
   and the kernel's launch count must grow by exactly each query's
   fused dispatches.

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


def oracle_q1(cols: dict) -> list[tuple]:
    keep = cols["ship"] <= _day(1998, 9, 2)
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


def oracle_q6(cols: dict) -> list[tuple]:
    keep = ((cols["ship"] >= _day(1994, 1, 1))
            & (cols["ship"] < _day(1995, 1, 1))
            & (cols["disc"] >= 5) & (cols["disc"] <= 7)
            & (cols["qty"] < 2400))
    rev = int((cols["price"][keep].astype(np.int64)
               * cols["disc"][keep]).sum())
    return [(_dec(rev, 4),)]


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


def main_path_fold_calls(device, tmp: str):
    """The fold inputs the main path gives the kernel for Q6 and Q1: the
    port's own plans (over a small lineitem, for the key domains),
    applied to one padded batch of FOLD_N generated rows."""
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

    def ids(col, words):
        return np.array([cl.catalog.lookup_string_id("lineitem", col, w)
                         for w in words], np.int32)
    chunks = list(lineitem_chunks(FOLD_N))
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
        masks = {k: np.ones(FOLD_N, bool) for k in plan.scan_columns}
        hb = pad_to_batch(plan.bound.table, plan, values, masks, FOLD_N,
                          FOLD_N, 0)
        dcols = tuple(torch.from_numpy(a).to(device) for a in hb.cols)
        dvalids = tuple(torch.from_numpy(a).to(device) for a in hb.valids)
        dmask = torch.from_numpy(hb.row_mask).to(device)
        acc = empty_device_partials(plan, device)
        calls[name] = build_fold_inputs(plan, xp)(acc, dcols, dvalids, dmask)
    cl.close()
    return calls


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


def run_checked(cl, qname: str, sql: str, want: list, n_rows: int,
                run_kind: str) -> int:
    """Run one query; its rows must equal the oracle's and the kernel's
    launches its fused dispatches.  -> kernel launches."""
    import torch
    from citus_tpu_torch.ops.scan_agg_fold import scan_agg_fold
    scan_agg_fold.launches = 0
    t0 = time.perf_counter()
    r = cl.execute(sql)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = scan_agg_fold.launches
    pipe = r.explain["pipeline"]
    if got != pipe["fused_dispatches"] or got == 0:
        raise AssertionError(f"{qname} {run_kind}: {got} kernel launches "
                             f"for {pipe['fused_dispatches']} fused dispatches")
    if r.rows != want:
        raise AssertionError(f"{qname} {run_kind}: rows differ from the "
                             f"numpy oracle:\n{r.rows}\n{want}")
    say(f"phase 4 {qname} {run_kind} at {n_rows} rows: rows equal the numpy "
        f"oracle; {n_rows / dt:.1f} rows/s ({dt:.4f} s), fused_dispatches "
        f"{pipe['fused_dispatches']}, kernel launches {got}, "
        f"stream_window_peak_bytes {pipe.get('stream_window_peak_bytes', 0)}, "
        f"host_decode_ms {pipe.get('host_decode_ms', 0)}, "
        f"device_ms {pipe.get('device_ms', 0)}")
    return got


# ------------------------------------------------------------- main


def run(args) -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import citus_tpu_torch as ctt
    from citus_tpu_torch import errors as ctt_errors
    from citus_tpu_torch.executor.device_cache import GLOBAL_CACHE
    from citus_tpu_torch.ops import cuda_build
    from citus_tpu_torch.ops.scan_agg_fold import (
        scan_agg_fold, scan_agg_fold_plain,
    )

    # ---- phase 1: card and versions
    card = card_line()
    say("phase 1 card:", card)
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    say(f"phase 1 versions: python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda} nvcc {nvcc}")
    device = torch.device("cuda", 0)

    # ---- phase 2: build every kernel, all nvcc processes at once
    t0 = time.perf_counter()
    kernels = ["scan_agg_fold"]
    cuda_build.build_all(kernels)
    say(f"phase 2 build: {len(kernels)} kernel(s) in "
        f"{time.perf_counter() - t0:.3f} s")
    for k in kernels:
        for line in cuda_build.build_log(k).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                say(f"phase 2 ptxas {k}: {line.strip()}")

    tmp = tempfile.mkdtemp(prefix="citus_tpu_torch_smoke_")
    try:
        # ---- phase 3: kernel vs plain version at the main path's shapes
        calls = main_path_fold_calls(device, tmp)
        cases = [("q6 scalar G=1", calls["q6"]),
                 ("q1 direct G=12", calls["q1"])]
        for all_false in (False, True):
            cases.append((f"direct G=65536{' all-false mask' if all_false else ''}",
                          synthetic_global_case(device, FOLD_N + 3, 65536,
                                                21, all_false)))
        timings = {}
        max_err = 0.0
        for name, call in cases:
            err = compare_fold(name, call, scan_agg_fold,
                               scan_agg_fold_plain)
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
            timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
            say(f"phase 3 scan_agg_fold [{name}]: N={n} G={G} "
                f"ops={len(call[5])} regime={regime} agrees "
                f"(max abs err of float sums {err!r}); kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({nbytes} B at 3.35 TB/s), library yardstick "
                f"(one int64 index_add_, one op) {lib_ms:.4f} ms")

        # ---- phase 4: the main path through the port's entry points
        n_rows = args.rows
        if n_rows != SF1_ROWS:
            say(f"phase 4 NOTE: scale cut to {n_rows} rows (SF1 is {SF1_ROWS})")
        torch.cuda.reset_peak_memory_stats(device)
        hits0 = GLOBAL_CACHE.hits
        cl, cols = load_lineitem(ctt, os.path.join(tmp, "sf"), n_rows)
        launches = 0
        for run_kind in ("cold", "warm"):
            launches += run_checked(cl, "Q6", Q6, oracle_q6(cols), n_rows,
                                    run_kind)
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
            launches += scan_agg_fold.launches
            say(f"phase 4 Q1 at {n_rows} rows: the int64 overflow guard "
                f"fires as the oracle predicts (largest group sum_charge "
                f"{q1_max_charge(cols)} at scale 8 >= 2^62), after "
                f"{scan_agg_fold.launches} kernel launches")
            cl.close()
            q1_rows = Q1_ROWS
            cl, cols = load_lineitem(ctt, os.path.join(tmp, "q1"), q1_rows)
        for run_kind in ("cold", "warm"):
            launches += run_checked(cl, "Q1", Q1, oracle_q1(cols), q1_rows,
                                    run_kind)
        cl.close()
        say(f"phase 4 device cache hits {GLOBAL_CACHE.hits - hits0}, "
            f"peak device memory {torch.cuda.max_memory_allocated(device)} B")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    t = timings["q1 direct G=12"]
    return {
        "card": card,
        "kernels": [{
            "name": "scan_agg_fold",
            "route": "cuda",
            "source": "citus_tpu_torch/csrc/scan_agg_fold.cu",
            "replaces": "citus_tpu/ops/scan_agg.py:277",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        }],
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
