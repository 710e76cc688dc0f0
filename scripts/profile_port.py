"""Where the warm time of chip_smoke.py's queries goes in citus_tpu_torch
on one CUDA card.

    python3 scripts/profile_port.py [--rows N] [--reps R]
                                    [--package-root DIR]
    python3 scripts/profile_port.py --kernels [--no-checks]
                                    [--cases PREFIX,...]
                                    [--package-root DIR]

Loads bench.py's lineitem (chip_smoke.py's copy of its generator, 4
shards) on the card, runs each of Q1, Q6, H1, H2 and P1 twice (for Q1
and Q6 the second run is served from the device cache; the hash GROUP
BY and the projection read the stripes on every run, as their executor
paths do, with citus.hash_agg_slots = auto), then R more times under
``torch.profiler`` and prints, per query: the wall time per run, the
device time per run summed over CUDA kernels and copies, the device's
busy share of the wall time, the device kernels per run (the port's, by
chip_smoke.py's PORT_KERNELS, and every other one, PyTorch's
elementwise kernels among them) and copies, and the kernels that took
most of the device time.  The same for S1 on chip_smoke.py's sketch
table.  ``--package-root`` imports ``citus_tpu_torch`` from another
checkout (say, the parent commit unpacked with ``git archive``), so two
trees are compared in one call.  Then the same for chip_smoke.py's phase-5 literal families
(8 variants each of Q6, H2, P1 and Q1, sent from 8 threads at once with
citus.megabatch_window_ms = 1000 and megabatch_max_size = 8, so they
coalesce): per round of 8 queries.

``--kernels`` times the kernels instead, with the chip_smoke.py and the
citus_tpu_torch of ``--package-root``: after a second of back-to-back
folds (so that no case is timed while the card's clocks ramp up), that
chip_smoke.py's phase-3 cases of scan_agg_fold, scan_agg_fold_batched
(sketch families too), exchange_blocks, hash_agg_insert,
hash_agg_merge, hash_agg_insert_batched, sorted_join, filter_mask,
filter_mask_batched, pack_blocks, mesh_combine and rollup_delta, each
held against its plain version and timed as phase 3 times it (skipped
with ``--no-checks``);
then, for each case, its device time a call (torch.profiler, the mean
of KERNEL_REPS calls, host time apart; a call that updates a hash
table in place runs on a fresh copy each time, whose copy is profiled
alone and taken out), the device time and launches a call of each
kernel name it runs, and its wrapper time (CUDA events around the
call, the median of 10), the generated kernels' register and spill
counts from ptxas, and one JSON line of it all.  The cases: the folds
(Q6, Q1, S1, the Q6 and Q1 families), B2's main, clustered and
adversarial inserts, the H family (B5c), R1's merge (B3), B8 at QJOIN
SF1, many-to-many and one skewed gid, the one-query predicate (B4) of
P1, Q6 and C1 over every node kind, the batched predicate (B5a) of the
Q6, Q1, H, P and C1all families at Q = 8, and the partition (B7) of
QJOIN's lineitem and orders_b sides (n_dev = 1), lineitem to 8
destinations, overflowing, and one member of phase 9's mesh to 4; the
combine (B6) of Q1's, S1's and a G = 65,536 fold's registers over 4
members, each member's registers separate tensors; the rollup delta
fold (B9) of each of its six kinds at n = 65,536 and 2^23 into 16,384
groups, the wrapper's call (tables allocated and filled, then the
fold), and its yardstick, one ``index_add_`` of the 2^23 rows into a
table of top-k's size.
``--cases B4,B7`` keeps the cases whose names start so.  The inputs of
the cases that the tree's chip_smoke.py may lack (the clustered insert,
the sort join's, predicate and partition cases) come from this
checkout's.  Run it in turns on two trees
(parent, change, change, parent) to compare them in one call.  Fails
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: calls a fold case's device time is the mean of (--kernels), and the
#: idle seconds at each end of its profiler session (a session that
#: starts or ends busy may lose its record)
KERNEL_REPS = 100
KERNEL_PAUSE_S = 0.5


def _module(path: str, name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_profile(fn, reset, reps: int) -> dict:
    """-> {kernel name: (device ms a call, launches a call)} of ``fn``
    alone: ``reps`` calls, each after ``reset`` (None: nothing), under
    torch.profiler, less a session of the resets alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def session(call: bool) -> dict:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(KERNEL_PAUSE_S)
            for _ in range(reps):
                if reset is not None:
                    reset()
                if call:
                    fn()
            torch.cuda.synchronize()
            time.sleep(KERNEL_PAUSE_S)
        return {e.key: (e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type.name == "CUDA"}
    with_fn = session(True)
    alone = session(False) if reset is not None else {}
    out = {}
    for name, (us, count) in with_fn.items():
        us0, count0 = alone.get(name, (0.0, 0))
        if count > count0:
            out[name] = ((us - us0) / 1e3 / reps, (count - count0) / reps)
    return out


def kernels(root: str, no_checks: bool = False, only=()) -> int:
    """``--kernels``: phase 3's cases of ``root``'s chip_smoke.py and
    citus_tpu_torch, then every case's device and wrapper times (of the
    cases whose names start with one of ``only``, if any)."""
    import torch

    # both of root: each tree's phase 3 checks its own regimes and launches
    sys.path.insert(0, root)
    import chip_smoke as cs
    here = cs if root == ROOT else _module(
        os.path.join(ROOT, "chip_smoke.py"), "chip_smoke_cases")
    import citus_tpu_torch as ctt
    from citus_tpu_torch.ops import cuda_build
    from citus_tpu_torch.ops.hash_agg_insert import (
        INSERT_BUILD, hash_agg_insert, hash_agg_insert_batched,
    )
    from citus_tpu_torch.ops.hash_agg_merge import hash_agg_merge
    from citus_tpu_torch.ops.scan_agg_fold import (
        FOLD_BUILD, scan_agg_fold, scan_agg_fold_batched,
    )
    from citus_tpu_torch.ops.filter_mask import (
        filter_mask, filter_mask_batched,
    )
    from citus_tpu_torch.parallel.mesh import mesh_combine
    from citus_tpu_torch.parallel.shuffle import pack_blocks, sorted_join
    from citus_tpu_torch.rollup import kernels as rollup_kernels
    from citus_tpu_torch.rollup.kernels import rollup_delta
    device = torch.device("cuda", 0)
    card = cs.card_line()
    package = os.path.dirname(ctt.__file__)
    print("card:", card, flush=True)
    print("package:", package, flush=True)
    tmp = tempfile.mkdtemp()
    t0 = time.perf_counter()
    plans = cs.smoke_plans(device, tmp)
    splans = cs.sketch_plans(device, tmp)
    # every generated fold and insert phase 3 launches and the fixed
    # kernels, all nvcc processes at once
    jobs = [cuda_build.start_generated(INSERT_BUILD if p.hashed
                                       else FOLD_BUILD, p.row.source)
            for p in {p.row.source: p for p in cs.generated_programs(
                plans, splans, tmp)}.values()]
    # and the predicates of the B4 and B5a cases
    preds = [plans["filters"][k][0].predicate.source
             for k in ("p1", "q6", "c1_all", "syn")]
    for name in ("Q6", "Q1", "H", "P", "C1", "C1all"):
        preds.append(cs.family_filter("cpu", *plans["families"][name])[0]
                     .predicate.source)
    jobs += [cuda_build.start_generated("filter_mask", src)
             for src in dict.fromkeys(preds)]
    cuda_build.build_all(["hash_agg_merge", "sorted_join", "partition_pack",
                          "mesh_exchange", "mesh_combine", "rollup_delta"])
    for job in jobs:
        cuda_build.finish_generated(job)
    cl, _ = cs.load_lineitem(ctt, os.path.join(tmp, "sf"), cs.SF1_ROWS)
    print(f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    folds = plans["fold_calls"]
    warm = cs.clone_call(folds["q1"])
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        for _ in range(50):
            scan_agg_fold(*warm)
        torch.cuda.synchronize()
    rows: list = []
    sides = cs.qjoin_sides(cs.SF1_ROWS, device)
    if not no_checks:
        cs.phase3_fold(device, plans, rows)
        cs.phase3_batched_fold(device, plans, rows)
        cs.phase3_sketch_folds(device, splans, rows)
        cs.phase3_mesh_exchange(device, rows, sides)
        cs.phase3_hash(device, cl, rows)
        cs.phase3_merge(device, tmp, rows)
        cs.phase3_batched_hash(device, cl, rows)
        cs.phase3_sorted_join(device, rows, sides)
        cs.phase3_filter(device, plans, rows)
        cs.phase3_batched_filter(device, plans, rows)
        cs.phase3_partition_pack(device, cs.SF1_ROWS, rows, sides)
        cs.phase3_mesh_combine(device, plans, splans, rows)
        cs.phase3_rollup_delta(device, rows)

    def fold(kernel, call):
        kc = cs.clone_call(call)
        return (lambda: kernel(*kc)), None, (FOLD_BUILD, call[0].row.source)

    def table_case(kernel, call, at):
        """A call whose table (argument ``at``) a fresh copy of which
        every call updates."""
        table = call[at]
        work = cs.clone_table(table)
        args = list(call)
        args[at] = work
        return ((lambda: kernel(*args)),
                (lambda: cs.copy_table_(work, table)), None)

    hash_call, n_real = cs.main_path_hash_call(cl, device)
    cases = {
        "Q6": fold(scan_agg_fold, folds["q6"]),
        "Q1": fold(scan_agg_fold, folds["q1"]),
        "S1": fold(scan_agg_fold, splans["s1_call"]),
        "Q6 family Q=8": fold(scan_agg_fold_batched,
                              cs.batched_fold_call(device, plans, "Q6")),
        "Q1 family Q=8": fold(scan_agg_fold_batched,
                              cs.batched_fold_call(device, plans, "Q1")),
        "B2 main": table_case(hash_agg_insert, hash_call, 1),
        "B2 clustered": table_case(
            hash_agg_insert, here.clustered_hash_call(hash_call, n_real), 1),
        "B2 adversarial": table_case(
            hash_agg_insert,
            cs.adversarial_hash_call(device, cs.FOLD_N + 3, 1000, 31,
                                     False), 1),
        "B5c H family Q=8": table_case(hash_agg_insert_batched,
                                       cs.batched_hash_call(cl, device)[0],
                                       1),
        "B3 R1 merge": table_case(
            hash_agg_merge,
            cs.main_path_merge_call(device, tempfile.mkdtemp())[0], 0),
    }
    for name, args in here.sorted_join_cases(device, sides):
        if name in ("QJOIN SF1", "many-to-many") or name.startswith("one"):
            cases[f"B8 {name}"] = ((lambda a=args: sorted_join(*a)), None,
                                   None)
    for name, prog, call in here.filter_cases(device, plans):
        if name != "syn":
            cases[f"B4 {name}"] = ((lambda p=prog, c=call: filter_mask(p, *c)),
                                   None, ("filter_mask", prog.predicate.source))
    for name, prog, call in here.batched_filter_cases(
            device, plans, ("Q6", "Q1", "H", "P", "C1all")):
        cases[f"B5a {name} family Q={cs.Q_BATCH}"] = (
            (lambda p=prog, c=call: filter_mask_batched(p, *c)), None,
            ("filter_mask", prog.predicate.source))
    for name, args in here.partition_cases(device, sides):
        cases[f"B7 {name}"] = ((lambda a=args: pack_blocks(*a)), None,
                               ("partition_pack", None))
    for name, call, empty in (
            ("Q1", folds["q1"], -1), ("S1", splans["s1_call"], -1),
            ("G=65,536", cs.synthetic_global_case(device, cs.FOLD_N, 65_536,
                                                  3, False), 2)):
        kinds, members = here.member_registers(call, here.MESH_MEMBERS,
                                               empty)
        cases[f"B6 {name}"] = (
            (lambda k=kinds, m=members: mesh_combine(k, m)), None,
            ("mesh_combine", None))
    groups = rollup_kernels._pad_to(here.SUPPLIERS)
    for n in here.ROLLUP_BATCHES:
        batch = here.rollup_batch(device, n, 31 + n)
        for kind, args in batch.items():
            cases[f"B9 {kind} n={n}"] = (
                (lambda a=args, k=kind: rollup_delta(k, *a, groups)), None,
                ("rollup_delta", None))
    # the topk fold's yardstick: one index_add_ of the backfill batch's
    # ok rows into a [G * TOPK_M] int64 table allocated beforehand
    _, g, ok = batch["topk"]
    m = rollup_kernels.TOPK_M
    flat = torch.zeros(groups * m, dtype=torch.int64, device=device)
    idx = g.to(torch.int64) * m + batch["topk"][0] % m
    src = ok.to(torch.int64)
    cases[f"B9 yardstick topk n={n}"] = (
        (lambda: flat.index_add_(0, idx, src)), None, None)
    if only:
        cases = {k: v for k, v in cases.items()
                 if any(k.startswith(o) for o in only)}
    device_ms, wrapper_ms, by_kernel = {}, {}, {}
    for name, (fn, reset, source) in cases.items():
        if reset is not None:
            reset()
        fn()  # built, loaded and allocated before the profiled calls
        torch.cuda.synchronize()
        per = device_profile(fn, reset, KERNEL_REPS)
        device_ms[name] = sum(ms for ms, _ in per.values()) or None
        wrapper_ms[name] = cs.time_cuda_fresh(fn, reset or (lambda: None))
        by_kernel[name] = {k: [round(ms, 6), n] for k, (ms, n) in per.items()}
        print(f"{name}: device "
              + (f"{device_ms[name]:.4f} ms a call" if per
                 else "not measured (no device record)")
              + f", {sum(n for _, n in per.values()):g} launches a call; "
              f"wrapper {wrapper_ms[name]:.4f} ms ({card})", flush=True)
        for k, (ms, n) in sorted(per.items(), key=lambda kv: -kv[1][0]):
            print(f"  {ms:9.4f} ms {n:6g} a call  {k[:100]}", flush=True)
        if source is not None:
            for line in cuda_build.build_log(*source).splitlines():
                if "registers" in line or "spill" in line:
                    print(f"{name} ptxas: {line.strip()}", flush=True)
    for line in cuda_build.build_log(INSERT_BUILD,
                                     hash_call[0].row.source).splitlines():
        if "registers" in line or "spill" in line:
            print(f"B2 ptxas: {line.strip()}", flush=True)
    for line in cuda_build.build_log("sorted_join").splitlines():
        if "registers" in line or "spill" in line:
            print(f"B8 ptxas: {line.strip()}", flush=True)
    cl.close()
    print(json.dumps({"card": card, "package": package,
                      "ms": {r["name"]: r["ms"] for r in rows},
                      "device_ms": device_ms, "wrapper_ms": wrapper_ms,
                      "kernels": by_kernel}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=5_000_000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--package-root", default=ROOT,
                    help="checkout whose citus_tpu_torch is profiled")
    ap.add_argument("--kernels", action="store_true",
                    help="time phase 3's kernels")
    ap.add_argument("--no-checks", action="store_true",
                    help="with --kernels: time the cases without phase 3's "
                         "checks against the plain versions")
    ap.add_argument("--cases", default="",
                    help="with --kernels: time only the cases whose names "
                         "start with one of these comma-separated prefixes")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: no CUDA device")
    if args.kernels:
        return kernels(os.path.abspath(args.package_root), args.no_checks,
                       tuple(c for c in args.cases.split(",") if c))
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    # the package of --package-root; chip_smoke.py stays this checkout's
    sys.path.insert(0, os.path.abspath(args.package_root))
    import citus_tpu_torch as ctt
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print("card:", card, flush=True)
    print("package:", os.path.dirname(ctt.__file__), flush=True)
    cl = ctt.Cluster(os.path.join(tempfile.mkdtemp(), "db"))
    cl.execute(cs.LINEITEM_DDL)
    cl.execute(f"SELECT create_distributed_table('lineitem', 'l_orderkey', {cs.SHARDS})")
    for c in cs.lineitem_chunks(args.rows):
        cl.copy_from("lineitem", columns=cs.copy_columns(c))
    cl.execute("SET citus.hash_agg_slots = auto")
    def profiled(name, run):
        run()
        run()  # warm: plan cached (Q1/Q6: batches cached too)
        torch.cuda.synchronize()
        # idle at each end of the session, as chip_smoke.py's retries do:
        # late in a long process a shorter session may lose its record
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(cs.PROFILE_RETRY_PAUSE_S)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.reps
            time.sleep(cs.PROFILE_RETRY_PAUSE_S)
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
        device_us = sum(e.self_device_time_total for e in events) / args.reps
        copies = sum(e.count for e in events
                     if e.key.lower().startswith(("memcpy", "memset")))
        port = sum(e.count for e in events
                   if any(k in e.key for k in cs.PORT_KERNELS))
        other = sum(e.count for e in events) - copies - port
        print(f"{name} warm at {args.rows} rows: wall {wall * 1e3:.3f} ms/run, "
              f"device {device_us / 1e3:.3f} ms/run, device busy share "
              f"{device_us / 1e6 / wall:.4f}; device kernels per run: "
              f"{port / args.reps:g} of the port, {other / args.reps:g} "
              f"other, {copies / args.reps:g} copies and sets ({card})",
              flush=True)
        events.sort(key=lambda e: -e.self_device_time_total)
        for e in events[:8]:
            print(f"  {e.self_device_time_total / args.reps / 1e3:9.4f} ms/run "
                  f"{e.count // args.reps:5d} calls/run  {e.key[:90]}",
                  flush=True)

    for name, sql in (("Q1", cs.Q1), ("Q6", cs.Q6), ("H1", cs.H1),
                      ("H2", cs.H2), ("P1", cs.P1)):
        profiled(name, lambda: cl.execute(sql))
    scl, _ = cs.load_sketch_table(ctt, os.path.join(tempfile.mkdtemp(),
                                                    "sketch"), args.rows)
    profiled("S1", lambda: scl.execute(cs.S1))
    scl.close()
    cl.execute(f"SET citus.megabatch_max_size = {cs.Q_BATCH}")
    for name, (_kind, variants) in cs.families().items():
        sqls = [sql for sql, _ in variants]

        def coalesced():
            cl.execute("SET citus.megabatch_window_ms = 1000")
            _, errors = cs.fanout(cl, sqls)
            cl.execute("SET citus.megabatch_window_ms = 0")
            if errors:
                raise SystemExit(f"profile_port: {name} family: {errors}")
        profiled(f"{name} family, {len(sqls)} coalesced queries", coalesced)
    cl.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
