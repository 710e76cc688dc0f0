"""chip_smoke.py's phase 11, 12 or 13 alone, at a chosen size.

On a machine with a CUDA card (a bring-up check of one phase without
the others; it needs nothing built beforehand):

    python3 scripts/phase_alone.py --phase 11 --rows 1000000
    python3 scripts/phase_alone.py --phase 12 --rows 1500303
    python3 scripts/phase_alone.py --phase 13 --rows 6001215

Phase 11 loads phase 4's generated lineitem at ``--rows`` rows on the
card, then runs ``chip_smoke.run_phase11`` (its kernels' sources from
``phase11_sources``, built during its load).  Phase 12 runs
``chip_smoke.run_phase12`` over ``--rows`` of bench.py's orders_b rows
(its sources from ``phase12_sources``, built during its COPY FROM).  Phase 13 loads
phase 4's lineitem at ``--rows`` rows and phase 8's orders_b at a
quarter of them, then runs ``chip_smoke.run_phase13`` (its sources from
``phase13_sources``, built during the loads).  Each prints the phase's
lines.

With ``--cpu``, on a ``Cluster(device="cpu")``: phase 11 times only its
load (the partitioned table's DDL, 84 monthly partitions of 4 shards,
and one ``copy_from`` of ``--rows`` generated rows routed to them);
phases 12 and 13 run whole, on the kernels' plain versions with no
profiled run, for their host times on the CPU.
"""

import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

#: each phase's ``--rows`` when it is not given: lineitem rows of phase
#: 11, orders of phase 12
DEFAULT_ROWS = {11: 1_000_000, 12: chip_smoke.SF1_ROWS // 4,
                13: chip_smoke.SF1_ROWS}


def phase11_cpu_load(tmp: str, rows: int) -> None:
    import citus_tpu_torch as ctt
    chunks = list(chip_smoke.lineitem_chunks(rows))
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    cl = ctt.Cluster(os.path.join(tmp, "db"), device="cpu")
    t0 = time.perf_counter()
    for sql in chip_smoke.PH11_DDL:
        cl.execute(sql)
    ddl_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = cl.copy_from("lineitem_m", columns=chip_smoke.copy_columns(cols))
    print(f"phase 11 load on the CPU: DDL {ddl_s:.3f} s, copy_from of "
          f"{n} rows into {chip_smoke.PH11_PARTITIONS} partitions "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    cl.close()


def load_lineitem_cpu(cl, rows: int) -> dict:
    """Phase 4's lineitem at ``rows`` rows into a CPU cluster; -> its
    generated columns."""
    cl.execute(chip_smoke.LINEITEM_DDL)
    cl.execute("SELECT create_distributed_table('lineitem', 'l_orderkey', "
               f"{chip_smoke.SHARDS})")
    chunks = list(chip_smoke.lineitem_chunks(rows))
    for c in chunks:
        cl.copy_from("lineitem", columns=chip_smoke.copy_columns(c))
    return {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}


def run(tmp: str, phase: int, rows: int, cpu: bool) -> None:
    import citus_tpu_torch as ctt
    line = "cpu" if cpu else chip_smoke.card_line()
    print("card", line, flush=True)
    sources = []
    if not cpu:
        t0 = time.perf_counter()
        sources = (chip_smoke.phase11_sources(tmp) if phase == 11
                   else chip_smoke.phase12_sources(tmp, rows) if phase == 12
                   else chip_smoke.phase13_sources(tmp, rows // 4))
        print(f"rehearsal: {len(sources)} sources in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    device = "cpu" if cpu else None
    jobs = chip_smoke.start_phase13_builds(sources) if phase == 13 else []
    if phase == 11 or (phase == 13 and not cpu):
        cl, cols = chip_smoke.load_lineitem(ctt, os.path.join(tmp, "sf"),
                                            rows)
    else:
        cl = ctt.Cluster(os.path.join(tmp, "db"), device=device)
        if phase == 13:
            cols = load_lineitem_cpu(cl, rows)
    if phase == 13:
        chip_smoke.load_orders_b(cl, rows // 4)
    try:
        cl.execute("SET citus.megabatch_window_ms = 0")
        launches = dict.fromkeys(chip_smoke.launch_counters(), 0)
        if phase == 11:
            chip_smoke.run_phase11(ctt, cl, cols, launches, line, sources)
        elif phase == 13:
            chip_smoke.run_phase13(cl, cols, rows // 4, launches, line,
                                   jobs, profile=not cpu)
        else:
            chip_smoke.run_phase12(cl, rows, launches, line, sources, tmp,
                                   profile=not cpu)
    finally:
        cl.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", type=int, choices=(11, 12, 13),
                    required=True)
    ap.add_argument("--rows", type=int, default=None,
                    help="lineitem rows (phases 11 and 13) or orders "
                         "(phase 12)")
    ap.add_argument("--cpu", action="store_true",
                    help="on the CPU: phase 11's load only, phases 12 and "
                         "13 whole")
    args = ap.parse_args()
    rows = args.rows if args.rows is not None else DEFAULT_ROWS[args.phase]
    tmp = tempfile.mkdtemp()
    try:
        if args.cpu and args.phase == 11:
            phase11_cpu_load(tmp, rows)
        else:
            run(tmp, args.phase, rows, args.cpu)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
