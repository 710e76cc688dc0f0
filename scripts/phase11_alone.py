"""chip_smoke.py's phase 11 alone, at a chosen size.

On a machine with a CUDA card (a bring-up check of phase 11 without the
other phases; it needs nothing built beforehand):

    python3 scripts/phase11_alone.py --rows 1000000

loads phase 4's generated lineitem at ``--rows`` rows on the card, then
runs ``chip_smoke.run_phase11`` (its kernels' sources from
``phase11_sources``, built during its load) and prints its lines.

With ``--cpu`` it times only phase 11's load on the CPU instead: the
partitioned table's DDL (84 monthly partitions, 4 shards each) and one
``copy_from`` of ``--rows`` generated rows routed to them, on a
``Cluster(device="cpu")``.
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


def cpu_load(rows: int) -> None:
    import citus_tpu_torch as ctt
    tmp = tempfile.mkdtemp()
    try:
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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def card(rows: int) -> None:
    import citus_tpu_torch as ctt
    line = chip_smoke.card_line()
    print("card", line, flush=True)
    tmp = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        sources = chip_smoke.phase11_sources(tmp)
        print(f"rehearsal: {len(sources)} sources in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        cl, cols = chip_smoke.load_lineitem(ctt, os.path.join(tmp, "sf"),
                                            rows)
        try:
            cl.execute("SET citus.megabatch_window_ms = 0")
            launches = dict.fromkeys(chip_smoke.launch_counters(), 0)
            chip_smoke.run_phase11(ctt, cl, cols, launches, line, sources)
        finally:
            cl.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--cpu", action="store_true",
                    help="time phase 11's load on the CPU only")
    args = ap.parse_args()
    if args.cpu:
        cpu_load(args.rows)
    else:
        card(args.rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
