"""Where the warm Q1/Q6 time goes in citus_tpu_torch on one CUDA card.

    python3 scripts/profile_port.py [--rows N] [--reps R]

Loads bench.py's lineitem (chip_smoke.py's copy of its generator, 4
shards) on the card, warms Q1 and Q6 (the second run is served from the
device cache), then runs each R more times under ``torch.profiler`` and
prints, per query: the wall time per run, the device time per run
summed over CUDA kernels and copies, the device's busy share of the
wall time, and the kernels that took most of the device time.  Fails
without a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=5_000_000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import citus_tpu_torch as ctt
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print("card:", card, flush=True)
    cl = ctt.Cluster(os.path.join(tempfile.mkdtemp(), "db"))
    cl.execute(cs.LINEITEM_DDL)
    cl.execute(f"SELECT create_distributed_table('lineitem', 'l_orderkey', {cs.SHARDS})")
    for c in cs.lineitem_chunks(args.rows):
        cl.copy_from("lineitem", columns=cs.copy_columns(c))
    for name, sql in (("Q1", cs.Q1), ("Q6", cs.Q6)):
        cl.execute(sql)
        cl.execute(sql)  # warm: plan cached, batches in the device cache
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.reps):
                cl.execute(sql)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.reps
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
        device_us = sum(e.self_device_time_total for e in events) / args.reps
        print(f"{name} warm at {args.rows} rows: wall {wall * 1e3:.3f} ms/run, "
              f"device {device_us / 1e3:.3f} ms/run, device busy share "
              f"{device_us / 1e6 / wall:.4f} ({card})", flush=True)
        events.sort(key=lambda e: -e.self_device_time_total)
        for e in events[:8]:
            print(f"  {e.self_device_time_total / args.reps / 1e3:9.4f} ms/run "
                  f"{e.count // args.reps:5d} calls/run  {e.key[:90]}",
                  flush=True)
    cl.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
