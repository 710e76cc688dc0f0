"""How often a short torch.profiler session loses its device activity,
under Kineto's CUPTI settings and with unprofiled work between sessions.

    python3 scripts/profiler_sessions.py [--sessions N]
        [--env default TEARDOWN_CUPTI=0 ...] [--between 0 5000]
        [--pause 0 0.02] [--cuda-only]

Each mode (every ``--env`` setting, a comma-separated list of VAR=value
or ``default``, with every ``--between`` count of small kernels launched
unprofiled between two sessions and every ``--pause`` in seconds that a
session idles at each end) runs in a process of its own, since Kineto
reads its variables in the process: N sessions, each around a few
elementwise kernels, a reduction and a device-to-host copy.  Prints, per
mode, the sessions that recorded no CUDA event, those that recorded some
but fewer than the most any session recorded, the longest run of empty
sessions in a row, the fewest and most CUDA events a session recorded,
and the seconds the mode took.  ``--cuda-only`` profiles CUDA activity
alone (no CPU activity).  Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

#: Kineto's variables a mode may set; each mode starts without them
KINETO_VARS = ("TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT")


def sessions(n: int, pause: float, between: int, cuda_only: bool) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda", 0)
    x = torch.randn(1 << 20, device=dev)
    y = torch.zeros(1, device=dev)
    activities = [ProfilerActivity.CUDA]
    if not cuda_only:
        activities.append(ProfilerActivity.CPU)

    def work():
        return ((x * 2 + 1).abs().sum()).item()

    t0 = time.perf_counter()
    counts = []
    for _ in range(n):
        for _ in range(between):
            y.add_(1)
        work()
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            time.sleep(pause)
            work()
            torch.cuda.synchronize()
            time.sleep(pause)
        counts.append(sum(e.device_type == torch.autograd.DeviceType.CUDA
                          for e in prof.events()))
    longest = streak = 0
    for c in counts:
        streak = streak + 1 if c == 0 else 0
        longest = max(longest, streak)
    most = max(counts)
    return {"sessions": n, "empty": sum(c == 0 for c in counts),
            "partial": sum(0 < c < most for c in counts),
            "longest_empty_streak": longest,
            "min_events": min(counts), "max_events": most,
            "seconds": round(time.perf_counter() - t0, 3)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sessions", type=int, default=300)
    ap.add_argument("--env", nargs="+", default=["default",
                                                 "TEARDOWN_CUPTI=0"])
    ap.add_argument("--between", nargs="+", type=int, default=[0])
    ap.add_argument("--pause", nargs="+", type=float, default=[0.0])
    ap.add_argument("--cuda-only", action="store_true")
    ap.add_argument("--child", nargs=2, type=float, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        pause, between = args.child
        print(json.dumps(sessions(args.sessions, pause, int(between),
                                  args.cuda_only)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profiler_sessions: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print("card:", card, "torch", torch.__version__, flush=True)
    for mode in args.env:
        env = {k: v for k, v in os.environ.items() if k not in KINETO_VARS}
        if mode != "default":
            env.update(kv.split("=", 1) for kv in mode.split(","))
        for between in args.between:
            for pause in args.pause:
                cmd = [sys.executable, os.path.abspath(__file__), "--child",
                       str(pause), str(between), "--sessions",
                       str(args.sessions)]
                if args.cuda_only:
                    cmd.append("--cuda-only")
                out = subprocess.run(cmd, env=env, capture_output=True,
                                     text=True, check=True)
                print(f"{mode}, {between} kernels between, pause {pause} s"
                      f"{', CUDA only' if args.cuda_only else ''}: "
                      f"{out.stdout.strip().splitlines()[-1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
