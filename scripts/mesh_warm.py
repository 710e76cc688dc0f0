"""Warm Q6 and Q1 over a 4-member mesh against the single stream, and the
rollup refresh's delta fold, for one checkout's citus_tpu_torch or for
two in alternating pairs, on one CUDA card.

    python3 scripts/mesh_warm.py [PACKAGE_ROOT]
    python3 scripts/mesh_warm.py --ab PARENT_ROOT [--pairs 10]

Loads 2,000,000 rows of bench.py's lineitem (chip_smoke.py's generator, 4
shards) through the package of PACKAGE_ROOT (default: this checkout) and
opens a second Cluster on the same data whose mesh has 4 members on the
card (``chip_smoke.mesh_cluster``).  A round measures Q6's and Q1's
median wall ms over 21 warm runs on each, and the median wall ms over 11
calls of ``rollup.kernels.delta_partials`` (the refresh's step that puts
one delta batch on the card, folds it and brings its tables back) for
each of phase 6's five aggregates at one refresh batch: 65,536 rows
into 10,000 groups, from a fixed seed.

With one tree it prints one round, then a cProfile of 20 warm mesh Q6
runs.  With ``--ab`` it starts one process for PARENT_ROOT (say, the
parent unpacked with ``git archive`` into an ignored directory) and one
for this checkout, each of which loads, warms up and then waits; pair k
runs a round in the parent and then in the change for even k, the
reverse for odd k, so only one process works at a time.  It prints each
round, then for every number the median and range of each side and the
pairs in which the change was faster.  Fails without a CUDA device.
"""

import argparse
import cProfile
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the prefix of the lines a serving process answers with (others, such
#: as the loader's, pass through)
ANSWER = "@mesh_warm "
ROWS = 2_000_000
RUNS = 21
DELTA_CALLS = 11
DELTA_ROWS = 65_536
DELTA_GROUPS = 10_000
DELTA_KINDS = ("count", "sum_int", "hll", "ddsk", "topk")


def median_ms(fn, runs: int) -> float:
    import torch
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def delta_batch(seed: int = 5) -> dict:
    """kind -> (gidx, ok, values) of one refresh batch, numpy, as the
    rollup manager hands them to ``delta_partials``."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, DELTA_GROUPS, DELTA_ROWS).astype(np.int64)
    ok = rng.random(DELTA_ROWS) < 0.97
    bits = rng.integers(-(1 << 62), 1 << 62, DELTA_ROWS, dtype=np.int64)
    vals = {"count": None, "sum_int": rng.integers(0, 10_000, DELTA_ROWS),
            "hll": bits, "ddsk": rng.random(DELTA_ROWS) * 1e5, "topk": bits}
    return {k: (g, ok, vals[k]) for k in DELTA_KINDS}


class Tree:
    """One checkout's package with its single-stream and mesh Clusters
    loaded and warm."""

    def __init__(self, root: str):
        sys.path.insert(0, root)
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("mesh_warm: no CUDA device")
        import citus_tpu_torch as ctt
        from citus_tpu_torch.rollup.kernels import delta_partials
        sys.path.insert(1, ROOT)
        import chip_smoke as cs
        self.cs, self.delta_partials = cs, delta_partials
        self.package = os.path.dirname(ctt.__file__)
        path = os.path.join(tempfile.mkdtemp(), "sf")
        self.cl, _ = cs.load_lineitem(ctt, path, ROWS)
        self.mcl = cs.mesh_cluster(ctt, path, torch.device("cuda", 0))
        self.batch = delta_batch()
        self.queries = (("Q6", cs.Q6), ("Q1", cs.Q1))
        for _, sql in self.queries:
            for cl in (self.cl, self.mcl):
                cl.execute(sql)
                cl.execute(sql)
        for kind in DELTA_KINDS:
            self.delta(kind)

    def delta(self, kind: str):
        g, ok, v = self.batch[kind]
        return self.delta_partials(kind, g, ok, DELTA_GROUPS, v,
                                   device="cuda")

    def round(self) -> dict:
        out = {}
        for name, sql in self.queries:
            out[f"{name} single"] = median_ms(lambda: self.cl.execute(sql),
                                              RUNS)
            out[f"{name} mesh"] = median_ms(lambda: self.mcl.execute(sql),
                                            RUNS)
        for kind in DELTA_KINDS:
            out[f"delta_partials {kind}"] = median_ms(
                lambda: self.delta(kind), DELTA_CALLS)
        out["delta_partials, the five"] = sum(
            out[f"delta_partials {k}"] for k in DELTA_KINDS)
        return out

    def close(self):
        self.mcl.close()
        self.cl.close()


def serve(root: str) -> int:
    """Load, say ready, then measure one round for each line on stdin."""
    tree = Tree(root)
    print(ANSWER + json.dumps({"ready": tree.package}), flush=True)
    for _ in sys.stdin:
        print(ANSWER + json.dumps(tree.round()), flush=True)
    tree.close()
    return 0


def answer(side: str, p) -> dict:
    """The next answer of ``side``'s process; the lines before it are
    printed."""
    for line in p.stdout:
        if line.startswith(ANSWER):
            return json.loads(line[len(ANSWER):])
        print(side, line.rstrip(), flush=True)
    raise SystemExit(f"mesh_warm: the {side} process failed")


def ab(parent: str, pairs: int) -> int:
    here = os.path.abspath(__file__)
    procs = {side: subprocess.Popen(
        [sys.executable, here, "--serve", root], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True)
        for side, root in (("parent", os.path.abspath(parent)),
                           ("change", ROOT))}
    try:
        for side, p in procs.items():
            print(side, answer(side, p)["ready"], flush=True)
        got = {"parent": [], "change": []}
        for k in range(pairs):
            for side in (("parent", "change") if k % 2 == 0
                         else ("change", "parent")):
                p = procs[side]
                p.stdin.write("round\n")
                p.stdin.flush()
                got[side].append(answer(side, p))
                print(f"pair {k} {side}", json.dumps(got[side][-1]),
                      flush=True)
    finally:
        for p in procs.values():
            p.stdin.close()
        for p in procs.values():
            p.wait(timeout=120)
    for key in got["parent"][0]:
        a = np.array([r[key] for r in got["parent"]])
        b = np.array([r[key] for r in got["change"]])
        print(f"{key}: parent median {np.median(a)} ms (range {a.min()}-"
              f"{a.max()}), change median {np.median(b)} ms (range "
              f"{b.min()}-{b.max()}); the change faster in "
              f"{int((b < a).sum())} of {pairs} pairs", flush=True)
    return 0


def one(root: str) -> int:
    tree = Tree(root)
    print("package", tree.package, "card", tree.cs.card_line(), flush=True)
    for key, ms in tree.round().items():
        print(f"{key}: median {ms} ms", flush=True)
    import torch
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(20):
        tree.mcl.execute(tree.cs.Q6)
        torch.cuda.synchronize()
    prof.disable()
    pstats.Stats(prof).sort_stats("cumulative").print_stats(25)
    tree.close()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", nargs="?", default=ROOT,
                    help="the checkout whose package to time")
    ap.add_argument("--ab", metavar="PARENT_ROOT",
                    help="time PARENT_ROOT's package against this one's")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--serve", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.serve:
        return serve(args.serve)
    if args.ab:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("mesh_warm: no CUDA device")
        sys.path.insert(0, ROOT)
        import chip_smoke as cs
        print("card:", cs.card_line(), flush=True)
        return ab(args.ab, args.pairs)
    return one(os.path.abspath(args.root))


if __name__ == "__main__":
    sys.exit(main())
