"""Design variants of hand-written kernels of citus_tpu_torch, timed on
one CUDA card at chip_smoke.py's phase-3 shapes.

    python3 scripts/kernel_variants.py [--only B4,B7,B9,B6]

- The predicate template (B4, B5a; ``ops/expr_codegen.py``): each of
  chip_smoke.py's one-query cases (P1, Q6) and batched families (Q6, Q1,
  H, P, C1 and C1all at Q = 8) with its generated source rebuilt at 1,
  2, 4 and 8 rows a thread (``FM_ROWS``; the generator picks one by the
  row's bytes and the predicate's length), each held against the plain
  version.
- The partition (B7, ``csrc/partition_pack.cu``): QJOIN's lineitem side
  at SF1 to one destination with 0, 1 and all 5 of its columns (what the
  pass costs apart from the copies), beside ``clone()`` of the 5
  columns (the card's own copy of the same bytes).
- The rollup delta fold (B9, ``csrc/rollup_delta.cu``), direct regime:
  count, sum_int, hll, ddsk and top-k at n = 65,536 and 2^23 into
  16,384 groups (chip_smoke.py's ``rollup_batch``), the source's direct
  regime replaced by ``variants/rollup_delta_direct.cu.inc``, which can
  fold the lanes of a warp on one cell first (``kMatchKinds``) for every
  kind, for count and sums only, or for none, and read hll's and top-k's
  register first (``kReadFirstKinds``) or not (the package does neither):
  the fold kernel's device time, the table held against the plain
  version; and count and sums of a refresh batch with half its rows in
  one group.
- The combine (B6, ``csrc/mesh_combine.cu``): chip_smoke.py's Q1, S1
  and G = 65,536 registers over 4 members, from one allocation a member
  and from separate tensors, with the block's segment as its row of a
  2-D grid (the package's) or found by a binary search of the table over
  a 1-D grid (``_search_grid``), and 128 or 256 threads a block
  (``MC_THREADS``): outputs identical to the plain version.

Each time is the device time a call from torch.profiler (the mean of
KERNEL_REPS calls, ``profile_port.device_profile``), printed beside the
card's name and power limit.  Fails without a CUDA device.
"""

from __future__ import annotations

import os
import re
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_REPS = 50


def _variant(source: str, constant: str, value: str) -> str:
    """``source`` with the definition of ``constant`` set to ``value``."""
    pat = (rf"(#define {constant} )\S+" if constant.isupper()
           else rf"({constant} = )[^;]+")
    out, n = re.subn(pat, lambda m: m.group(1) + value, source, count=1)
    if n != 1:
        raise AssertionError(f"kernel_variants: no {constant} to set")
    return out


def _direct_choices(source: str) -> str:
    """``csrc/rollup_delta.cu`` with its direct-regime section replaced by
    ``variants/rollup_delta_direct.cu.inc`` (the warp match and the
    register read first, each off until ``_variant`` sets it)."""
    start = "// ---------------------------------------------------- the direct regime\n"
    end = "// ------------------------------------------------ the privatized regime\n"
    a, b = source.index(start), source.index(end)
    with open(os.path.join(ROOT, "scripts", "variants",
                           "rollup_delta_direct.cu.inc")) as f:
        return source[:a + len(start)] + "\n" + f.read() + "\n" + source[b:]


def _search_grid(source: str) -> str:
    """``csrc/mesh_combine.cu`` over a 1-D grid of every segment's blocks,
    each block finding its segment by a binary search of the table."""
    pat = (r"    // the grid is \[blocks of the largest segment\].*?"
           r"    if \(b >= end - first\) return;\n")
    search = """    // the block's segment: the last whose first block is not after it
    uint32_t b = blockIdx.x;
    int lo = 0, hi = a.n_segs - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if ((uint32_t)(a.words[4 * mid] >> 32) <= b) lo = mid;
        else hi = mid - 1;
    }
    const int seg = lo;
    b -= (uint32_t)(a.words[4 * seg] >> 32);
"""
    out, n = re.subn(pat, lambda m: search, source, count=1, flags=re.S)
    grid = "dim3(most, (unsigned)a.n_segs)"
    if n != 1 or grid not in out:
        raise AssertionError("kernel_variants: mesh_combine.cu's grid moved")
    return out.replace(grid, "dim3((unsigned)a.blocks)")


def rollup_variants(cs, device, device_profile, card) -> None:
    """B9's direct regime with and without the warp fold and the read of
    the register first."""
    import torch
    from citus_tpu_torch.ops import cuda_build
    from citus_tpu_torch.rollup import kernels as K
    with open(os.path.join(cuda_build.CSRC, "rollup_delta.cu")) as f:
        src = _direct_choices(f.read())
    variants = {}
    for match, mname in (("0x3fu", "every kind"),
                         ("0x7u", "count and sums"), ("0u", "no kind")):
        for first, fname in (("(1u << RD_HLL) | (1u << RD_TOPK)",
                              "hll and top-k read first"),
                             ("0u", "no register read first")):
            v = _variant(_variant(src, "kMatchKinds", match),
                         "kReadFirstKinds", first)
            variants[f"lanes folded: {mname}; {fname}"] = v
    jobs = {k: cuda_build.start_generated("rollup_delta", v)
            for k, v in variants.items()}
    G = K._pad_to(cs.SUPPLIERS)
    batches = {n: cs.rollup_batch(device, n, 31 + n)
               for n in cs.ROLLUP_BATCHES}
    # a refresh batch with a hot group: every other row in group 0
    hot = dict(cs.rollup_batch(device, 65_536, 7))
    for kind in ("count", "sum_int", "sum_float"):
        vals, g, ok = hot[kind]
        g = g.clone()
        g[::2] = 0
        hot[kind] = (vals, g, ok)
    real = K._lib
    try:
        for name, job in jobs.items():
            K._lib = K.bind(cuda_build.finish_generated(job))
            for n, batch in batches.items():
                for kind in ("count", "sum_int", "hll", "ddsk", "topk"):
                    vals, g, ok = batch[kind]
                    t = K._table(kind, G, device)
                    K.launch_fold(kind, vals, g, ok, t, "direct")
                    want = K._tables(kind, G, device)
                    K.rollup_delta_plain(kind, vals, g, ok, *want)
                    got = K._split(kind, t)
                    for a, b in zip(got if kind == "topk" else (got,), want):
                        if not torch.equal(a, b):
                            raise AssertionError(f"B9 [{name}] {kind} n={n}: "
                                                 "tables differ")
                    per = device_profile(lambda: K.launch_fold(
                        kind, vals, g, ok, t, "direct"), None, KERNEL_REPS)
                    fold = sum(ms for k, (ms, _) in per.items()
                               if "rd_direct" in k)
                    print(f"B9 [{name}] {kind} n={n} direct: the fold "
                          f"{fold:.4f} ms a call (device), tables identical "
                          f"({card})", flush=True)
            for kind in ("count", "sum_int", "sum_float"):
                vals, g, ok = hot[kind]
                t = K._table(kind, G, device)
                per = device_profile(lambda: K.launch_fold(
                    kind, vals, g, ok, t, "direct"), None, KERNEL_REPS)
                fold = sum(ms for k, (ms, _) in per.items()
                           if "rd_direct" in k)
                print(f"B9 [{name}] {kind} n=65536, half the rows in one "
                      f"group, direct: the fold {fold:.4f} ms a call "
                      f"(device) ({card})", flush=True)
    finally:
        K._lib = real


def combine_variants(cs, device, plans, splans, device_profile,
                     card) -> None:
    """B6 with the block's segment by search or by the grid, at 128 and
    256 threads a block."""
    from citus_tpu_torch.ops import cuda_build
    from citus_tpu_torch.parallel import mesh as pmesh
    with open(os.path.join(cuda_build.CSRC, "mesh_combine.cu")) as f:
        src = f.read()
    variants = {}
    for grid, gname in ((_search_grid, "search"), (str, "2-D grid")):
        for threads in ("128", "256"):
            variants[(f"segment by {gname}, {threads} threads", threads)] = \
                _variant(grid(src), "MC_THREADS", threads)
    jobs = {k: cuda_build.start_generated("mesh_combine", v)
            for k, v in variants.items()}
    cases = [("Q1", plans["fold_calls"]["q1"], -1),
             ("S1", splans["s1_call"], -1),
             ("G=65,536", cs.synthetic_global_case(device, cs.FOLD_N, 65_536,
                                                   3, False), 2)]
    regs = [(name,) + cs.member_registers(call, cs.MESH_MEMBERS, empty)
            for name, call, empty in cases]
    real = pmesh._lib, pmesh._MC_THREADS
    try:
        for (name, threads), job in jobs.items():
            pmesh._MC_THREADS = int(threads)
            pmesh._LAYOUTS.clear()
            pmesh._lib = pmesh.bind(cuda_build.finish_generated(job))
            for case, kinds, members in regs:
                layout, arenas = cs.member_arenas(kinds, members)
                want = pmesh.mesh_combine_plain(kinds, members)
                cs.compare_bits(f"B6 [{name}] {case}", layout.out_views(
                    pmesh.mesh_combine_arenas(layout, arenas)), want)
                cs.compare_bits(f"B6 [{name}] {case}",
                                pmesh.mesh_combine(kinds, members), want)
                arena = device_profile(lambda: pmesh.mesh_combine_arenas(
                    layout, arenas), None, KERNEL_REPS)
                sep = device_profile(lambda: pmesh.mesh_combine(
                    kinds, members), None, KERNEL_REPS)
                print(f"B6 [{name}] {case}: one allocation a member "
                      f"{sum(ms for ms, _ in arena.values()):.4f} ms, "
                      f"separate tensors "
                      f"{sum(ms for ms, _ in sep.values()):.4f} ms a call "
                      f"(device), outputs identical ({card})", flush=True)
    finally:
        pmesh._lib, pmesh._MC_THREADS = real
        pmesh._LAYOUTS.clear()


def main() -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="B4,B7,B9,B6",
                    help="comma-separated kernels whose variants to time")
    only = set(ap.parse_args().only.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke as cs
    from profile_port import device_profile
    from citus_tpu_torch.ops import cuda_build
    from citus_tpu_torch.ops.expr_codegen import Predicate
    from citus_tpu_torch.ops.filter_mask import (
        FilterProgram, filter_mask, filter_mask_batched,
        filter_mask_batched_plain, filter_mask_plain,
    )
    from citus_tpu_torch.parallel.shuffle import pack_blocks
    device = torch.device("cuda", 0)
    card = cs.card_line()
    print("card:", card, flush=True)
    plans = cs.smoke_plans(device, tempfile.mkdtemp())
    if "B9" in only:
        rollup_variants(cs, device, device_profile, card)
    if "B6" in only:
        combine_variants(cs, device, plans,
                         cs.sketch_plans(device, tempfile.mkdtemp()),
                         device_profile, card)
    if "B4" not in only and "B7" not in only:
        return 0
    cases = [(name, prog, call, False)
             for name, prog, call in cs.filter_cases(device, plans)
             if name in ("P1", "Q6")]
    cases += [(f"{name} family", prog, call, True)
              for name, prog, call in cs.batched_filter_cases(
                  device, plans, ("Q6", "Q1", "H", "P", "C1", "C1all"))]

    def at_rows(prog, rows: int) -> FilterProgram:
        pred = prog.predicate
        v = FilterProgram(prog.expr, prog.col_dtypes, prog.param_dtypes)
        v._predicate = Predicate(
            re.sub(r"#define FM_ROWS \d+", f"#define FM_ROWS {rows}",
                   pred.source), pred.columns, pred.params, pred.tables)
        return v

    variants = [(name, rows, prog, at_rows(prog, rows), call, batched)
                for name, prog, call, batched in cases
                for rows in (1, 2, 4, 8)]
    jobs = [cuda_build.start_generated("filter_mask", src) for src in
            dict.fromkeys(v.predicate.source for *_, v, _, _ in variants)]
    cuda_build.build_all(["partition_pack"])
    for job in jobs:
        cuda_build.finish_generated(job)
    for name, rows, generated, prog, call, batched in variants:
        kernel = filter_mask_batched if batched else filter_mask
        plain = filter_mask_batched_plain if batched else filter_mask_plain
        if not torch.equal(kernel(prog, *call), plain(prog, *call)):
            raise AssertionError(f"{name} at {rows} rows a thread: masks "
                                 "differ from the plain version")
        per = device_profile(lambda: kernel(prog, *call), None, KERNEL_REPS)
        chosen = f"#define FM_ROWS {rows}\n" in generated.predicate.source
        print(f"predicate {name}, {rows} rows a thread"
              f"{' (the generated choice)' if chosen else ''}: "
              f"device {sum(ms for ms, _ in per.values()):.4f} ms a call, "
              f"masks identical ({card})", flush=True)
    (lgid, lcols, cap), _, _ = cs.qjoin_sides(cs.SF1_ROWS, device)
    n = lgid.numel()
    target = torch.zeros(n, dtype=torch.int32, device=device)
    mask = torch.ones(n, dtype=torch.bool, device=device)
    values = (lgid,) + lcols
    for k in (0, 1, len(values)):
        per = device_profile(lambda: pack_blocks(values[:k], target, mask, 1,
                                                 cap), None, KERNEL_REPS)
        print(f"partition QJOIN lineitem, {k} of {len(values)} columns: "
              + ", ".join(f"{name.split('(')[0]} {ms:.4f} ms"
                          for name, (ms, _) in per.items())
              + f" a call ({card})", flush=True)
    per = device_profile(lambda: [v.clone() for v in values], None,
                         KERNEL_REPS)
    print(f"clone() of the {len(values)} columns: "
          f"{sum(ms for ms, _ in per.values()):.4f} ms a call ({card})",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
