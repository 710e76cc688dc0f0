"""Design variants of two hand-written kernels of citus_tpu_torch, timed on
one CUDA card at chip_smoke.py's phase-3 shapes.

    python3 scripts/kernel_variants.py

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


def main() -> int:
    import torch
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
