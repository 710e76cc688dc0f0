"""The generated fold and hash-insert kernels (``ops/expr_codegen.py
generate_fold_row`` instantiating ``csrc/scan_agg_fold*.cu`` and
``csrc/hash_agg_insert*.cu``) against their plain versions, on the card.

Plans of ``torch_fold_cases`` (bench.py's Q1, S1 and H2; the synthetic
direct and scalar plans whose keys and arguments hold every bound node
kind of ROADMAP.md C1's predicate, and a synthetic hash plan with the
same key node kinds and signed float sums, within the insert kernel's
limits) run over
numpy-seeded columns with nulls, NaN, +-inf, +-0.0, zero divisors,
INT64_MIN/MAX and floats past the int64 range, through chip_smoke.py's
comparisons:
- a fold (one query, and three queries at once): int64 registers,
  counts, min/max and NaN positions identical, and each float64 sum
  within 1e-12 times its group's sum of magnitudes (``compare_fold``
  with ``abs_sums``: the data are signed, and atomics add in another
  order, so near cancellation a bound relative to the sum itself is
  wrong);
- an insert (one table, and two tables at once): each side's table and
  spilled rows merged on the host give the same groups, with the same
  bounds (``compare_hash``, ``compare_hash_batched``).

The CUDA kernels have no CPU mode: these tests need a card and skip
without one.  This module imports no JAX, so it runs on a machine
without the JAX package, past the suite's ``conftest.py`` (which sets
JAX up): ``python -m pytest --noconftest tests/test_torch_fold_card.py``.
"""

import numpy as np
import pytest
import torch

import citus_tpu_torch as ctt
from citus_tpu_torch.executor.executor import (
    _hash_key_dtypes, _param_dtypes, _params_env,
)
from citus_tpu_torch.ops import scan_agg_fold as saf
from citus_tpu_torch.ops.hash_agg import empty_hash_state
from citus_tpu_torch.ops.hash_agg_insert import (
    hash_agg_insert, hash_agg_insert_batched, insert_batched_plain,
    insert_plain,
)
from citus_tpu_torch.ops.scan_agg import empty_device_partials
from torch_fold_cases import N, PLANS, columns, load_data, port_plan, row_mask

import chip_smoke as cs  # noqa: E402 (on the path through torch_fold_cases)


class _Case:
    """One plan of ``PLANS`` on the port: its plan, parameters, hash key
    dtypes (None for a fold) and ``FoldProgram``."""

    def __init__(self, cat, sql: str, direct_limit):
        self.pplan, params = port_plan(cat, sql, direct_limit)
        self.penv = _params_env(self.pplan, params)
        self.key_dtypes = _hash_key_dtypes(self.pplan, self.penv) \
            if self.pplan.group_mode.kind == "hash_host" else None
        self.prog = saf.FoldProgram.of_plan(
            self.pplan, _param_dtypes(self.pplan, params), self.key_dtypes)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    clusters = {}
    out = {}
    try:
        for name, (data, sql, limit) in PLANS.items():
            if data not in clusters:
                cl = ctt.Cluster(str(tmp_path_factory.mktemp(data)),
                                 device="cpu")
                load_data(data, cl)
                clusters[data] = cl
            out[name] = _Case(clusters[data].catalog, sql, limit)
        yield out
    finally:
        for cl in clusters.values():
            cl.close()


def _device_batch(case, seed=11):
    cols, valids = columns(case.pplan, seed)
    return ({c: (torch.from_numpy(cols[c]).cuda(),
                 torch.from_numpy(valids[c]).cuda()) for c in cols},
            torch.from_numpy(row_mask()).cuda())


def _masks(n_q: int, seed: int, rows: torch.Tensor) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(seed)
    return ((torch.rand((n_q, N), generator=g) < 0.7).cuda()
            & rows).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["q1", "syn_direct", "syn_scalar", "s1"])
def test_generated_fold_matches_plain_on_card(cases, name):
    case = cases[name]
    tcols, rows_real = _device_batch(case)
    acc = empty_device_partials(case.pplan, "cuda")
    n_ops = len(case.prog.ops)
    if case.pplan.group_mode.kind == "direct":
        regs, rows = list(acc[:n_ops]), acc[n_ops]
    else:
        regs = [a.view(1) if a.dim() == 0 else a for a in acc[:n_ops]]
        rows = None
    call = (case.prog, regs, rows, tcols, case.penv, rows_real)
    launches = saf.scan_agg_fold.launches
    cs.compare_fold(name, call, saf.scan_agg_fold, saf.fold_plain,
                    abs_sums=True)
    assert saf.scan_agg_fold.launches == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["q1", "syn_direct"])
def test_generated_batched_fold_matches_plain_on_card(cases, name):
    from citus_tpu_torch.executor.megabatch import _empty_stacked_partials
    case = cases[name]
    tcols, rows_real = _device_batch(case)
    regs, rows = _empty_stacked_partials(case.pplan, 3, "cuda")
    launches = saf.scan_agg_fold_batched.launches
    cs.compare_fold(name, (case.prog, regs, rows, tcols,
                           _masks(3, 3, rows_real)),
                    saf.scan_agg_fold_batched, saf.fold_batched_plain,
                    abs_sums=True)
    assert saf.scan_agg_fold_batched.launches == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name,slots", [("syn_hash_card", 64),
                                        ("h2", 4096)])
def test_generated_insert_matches_plain_on_card(cases, name, slots):
    case = cases[name]
    tcols, rows_real = _device_batch(case)
    t = empty_hash_state(case.pplan, slots, case.key_dtypes, "cuda")
    cs.compare_hash(name, (case.prog, t, tcols, case.penv, rows_real),
                    hash_agg_insert, insert_plain, abs_sums=True)
    t = empty_hash_state(case.pplan, slots, case.key_dtypes, "cuda",
                         n_queries=2)
    err, kt, spill = cs.compare_hash_batched(
        name, (case.prog, t, tcols, _masks(2, 4, rows_real)),
        hash_agg_insert_batched, insert_batched_plain, abs_sums=True)
    assert np.isfinite(err) and int(kt.rows.sum()) > 0
