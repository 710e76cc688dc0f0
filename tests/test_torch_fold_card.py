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
  bounds (``compare_hash``, ``compare_hash_batched``);
- the fold's warp-aggregated updates at their edges, one query and three
  at once (passing their own rows, or nearly the same rows, so that the
  rows every query passes fold once into the table's common registers),
  in the shared-memory table (G = 40) and with global atomics
  (G = 65,536): warps whose 32 lanes share one group, whose lanes are
  all in different groups, and whose every other lane is masked out;
  NaN, +-0.0 and +-inf mixed among one warp's peers for min and max
  (float64, float32) beside int64 and int32 ones; N not a multiple of
  32; and the sketch registers of a family of 8 queries, which pass the
  opt-in shared-memory limit together and fold in the shared-memory
  table in two query chunks (regime 2).

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


def _warp_case(pattern: str, G: int, n_q=None, seed: int = 5,
               shared_masks: bool = False):
    """A direct fold over N = 32 * 97 + 13 rows whose warps (32 rows)
    follow ``pattern``: ``one_slot`` (a warp's rows in one group),
    ``distinct`` (each lane its own group), ``half_masked`` (every other
    row masked out, the rest in 3 groups a warp).  Float arguments cycle
    NaN, -0.0, +0.0, +inf, -inf and finite values through each warp (a
    warp in four holds no NaN), with int64 and int32 beside them.  With
    ``n_q`` queries, each passes its own share of the rows, or
    (``shared_masks``) they pass the same rows but 1 % that the last one
    drops, so most warps pass every query.  -> the arguments of
    ``scan_agg_fold`` (``scan_agg_fold_batched`` with ``n_q``)."""
    from citus_tpu_torch import types as T
    from citus_tpu_torch.ops.scan_agg_fold import FoldOp
    rng = np.random.default_rng(seed)
    n = 32 * 97 + 13
    lane, warp = np.arange(n) % 32, np.arange(n) // 32
    if pattern == "one_slot":
        key = warp % G
    elif pattern == "distinct":
        key = (warp * 32 + lane) % G
    else:
        key = (warp + lane % 3) % G
    special = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.5, 0.0])
    f = rng.standard_normal(n) * 100
    pick = rng.random(n) < 0.5
    f[pick] = special[rng.integers(0, special.size, int(pick.sum()))]
    f[(warp % 4 == 0) & np.isnan(f)] = -0.0
    i64 = rng.integers(-10**15, 10**15, n)
    i32 = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    valid = rng.random(n) < 0.9

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()
    cols = {"key": (t(key.astype(np.int64)), None), "f": (t(f), t(valid)),
            "f32": (t(f.astype(np.float32)), None), "i64": (t(i64), t(valid)),
            "i32": (t(i32), None)}
    types = {"key": T.INT64_T, "f": T.FLOAT64_T, "f32": T.FLOAT32_T,
             "i64": T.INT64_T, "i32": T.INT32_T}
    ops = [FoldOp("count_star"), FoldOp("count", 0), FoldOp("sum", 0),
           FoldOp("min", 0), FoldOp("max", 0), FoldOp("min", 1),
           FoldOp("max", 1), FoldOp("sum", 2), FoldOp("min", 2),
           FoldOp("max", 2), FoldOp("sum", 3), FoldOp("min", 3),
           FoldOp("max", 3)]
    dts = [torch.int64, torch.int64, torch.float64, torch.float64,
           torch.float64, torch.float32, torch.float32, torch.int64,
           torch.int64, torch.int64, torch.int64, torch.int32, torch.int32]
    prog = cs.column_program(None, ["key"], ["f", "f32", "i64", "i32"], ops,
                             types, cols, domains=[(0, 1, 1)], n_groups=G)
    pre = () if n_q is None else (n_q,)
    regs = []
    for op, dt in zip(ops, dts):
        fill = 0
        if op.kind in ("min", "max"):
            if dt.is_floating_point:
                fill = float("inf") if op.kind == "min" else float("-inf")
            else:
                info = torch.iinfo(dt)
                fill = info.max if op.kind == "min" else info.min
        regs.append(torch.full(pre + (G,), fill, dtype=dt, device="cuda"))
    rows = torch.zeros(pre + (G,), dtype=torch.int64, device="cuda")
    mask = np.ones(n, bool)
    if pattern == "half_masked":
        mask = lane % 2 == 0
    if n_q is None:
        return (prog, regs, rows, cols, {}, t(mask))
    if shared_masks:
        masks = np.stack([mask] * n_q)
        masks[-1] &= rng.random(n) >= 0.01
    else:
        masks = np.stack([mask & (rng.random(n) < p)
                          for p in np.linspace(1.0, 0.3, n_q)])
    return (prog, regs, rows, cols, t(masks))


@pytest.mark.cuda
@pytest.mark.parametrize("G,regime", [(40, 1), (65_536, 0)])
@pytest.mark.parametrize("pattern", ["one_slot", "distinct", "half_masked"])
def test_warp_aggregated_fold_edges_on_card(pattern, G, regime):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    call = _warp_case(pattern, G)
    cs.compare_fold(pattern, call, saf.scan_agg_fold, saf.fold_plain,
                    abs_sums=True)
    assert saf.scan_agg_fold.last_regime == regime
    for shared_masks in (False, True):
        call = _warp_case(pattern, G, n_q=3, shared_masks=shared_masks)
        cs.compare_fold(pattern, call, saf.scan_agg_fold_batched,
                        saf.fold_batched_plain, abs_sums=True)
        assert saf.scan_agg_fold_batched.last_regime == regime


@pytest.mark.cuda
def test_sketch_family_of_8_folds_in_query_chunks_on_card():
    """Eight queries' sketch registers (~270 KB) pass the opt-in limit:
    the batched fold keeps the shared-memory table, in two chunks of 4
    queries, and matches its plain version register for register."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    call = cs.adversarial_sketch_call(torch.device("cuda"), 32 * 4099 + 7,
                                      q=8)
    launches = saf.scan_agg_fold_batched.launches
    cs.compare_fold("sketch family Q=8", call, saf.scan_agg_fold_batched,
                    saf.fold_batched_plain)
    assert saf.scan_agg_fold_batched.launches == launches + 1
    assert saf.scan_agg_fold_batched.last_regime == 2
