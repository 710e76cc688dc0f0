"""The sort join (B8, ``csrc/sorted_join.cu``) on the card against its
plain version, at the edges that chip_smoke.py's phase 3 does not reach:

- every gid invalid (no radix pass: the order is the rows' own);
- no output slot (join_cap 0), and fewer slots than pairs (the clipped
  tail alone past them);
- one row on each side;
- right gids below 0, past U and the int64 maximum (the reference's key
  of an invalid left row, which joins the invalid left rows), valid left
  gids outside [0, U);
- more gathered columns (40, of 1, 4 and 8 bytes, on both sides) than
  the slot kernel gathers (32: the rest by ``sorted_join_gather_launch``);
- one reused workspace over calls whose sizes grow and shrink, the
  same call twice (its look-back words from an earlier launch).

Every output must be identical.  The kernel has no CPU mode: these
tests need a card and skip without one.  This module imports no JAX,
so it runs past the suite's ``conftest.py``:
``python -m pytest --noconftest tests/test_torch_join_card.py``.
"""

import numpy as np
import pytest
import torch

from citus_tpu_torch.parallel.shuffle import sorted_join, sorted_join_plain

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _case(L, R, U, seed, lmiss=0.1, rmiss=0.1):
    rng = np.random.default_rng(seed)
    lgid = rng.integers(0, max(U, 1), L).astype(np.int64)
    rgid = rng.integers(0, max(U, 1), R).astype(np.int64)
    return lgid, rng.random(L) >= lmiss, rgid, rng.random(R) >= rmiss


def _pairs(lgid, lvalid, rgid, rvalid, U):
    ok = lvalid & (lgid >= 0) & (lgid < U)
    c = np.bincount(lgid[ok], minlength=U)
    inr = rvalid & (rgid >= 0) & (rgid < U)
    return int(c[rgid[inr]].sum())


def _check(card, lgid, lvalid, rgid, rvalid, U, J, lcols=None, rcols=None):
    def c(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)
    lcols = (lgid,) if lcols is None else lcols
    rcols = (rvalid,) if rcols is None else rcols
    args = (c(lgid), c(lvalid), c(rgid), c(rvalid),
            tuple(c(x) for x in lcols), tuple(c(x) for x in rcols), U, J)
    got = sorted_join(*args)
    want = sorted_join_plain(*args)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got[:4], want[:4])):
        assert torch.equal(g, w), i
    for g, w in zip(got[4] + got[5], want[4] + want[5]):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_every_left_gid_invalid(card):
    lgid, _, rgid, rvalid = _case(5000, 700, 0, 1)
    rgid[:3] = np.iinfo(np.int64).max
    _check(card, lgid, np.zeros(5000, bool), rgid, rvalid, 0, 64)


@pytest.mark.parametrize("cap", [0, "under"])
def test_no_slot_and_fewer_slots_than_pairs(card, cap):
    case = _case(20_000, 3000, 1500, 2)
    J = 0 if cap == 0 else _pairs(*case, 1500) // 3
    _check(card, *case, 1500, J)


def test_one_row_each(card):
    one = np.zeros(1, np.int64)
    _check(card, one, np.ones(1, bool), one, np.ones(1, bool), 1, 3)


def test_out_of_range_gids(card):
    lgid, lvalid, rgid, rvalid = _case(30_000, 4000, 2000, 3, 0.2, 0.0)
    lgid[:6] = [-3, 2000, 2005, np.iinfo(np.int64).max, -1, 4000]
    lvalid[:6] = True
    rgid[:5] = [np.iinfo(np.int64).max, 2005, -3, 2000, np.iinfo(np.int64).max]
    J = _pairs(lgid, lvalid, rgid, rvalid, 2000) + 2 * 30_000
    _check(card, lgid, lvalid, rgid, rvalid, 2000, J)


def test_more_columns_than_one_launch_gathers(card):
    lgid, lvalid, rgid, rvalid = _case(40_000, 6000, 9000, 4)
    rng = np.random.default_rng(4)
    kinds = (np.int64, np.int32, np.bool_, np.float64)
    lcols = [rng.integers(-99, 99, 40_000).astype(kinds[k % 4])
             for k in range(22)]
    rcols = [rng.integers(-99, 99, 6000).astype(kinds[k % 4])
             for k in range(18)]
    J = _pairs(lgid, lvalid, rgid, rvalid, 9000) + 17
    _check(card, lgid, lvalid, rgid, rvalid, 9000, J, lcols, rcols)


def test_workspace_reused_over_growing_and_shrinking_calls(card):
    for L, R, U, seed in ((2000, 300, 100, 5), (300_000, 40_000, 70_000, 6),
                          (2000, 300, 100, 5), (70_000, 9000, 65_535, 7),
                          (70_000, 9000, 65_535, 7)):
        case = _case(L, R, U, seed)
        _check(card, *case, U, _pairs(*case, U) + 5)
