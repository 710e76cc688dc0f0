"""The partition (B7, ``csrc/partition_pack.cu``) on the card against its
plain version, at the edges that chip_smoke.py's phase 3 does not reach:

- one destination, 4 and 1,023 (the most one launch takes), each with
  capacities over, at and under the largest block (the fill of the
  slots no row reached; the overflow);
- every row masked, no rows, one row;
- targets out of range (below 0, n_dev and past it: dropped as masked
  rows), and ROADMAP.md C8's full last block followed by masked rows;
- columns, target and mask as views at odd offsets (no base aligned);
- 64 columns of 1, 4 and 8 bytes;
- one reused workspace over calls whose sizes and destinations grow and
  shrink, the same call twice (its look-back words and tickets from the
  launches before).

Every output must be identical.  The kernel has no CPU mode: these
tests need a card and skip without one.  This module imports no JAX,
so it runs past the suite's ``conftest.py``:
``python -m pytest --noconftest tests/test_torch_pack_card.py``.
"""

import numpy as np
import pytest
import torch

from citus_tpu_torch.parallel.shuffle import pack_blocks, pack_blocks_plain

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _case(n, n_dev, seed, masked=0.1, n_cols=4):
    rng = np.random.default_rng(seed)
    target = rng.integers(0, n_dev, n).astype(np.int32)
    mask = rng.random(n) >= masked
    kinds = (np.int64, np.int32, np.bool_, np.float64)
    values = [rng.integers(-9, 10**9, n).astype(kinds[j % 4])
              for j in range(n_cols)]
    return values, target, mask


def _need(target, mask, n_dev):
    ok = mask & (target >= 0) & (target < n_dev)
    return int(np.bincount(target[ok], minlength=n_dev).max()) if ok.any() \
        else 0


def _on(card, a, offset=0):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(card)
    if not offset:
        return t
    buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device=card)
    buf[offset:] = t
    return buf[offset:]


def _check(card, values, target, mask, n_dev, capacity, offset=0):
    args = (tuple(_on(card, v, offset) for v in values),
            _on(card, target, offset), _on(card, mask, offset), n_dev,
            capacity)
    got = pack_blocks(*args)
    want = pack_blocks_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got[0] + (got[1], got[2]), want[0] + (want[1], want[2])):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    return int(got[2])


@pytest.mark.parametrize("fit", ["over", "exact", "under"])
@pytest.mark.parametrize("n_dev", [1, 4, 1023])
def test_destinations_and_capacities(card, n_dev, fit):
    values, target, mask = _case(200_003, n_dev, n_dev)
    need = _need(target, mask, n_dev)
    cap = {"over": need + 7, "exact": need, "under": max(need // 3, 1)}[fit]
    over = _check(card, values, target, mask, n_dev, cap)
    assert (over > 0) == (fit == "under")


def test_every_row_masked_no_rows_one_row(card):
    values, target, mask = _case(5000, 3, 1, masked=1.1)
    _check(card, values, target, mask, 3, 10)
    values, target, mask = _case(0, 3, 2)
    _check(card, values, target, mask, 3, 10)
    values, target, mask = _case(1, 1, 3, masked=0.0)
    _check(card, values, target, mask, 1, 1)


def test_targets_out_of_range_and_c8(card):
    values, target, mask = _case(50_000, 6, 4)
    target[::7] = -1
    target[1::11] = 6
    target[2::13] = 2**31 - 1
    _check(card, values, target, mask, 6, _need(target, mask, 6))
    # a full last block, then masked rows: its last row stays
    values = [np.array([10, 11, 12, 13], np.int64)]
    target = np.zeros(4, np.int32)
    mask = np.array([True, True, False, False])
    assert _check(card, values, target, mask, 1, 2) == 0


@pytest.mark.parametrize("offset", [1, 3])
def test_views_at_odd_offsets(card, offset):
    values, target, mask = _case(123_457, 5, offset)
    _check(card, values, target, mask, 5, _need(target, mask, 5), offset)


def test_sixty_four_columns(card):
    values, target, mask = _case(40_000, 3, 9, n_cols=64)
    _check(card, values, target, mask, 3, _need(target, mask, 3) - 3)


def test_workspace_reused_over_growing_and_shrinking_calls(card):
    for n, n_dev in ((1000, 2), (300_000, 9), (5000, 1023), (10, 1),
                     (300_000, 9), (300_000, 9), (70_000, 64)):
        values, target, mask = _case(n, n_dev, n + n_dev)
        _check(card, values, target, mask, n_dev,
               max(_need(target, mask, n_dev), 1))
