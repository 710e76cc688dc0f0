"""The rollup delta fold (B9, ``csrc/rollup_delta.cu``) on the card,
against its plain version, in each regime:

- every kind, direct, at a refresh batch, a ragged batch (n not a
  multiple of 4: a row at a time) and a batch of views 3 rows into their
  buffers (not 16-byte aligned: a row at a time);
- count and sums privatized (a [G] table in each block's shared memory,
  flushed by global atomics) and direct, at a backfill batch, a ragged one, and 8 groups (two blocks an SM);
- the table filled by the launch (top-k's (0, INT64_MIN) records) and
  group ids at or past G changing nothing.

Tables identical, float sums within 1e-12 of their groups' sums of |x|
(the rows added in another order, with cancellation).  The
kernel has no CPU mode: these tests need a card and skip without one.
This module imports no JAX:
``python -m pytest --noconftest tests/test_torch_rollup_card.py``.
"""

import numpy as np
import pytest
import torch

from citus_tpu_torch.rollup import kernels as K


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _batch(kind, n, groups, seed, card, offset=0):
    """n rows into ``groups`` groups (a few past them), NaN, +-inf and
    +-0.0 among the float values; views ``offset`` rows into their
    buffers."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, groups, n + offset).astype(np.int32)
    g[offset + 3::997] = groups + 5          # past G: changes nothing
    ok = rng.random(n + offset) > 0.1
    if kind in ("sum_float", "ddsk"):
        v = rng.normal(0, 1e4, n + offset)
        v[offset:offset + 6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 5e-324]
    else:
        v = rng.integers(-2**62, 2**62, n + offset)
    t = [torch.from_numpy(a).to(card)[offset:] for a in (v, g, ok)]
    return (None if kind == "count" else t[0]), t[1], t[2]


def _plain(kind, vals, g, ok, gp):
    keep = g < gp
    want = K._tables(kind, gp, g.device)
    K.rollup_delta_plain(kind, None if vals is None else vals[keep],
                         g[keep], ok[keep], *want)
    return want


def _same(kind, got, want, abs_sums=None):
    """Identical tables; a float sum within 1e-12 of its group's sum of
    |x| (``abs_sums``; the rows added in another order)."""
    got = got if isinstance(got, tuple) else (got,)
    for k, p in zip(got, want):
        if kind == "sum_float":
            assert torch.equal(torch.isnan(k), torch.isnan(p))
            fin = torch.isfinite(p)
            assert torch.equal(k[~fin & ~torch.isnan(p)],
                               p[~fin & ~torch.isnan(p)])
            assert ((k[fin] - p[fin]).abs()
                    <= 1e-12 * abs_sums[fin]).all()
        else:
            assert torch.equal(k, p)


def _abs_sums(vals, g, ok, gp):
    """Each group's sum of |x| over its ok rows below G."""
    keep = ok & (g < gp)
    out = torch.zeros(gp, dtype=torch.float64, device=g.device)
    return out.index_add_(0, g[keep].long(), vals[keep].abs())


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(65_536, 0), (65_531, 0), (4096, 3)])
@pytest.mark.parametrize("kind", list(K.KINDS))
def test_direct_regime_matches_plain(card, kind, n, offset):
    gp = K._pad_to(10_000)
    vals, g, ok = _batch(kind, n, gp, n + offset, card, offset)
    launches = K.rollup_delta.launches
    got = K.rollup_delta(kind, vals, g, ok, gp)
    torch.cuda.synchronize()
    assert K.rollup_delta.launches == launches + 1
    assert K.rollup_delta.last_regime == "direct"
    _same(kind, got, _plain(kind, vals, g, ok, gp),
          kind == "sum_float" and _abs_sums(vals, g, ok, gp))


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["private", "direct"])
@pytest.mark.parametrize("n,groups", [(1 << 23, 16_384),
                                      (1_000_003, 16_384), (100_000, 8)])
@pytest.mark.parametrize("kind", list(K.PRIVATE_KINDS))
def test_privatized_regime_matches_plain(card, kind, n, groups, regime):
    vals, g, ok = _batch(kind, n, groups, 7, card)
    assert K.regime(kind, n, groups) == "private"
    table = K._table(kind, groups, card)
    table.fill_(7)           # the launch sets it empty first
    K.launch_fold(kind, vals, g, ok, table, regime)
    torch.cuda.synchronize()
    _same(kind, table, _plain(kind, vals, g, ok, groups),
          kind == "sum_float" and _abs_sums(vals, g, ok, groups))
