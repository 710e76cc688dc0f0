"""The repartition kernels of the port (B7 partition, B8 sort join), held
against the JAX package's jitted bodies.

- ``pack_blocks`` (``citus_tpu_torch/parallel/shuffle.py``, B7) on CPU
  tensors runs its plain version; on the same numpy-seeded columns it
  must give ``citus_tpu/parallel/shuffle.py _pack_blocks``'s packed
  values, validity and overflow, for n_dev 1, 2 and 8, capacities under
  and over the need, all rows masked, and no rows.  One difference is
  deliberate and pinned (ROADMAP.md C8): the reference clips a dropped
  row's slot into its block's last slot and scatters it there, so an
  overflowing block, and a full last block followed by masked rows,
  lose their last row; the port keeps it.
- ``sorted_join`` (B8) on CPU tensors must give
  ``_sorted_join_indexes``'s l_idx, r_idx, out_valid and total slot for
  slot (the slots past the last pair too) and the gathers of
  ``build_repartition_join``.
- A numpy model of each CUDA kernel's algorithm (counting passes, the
  radix sort by dense gid, the run expansion and the tail of clipped
  slots; ``csrc/partition_pack.cu``, ``csrc/sorted_join.cu``) gives the
  same outputs: the kernels' design is checked here, their code on a
  card.
- Over a mesh of 8 CPU members, ``build_repartition`` and
  ``build_repartition_join`` (each member packs, ``exchange_blocks``
  moves block d of every member to member d, the overflow sums over
  members, each member joins) against the reference's builders at
  tests/conftest.py's 8 devices: values, validity and overflow, an
  overflowing block too, where the reference's C8 slots are recorded;
  ``exchange_blocks_plain`` against a numpy block transpose.
- ``test_*_kernel_matches_plain_on_card`` hold the CUDA kernels against
  the plain versions; they need a card and skip here.
"""

import numpy as np
import pytest

import citus_tpu  # noqa: F401  (x64 on before any JAX array)
import jax.numpy as jnp
import torch

from citus_tpu.parallel.shuffle import _pack_blocks, _sorted_join_indexes
from citus_tpu_torch.parallel import shuffle
from citus_tpu_torch.parallel.mesh import DeviceMesh
from citus_tpu_torch.parallel.shuffle import (
    build_repartition, build_repartition_join, pack_blocks, pack_blocks_plain,
    repartition_host, sorted_join, sorted_join_indexes_plain,
    sorted_join_plain, _sj_passes,
)

# ------------------------------------------------------------------ B7


def _pack_case(n, n_dev, seed, masked=0.2, all_masked=False):
    rng = np.random.default_rng(seed)
    target = rng.integers(0, n_dev, n).astype(np.int32)
    mask = rng.random(n) >= masked
    if all_masked:
        mask[:] = False
    values = (np.arange(n, dtype=np.int64) * 7 - 3,
              rng.integers(-1000, 1000, n).astype(np.int32),
              rng.normal(0, 1, n),
              rng.random(n) > 0.5)
    return values, target, mask


def _need(target, mask, n_dev):
    counts = np.bincount(target[mask], minlength=n_dev) if mask.any() \
        else np.zeros(n_dev, np.int64)
    return int(counts.max()) if n_dev else 0


def _pack_oracle(values, target, mask, n_dev, capacity):
    """A stable partition straight from its definition."""
    packed = [np.zeros((n_dev, capacity), v.dtype) for v in values]
    pvalid = np.zeros((n_dev, capacity), bool)
    overflow = 0
    for d in range(n_dev):
        rows = np.nonzero(mask & (target == d))[0]
        overflow += max(len(rows) - capacity, 0)
        rows = rows[:capacity]
        for p, v in zip(packed, values):
            p[d, :len(rows)] = v[rows]
        pvalid[d, :len(rows)] = True
    return packed, pvalid, overflow


def _c8_slots(target, mask, n_dev, capacity):
    """The reference's clobbered slots: a dropped row's slot is clipped
    into its block's last slot (a masked row's into the last block's),
    so the last row of every overflowing block and, when masked rows
    exist, of a full last block can be overwritten."""
    counts = np.bincount(target[mask], minlength=n_dev) if mask.any() \
        else np.zeros(n_dev, np.int64)
    out = [(d, capacity - 1) for d in range(n_dev) if counts[d] > capacity]
    if counts[n_dev - 1] == capacity and (~mask).any():
        out.append((n_dev - 1, capacity - 1))
    return out


def _run_port_pack(values, target, mask, n_dev, capacity):
    packed, pvalid, ov = pack_blocks(
        tuple(torch.from_numpy(v) for v in values), torch.from_numpy(target),
        torch.from_numpy(mask), n_dev, capacity)
    return [p.numpy() for p in packed], pvalid.numpy(), int(ov)


def _run_ref_pack(values, target, mask, n_dev, capacity):
    packed, pvalid, ov = _pack_blocks(
        tuple(jnp.asarray(v) for v in values), jnp.asarray(target),
        jnp.asarray(mask), n_dev, capacity)
    return [np.asarray(p) for p in packed], np.asarray(pvalid), int(ov)


PACK_CASES = [
    # (n, masked share, all masked)
    (3000, 0.2, False),
    (1, 0.0, False),
    (257, 0.0, False),
    (500, 1.0, True),
    (0, 0.0, False),
]


@pytest.mark.parametrize("fit", ["over", "exact", "under"])
@pytest.mark.parametrize("n_dev", [1, 2, 8])
@pytest.mark.parametrize("n,masked,all_masked", PACK_CASES,
                         ids=["mixed", "one_row", "unmasked", "all_masked",
                              "empty"])
def test_pack_blocks_plain_matches_reference(n, masked, all_masked, n_dev,
                                             fit):
    values, target, mask = _pack_case(n, n_dev, seed=n + n_dev,
                                      masked=masked, all_masked=all_masked)
    need = _need(target, mask, n_dev)
    capacity = {"over": need + 3, "exact": max(need, 1),
                "under": max(need // 2, 1)}[fit]
    got = _run_port_pack(values, target, mask, n_dev, capacity)
    want = _run_ref_pack(values, target, mask, n_dev, capacity)
    oracle = _pack_oracle(values, target, mask, n_dev, capacity)
    assert got[2] == want[2] == oracle[2]
    c8 = _c8_slots(target, mask, n_dev, capacity)
    for g, w, o in zip(got[0] + [got[1]], want[0] + [want[1]],
                       oracle[0] + [oracle[1]]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, o)
        # ROADMAP.md C8: only those slots of the reference may differ
        w, o = w.copy(), o.copy()
        for slot in c8:
            w[slot] = o[slot] = 0
        np.testing.assert_array_equal(w, o)


def test_reference_pack_blocks_loses_a_full_last_block_row_c8():
    """ROADMAP.md C8, pinned: two valid rows fill the one block of
    capacity 2 and two masked rows follow; the reference reports no
    overflow but its packed validity holds one row, the port's both."""
    values = (np.array([10, 11, 12, 13], np.int64),)
    target = np.zeros(4, np.int32)
    mask = np.array([True, True, False, False])
    ref = _run_ref_pack(values, target, mask, 1, 2)
    port = _run_port_pack(values, target, mask, 1, 2)
    assert ref[2] == port[2] == 0
    assert ref[1].tolist() == [[True, False]]
    assert ref[0][0].tolist() == [[10, 0]]
    assert port[1].tolist() == [[True, True]]
    assert port[0][0].tolist() == [[10, 11]]


def _digit_look_backs(counts, rng):
    """The rows of each destination in the tiles before each tile, as
    partition_pack.cu's decoupled look-backs find them when tiles finish
    out of order: ``counts`` [tiles, n_dev].  Tiles are numbered in the
    order they start; at each step one tile of those that can move, drawn
    at random, either publishes its counts (status AGG) or, once
    published, walks back over the tiles before it, adding the counts of
    those that have only published theirs (AGG) until one has published
    its inclusive counts (INCL), and publishes its own.  A walk that
    meets a tile that has published nothing waits.  -> (before [tiles,
    n_dev], how many walks added an AGG tile's counts)."""
    nt, n_dev = counts.shape
    state = ["none"] * nt
    incl = np.zeros_like(counts)
    before = np.zeros_like(counts)
    partial = 0
    while any(st != "incl" for st in state):
        moves = []
        for t in range(nt):
            if state[t] == "none":
                moves.append(t)
            elif state[t] == "agg":
                j = t - 1
                while j >= 0 and state[j] == "agg":
                    j -= 1
                if j < 0 or state[j] == "incl":
                    moves.append(t)
        t = int(rng.choice(moves))
        if state[t] == "none":
            state[t] = "incl" if t == 0 else "agg"
            if t == 0:
                incl[0] = counts[0]
            continue
        acc, j = np.zeros(n_dev, counts.dtype), t - 1
        while state[j] == "agg":
            acc += counts[j]
            partial += 1
            j -= 1
        acc += incl[j]
        before[t], incl[t] = acc, acc + counts[t]
        state[t] = "incl"
    return before, partial


def _pack_kernel_model(values, target, mask, n_dev, capacity, tile=2048,
                       seed=0):
    """partition_pack.cu step by step on tiles of ``tile`` rows: each
    tile's 8 warps (tile / 8 consecutive rows each) rank their own kept
    rows of a destination in input order, the warps' counts give each
    warp's start, the look-backs the tile's start among all rows of a
    destination (``_digit_look_backs``, tiles finishing out of order); the
    kept rows are staged in (destination, input) order and written from
    there, those past the capacity dropped (a tile whose rows all go to
    one destination writes them as they lie); then the fill of every
    block's slots past its rows from the last tile's inclusive counts,
    and the overflow from them.  -> (packed, validity, overflow, the
    walks that added a tile's published counts)."""
    rng = np.random.default_rng(seed)
    n = len(target)
    kept = mask & (target >= 0) & (target < n_dev)
    nt = -(-n // tile)
    counts = np.zeros((nt, n_dev), np.int64)
    for t in range(nt):
        rows = np.arange(t * tile, min(n, (t + 1) * tile))
        rows = rows[kept[rows]]
        counts[t] = np.bincount(target[rows], minlength=n_dev)
    before, partial = _digit_look_backs(counts, rng) if nt \
        else (counts, 0)
    packed = [np.full((n_dev, capacity), 99, v.dtype) for v in values]
    pvalid = np.full((n_dev, capacity), 7, np.uint8)
    for t in range(nt):
        rows = np.arange(t * tile, min(n, (t + 1) * tile))
        dense = np.nonzero(counts[t] == rows.size)[0]
        if dense.size:
            # every row kept, to one destination: its rows as they lie
            d = dense[0]
            for at, i in enumerate(rows):
                r = before[t, d] + at
                if r < capacity:
                    for p, v in zip(packed, values):
                        p[d, r] = v[i]
                    pvalid[d, r] = 1
            continue
        warp = (rows - t * tile) // (tile // 8)
        wcounts = np.zeros((8, n_dev), np.int64)
        rank = np.zeros(rows.size, np.int64)
        for k, i in enumerate(rows):
            if kept[i]:
                rank[k] = wcounts[warp[k], target[i]]
                wcounts[warp[k], target[i]] += 1
        warp_start = np.cumsum(wcounts, 0) - wcounts
        local_start = np.cumsum(counts[t]) - counts[t]
        staged = np.full(int(counts[t].sum()), -1, np.int64)
        for k, i in enumerate(rows):
            if kept[i]:
                d = target[i]
                staged[local_start[d] + warp_start[warp[k], d] + rank[k]] = i
        assert (staged >= 0).all()
        for at, i in enumerate(staged):
            d = target[i]
            r = before[t, d] + at - local_start[d]
            if r < capacity:
                for p, v in zip(packed, values):
                    p[d, r] = v[i]
                pvalid[d, r] = 1
    total = before[-1] + counts[-1] if nt else np.zeros(n_dev, np.int64)
    for d in range(n_dev):
        for r in range(min(int(total[d]), capacity), capacity):
            for p in packed:
                p[d, r] = 0
            pvalid[d, r] = 0
    overflow = int(np.maximum(total - capacity, 0).sum())
    return packed, pvalid.astype(bool), overflow, partial


#: the masked share of a model case by its row count (else 0.2): none
#: masked (4,100 rows to one destination: every tile takes the dense
#: path, an overflowing one), every row masked
MODEL_MASKED = {3000: 0.0, 1000: 1.1, 4100: 0.0}


@pytest.mark.parametrize("n,n_dev,fit", [
    (5000, 1, "exact"), (5000, 4, "exact"), (5000, 8, "under"),
    (4097, 3, "over"), (6000, 1023, "exact"), (3000, 1023, "under"),
    (1000, 2, "exact"), (0, 2, "over"), (4100, 1, "under")])
def test_pack_kernel_model_matches_plain(n, n_dev, fit):
    """The CUDA kernel's algorithm (a numpy model with a small tile, so
    rows cross tiles, and tiles that finish out of order so look-backs
    add the counts of tiles still in flight) gives the plain version's
    blocks and, apart from ROADMAP.md C8's slots, the reference's: one
    destination, 4, 8 and 1,023 (rows past a ragged tile's end, targets
    out of range), overflowing blocks, masked rows, every row masked, no
    rows."""
    masked = MODEL_MASKED.get(n, 0.2)
    values, target, mask = _pack_case(n, n_dev, seed=3, masked=masked)
    if n and masked:
        target[::97] = n_dev      # out of range: dropped as masked rows
        target[1::101] = -1
    need = _need(target, mask & (target >= 0) & (target < n_dev), n_dev)
    capacity = {"over": need + 1, "exact": max(need, 1),
                "under": max(need // 3, 1)}[fit]
    got = _pack_kernel_model(values, target, mask, n_dev, capacity,
                             tile=512, seed=n_dev)
    want = _run_port_pack(values, target, mask, n_dev, capacity)
    ref = _run_ref_pack(values, target, mask, n_dev, capacity)
    assert got[2] == want[2] == ref[2]
    if n >= 4 * 512 and n_dev < 1023 and masked < 1:
        assert got[3] > 0   # some look-back met a tile still in flight
    c8 = _c8_slots(target, mask & (target >= 0) & (target < n_dev), n_dev,
                   capacity)
    for g, w, r in zip(got[0] + [got[1]], want[0] + [want[1]],
                       ref[0] + [ref[1]]):
        np.testing.assert_array_equal(g, w)
        r, w = r.copy(), w.copy()
        for slot in c8:
            r[slot] = w[slot] = 0
        np.testing.assert_array_equal(r, w)


def test_pack_kernel_model_keeps_the_c8_row():
    """ROADMAP.md C8's case through the kernel's model: a full last
    block followed by masked rows keeps its last row, as the plain
    version does (the reference loses it)."""
    values = (np.array([10, 11, 12, 13], np.int64),)
    target = np.zeros(4, np.int32)
    mask = np.array([True, True, False, False])
    got = _pack_kernel_model(values, target, mask, 1, 2, tile=8)
    assert got[2] == 0
    assert got[1].tolist() == [[True, True]]
    assert got[0][0].tolist() == [[10, 11]]


def test_pack_blocks_on_cpu_runs_the_plain_version():
    values, target, mask = _pack_case(100, 2, seed=1)
    before = pack_blocks.launches
    _run_port_pack(values, target, mask, 2, 64)
    assert pack_blocks.launches == before


# ------------------------------------------------------------------ B8


def _join_case(L, R, U, seed, lmasked=0.1, rmasked=0.1):
    rng = np.random.default_rng(seed)
    lgid = rng.integers(0, U, L).astype(np.int64)
    rgid = rng.integers(0, U, R).astype(np.int64)
    lvalid = rng.random(L) >= lmasked
    rvalid = rng.random(R) >= rmasked
    # an invalid row's gid is whatever its slot held (0 padding, stale
    # ids): keep some in range and some not
    lgid[~lvalid & (rng.random(L) < 0.5)] = 0
    rgid[~rvalid & (rng.random(R) < 0.5)] = U + 5
    return lgid, lvalid, rgid, rvalid


def _pairs_needed(lgid, lvalid, rgid, rvalid):
    lc = np.bincount(lgid[lvalid], minlength=1)
    n = 0
    for g, v in zip(rgid, rvalid):
        if v and 0 <= g < len(lc):
            n += int(lc[g])
    return n


def _run_ref_join(lgid, lvalid, rgid, rvalid, J):
    out = _sorted_join_indexes(jnp.asarray(lgid), jnp.asarray(lvalid),
                               jnp.asarray(rgid), jnp.asarray(rvalid), J)
    return [np.asarray(o).astype(np.int64) if np.asarray(o).dtype != bool
            else np.asarray(o) for o in out]


def _run_port_join(lgid, lvalid, rgid, rvalid, U, J, lcols=(), rcols=()):
    out = sorted_join(torch.from_numpy(lgid), torch.from_numpy(lvalid),
                      torch.from_numpy(rgid), torch.from_numpy(rvalid),
                      tuple(torch.from_numpy(c) for c in lcols),
                      tuple(torch.from_numpy(c) for c in rcols), U, J)
    li, ri, ov, total, ol, orr = out
    return ([li.numpy(), ri.numpy(), ov.numpy(), np.int64(total)],
            [o.numpy() for o in ol], [o.numpy() for o in orr])


#: device_join's unit case (tests/test_device_join.py:114): gids not
#: dense, an invalid left row, a right row with no match
UNIT = (np.array([5, 2, 2, 9, 2, 7], np.int64),
        np.array([True, True, True, False, True, True]),
        np.array([2, 7, 7, 3, 9], np.int64),
        np.array([True] * 5))


def _join_cases():
    cases = {"unit": UNIT + (10,)}
    cases["many_to_many"] = _join_case(3000, 5000, 400, seed=11) + (400,)
    cases["one_group"] = _join_case(40, 30, 1, seed=2, lmasked=0.0,
                                    rmasked=0.0) + (1,)
    cases["left_empty"] = _join_case(64, 100, 50, seed=4, lmasked=1.1) + (50,)
    cases["right_empty"] = _join_case(64, 100, 50, seed=5, rmasked=1.1) + (50,)
    cases["invalid_both"] = _join_case(2048, 1024, 700, seed=6, lmasked=0.5,
                                       rmasked=0.5) + (700,)
    cases["one_row_each"] = (np.array([0], np.int64), np.array([True]),
                             np.array([0], np.int64), np.array([True]), 1)
    # one gid holding 70 % of the left rows, present twice on the right
    lgid, lvalid, rgid, rvalid = _join_case(3000, 400, 300, seed=12)
    rng = np.random.default_rng(12)
    lgid[rng.random(3000) < 0.7] = 123
    rgid[rgid == 123] = 124
    rgid[[5, 300]], rvalid[[5, 300]] = 123, True
    cases["skewed"] = (lgid, lvalid, rgid, rvalid, 300)
    # keys in [0, 65535]: two passes of 8 bits, the largest digit count
    cases["widest_digits"] = _join_case(3000, 700, 65535, seed=13) + (65535,)
    return cases


JOIN_CASES = _join_cases()


@pytest.mark.parametrize("cap", ["exact", "over", "under"])
@pytest.mark.parametrize("case", list(JOIN_CASES))
def test_sorted_join_indexes_plain_matches_reference(case, cap):
    lgid, lvalid, rgid, rvalid, U = JOIN_CASES[case]
    total = _pairs_needed(lgid, lvalid, rgid, rvalid)
    J = {"exact": total, "over": total + 37, "under": total // 2}[cap]
    want = _run_ref_join(lgid, lvalid, rgid, rvalid, J)
    got, _, _ = _run_port_join(lgid, lvalid, rgid, rvalid, U, J)
    assert int(got[3]) == int(want[3]) == total
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)


def test_sorted_join_gathers_every_column():
    lgid, lvalid, rgid, rvalid, U = JOIN_CASES["many_to_many"]
    rng = np.random.default_rng(8)
    lcols = (rng.integers(0, 10**9, len(lgid)), rng.random(len(lgid)) > 0.3,
             rng.normal(0, 1, len(lgid)),
             rng.integers(0, 99, len(lgid)).astype(np.int32))
    rcols = (rng.integers(0, 10**9, len(rgid)), rng.random(len(rgid)) > 0.3)
    J = _pairs_needed(lgid, lvalid, rgid, rvalid) + 5
    idx, ol, orr = _run_port_join(lgid, lvalid, rgid, rvalid, U, J, lcols,
                                  rcols)
    ref = _run_ref_join(lgid, lvalid, rgid, rvalid, J)
    for c, o in zip(lcols, ol):
        np.testing.assert_array_equal(o, np.asarray(jnp.asarray(c)[ref[0]]))
    for c, o in zip(rcols, orr):
        np.testing.assert_array_equal(o, np.asarray(jnp.asarray(c)[ref[1]]))
    assert sorted_join.launches == 0


def test_sorted_join_refuses_an_empty_side():
    """The reference's searches need a row on each side (its device join
    never sends fewer: capacities are at least 1); so do both versions
    here."""
    e = torch.zeros(0, dtype=torch.int64)
    one = torch.zeros(1, dtype=torch.int64)
    for lg, rg in ((e, one), (one, e)):
        with pytest.raises(ValueError, match="at least one row"):
            sorted_join(lg, lg > 0, rg, rg > 0, (), (), 1, 4)


def _look_back(tile_sums, rng):
    """The exclusive prefix of every tile as sorted_join.cu's decoupled
    look-back finds it: tile t publishes its sum, then walks back over
    the tiles before it, adding the sums of those still in flight (a
    random number of them: published sum only) until one has published
    its inclusive prefix, and publishes its own."""
    incl = []
    out = []
    for t, s in enumerate(tile_sums):
        in_flight = int(rng.integers(0, t + 1))
        before, j = 0, t - 1
        while j >= 0:
            if t - j <= in_flight:
                before += tile_sums[j]
            else:
                before += incl[j]
                break
            j -= 1
        out.append(before)
        incl.append(before + s)
    return np.array(out, np.int64)


def _join_kernel_model(lgid, lvalid, rgid, rvalid, U, J, tile=512, seed=0):
    """sorted_join.cu step by step, on tiles of ``tile`` rows: left keys
    counted (the invalid rows at U); the counts scanned tile by tile into
    starts with the look-back, and every pass's digit histogram taken
    from them; the stable radix sort of
    (key, row), ceil(bits / 8) passes of ceil(bits / passes) bits, each
    tile placing its rows of a digit after the digit's smaller digits
    (the histogram) and after the tiles before it (a look-back per
    digit), within the tile by the warps' counts and each warp's ranks
    (staged in the tile's sorted order); the right rows' runs scanned
    tile by tile into run ends and bases; then each output slot's right
    row by a search of the run ends and its left row from the order."""
    rng = np.random.default_rng(seed)
    L, R = len(lgid), len(rgid)
    ok = lvalid & (lgid >= 0) & (lgid < U)
    key = np.where(ok, lgid, U).astype(np.int64)
    counts = np.zeros(U + 1, np.int64)
    np.add.at(counts, key, 1)      # the invalid rows at U

    def scan(values):
        n = len(values)
        sums = [int(values[a:a + tile].sum()) for a in range(0, n, tile)]
        prefix = _look_back(sums, rng)
        out = np.empty(n, np.int64)
        for t, a in enumerate(range(0, n, tile)):
            chunk = values[a:a + tile]
            out[a:a + tile] = prefix[t] + np.cumsum(chunk) - chunk
        return out
    starts = scan(counts)
    passes, width = _sj_passes(U)
    idx = np.arange(L)
    nt = -(-L // tile)
    for k in range(passes):
        digit = (key >> (k * width)) & ((1 << width) - 1)
        # from the counts a gid, as the starts scan takes it
        hist = np.bincount((np.arange(U + 1) >> (k * width))
                           & ((1 << width) - 1), weights=counts,
                           minlength=1 << width).astype(np.int64)
        first = np.cumsum(hist) - hist
        per_tile = np.stack([np.bincount(digit[t * tile:(t + 1) * tile],
                                         minlength=1 << width)
                             for t in range(nt)])
        before = np.stack([_look_back(list(per_tile[:, d]), rng)
                           for d in range(1 << width)], 1)
        nkey, nidx = np.empty_like(key), np.empty_like(idx)
        for t in range(nt):
            # 8 warps of tile / 8 consecutive rows: each ranks its rows
            # of a digit, the warps' counts give their starts
            rows = np.arange(t * tile, min(L, (t + 1) * tile))
            warp = (rows - t * tile) // (tile // 8)
            wcounts = np.zeros((8, 1 << width), np.int64)
            rank = np.empty(rows.size, np.int64)
            for n, i in enumerate(rows):
                rank[n] = wcounts[warp[n], digit[i]]
                wcounts[warp[n], digit[i]] += 1
            warp_start = np.cumsum(wcounts, 0) - wcounts
            local_start = np.cumsum(per_tile[t]) - per_tile[t]
            offset = first + before[t] - local_start
            for n, i in enumerate(rows):
                at = local_start[digit[i]] + warp_start[warp[n], digit[i]] \
                    + rank[n]
                nkey[offset[digit[i]] + at] = key[i]
                nidx[offset[digit[i]] + at] = idx[i]
        key, idx = nkey, nidx
    order = idx
    nvl = starts[U]
    lo = np.zeros(R, np.int64)
    run = np.zeros(R, np.int64)
    for r in range(R):
        g = rgid[r]
        if g < 0:
            a = b = 0
        elif g >= U:
            a, b = nvl, (L if g == np.iinfo(np.int64).max else nvl)
        else:
            a, b = starts[g], starts[g + 1]
        lo[r], run[r] = a, (b - a if rvalid[r] else 0)
    excl = scan(run)
    ends, base = excl + run, lo - excl
    total = ends[-1]
    j = np.arange(J)
    r_idx = np.minimum(np.searchsorted(ends, j, side="right"), R - 1)
    l_idx = order[np.clip(base[r_idx] + j, 0, L - 1)]
    return [l_idx, r_idx, j < total, np.int64(total)]


@pytest.mark.parametrize("case", ["unit", "many_to_many", "one_group",
                                  "left_empty", "invalid_both",
                                  "one_row_each", "skewed",
                                  "widest_digits"])
def test_sorted_join_kernel_model_matches_plain(case):
    """The CUDA kernel's algorithm (a numpy model, small tiles so rows
    cross tiles, look-backs that find tiles still in flight) gives the
    plain version's slots, the clipped ones included; a gid range over
    256 takes two radix passes, U = 65,535 two passes of 256 digits, and
    one gid holding most left rows spans many tiles."""
    lgid, lvalid, rgid, rvalid, U = JOIN_CASES[case]
    J = _pairs_needed(lgid, lvalid, rgid, rvalid) + 9
    got = _join_kernel_model(lgid, lvalid, rgid, rvalid, U, J)
    want, _, _ = _run_port_join(lgid, lvalid, rgid, rvalid, U, J)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_out_of_range_left_gids_join_as_invalid_rows():
    """A valid left gid outside [0, U) joins as an invalid row in the
    plain version, as in the kernel (its numpy model): the slots equal
    those of the same input with those rows marked invalid, right gids
    outside [0, U) (the int64 maximum among them) included."""
    lgid, lvalid, rgid, rvalid, U = JOIN_CASES["invalid_both"]
    lgid, rgid = lgid.copy(), rgid.copy()
    lvalid = lvalid.copy()
    lvalid[:8] = True
    lgid[:8] = [-3, U, U + 5, np.iinfo(np.int64).max, -1, U, 2 * U, U + 1]
    rgid[:4] = [np.iinfo(np.int64).max, U + 5, -3, U]
    out = ~((lgid >= 0) & (lgid < U))
    J = _pairs_needed(lgid, lvalid & ~out, rgid, rvalid) + 9
    got, _, _ = _run_port_join(lgid, lvalid, rgid, rvalid, U, J)
    masked, _, _ = _run_port_join(lgid, lvalid & ~out, rgid, rvalid, U, J)
    model = _join_kernel_model(lgid, lvalid, rgid, rvalid, U, J)
    for g, m, k in zip(got, masked, model):
        np.testing.assert_array_equal(g, m)
        np.testing.assert_array_equal(g, k)


# ------------------------------------------------------- over the mesh


def test_build_repartition_join_on_one_device_matches_host_join():
    """The one-card mesh: both sides packed (B7, the exchange an
    identity) and joined (B8); the joined rows are those of a host hash
    join, and the overflow is 0 with exact capacities."""
    lgid, lvalid, rgid, rvalid, U = JOIN_CASES["many_to_many"]
    mesh = DeviceMesh([torch.device("cpu")])
    lv = (np.arange(len(lgid), dtype=np.int64), lvalid.copy())
    rv = (np.arange(len(rgid), dtype=np.int64) + 10**6, rvalid.copy())
    J = _pairs_needed(lgid, lvalid, rgid, rvalid)
    cap_l, cap_r = int(lvalid.sum()), int(rvalid.sum())
    fn = build_repartition_join(mesh, 2, 2, cap_l, cap_r, J, U)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))[None]  # noqa
    out_l, out_r, ovalid, overflow = fn(
        tuple(t(v) for v in lv), t(lgid), t(np.zeros(len(lgid), np.int32)),
        t(lvalid), tuple(t(v) for v in rv), t(rgid),
        t(np.zeros(len(rgid), np.int32)), t(rvalid))
    assert int(overflow) == 0
    sel = ovalid[0].numpy()
    got = sorted(zip(out_l[0][0].numpy()[sel].tolist(),
                     out_r[0][0].numpy()[sel].tolist()))
    want = sorted((i, j + 10**6) for j in range(len(rgid)) if rvalid[j]
                  for i in range(len(lgid))
                  if lvalid[i] and lgid[i] == rgid[j])
    assert got == want


def test_build_repartition_packs_into_the_one_bucket():
    mesh = DeviceMesh([torch.device("cpu")])
    values, target, mask = _pack_case(300, 1, seed=9)
    fn = build_repartition(mesh, 2, 512)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))[None]  # noqa
    out, ovalid, overflow = fn((t(values[0]), t(values[1])), t(target),
                               t(mask))
    assert int(overflow) == 0
    sel = ovalid[0].numpy()
    np.testing.assert_array_equal(out[0][0].numpy()[sel], values[0][mask])
    host = repartition_host(values[:2], target, mask, 1)
    np.testing.assert_array_equal(out[1][0].numpy()[sel], host[0][1])


def test_a_mesh_of_more_than_one_card_is_refused_naming_a9b():
    """A mesh of several members of one kind runs (the tests below); one
    whose members span device kinds, as a mesh across hosts would, is
    refused, naming ROADMAP.md A9b."""
    assert DeviceMesh([torch.device("cpu")] * 2).shape["shard"] == 2
    with pytest.raises(NotImplementedError, match="A9b"):
        DeviceMesh([torch.device("cpu"), torch.device("cuda", 0)])


# ------------------------------------------ over a mesh of 8 members


N_DEV = 8


def _stacked_case(n, seed, masked=0.1):
    """[N_DEV, n] stacks of four columns (int64, int32, float64, bool),
    targets and masks, one row per member, from numpy."""
    rng = np.random.default_rng(seed)
    values = (np.arange(N_DEV * n, dtype=np.int64).reshape(N_DEV, n) * 3 - 7,
              rng.integers(-1000, 1000, (N_DEV, n)).astype(np.int32),
              rng.normal(0, 1, (N_DEV, n)),
              rng.random((N_DEV, n)) > 0.5)
    target = rng.integers(0, N_DEV, (N_DEV, n)).astype(np.int32)
    mask = rng.random((N_DEV, n)) >= masked
    return values, target, mask


def _port_mesh():
    return DeviceMesh([torch.device("cpu")] * N_DEV)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("fit", ["over", "exact", "under"])
def test_build_repartition_over_8_members_matches_reference(fit):
    """Values, validity and overflow of the port's repartition (each
    member packs, exchange_blocks moves block d to member d,
    mesh_combine sums the overflow) against the reference's
    build_repartition at 8 devices.  The reference may lose a block's
    last row where ROADMAP.md C8 says; those slots are recorded and
    only they may differ."""
    from citus_tpu.parallel.mesh import default_mesh
    from citus_tpu.parallel.shuffle import (
        build_repartition as ref_build_repartition,
    )
    values, target, mask = _stacked_case(400, seed={"over": 1, "exact": 2,
                                                    "under": 3}[fit])
    need = max(_need(target[s], mask[s], N_DEV) for s in range(N_DEV))
    cap = {"over": need + 2, "exact": need, "under": need // 2}[fit]
    want = ref_build_repartition(default_mesh(), len(values), cap)(
        values, target, mask)
    shuffle.exchange_blocks_plain.calls = 0
    got = build_repartition(_port_mesh(), len(values), cap)(
        tuple(_t(v) for v in values), _t(target), _t(mask))
    assert shuffle.exchange_blocks_plain.calls == 1
    assert int(got[2]) == int(want[2])
    assert (int(got[2]) > 0) == (fit == "under")
    # the slots the reference's pack clobbered: block d of source s
    # lands on member d at rows [s * cap, (s + 1) * cap)
    c8 = [(d, s * cap + r) for s in range(N_DEV)
          for d, r in _c8_slots(target[s], mask[s], N_DEV, cap)]
    assert (len(c8) > 0) == (fit == "under")
    for g, w in zip(got[0] + (got[1],), tuple(want[0]) + (want[1],)):
        g, w = g.numpy().copy(), np.asarray(w).copy()
        assert g.dtype == w.dtype and g.shape == w.shape == (N_DEV,
                                                             N_DEV * cap)
        for slot in c8:
            g[slot] = w[slot] = 0
        np.testing.assert_array_equal(g, w)


def test_one_column_repartition_over_8_members_as_dryrun_multichip():
    """__graft_entry__.py dryrun_multichip's repartition: one int64
    column, every row valid, targets value % 8, capacity N: no
    overflow, every row received once, on the member it targets, and
    the reference's blocks exactly."""
    from citus_tpu.parallel.mesh import default_mesh
    from citus_tpu.parallel.shuffle import (
        build_repartition as ref_build_repartition,
    )
    N = 64
    vals = np.arange(N_DEV * N, dtype=np.int64).reshape(N_DEV, N)
    tgt = (vals % N_DEV).astype(np.int32)
    msk = np.ones((N_DEV, N), bool)
    (want,), want_valid, want_ov = ref_build_repartition(
        default_mesh(), 1, N)((vals,), tgt, msk)
    (got,), valid, ov = build_repartition(_port_mesh(), 1, N)(
        (_t(vals),), _t(tgt), _t(msk))
    assert int(ov) == int(want_ov) == 0
    assert int(valid.sum()) == N_DEV * N
    for d in range(N_DEV):
        assert (got[d][valid[d]] % N_DEV == d).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))


def _join_stacks(seed, n_l=300, n_r=200, u=60):
    rng = np.random.default_rng(seed)
    lgid = rng.integers(0, u, (N_DEV, n_l)).astype(np.int64)
    rgid = rng.integers(0, u, (N_DEV, n_r)).astype(np.int64)
    lmask = rng.random((N_DEV, n_l)) > 0.1
    rmask = rng.random((N_DEV, n_r)) > 0.1
    lv = (np.arange(N_DEV * n_l, dtype=np.int64).reshape(N_DEV, n_l), lmask)
    rv = (rng.normal(0, 1, (N_DEV, n_r)), rmask)
    ltgt, rtgt = (lgid % N_DEV).astype(np.int32), (rgid % N_DEV).astype(
        np.int32)
    return lv, lgid, ltgt, lmask, rv, rgid, rtgt, rmask, u


def _pair_counts(lgid, lmask, rgid, rmask, u):
    lc = np.bincount(lgid[lmask], minlength=u)
    rc = np.bincount(rgid[rmask], minlength=u)
    per = np.zeros(N_DEV, np.int64)
    np.add.at(per, np.arange(u) % N_DEV, lc * rc)
    return int(per.max()), int((lc * rc).sum())


@pytest.mark.parametrize("fit", ["exact", "block_under", "join_under"])
def test_build_repartition_join_over_8_members_matches_reference(fit):
    """Left and right columns gathered per member, validity and the
    overflow (summed over members) against the reference's
    build_repartition_join at 8 devices, with exact capacities, an
    overflowing block and a join_cap one short."""
    from citus_tpu.parallel.mesh import default_mesh
    from citus_tpu.parallel.shuffle import (
        build_repartition_join as ref_build_join,
    )
    lv, lgid, ltgt, lmask, rv, rgid, rtgt, rmask, u = _join_stacks(
        seed={"exact": 4, "block_under": 5, "join_under": 6}[fit])
    cap_l = max(_need(ltgt[s], lmask[s], N_DEV) for s in range(N_DEV))
    cap_r = max(_need(rtgt[s], rmask[s], N_DEV) for s in range(N_DEV))
    J, pairs = _pair_counts(lgid, lmask, rgid, rmask, u)
    if fit == "block_under":
        cap_l -= 1
    if fit == "join_under":
        J -= 1
    want = ref_build_join(default_mesh(), 2, 2, cap_l, cap_r, J)(
        lv, lgid, ltgt, lmask, rv, rgid, rtgt, rmask)
    got = build_repartition_join(_port_mesh(), 2, 2, cap_l, cap_r, J, u)(
        tuple(_t(v) for v in lv), _t(lgid), _t(ltgt), _t(lmask),
        tuple(_t(v) for v in rv), _t(rgid), _t(rtgt), _t(rmask))
    assert int(got[3]) == int(want[3])
    assert (int(got[3]) > 0) == (fit != "exact")
    gv, wv = got[2].numpy(), np.asarray(want[2])
    assert gv.shape == wv.shape == (N_DEV, J)
    if fit == "block_under":
        # ROADMAP.md C8: the reference's overflowing blocks lost their
        # last row besides the rows past capacity, so its pairs differ;
        # the port's counted overflow is the same
        assert gv.sum() >= wv.sum()
        return
    np.testing.assert_array_equal(gv, wv)
    assert int(gv.sum()) == pairs if fit == "exact" else int(gv.sum()) < pairs
    for g, w in zip(got[0] + got[1], tuple(want[0]) + tuple(want[1])):
        np.testing.assert_array_equal(g.numpy()[gv], np.asarray(w)[wv])


def test_exchange_blocks_plain_is_a_block_transpose():
    """Destination d receives block d of every source, in source order:
    a transpose of the [source, destination] block grid."""
    rng = np.random.default_rng(8)
    C = 5
    grid = rng.integers(0, 10**6, (N_DEV, N_DEV, C))      # [s, d, C]
    valid = rng.random((N_DEV, N_DEV, C)) > 0.3
    blocks = [(_t(grid[s]), _t(valid[s])) for s in range(N_DEV)]
    out = shuffle.exchange_blocks(blocks, _port_mesh())
    assert shuffle.exchange_blocks.launches == 0
    want = grid.transpose(1, 0, 2).reshape(N_DEV, N_DEV * C)
    want_v = valid.transpose(1, 0, 2).reshape(N_DEV, N_DEV * C)
    for d in range(N_DEV):
        np.testing.assert_array_equal(out[d][0].numpy(), want[d])
        np.testing.assert_array_equal(out[d][1].numpy(), want_v[d])


def _emulate_exchange(p: np.ndarray, arena: np.ndarray) -> None:
    """``csrc/mesh_exchange.cu``'s kernel in numpy, over one parameter
    block whose pointers are byte offsets into ``arena``: per run
    (destination row, source, column), the unaligned head and tail byte
    by byte and the body as aligned 16-byte stores, each from the two
    aligned 16-byte source chunks that cover it, their little-endian
    words shifted into place as ``shifted<WO>`` does."""
    n_src, cap, n_cols, n_dst, remote = (int(v) for v in p[:5])
    dst_ids = p[shuffle._MX_DST_IDS:shuffle._MX_DST_IDS + n_dst]
    elem = p[shuffle._MX_ELEM:shuffle._MX_ELEM + n_cols]
    dst = p[shuffle._MX_DST:shuffle._MX_DST + n_cols]
    src = p[shuffle._MX_SRC:].reshape(shuffle._MX_MAX_COLS,
                                      shuffle.MAX_MEMBERS)
    for k in range(n_dst):
        for s in range(n_src):
            for c in range(n_cols):
                ln = cap * int(elem[c])
                row = k if (remote >> s) & 1 else int(dst_ids[k])
                a = int(src[c, s]) + row * ln
                b = int(dst[c]) + (k * n_src + s) * ln
                head = min((16 - b % 16) % 16, ln)
                nb = (ln - head) // 16
                arena[b:b + head] = arena[a:a + head]
                t0 = head + nb * 16
                arena[b + t0:b + ln] = arena[a + t0:a + ln]
                if nb == 0:
                    continue
                s0 = a + head
                base, wo, sh = s0 & ~15, (s0 & 15) >> 2, (s0 & 3) * 8
                m = np.arange(nb)
                lo = arena[base + 16 * m[:, None] + np.arange(16)]
                if s0 % 16:
                    hi = arena[base + 16 * (m[:, None] + 1) + np.arange(16)]
                    lo = np.concatenate([lo, hi], axis=1)
                w = lo.view("<u4").astype(np.uint64)
                if s0 % 16:
                    w = ((w[:, wo + 1:wo + 5] << np.uint64(32))
                         | w[:, wo:wo + 4]) >> np.uint64(sh)
                body = (w & np.uint64(0xffffffff)).astype("<u4")
                arena[b + head:b + head + nb * 16] = body.view(np.uint8) \
                    .reshape(-1)


def _arena_blocks(n, C, dtypes, seed):
    """n sources' [n, C] columns of ``dtypes`` laid out in one byte arena
    at offsets of every alignment: -> (arena, blocks as numpy arrays,
    their offsets [column][source])."""
    rng = np.random.default_rng(seed)
    sizes = [n * C * np.dtype(dt).itemsize for dt in dtypes]
    # sources, receive rows, copied rows, and the padding between them
    arena = np.zeros(4096 + 3 * n * sum(sizes) + 512 * (n + 4) * len(dtypes),
                     np.uint8)
    at, blocks, offs = 4096 + 3, [], [[0] * n for _ in dtypes]
    for s in range(n):
        cols = []
        for c, dt in enumerate(dtypes):
            a = (rng.integers(-10**12, 10**12, (n, C)) if dt == np.int64
                 else rng.integers(-9, 9, (n, C)).astype(np.int32)
                 if dt == np.int32 else rng.random((n, C)) > 0.5)
            a = np.ascontiguousarray(a.astype(dt))
            # 8-, 4- and 1-byte aligned as allocations of their type
            at += (-at) % np.dtype(dt).itemsize
            arena[at:at + a.nbytes] = a.view(np.uint8).reshape(-1)
            offs[c][s] = at
            at += a.nbytes + int(rng.integers(0, 24)) * np.dtype(dt).itemsize
            cols.append(a)
        blocks.append(tuple(cols))
    return arena, blocks, offs, at


@pytest.mark.parametrize("n,C", [(1, 7), (4, 1000), (4, 1003), (16, 37)])
def test_exchange_plan_emulated_matches_plain(n, C):
    """The one-card parameter block (every member a destination, k = d)
    applied by a numpy model of the kernel: every destination's receive
    row equals ``exchange_blocks_plain``'s, for 1-, 4- and 8-byte
    columns, capacities 16 does not divide, sources at every alignment."""
    dtypes = [np.int64, np.int32, np.bool_, np.int32, np.int64]
    arena, blocks, offs, at = _arena_blocks(n, C, dtypes, n * C)
    dst = []
    for dt in dtypes:
        at += (-at) % 256                 # allocations start 256-aligned
        dst.append(at)
        at += n * n * C * np.dtype(dt).itemsize
    assert at <= arena.size
    p = shuffle.exchange_params(n, C, list(range(n)), 0,
                                [np.dtype(dt).itemsize for dt in dtypes],
                                dst, offs)
    _emulate_exchange(p, arena)
    want = shuffle.exchange_blocks_plain(
        [tuple(_t(b) for b in cols) for cols in blocks],
        DeviceMesh([torch.device("cpu")] * n))
    for c, dt in enumerate(dtypes):
        size = np.dtype(dt).itemsize
        got = arena[dst[c]:dst[c] + n * n * C * size].view(dt).reshape(
            n, n * C)
        for d in range(n):
            np.testing.assert_array_equal(got[d], want[d][c].numpy())


def test_exchange_cards_one_launch_per_card():
    """One card: one launch for every destination, no copy.  Members on
    two cards: a launch per card for its own destinations, the other
    card's sources marked remote; their copied rows (one per
    destination, row k) exchange as the plain version does."""
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert shuffle.exchange_cards([c0] * 4, [c0] * 4) == [(c0, [0, 1, 2, 3],
                                                           0)]
    two = shuffle.exchange_cards([c0, c1, c0, c1], [c0, c1, c0, c1])
    assert two == [(c0, [0, 2], 0b1010), (c1, [1, 3], 0b0101)]
    n, C = 4, 9
    dtypes = [np.int64, np.bool_, np.int32]
    arena, blocks, offs, at = _arena_blocks(n, C, dtypes, 5)
    want = shuffle.exchange_blocks_plain(
        [tuple(_t(b) for b in cols) for cols in blocks],
        DeviceMesh([torch.device("cpu")] * n))
    for dev, dsts, remote in two:
        src = [[0] * n for _ in dtypes]
        for s in range(n):
            for c, dt in enumerate(dtypes):
                if (remote >> s) & 1:   # the rows dsts, copied in order
                    a = np.ascontiguousarray(blocks[s][c][dsts])
                    at += (-at) % 256
                    arena[at:at + a.nbytes] = a.view(np.uint8).reshape(-1)
                    src[c][s] = at
                    at += a.nbytes
                else:
                    src[c][s] = offs[c][s]
        dst = []
        for dt in dtypes:
            at += (-at) % 256
            dst.append(at)
            at += len(dsts) * n * C * np.dtype(dt).itemsize
        assert at <= arena.size
        p = shuffle.exchange_params(n, C, dsts, remote,
                                    [np.dtype(dt).itemsize for dt in dtypes],
                                    dst, src)
        _emulate_exchange(p, arena)
        for c, dt in enumerate(dtypes):
            size = np.dtype(dt).itemsize
            got = arena[dst[c]:dst[c] + len(dsts) * n * C * size].view(
                dt).reshape(len(dsts), n * C)
            for k, d in enumerate(dsts):
                np.testing.assert_array_equal(got[k], want[d][c].numpy())


def test_exchange_params_layout_and_limits():
    """The block is MxParams' 453 int64 words (3,624 B, under the 4 KB
    of kernel parameters): header, destination ids, element sizes,
    receive pointers, source pointers [column][source]; 24 columns and
    16 members at most."""
    p = shuffle.exchange_params(3, 11, [2, 0], 0b10, [8, 1], [100, 200],
                                [[1, 2, 3], [4, 5, 6]])
    assert p.dtype == np.int64 and p.nbytes == 3624 <= 4096
    assert list(p[:5]) == [3, 11, 2, 2, 0b10]
    assert list(p[shuffle._MX_DST_IDS:shuffle._MX_DST_IDS + 2]) == [2, 0]
    assert list(p[shuffle._MX_ELEM:shuffle._MX_ELEM + 2]) == [8, 1]
    assert list(p[shuffle._MX_DST:shuffle._MX_DST + 2]) == [100, 200]
    src = p[shuffle._MX_SRC:].reshape(24, 16)
    assert src[0, :3].tolist() == [1, 2, 3] and src[1, :3].tolist() == \
        [4, 5, 6] and not src[2:].any() and not src[:, 3:].any()
    for bad in (dict(elems=[8] * 25, dst_ptrs=[0] * 25,
                     src_ptrs=[[0]] * 25), dict(n_src=17)):
        kw = dict(n_src=1, capacity=4, dst_ids=[0], remote=0, elems=[8],
                  dst_ptrs=[0], src_ptrs=[[0]])
        kw.update(bad)
        with pytest.raises(ValueError):
            shuffle.exchange_params(**kw)


@pytest.mark.parametrize("n", [1, 4])
def test_received_stacked_columns(n):
    """``_received_stacked``: per column the ``[n, n * C]`` receive rows,
    row d destination d's.  One member: its packed blocks themselves (no
    copy); several on the CPU: the plain exchange's columns stacked."""
    rng = np.random.default_rng(n)
    C = 5
    blocks = [(_t(rng.integers(0, 99, (n, C))), _t(rng.random((n, C)) > 0.5))
              for _ in range(n)]
    mesh = DeviceMesh([torch.device("cpu")] * n)
    got = shuffle._received_stacked(mesh, blocks)
    if n == 1:
        assert all(g is b for g, b in zip(got, blocks[0]))
        return
    want = shuffle.exchange_blocks_plain(blocks, mesh)
    assert len(got) == 2
    for c, g in enumerate(got):
        assert g.shape == (n, n * C)
        assert torch.equal(g, torch.stack([w[c] for w in want]))


# ------------------------------------------------------------- on a card


@pytest.mark.cuda
def test_pack_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    def view(a, offset):   # a view at an odd offset: no base aligned
        t = torch.from_numpy(np.ascontiguousarray(a)).cuda()
        buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device="cuda")
        buf[offset:] = t
        return buf[offset:]
    for n, n_dev, offset in ((100_000, 1, 0), (100_000, 8, 0), (0, 2, 0),
                             (100_001, 4, 3), (300_000, 1023, 1)):
        values, target, mask = _pack_case(n, n_dev, seed=n_dev)
        cap = max(_need(target, mask, n_dev) - 5, 1)
        args = (tuple(view(v, offset) for v in values), view(target, offset),
                view(mask, offset), n_dev, cap)
        got = pack_blocks(*args)
        want = pack_blocks_plain(*args)
        for g, w in zip(got[0] + (got[1], got[2]), want[0] + (want[1], want[2])):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_sorted_join_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    for case, (lgid, lvalid, rgid, rvalid, U) in JOIN_CASES.items():
        J = _pairs_needed(lgid, lvalid, rgid, rvalid) + 9
        c = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
        args = (c(lgid), c(lvalid), c(rgid), c(rvalid), (c(lgid),),
                (c(rvalid),), U, J)
        got = sorted_join(*args)
        want = sorted_join_plain(*args)
        for g, w in zip(got[:4], want[:4]):
            assert torch.equal(g, w), case
        assert torch.equal(got[4][0], want[4][0]), case
        assert torch.equal(got[5][0], want[5][0]), case


@pytest.mark.cuda
def test_exchange_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(8)
    for n, C in ((1, 7), (4, 1000), (8, 4097)):
        mesh = DeviceMesh([torch.device("cuda", 0)] * n)
        blocks = [(torch.from_numpy(rng.integers(0, 10**9, (n, C))).cuda(),
                   torch.from_numpy(rng.integers(-9, 9, (n, C)).astype(
                       np.int32)).cuda(),
                   torch.from_numpy(rng.random((n, C)) > 0.5).cuda())
                  for _ in range(n)]
        got = shuffle.exchange_blocks(blocks, mesh)
        want = shuffle.exchange_blocks_plain(blocks, mesh)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert torch.equal(a, b)


def test_plain_versions_are_what_the_wrappers_run_on_cpu():
    """The wrappers' CPU path is the module's plain versions (no other
    code between them)."""
    lgid, lvalid, rgid, rvalid, U = JOIN_CASES["unit"]
    t = torch.from_numpy
    a = sorted_join(t(lgid), t(lvalid), t(rgid), t(rvalid), (), (), U, 8)
    b = sorted_join_indexes_plain(t(lgid), t(lvalid), t(rgid), t(rvalid), 8)
    for x, y in zip(a[:4], b):
        assert torch.equal(x, y)
    assert shuffle.sorted_join.launches == 0
