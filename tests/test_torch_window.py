"""The port's window pass (executor/window.py) against the reference's.

``compute_window`` of ``citus_tpu_torch`` and of ``citus_tpu`` take the
same seeded columns: partitions with a NULL key, an ORDER BY column with
peers (ties) and NULLs in both directions, arguments with NULLs as
integers, floats and decimals; every function of RANKING, NAVIGATION
and AGGS, under the default frame and ROWS and RANGE frames (offsets,
CURRENT ROW, UNBOUNDED).  The outputs must be identical, value and type.
"""

import decimal

import numpy as np
import pytest

import citus_tpu.executor.window as ref_window
import citus_tpu_torch.executor.window as port_window

N = 160

FRAMES = [
    None,
    ("rows", ("preceding", 2), ("following", 1)),
    ("rows", ("preceding", None), ("current", 0)),
    ("rows", ("following", 1), ("following", 3)),
    ("rows", ("current", 0), ("following", None)),
    ("range", ("preceding", None), ("current", 0)),
    ("range", ("preceding", 3), ("current", 0)),
    ("range", ("current", 0), ("following", 5)),
    ("range", ("preceding", 2), ("following", 2)),
    ("range", ("preceding", None), ("following", None)),
]


def _columns(seed: int = 3):
    rng = np.random.default_rng(seed)

    def nullable(vals, p=0.1):
        return [None if rng.random() < p else v for v in vals]
    part = nullable([int(x) for x in rng.integers(0, 4, N)], 0.05)
    order = nullable([int(x) for x in rng.integers(0, 25, N)])
    ints = nullable([int(x) for x in rng.integers(-50, 50, N)])
    floats = nullable([float(x) for x in rng.normal(0, 10, N)])
    decs = nullable([decimal.Decimal(int(x)).scaleb(-2)
                     for x in rng.integers(-10_000, 10_000, N)])
    return part, order, ints, floats, decs


def _both(fn, args, partition, order, frame=None, params=()):
    got = port_window.compute_window(N, fn, args, partition, order,
                                     frame=frame, params=params)
    want = ref_window.compute_window(N, fn, args, partition, order,
                                     frame=frame, params=params)
    assert len(got) == len(want) == N
    for a, b in zip(got, want):
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (
            fn, frame, a, b)


def test_function_sets_match_reference():
    assert port_window.RANKING == ref_window.RANKING
    assert port_window.NAVIGATION == ref_window.NAVIGATION
    assert port_window.AGGS == ref_window.AGGS


@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("fn", sorted(ref_window.RANKING))
def test_ranking(fn, asc):
    part, order, _, _, _ = _columns()
    params = (5,) if fn == "ntile" else ()
    _both(fn, [], [part], [(order, asc)], params=params)
    # no PARTITION BY, and two ORDER BY keys
    _both(fn, [], [], [(order, asc), (part, not asc)], params=params)


@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("frame", FRAMES, ids=repr)
@pytest.mark.parametrize("fn", sorted(ref_window.NAVIGATION))
def test_navigation(fn, frame, asc):
    part, order, ints, floats, decs = _columns()
    params = {"lag": (2, -1), "lead": (3,), "nth_value": (2,)}.get(fn, ())
    for arg in (ints, floats, decs):
        _both(fn, [arg], [part], [(order, asc)], frame=frame, params=params)
    if frame is None:
        # no ORDER BY: the whole partition is the frame
        _both(fn, [ints], [part], [], params=params)


@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("frame", FRAMES, ids=repr)
@pytest.mark.parametrize("fn", sorted(ref_window.AGGS))
def test_aggregates(fn, frame, asc):
    part, order, ints, floats, decs = _columns()
    for arg in (ints, floats, decs):
        _both(fn, [arg], [part], [(order, asc)], frame=frame)
    if fn == "count":
        _both(fn, [], [part], [(order, asc)], frame=frame)  # count(*)
    if frame is None:
        _both(fn, [decs], [part], [])


@pytest.mark.parametrize("case", ["two_keys", "text_key", "zero_tiles",
                                  "unknown"])
def test_errors_match_reference(case):
    part, order, ints, _, _ = _columns()
    offset = ("range", ("preceding", 2), ("current", 0))
    fn, args, kw = {
        "two_keys": ("sum", [ints], dict(order=[(order, True), (part, True)],
                                         frame=offset)),
        "text_key": ("sum", [ints], dict(order=[([str(v) for v in order],
                                                 True)], frame=offset)),
        "zero_tiles": ("ntile", [], dict(order=[(order, True)],
                                          params=(0,))),
        "unknown": ("median", [ints], dict(order=[])),
    }[case]
    with pytest.raises(Exception) as want:
        ref_window.compute_window(N, fn, args, [part], **kw)
    with pytest.raises(Exception) as got:
        port_window.compute_window(N, fn, args, [part], **kw)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
