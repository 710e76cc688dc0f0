"""Phase 10's Q15 and parameterized Q6 (chip_smoke.py) on the card,
against the port's numpy ``cpu`` backend on the same tables and a numpy
oracle from the generated arrays, at 200,000 rows: the CTE query's
intermediate tables through the port's kernels, no growth of the
allocated device memory over its warm runs, and the $1..$5 Q6 under 8
value sets through ``execute(sql, params)`` and PREPARE/EXECUTE with one
plan-cache miss.  The kernels have no CPU mode: these tests need a card
and skip without one.  This module imports no JAX, so it runs past the
suite's ``conftest.py``:
``python -m pytest --noconftest tests/test_torch_select_card.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

import citus_tpu_torch as ctt

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda

ROWS = 200_000


@pytest.fixture(scope="module")
def card(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    cl = ctt.Cluster(str(tmp_path_factory.mktemp("db")))
    cl.execute(chip_smoke.LINEITEM_DDL)
    cl.execute("SELECT create_distributed_table('lineitem', 'l_orderkey', 4)")
    chunks = list(chip_smoke.lineitem_chunks(ROWS))
    for c in chunks:
        cl.copy_from("lineitem", columns=chip_smoke.copy_columns(c))
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    yield cl, cols
    cl.close()


def test_q15_on_the_card(card):
    cl, cols = card
    assert cl.device.type == "cuda"
    want = chip_smoke.cpu_backend_rows(cl, chip_smoke.Q15)
    assert want == chip_smoke.oracle_q15(cols)
    assert cl.execute(chip_smoke.Q15).rows == want
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for _ in range(10):
        assert cl.execute(chip_smoke.Q15).rows == want
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= before
    assert not [n for n in cl.catalog.tables if n.startswith("__")]


def test_parameterized_q6_on_the_card(card):
    cl, cols = card
    c0 = cl.counters.snapshot()
    s = cl.session()
    s.execute("PREPARE q6 (date, date, numeric, numeric, bigint) AS "
              + chip_smoke.Q6_PARAM)
    for i in range(chip_smoke.Q_BATCH):
        p = chip_smoke.q6_params(i)
        year, disc, qty = 1993 + i % 5, 2 + i, 24 + i % 2
        want = chip_smoke.oracle_q6(cols, year, disc, qty)
        assert cl.execute(chip_smoke.Q6_PARAM, params=p).rows == want
        args = f"date '{p[0]}', date '{p[1]}', {p[2]}, {p[3]}, {p[4]}"
        assert s.execute(f"EXECUTE q6 ({args})").rows == want
    s.execute("DEALLOCATE q6")
    c1 = cl.counters.snapshot()
    assert c1.get("plan_cache_misses", 0) - c0.get("plan_cache_misses", 0) == 1
    assert c1.get("plan_cache_hits", 0) - c0.get("plan_cache_hits", 0) == 15
    cpu = chip_smoke.cpu_backend_rows(cl, chip_smoke.Q6_PARAM,
                                      chip_smoke.q6_params(0))
    assert cpu == chip_smoke.oracle_q6(cols, 1993, 2, 24)
