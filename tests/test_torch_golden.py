"""pg_regress-style golden scripts through the port.

Each tests/golden/NAME.sql below runs statement by statement against a
fresh ``citus_tpu_torch.Cluster(device="cpu", n_nodes=2)``, formatted as
tests/test_golden.py formats the reference's output; it must equal the
unchanged tests/golden/NAME.out exactly.  The .out files are the
reference's: they are never regenerated from the port.

``joins_dml`` (joins, UPDATE, MERGE, DELETE) matches its unchanged .out
since MERGE is ported; ``views_sequences``, ``analytics2``, ``objects``,
``objects2`` and ``types2`` (views, enum types, SQL functions, domains,
collations, publications, extensions, their catalog UDFs and the EXPLAIN
of an UPDATE) since they are.  Left out: rls_triggers.sql (roles, GRANT,
policies, statement triggers, text search: ROADMAP.md A14b).
"""

import os
import pathlib
import sys

import pytest

import citus_tpu_torch as ctt
from citus_tpu_torch.errors import CitusTpuError

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_golden import GOLDEN_DIR, split_statements  # noqa: E402

SCRIPTS = ["aggregates_ext", "analytics2", "basic", "grouping_sets",
           "insert_select", "joins_dml", "objects", "objects2",
           "partitioning", "recursive_cte", "setops", "sql_surface2",
           "strings", "txn_ddl", "types2", "views_sequences", "windows"]


def run_script(cl, text: str) -> str:
    """tests/test_golden.py's run_script, with the port's error base."""
    out = []
    for raw in split_statements(text):
        out.append(f"-- {raw}")
        try:
            r = cl.execute(raw)
            if r.columns:
                out.append(" | ".join(r.columns))
            for row in r.rows:
                out.append(" | ".join("\\N" if v is None else str(v)
                                      for v in row))
            if r.columns:
                out.append(f"({r.rowcount} rows)")
        except CitusTpuError as e:
            out.append(f"ERROR: {type(e).__name__}")
        out.append("")
    return "\n".join(out)


@pytest.mark.parametrize("name", SCRIPTS)
def test_golden_through_the_port(name, tmp_path):
    cl = ctt.Cluster(str(tmp_path / "db"), n_nodes=2, device="cpu")
    try:
        got = run_script(cl, (GOLDEN_DIR / f"{name}.sql").read_text())
    finally:
        cl.close()
    expected = pathlib.Path(GOLDEN_DIR / f"{name}.out").read_text()
    assert got == expected, f"golden mismatch for {name}"
