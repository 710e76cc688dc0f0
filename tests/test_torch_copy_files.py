"""COPY to and from files through the port against the reference.

The same statements over the same seeded rows go through
``citus_tpu.Cluster`` and ``citus_tpu_torch.Cluster(device="cpu")``
(tests/torch_write_pair.py, strict): identical rows, ``explain`` dicts
(``copied``), error classes and messages, and identical CSV files byte
for byte.  Decimals and integers are compared exactly; the float
column within rel 1e-12 (an intermediate table may reorder a float
sum).  A ``CTPUBIN1`` binary file written by either package loads
through the other, into a table whose dictionary ids differ.
"""

import os
import sys

import numpy as np
import pytest

import citus_tpu as ct
import citus_tpu_torch as ctt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_write_pair import Pair, same_rows  # noqa: E402

N = 500
SCHEMA = ("(id bigint NOT NULL, grp bigint, label text, price decimal(10,2), "
          "w double precision, d date, u uuid)")


def _rows(seed=11, n=N):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = int(rng.integers(0, 5))
        p = int(rng.integers(1, 100_000))
        out.append((
            i,
            None if i % 17 == 3 else g,
            None if i % 13 == 5 else ["red", "green", "blue, dark",
                                      'say "hi"', ""][g],
            f"{p // 100}.{p % 100:02d}",
            float(rng.random()),
            f"2024-{1 + i % 12:02d}-{1 + i % 28:02d}",
            None if i % 11 == 1 else
            f"{i:08x}-0000-4000-8000-{i * 7919:012x}"))
    return out


@pytest.fixture()
def db(tmp_path):
    p = Pair(tmp_path, strict=True)
    p.run(f"CREATE TABLE items {SCHEMA}",
          "SELECT create_distributed_table('items', 'id', 4)",
          ("copy", "items", {"rows": _rows()}))
    p.files = {id(p.ref): tmp_path / "ref_files",
               id(p.port): tmp_path / "port_files"}
    for d in p.files.values():
        d.mkdir()
    yield p
    p.close()


def _file_step(p, sql):
    """A step whose SQL names a file: each package writes and reads its
    own directory's copy (``{d}`` in the SQL)."""
    return [("check", lambda cl, sql=sql: _run(p, cl, sql))]


def _run(p, cl, sql):
    try:
        r = cl.execute(sql.format(d=p.files[id(cl)]))
    except Exception as e:  # noqa: BLE001 -- the outcome is compared
        return ("error", type(e).__name__,
                str(e).replace(str(p.files[id(cl)]), "<dir>"))
    return ("rows", list(r.columns), [tuple(x) for x in r.rows],
            dict(r.explain))


def _files_equal(p, name):
    a = (p.files[id(p.ref)] / name).read_bytes()
    b = (p.files[id(p.port)] / name).read_bytes()
    return a == b, len(a)


@pytest.mark.parametrize("opts", [
    "",
    " WITH (header true)",
    " WITH (delimiter '|', null '\\N')",
    " WITH (format csv, header on, delimiter ';', null 'NULL')",
])
def test_csv_round_trip(db, opts):
    out = db.run(*_file_step(db, f"COPY items TO '{{d}}/t.csv'{opts}"),
                 f"CREATE TABLE back {SCHEMA}",
                 *_file_step(db, f"COPY back FROM '{{d}}/t.csv'{opts}"),
                 "SELECT * FROM back ORDER BY id",
                 "SELECT count(*), sum(price), sum(w) FROM back")
    assert out[0] == ("value", ("rows", [], [], {"copied": N}))
    assert out[2] == ("value", ("rows", [], [], {"copied": N}))
    same, size = _files_equal(db, "t.csv")
    assert same and size > 0
    want = db.step("SELECT * FROM items ORDER BY id")[2]
    if "null" not in opts:
        # the default NULL string is the empty field: an empty word
        # comes back as NULL (in both packages)
        want = [tuple(None if v == "" else v for v in r) for r in want]
    assert out[3][2] == want


def test_pipe_load_into_a_partitioned_parent_with_fk_and_check(tmp_path):
    """TPC-H's `|` layout (no trailing `|`) into monthly partitions of a
    table with a foreign key to a reference table and a CHECK: the file
    load goes through copy_from, so routing and every check apply."""
    p = Pair(tmp_path, strict=True)
    lines = [f"{i}|{1 + i % 7}|2024-{1 + i % 3:02d}-{1 + i % 28:02d}|"
             f"{(i * 37) % 1000}.{i % 100:02d}" for i in range(300)]
    bad_fk = lines + ["900|99|2024-01-05|1.00"]
    bad_check = lines + ["901|1|2024-01-05|-1.00"]
    bad_range = lines + ["902|1|2025-01-05|1.00"]
    files = {}
    for name, body in (("ok", lines), ("fk", bad_fk), ("ck", bad_check),
                       ("rg", bad_range)):
        files[name] = tmp_path / f"{name}.tbl"
        files[name].write_text("\n".join(body) + "\n")
    try:
        out = p.run(
            "CREATE TABLE cust (ck bigint NOT NULL PRIMARY KEY, n text)",
            "SELECT create_reference_table('cust')",
            ("copy", "cust", {"rows": [(i, f"c{i}") for i in range(1, 8)]}),
            "CREATE TABLE ord (ok bigint NOT NULL, ck bigint REFERENCES "
            "cust (ck), od date, amt decimal(12,2) CHECK (amt >= 0)) "
            "PARTITION BY RANGE (od)",
            "CREATE TABLE ord_01 PARTITION OF ord "
            "FOR VALUES FROM ('2024-01-01') TO ('2024-02-01')",
            "CREATE TABLE ord_02 PARTITION OF ord "
            "FOR VALUES FROM ('2024-02-01') TO ('2024-03-01')",
            "CREATE TABLE ord_03 PARTITION OF ord "
            "FOR VALUES FROM ('2024-03-01') TO ('2024-04-01')",
            "SELECT create_distributed_table('ord', 'ok', 4)",
            f"COPY ord FROM '{files['fk']}' WITH (delimiter '|')",
            f"COPY ord FROM '{files['ck']}' WITH (delimiter '|')",
            f"COPY ord FROM '{files['rg']}' WITH (delimiter '|')",
            "SELECT count(*) FROM ord",
            f"COPY ord FROM '{files['ok']}' WITH (delimiter '|')",
            "SELECT count(*) FROM ord_01",
            "SELECT count(*) FROM ord_02",
            "SELECT ck, count(*), sum(amt) FROM ord GROUP BY ck ORDER BY ck")
    finally:
        p.close()
    assert out[8][:2] == ("error", "ForeignKeyViolation")
    assert out[9][:2] == ("error", "CheckViolation")
    assert out[10][0] == "error"
    assert out[11][2] == [(0,)]
    assert out[12][3] == {"copied": 300}
    assert out[13][2][0][0] + out[14][2][0][0] < 300


def test_copy_query_to(db):
    q = ("COPY (SELECT grp, count(*), sum(price) FROM items GROUP BY grp "
         "ORDER BY grp) TO '{d}/q.csv' WITH (header true, null 'none')")
    out = db.run(*_file_step(db, q),
                 *_file_step(db, "COPY (SELECT label, id FROM items "
                                 "WHERE price > 500 ORDER BY id) "
                                 "TO '{d}/p.csv' WITH (delimiter '|')"))
    assert out[0][1][3] == {"copied": 6}
    assert _files_equal(db, "q.csv")[0] and _files_equal(db, "p.csv")[0]
    text = (db.files[id(db.port)] / "q.csv").read_text().splitlines()
    assert text[0] == "grp,count,sum" and text[-1].startswith("none,")


def test_binary_round_trip_and_errors(db):
    out = db.run(*_file_step(db, "COPY items TO '{d}/t.bin' "
                                 "WITH (format binary)"),
                 f"CREATE TABLE back {SCHEMA}",
                 *_file_step(db, "COPY back FROM '{d}/t.bin' "
                                 "WITH (format binary)"),
                 "SELECT * FROM back ORDER BY id",
                 "CREATE TABLE wide (id bigint, extra bigint)",
                 *_file_step(db, "COPY wide FROM '{d}/t.bin' "
                                 "WITH (format binary)"),
                 *_file_step(db, "COPY back FROM '{d}/t.csv0' "
                                 "WITH (format binary)"))
    assert out[2][1][3] == {"copied": N}
    assert out[3][2] == db.step("SELECT * FROM items ORDER BY id")[2]
    assert out[5][1][:2] == ("error", "AnalysisError")
    assert out[6][1][:2] == ("error", "FileNotFoundError")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_binary_file_crosses_between_packages(tmp_path, writer):
    """A binary file carries words, not dictionary codes: it loads into
    the other package's table whose dictionary holds the words in
    another order (other ids)."""
    src = ct.Cluster(str(tmp_path / "a")) if writer == "reference" \
        else ctt.Cluster(str(tmp_path / "a"), device="cpu")
    dst = ctt.Cluster(str(tmp_path / "b"), device="cpu") \
        if writer == "reference" else ct.Cluster(str(tmp_path / "b"))
    path = str(tmp_path / "x.bin")
    try:
        for cl in (src, dst):
            cl.execute(f"CREATE TABLE items {SCHEMA}")
            cl.execute("SELECT create_distributed_table('items', 'id', 4)")
        dst.copy_from("items", rows=[(10_000 + i, 0, w, "1.00", 0.0,
                                      "2024-01-01", None)
                                     for i, w in enumerate(
                                         ["zz", "blue, dark", "", "red"])])
        src.copy_from("items", rows=_rows())
        assert src.execute(f"COPY items TO '{path}' WITH (format binary)"
                           ).explain == {"copied": N}
        assert dst.execute(f"COPY items FROM '{path}' WITH (format binary)"
                           ).explain == {"copied": N}
        q = "SELECT * FROM items WHERE id < 10000 ORDER BY id"
        assert same_rows(dst.execute(q).rows, src.execute(q).rows, True)
        g = "SELECT label, count(*) FROM items GROUP BY label ORDER BY label"
        want = dict(src.execute(g).rows)
        for w in ("zz", "blue, dark", "", "red"):
            want[w] = want.get(w, 0) + 1
        assert dict(dst.execute(g).rows) == want
    finally:
        src.close()
        dst.close()


def test_torn_export_is_refused(db, monkeypatch):
    """COPY TO reads the table's flip generation before and after: a
    flip in between raises rather than writing a mixture."""
    import citus_tpu.transaction.snapshot as ref_snap
    import citus_tpu_torch.transaction.snapshot as port_snap
    for mod in (ref_snap, port_snap):
        gens = iter([(0, False), (1, False)])
        monkeypatch.setattr(mod, "read_generation",
                            lambda *_a, gens=gens: next(gens))
    out = db.run(*_file_step(db, "COPY items TO '{d}/torn.csv'"))
    assert out[0][1] == ("error", "ExecutionError",
                         "concurrent metadata flip during COPY TO; re-run "
                         "the export")


def test_c17_csv_export_writes_empty_words_as_null(db):
    """ROADMAP.md C17, a reference fault the port mirrors: with the
    default NULL string (the empty field) COPY TO writes an empty word
    and a NULL alike, unquoted, so a round trip turns '' into NULL
    (PostgreSQL's CSV quotes the empty word)."""
    out = db.run("CREATE TABLE w (k bigint, s text)",
                 "INSERT INTO w VALUES (1, ''), (2, NULL), (3, 'a')",
                 *_file_step(db, "COPY w TO '{d}/w.csv'"),
                 ("check", lambda cl: (db.files[id(cl)] / "w.csv")
                  .read_text()),
                 "CREATE TABLE w2 (k bigint, s text)",
                 *_file_step(db, "COPY w2 FROM '{d}/w.csv'"),
                 "SELECT k, s FROM w2 ORDER BY k")
    assert out[3] == ("value", "1,\n2,\n3,a\n")
    assert out[6][2] == [(1, None), (2, None), (3, "a")]


@pytest.mark.parametrize("body", ["1,2,a\n3,4\n", "1,2,a\n\n3,4,b\n",
                                  "1,2,a,9\n", "1,x,a\n"])
def test_malformed_csv_rows_match(tmp_path, body):
    """A row of the wrong width, a blank line and a value that does not
    parse fail the load with the reference's error, loading nothing."""
    f = tmp_path / "bad.csv"
    f.write_text(body)
    p = Pair(tmp_path, strict=True)
    try:
        out = p.run("CREATE TABLE m (k bigint, v bigint, s text)",
                    f"COPY m FROM '{f}'", "SELECT count(*) FROM m")
    finally:
        p.close()
    assert out[1][0] == "error"
    assert out[2][2] == [(0,)]
