"""A reference/port pair for the write-surface differential tests.

``Pair`` opens ``citus_tpu.Cluster`` (the reference, JAX on the CPU) and
``citus_tpu_torch.Cluster(device="cpu")`` (the port) on data directories
of their own and runs each step through both.  A step's outcome is its
result (columns, rows, and the write counts and strategy of its
``explain``) or the class name of the error it raised; the two outcomes
must be equal.  Rows are compared in order when the statement has an
ORDER BY, else as multisets; floats within rel ``FLOAT_REL`` (an
intermediate table may reorder a float sum), everything else exactly.

Steps:
- ``"SQL"``: ``execute`` on the default session;
- ``("params", sql, params)``: ``execute(sql, params=params)``;
- ``("role", sql, role)`` / ``("rparams", sql, params, role)``:
  ``execute`` under ``role`` (row-level security, privileges);
- ``("copy", table, kwargs)``: ``copy_from(table, **kwargs)``;
- ``("s", sql)`` / ``("scopy", table, kwargs)`` / ``("srole", sql,
  role)``: on an explicit session, opened at the first such step;
- ``("check", fn)``: ``fn(cluster)``, compared as a value (catalog
  state, files on disk).

``Pair(..., strict=True)`` also compares an error's message (with each
package's data directory written as ``<dir>``) and the whole
``explain`` dict but for the keys that hold timings and executor
internals (``VOLATILE_KEYS``).
"""

import math

import citus_tpu as ct
import citus_tpu_torch as ctt

#: the relative tolerance of float values
FLOAT_REL = 1e-12

#: the ``explain`` keys a write reports (compared between packages)
EXPLAIN_KEYS = ("inserted", "updated", "deleted", "skipped", "strategy",
                "partitions_created", "partitions_dropped", "selected",
                "placements_rewritten", "rows_reclaimed", "copied",
                "statistics_refreshed", "segments_rebuilt")

#: ``explain`` keys a strict pair leaves out: wall times, the executor's
#: task and pipeline records (the two packages' device paths differ)
VOLATILE_KEYS = ("elapsed_s", "tasks", "remote_tasks", "pipeline")


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or abs(a - b) <= FLOAT_REL * max(abs(a), abs(b))
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b if a is not None else b is None


def same_rows(a: list, b: list, ordered: bool) -> bool:
    if not ordered:
        a, b = sorted(a, key=repr), sorted(b, key=repr)
    return len(a) == len(b) and all(_close(tuple(x), tuple(y))
                                    for x, y in zip(a, b))


class Pair:
    def __init__(self, tmp_path, name: str = "db", strict: bool = False,
                 **kw):
        self.ref = ct.Cluster(str(tmp_path / "ref" / name), **kw)
        self.port = ctt.Cluster(str(tmp_path / "port" / name),
                                device="cpu", **kw)
        self.strict = strict
        self._dirs = {id(self.ref): str(tmp_path / "ref"),
                      id(self.port): str(tmp_path / "port")}
        self._sessions = {}

    def close(self) -> None:
        for s in self._sessions.values():
            s.close()
        self.port.close()
        self.ref.close()

    def _session(self, cl):
        if id(cl) not in self._sessions:
            self._sessions[id(cl)] = cl.session()
        return self._sessions[id(cl)]

    def _outcome(self, cl, step):
        try:
            if isinstance(step, str):
                r = cl.execute(step)
            elif step[0] == "params":
                r = cl.execute(step[1], params=step[2])
            elif step[0] == "role":
                r = cl.execute(step[1], role=step[2])
            elif step[0] == "rparams":
                r = cl.execute(step[1], params=step[2], role=step[3])
            elif step[0] == "srole":
                r = self._session(cl).execute(step[1], role=step[2])
            elif step[0] == "copy":
                return ("copied", cl.copy_from(step[1], **step[2]))
            elif step[0] == "s":
                r = self._session(cl).execute(step[1])
            elif step[0] == "scopy":
                return ("copied",
                        self._session(cl).copy_from(step[1], **step[2]))
            elif step[0] == "check":
                return ("value", step[1](cl))
            else:
                raise ValueError(f"unknown step {step!r}")
        except Exception as e:  # noqa: BLE001 -- the class is the outcome
            if self.strict:
                return ("error", type(e).__name__,
                        str(e).replace(self._dirs[id(cl)], "<dir>"))
            return ("error", type(e).__name__)
        explain = {k: v for k, v in (r.explain or {}).items()
                   if (k not in VOLATILE_KEYS if self.strict
                       else k in EXPLAIN_KEYS)}
        return ("rows", list(r.columns), [tuple(x) for x in r.rows],
                explain)

    def step(self, step):
        """Run one step through both packages; -> the reference's
        outcome, after asserting the port's equals it."""
        want = self._outcome(self.ref, step)
        got = self._outcome(self.port, step)
        text = step if isinstance(step, str) else step[1] \
            if isinstance(step[1], str) else repr(step)
        if want[0] == "rows" and got[0] == "rows":
            ordered = isinstance(text, str) and "ORDER BY" in text.upper()
            assert want[1] == got[1], (text, want[1], got[1])
            assert same_rows(want[2], got[2], ordered), \
                (text, want[2][:8], got[2][:8])
            assert want[3] == got[3], (text, want[3], got[3])
        else:
            assert want == got, (text, want, got)
        return want

    def run(self, *steps) -> list:
        return [self.step(s) for s in steps]
