"""Background job/task runner.

Reference: pg_dist_background_job / pg_dist_background_task (+ _depend)
executed by background workers (src/backend/distributed/utils/
background_jobs.c — citus_job_wait :192, StartCitusBackgroundTaskExecutor
:1650), used by the rebalancer to run shard moves with per-node
concurrency caps and retries.

Here: a thread-pool executor over a persisted job/task queue.  Tasks are
named operations with JSON arguments (a registry maps names to Python
callables), dependencies gate execution order, failures retry up to
``max_attempts``, and state survives restarts via the catalog data dir.

Each task row is a live progress record (reference: the DSM progress
monitor behind get_rebalance_progress, progress/multi_progress.c): the
running operation calls the module-level ``report_progress()`` to update
its own row's ``phase`` / ``bytes_done`` / ``bytes_total`` in place, and
views derive a rate-based ETA from ``started_at``.  Progress updates are
memory-only — a crash loses at most the progress of the task being
retried anyway; durable state still changes only at claim/finish.
"""

from __future__ import annotations

import json
import os
import threading
import time
from citus_tpu_torch.utils.clock import now as wall_now
import traceback
from typing import Callable, Optional

from citus_tpu_torch.catalog import Catalog

JOBS_FILE = "background_jobs.json"


class JobStatus:
    SCHEDULED = "scheduled"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    CANCELLED = "cancelled"


# the task a worker thread is currently executing, so report_progress()
# from anywhere inside the operation lands on the right row without
# threading a handle through every call layer
_current_task = threading.local()


def report_progress(phase: Optional[str] = None,
                    bytes_done: Optional[int] = None,
                    bytes_total: Optional[int] = None,
                    add_bytes: int = 0) -> None:
    """Update the calling background task's progress row in place.
    No-op when the caller is not running under a background task (the
    same operations run synchronously from utility commands too)."""
    bound = getattr(_current_task, "bound", None)
    if bound is None:
        return
    runner, task = bound
    with runner._lock:
        if phase is not None:
            task["phase"] = phase
        if bytes_total is not None:
            task["bytes_total"] = int(bytes_total)
        if bytes_done is not None:
            task["bytes_done"] = int(bytes_done)
        elif add_bytes:
            task["bytes_done"] = int(task.get("bytes_done") or 0) + int(add_bytes)


class BackgroundJobRunner:
    """One runner per cluster; tasks execute on worker threads."""

    def __init__(self, cat: Catalog, max_workers: int = 2,
                 max_task_executors_per_node: int = 1):
        self.cat = cat
        self.max_workers = max_workers
        self.max_per_node = max_task_executors_per_node
        self._registry: dict[str, Callable] = {}
        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._node_running: dict[int, int] = {}
        self._state = self._load()

    # ---- persistence ---------------------------------------------------
    def _path(self) -> str:
        return os.path.join(self.cat.data_dir, JOBS_FILE)

    def _load(self) -> dict:
        if os.path.exists(self._path()):
            with open(self._path()) as fh:
                state = json.load(fh)
            # tasks that were mid-flight when the process died are retried
            for t in state["tasks"]:
                if t["status"] == JobStatus.RUNNING:
                    t["status"] = JobStatus.SCHEDULED
            return state
        return {"next_job_id": 1, "next_task_id": 1, "jobs": [], "tasks": []}

    def _store(self) -> None:
        tmp = self._path() + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._state, fh)
        os.replace(tmp, self._path())

    # ---- registry / API --------------------------------------------------
    def register(self, name: str, fn: Callable) -> None:
        self._registry[name] = fn

    def create_job(self, description: str) -> int:
        with self._lock:
            jid = self._state["next_job_id"]
            self._state["next_job_id"] += 1
            self._state["jobs"].append({
                "job_id": jid, "description": description,
                "status": JobStatus.SCHEDULED, "created_at": wall_now(),
            })
            self._store()
            return jid

    def add_task(self, job_id: int, op: str, args: dict, *,
                 depends_on: Optional[list[int]] = None, node: Optional[int] = None,
                 max_attempts: int = 3) -> int:
        with self._lock:
            tid = self._state["next_task_id"]
            self._state["next_task_id"] += 1
            self._state["tasks"].append({
                "task_id": tid, "job_id": job_id, "op": op, "args": args,
                "status": JobStatus.SCHEDULED, "depends_on": depends_on or [],
                "node": node, "attempts": 0, "max_attempts": max_attempts,
                "error": None,
                # live progress record, updated in place by the running
                # operation through report_progress()
                "phase": "", "bytes_done": 0, "bytes_total": 0,
                "started_at": None,
            })
            self._store()
        self._wake.set()
        return tid

    @staticmethod
    def _eta_s(t: dict, now: float) -> Optional[float]:
        """Rate-derived seconds-to-completion for a running task with
        byte progress; None when no rate can be established yet."""
        done = t.get("bytes_done") or 0
        total = t.get("bytes_total") or 0
        started = t.get("started_at")
        if (t["status"] != JobStatus.RUNNING or not started
                or done <= 0 or total <= done):
            return None
        elapsed = max(1e-9, now - started)
        return round((total - done) * elapsed / done, 3)

    def job_progress(self, job_id: int) -> list[tuple]:
        """Per-task progress rows (reference: get_rebalance_progress over
        the DSM progress monitor, progress/multi_progress.c).  Columns:
        (task_id, op, args, status, attempts, phase, bytes_done,
        bytes_total, started_at, eta_s)."""
        now = wall_now()
        with self._lock:
            return [(t["task_id"], t["op"], str(t["args"]), t["status"],
                     t["attempts"], t.get("phase") or "",
                     int(t.get("bytes_done") or 0),
                     int(t.get("bytes_total") or 0),
                     t.get("started_at"), self._eta_s(t, now))
                    for t in self._state["tasks"] if t["job_id"] == job_id]

    def jobs_view(self) -> dict:
        """Public snapshot of the job/task queue — row copies, so
        callers never need (and must not reach for) ``_lock``/``_state``."""
        with self._lock:
            return {"jobs": [dict(j) for j in self._state["jobs"]],
                    "tasks": [dict(t) for t in self._state["tasks"]]}

    def job_status(self, job_id: int) -> str:
        with self._lock:
            tasks = [t for t in self._state["tasks"] if t["job_id"] == job_id]
            if any(t["status"] == JobStatus.FAILED for t in tasks):
                return JobStatus.FAILED
            if all(t["status"] == JobStatus.DONE for t in tasks):
                return JobStatus.DONE
            if any(t["status"] == JobStatus.RUNNING for t in tasks):
                return JobStatus.RUNNING
            return JobStatus.SCHEDULED

    def task_rows(self) -> list[tuple]:
        with self._lock:
            return [(t["task_id"], t["job_id"], t["op"], t["status"], t["attempts"])
                    for t in self._state["tasks"]]

    def wait_for_job(self, job_id: int, timeout: float = 60.0) -> str:
        """citus_job_wait analog."""
        deadline = wall_now() + timeout
        while wall_now() < deadline:
            st = self.job_status(job_id)
            if st in (JobStatus.DONE, JobStatus.FAILED, JobStatus.CANCELLED):
                return st
            time.sleep(0.02)
        return self.job_status(job_id)

    def cancel_job(self, job_id: int) -> None:
        with self._lock:
            for t in self._state["tasks"]:
                if t["job_id"] == job_id and t["status"] == JobStatus.SCHEDULED:
                    t["status"] = JobStatus.CANCELLED
            self._store()

    # ---- execution -------------------------------------------------------
    def start(self) -> None:
        if self._threads:
            return
        self._stop.clear()
        for i in range(self.max_workers):
            th = threading.Thread(target=self._worker_loop, daemon=True,
                                  name=f"bg-task-executor-{i}")
            th.start()
            self._threads.append(th)

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        for th in self._threads:
            th.join(timeout=5)
        self._threads = []

    def _claim(self) -> Optional[dict]:
        with self._lock:
            done = {t["task_id"] for t in self._state["tasks"]
                    if t["status"] == JobStatus.DONE}
            for t in self._state["tasks"]:
                if t["status"] != JobStatus.SCHEDULED:
                    continue
                if any(d not in done for d in t["depends_on"]):
                    continue
                node = t.get("node")
                if node is not None and self._node_running.get(node, 0) >= self.max_per_node:
                    continue
                t["status"] = JobStatus.RUNNING
                t["attempts"] += 1
                # fresh progress record per attempt: a retry must not
                # resume a dead attempt's bytes_done or phase
                t["phase"] = "starting"
                t["bytes_done"] = 0
                t["started_at"] = wall_now()
                if node is not None:
                    self._node_running[node] = self._node_running.get(node, 0) + 1
                self._store()
                return t
        return None

    def _finish(self, task: dict, status: str, error: Optional[str]) -> None:
        with self._lock:
            task["status"] = status
            task["error"] = error
            node = task.get("node")
            if node is not None:
                self._node_running[node] = max(0, self._node_running.get(node, 0) - 1)
            self._store()
        self._wake.set()

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            task = self._claim()
            if task is None:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            fn = self._registry.get(task["op"])
            if fn is None:
                self._finish(task, JobStatus.FAILED, f"unknown op {task['op']!r}")
                continue
            _current_task.bound = (self, task)
            try:
                fn(**task["args"])
                self._finish(task, JobStatus.DONE, None)
            except Exception:
                err = traceback.format_exc(limit=4)
                if task["attempts"] < task["max_attempts"]:
                    with self._lock:
                        task["status"] = JobStatus.SCHEDULED
                        task["error"] = err
                        node = task.get("node")
                        if node is not None:
                            self._node_running[node] = max(0, self._node_running.get(node, 0) - 1)
                        self._store()
                else:
                    self._finish(task, JobStatus.FAILED, err)
            finally:
                _current_task.bound = None
