"""The port's admission pool and tenant-aware workload scheduler
(citus_tpu_torch/executor/admission.py, citus_tpu_torch/workload/).

The cases of tests/test_admission.py and tests/test_workload.py, run
against the port's modules (cases that repeat each other are one
parametrised test).  Left out, as ROADMAP.md records: the tenant
isolation case (``citus_isolate_tenant_to_node`` needs shard moves and
splits, A14) and the SQL quota writers (``citus_add_tenant_quota`` and
friends are 2PC catalog writes, A11/A13); quotas are set here through
``GLOBAL_TENANTS`` directly.

The fairness tests drive a private SharedTaskPool + TenantScheduler pair
so global pool counters stay untouched; the SQL-surface tests go through
a real ``citus_tpu_torch.Cluster`` on the CPU.
"""

import threading
import time

import numpy as np
import pytest

import citus_tpu_torch as ctt
from citus_tpu_torch.config import (
    ExecutorSettings, Settings, WorkloadSettings,
)
from citus_tpu_torch.errors import AdmissionShedError, ExecutionError
from citus_tpu_torch.executor.admission import SharedTaskPool
from citus_tpu_torch.utils.clock import set_wall_clock
from citus_tpu_torch.workload import (
    GLOBAL_TENANTS, SHARED_TENANT, TenantScheduler, tenant_key,
)


def _settings(limit, **wl):
    return Settings(executor=ExecutorSettings(max_shared_pool_size=limit),
                    workload=WorkloadSettings(**wl))


@pytest.fixture(autouse=True)
def _clean_registry():
    GLOBAL_TENANTS.clear()
    yield
    GLOBAL_TENANTS.clear()
    set_wall_clock(None)


def _join(threads, timeout=30):
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)


# ------------------------------------------------------- the task pool


def test_required_waits_and_bounds_concurrency():
    pool = SharedTaskPool()
    peak = []

    def work(i):
        with pool.slot(2, timeout=10):
            peak.append(pool.in_use)
            time.sleep(0.02)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    _join(threads)
    assert pool.high_water <= 2
    assert max(peak) <= 2
    assert pool.granted == 8
    assert pool.waits > 0
    assert pool.in_use == 0


def test_optional_denied_fast():
    pool = SharedTaskPool()
    assert pool.acquire(1) is True
    t0 = time.monotonic()
    assert pool.acquire(1, optional=True) is False
    assert time.monotonic() - t0 < 0.1  # never waited
    assert pool.stats()["denied_optional"] == 1
    pool.release()


@pytest.mark.parametrize("timeout", [0.1, 0.05])
def test_required_times_out_and_counts_it(timeout):
    pool = SharedTaskPool()
    pool.acquire(1)
    with pytest.raises(ExecutionError, match="max_shared_pool_size"):
        pool.acquire(1, timeout=timeout)
    assert pool.stats()["timeouts"] == 1
    pool.release()


def test_unlimited_by_default():
    pool = SharedTaskPool()
    for _ in range(64):
        assert pool.acquire(0) is True
    assert pool.high_water == 64


def test_fifo_ticket_order():
    """A freed slot goes to the LONGEST-waiting required acquirer, not
    whichever thread the OS wakes first."""
    pool = SharedTaskPool()
    pool.acquire(1)
    order = []
    threads = []

    def waiter(i):
        pool.acquire(1, timeout=10)
        order.append(i)
        time.sleep(0.01)
        pool.release()

    for i in range(4):
        t = threading.Thread(target=waiter, args=(i,))
        threads.append(t)
        t.start()
        # arrival order is the ticket order: wait until i is queued
        deadline = time.monotonic() + 5
        while len(pool._waiters) < i + 1 and time.monotonic() < deadline:
            time.sleep(0.001)
    pool.release()
    _join(threads)
    assert order == [0, 1, 2, 3]
    # waits counts waiters, not grants: the seed acquire never waited
    assert pool.waits == 4
    assert pool.granted == 5


def test_optional_never_barges_waiters():
    """With a required waiter queued, an optional acquire is denied even
    at the instant a slot frees — the freed slot belongs to the queue
    head."""
    pool = SharedTaskPool()
    pool.acquire(1)
    got = []
    t = threading.Thread(target=lambda: got.append(
        pool.acquire(1, timeout=10)))
    t.start()
    deadline = time.monotonic() + 5
    while not pool._waiters and time.monotonic() < deadline:
        time.sleep(0.001)
    pool.release()  # head ticket now owns the slot, maybe not yet awake
    assert pool.acquire(1, optional=True) is False
    _join([t])
    assert got == [True]
    pool.release()


def test_coalesced_followers_are_booked_on_the_pool():
    pool = SharedTaskPool()
    pool.note_coalesced(0)
    pool.note_coalesced(3)
    assert pool.stats()["coalesced"] == 3


# ------------------------------------------------------------- fairness


def _drive(sched, settings, tenant, stop, hold_s):
    while not stop.is_set():
        sched.acquire(settings, tenant)
        try:
            time.sleep(hold_s)
        finally:
            sched.release(tenant)


def _storm(sched, st, tenants_threads, hold_s=0.001, run_s=0.6):
    stop = threading.Event()
    threads = [threading.Thread(target=_drive,
                                args=(sched, st, tenant, stop, hold_s))
               for tenant, n in tenants_threads for _ in range(n)]
    for t in threads:
        t.start()
    time.sleep(run_s)
    stop.set()
    _join(threads)
    return {r[0]: r for r in sched.rows_view()}


def test_equal_weight_tenants_get_equal_share():
    """One tenant flooding 8 threads cannot monopolize: with equal
    weights every tenant's share of granted slots stays >= 1/N - 10%."""
    sched = TenantScheduler(pool=SharedTaskPool())
    rows = _storm(sched, _settings(1),
                  [("noisy", 8), ("a", 1), ("b", 1), ("c", 1)])
    total = sum(r[3] for r in rows.values())
    assert total > 50
    for tenant in ("noisy", "a", "b", "c"):
        share = rows[tenant][3] / total
        assert share >= (1 / 4) - 0.10, (tenant, share, rows)


@pytest.mark.parametrize("level", ["tenant", "class"])
def test_weights_bias_share(level):
    """weight 3 vs 1 under equal demand converges toward a 3:1 split,
    whether the weights sit on the tenants or on their priority classes
    (the upper level of the two-level stride tree)."""
    if level == "tenant":
        GLOBAL_TENANTS.set_quota("gold", weight=3.0)
        GLOBAL_TENANTS.set_quota("basic", weight=1.0)
    else:
        GLOBAL_TENANTS.set_class("premium", 3.0)
        GLOBAL_TENANTS.set_class("standard", 1.0)
        GLOBAL_TENANTS.set_quota("gold", priority_class="premium")
        GLOBAL_TENANTS.set_quota("basic", priority_class="standard")
    sched = TenantScheduler(pool=SharedTaskPool())
    rows = _storm(sched, _settings(1), [("gold", 3), ("basic", 3)])
    total = rows["gold"][3] + rows["basic"][3]
    assert total > 50
    assert rows["gold"][3] / total >= 0.60, rows
    assert rows["basic"][3] / total >= 0.10, rows


def test_noisy_neighbor_light_tenant_p99():
    """A light tenant's p99 under a flooding neighbor stays within 3x
    its isolated p99 (the headline fairness acceptance)."""
    work_s = 0.02

    def light_run(sched, st, n=15):
        lat = []
        for _ in range(n):
            t0 = time.monotonic()
            sched.acquire(st, "light")
            try:
                time.sleep(work_s)
            finally:
                sched.release("light")
            lat.append(time.monotonic() - t0)
        lat.sort()
        return lat[min(len(lat) - 1, int(0.99 * len(lat)))]

    st = _settings(1)
    p99_isolated = light_run(TenantScheduler(pool=SharedTaskPool()), st)
    sched = TenantScheduler(pool=SharedTaskPool())
    stop = threading.Event()
    heavy = [threading.Thread(target=_drive,
                              args=(sched, st, "heavy", stop, work_s))
             for _ in range(6)]
    for t in heavy:
        t.start()
    try:
        p99_contended = light_run(sched, st)
    finally:
        stop.set()
        _join(heavy)
    assert p99_contended <= 3 * p99_isolated + 0.01, \
        (p99_isolated, p99_contended)


def test_degenerate_single_tenant_is_fifo():
    """No quotas, default GUCs, one tenant class: grant order is strict
    arrival order, and timeout raises the pool's own error shape."""
    pool = SharedTaskPool()
    sched = TenantScheduler(pool=pool)
    st = _settings(1)
    sched.acquire(st, "*")
    order = []
    threads = []

    def waiter(i):
        sched.acquire(st, "*")
        order.append(i)
        time.sleep(0.005)
        sched.release("*")

    for i in range(3):
        t = threading.Thread(target=waiter, args=(i,))
        threads.append(t)
        t.start()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if any(r[0] == "*" and r[2] == i + 1 for r in sched.rows_view()):
                break
            time.sleep(0.001)
    sched.release("*")
    _join(threads)
    assert order == [0, 1, 2]
    assert pool.in_use == 0
    with sched.slot(st, "*"):
        with pytest.raises(ExecutionError, match="max_shared_pool_size"):
            sched.acquire(st, "other", timeout=0.05)


def test_try_extra_never_barges_required_waiters():
    pool = SharedTaskPool()
    sched = TenantScheduler(pool=pool)
    st = _settings(2)
    assert sched.try_extra(2) is True          # nobody queued: granted
    sched.acquire(st, "a")
    t = threading.Thread(target=lambda: (sched.acquire(st, "a", timeout=10),
                                         sched.release("a")))
    t.start()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not any(
            r[0] == "a" and r[2] == 1 for r in sched.rows_view()):
        time.sleep(0.001)
    assert sched.try_extra(2) is False         # a required waiter exists
    sched.release_extra()
    _join([t])
    sched.release("a")
    assert pool.in_use == 0


# ------------------------------------------------------------- shedding


def test_queue_depth_shed_is_fast_retryable_and_slotless():
    pool = SharedTaskPool()
    sched = TenantScheduler(pool=pool)
    st = _settings(1, tenant_queue_depth=2)
    sched.acquire(st, "a")  # slot holder
    threads = []
    for _ in range(2):
        t = threading.Thread(
            target=lambda: (sched.acquire(st, "a", timeout=10),
                            sched.release("a")))
        threads.append(t)
        t.start()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if any(r[0] == "a" and r[2] == 2 for r in sched.rows_view()):
            break
        time.sleep(0.001)
    t0 = time.monotonic()
    with pytest.raises(AdmissionShedError) as ei:
        sched.acquire(st, "a")
    assert time.monotonic() - t0 < 0.1  # fast fail, never queued
    assert ei.value.retryable is True
    assert isinstance(ei.value, ExecutionError)
    assert "tenant_queue_depth" in str(ei.value)
    assert pool.in_use == 1  # a shed query never held a slot
    sched.release("a")
    _join(threads)
    row = {r[0]: r for r in sched.rows_view()}["a"]
    assert row[4] == 1  # shed
    assert pool.in_use == 0


def test_saturation_advisory_halves_the_queue_depth(monkeypatch):
    from citus_tpu_torch.observability import flight_recorder
    monkeypatch.setattr(flight_recorder.ADVISORY, "pool_saturated", True)
    pool = SharedTaskPool()
    sched = TenantScheduler(pool=pool)
    st = _settings(1, tenant_queue_depth=2)
    sched.acquire(st, "a")
    t = threading.Thread(target=lambda: (sched.acquire(st, "a", timeout=10),
                                         sched.release("a")))
    t.start()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not any(
            r[0] == "a" and r[2] == 1 for r in sched.rows_view()):
        time.sleep(0.001)
    with pytest.raises(AdmissionShedError, match="1 waiters"):
        sched.acquire(st, "a")
    sched.release("a")
    _join([t])


def test_rate_limit_token_bucket_shed_and_refill():
    fake = [1000.0]
    set_wall_clock(lambda: fake[0])
    sched = TenantScheduler(pool=SharedTaskPool())
    st = _settings(0, tenant_rate_limit_qps=2.0)  # burst capacity 2
    for _ in range(2):
        sched.acquire(st, "r")
        sched.release("r")
    with pytest.raises(AdmissionShedError, match="tenant_rate_limit_qps"):
        sched.acquire(st, "r")
    fake[0] += 1.0  # one second refills 2 tokens
    sched.acquire(st, "r")
    sched.release("r")
    row = {r[0]: r for r in sched.rows_view()}["r"]
    assert row[3] == 3 and row[4] == 1  # granted, shed


def test_tenant_shed_counter_bumps():
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    before = GLOBAL_COUNTERS.snapshot().get("tenant_shed", 0)
    sched = TenantScheduler(pool=SharedTaskPool())
    st = _settings(0, tenant_rate_limit_qps=1.0)
    sched.acquire(st, "x")
    sched.release("x")
    with pytest.raises(AdmissionShedError):
        sched.acquire(st, "x")
    assert GLOBAL_COUNTERS.snapshot()["tenant_shed"] == before + 1


# ------------------------------------------------------------ registry


def test_registry_quotas_and_classes_round_trip():
    GLOBAL_TENANTS.set_quota("7", weight=2.5, max_concurrency=3,
                             rate_limit_qps=10.0, queue_depth=8)
    assert GLOBAL_TENANTS.rows_view() == [("7", 2.5, 3, 10.0, 8, None, "")]
    GLOBAL_TENANTS.pin("7", 2)
    assert GLOBAL_TENANTS.get("7").pinned_node == 2
    GLOBAL_TENANTS.set_class("gold", 0.0)
    assert GLOBAL_TENANTS.class_weight("gold") == pytest.approx(1e-6)
    assert GLOBAL_TENANTS.class_weight("unknown") == 1.0
    assert GLOBAL_TENANTS.remove_class("gold") is True
    assert GLOBAL_TENANTS.remove("7") is True
    assert GLOBAL_TENANTS.rows_view() == []
    assert tenant_key(None) == SHARED_TENANT and tenant_key(42) == "42"


def test_max_concurrency_caps_one_tenant():
    GLOBAL_TENANTS.set_quota("capped", max_concurrency=1)
    sched = TenantScheduler(pool=SharedTaskPool())
    st = _settings(0)
    running, peak = [0], [0]
    mu = threading.Lock()

    def work():
        with sched.slot(st, "capped", timeout=10):
            with mu:
                running[0] += 1
                peak[0] = max(peak[0], running[0])
            time.sleep(0.005)
            with mu:
                running[0] -= 1
    threads = [threading.Thread(target=work) for _ in range(6)]
    for t in threads:
        t.start()
    _join(threads)
    assert peak[0] == 1


# ------------------------------------------------------- SQL surface


def _make_cluster(tmp_path, **exec_kw):
    cl = ctt.Cluster(str(tmp_path / "db"), n_nodes=1, device="cpu",
                     settings=Settings(executor=ExecutorSettings(**exec_kw)))
    cl.execute("CREATE TABLE t (k bigint NOT NULL, v bigint)")
    cl.execute("SELECT create_distributed_table('t', 'k', 4)")
    cl.copy_from("t", columns={"k": np.arange(2000, dtype=np.int64) % 50,
                               "v": np.arange(2000, dtype=np.int64)})
    return cl


def test_queries_bounded_end_to_end(tmp_path):
    """Concurrent queries through the SQL surface respect the cap and
    the citus_stat_pool view reports it."""
    cl = _make_cluster(tmp_path, max_shared_pool_size=2)
    results = []

    def q():
        results.append(cl.execute("SELECT sum(v) FROM t").rows[0][0])

    threads = [threading.Thread(target=q) for _ in range(6)]
    for t in threads:
        t.start()
    _join(threads, timeout=120)
    assert results == [sum(range(2000))] * 6
    view = cl.execute("SELECT citus_stat_pool()")
    row = dict(zip(view.columns, view.rows[0]))
    assert row["pool_size"] == 2
    assert row["in_use"] == 0
    assert row["granted"] >= 6
    assert row["high_water"] >= 1
    cl.close()


def test_stat_tenants_live_view(tmp_path):
    cl = _make_cluster(tmp_path)
    cl.execute("SELECT count(*) FROM t WHERE k = 5")
    cl.execute("SELECT count(*) FROM t WHERE k = 5")
    cl.execute("SELECT sum(v) FROM t")
    view = cl.execute("SELECT citus_stat_tenants()")
    assert view.columns[:3] == ["tenant", "query_count", "total_time_ms"]
    rows = {r[0]: dict(zip(view.columns, r)) for r in view.rows}
    assert rows["5"]["query_count"] == 2
    assert rows["5"]["granted"] >= 2
    assert rows["5"]["p99_ms"] > 0
    # multi-shard analytics book under the shared "*" class
    assert rows["*"]["granted"] >= 1
    assert rows["*"]["running"] == 0 and rows["*"]["queued"] == 0
    cl.close()


@pytest.mark.parametrize("guc,value,shown", [
    ("citus.tenant_default_weight", "2.0", "2.0"),
    ("citus.tenant_queue_depth", "16", "16"),
    ("citus.tenant_rate_limit_qps", "100.0", "100.0"),
    ("citus.tenant_default_priority_class", "gold", "gold"),
])
def test_sql_set_tenant_gucs(tmp_path, guc, value, shown):
    cl = _make_cluster(tmp_path)
    cl.execute(f"SET {guc} = {value}")
    assert cl.execute(f"SHOW {guc}").rows == [(shown,)]
    cl.close()


def test_shed_error_surfaces_through_sql(tmp_path):
    cl = _make_cluster(tmp_path)
    cl.execute("SET citus.tenant_rate_limit_qps = 1.0")
    cl.execute("SELECT count(*) FROM t WHERE k = 3")
    with pytest.raises(AdmissionShedError, match="retry after backoff"):
        cl.execute("SELECT count(*) FROM t WHERE k = 3")
    cl.close()
