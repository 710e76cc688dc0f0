"""Configuration ("GUC") system.

The reference defines ~139 ``citus.*`` GUCs in shared_library_init.c plus 4
``columnar.*`` GUCs (src/backend/columnar/columnar.c).  We keep the
load-bearing ones as a typed dataclass tree; per-table options (compression,
chunk sizes) can be overridden at table level, mirroring
``columnar_internal.options``.

``task_executor_backend`` selects where per-shard scan kernels run:
``"gpu"`` (default: torch on the Cluster's device, the hand-written
CUDA fold kernel on a card) or ``"cpu"`` (host-side numpy reference
path, used as the correctness oracle).
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field


@dataclass
class ColumnarSettings:
    """Mirrors columnar.* GUCs (reference columnar.h:224-227)."""

    # Rows per chunk group.  The reference default is 10_000; we use a
    # power of two so padded device batches tile cleanly on (8,128) VREGs.
    chunk_group_row_limit: int = 8192
    # Rows per stripe (reference default 150_000).
    stripe_row_limit: int = 131072
    # Stripe compression codec: zstd | lz4 | zlib | none
    # (reference columnar.compression; decompression happens host-side
    # before batches stream to HBM).
    compression: str = "zstd"
    # Codec level (reference columnar.compression_level).
    compression_level: int = 3


@dataclass
class PlannerSettings:
    # GROUP BY strategy thresholds.
    # Direct-gid when the composite key domain is provably <= this bound
    # (exact, collision-free scatter-add).
    direct_gid_limit: int = 65536
    # Slot count for the fingerprint hash-aggregate fallback; 0 = auto
    # (SET citus.hash_agg_slots = auto): sized from catalog row-count
    # stats, next power of two clamped [1024, 1<<20].
    hash_agg_slots: int = 8192
    # Enable repartition (all_to_all) joins; reference GUC
    # citus.enable_repartition_joins.
    enable_repartition_joins: bool = True
    # Buckets per mesh axis for repartition, reference
    # citus.repartition_join_bucket_count_per_node.
    repartition_bucket_count_per_device: int = 1
    # Plan caching for SELECTs (reference citus.plan_cache_mode /
    # plancache.c): "auto" hoists filter literals into synthetic params
    # so literal variants of one query family share a generic plan's
    # compiled kernels; "force_generic" behaves the same (every cached
    # plan is generic here); "force_custom" disables hoisting AND plan
    # caching — every statement re-binds, re-plans, re-prunes.
    plan_cache_mode: str = "auto"


@dataclass
class ExecutorSettings:
    # "gpu" = torch on the Cluster's device; "cpu" = numpy oracle.
    task_executor_backend: str = "gpu"
    # Max shard-kernel invocations in flight per device — the streaming
    # prefetch window (analog of citus.max_adaptive_executor_pool_size).
    # Default 2 = classic double buffering; raising it trades HBM
    # headroom for deeper overlap in the past-cache streaming regime.
    max_tasks_in_flight: int = 2
    # Process-wide cap on queries driving device work concurrently;
    # 0 = unlimited (analog of citus.max_shared_pool_size backed by
    # connection/shared_connection_stats.c's shared counters).  Extra
    # concurrent remote-task RPCs beyond a query's first take OPTIONAL
    # slots from this same pool (executor/pipeline.py).
    max_shared_pool_size: int = 0
    # Per-worker-node cap on concurrent execute_task RPCs — the
    # citus.max_adaptive_executor_pool_size analog.  Each node's
    # dispatch window starts at 1 and ramps by one per success toward
    # this cap (slow start, executor/pipeline.py).
    max_adaptive_pool_size: int = 16
    # Host read-ahead depth (batches; rounds on the mesh path) the
    # background decode worker keeps prepared ahead of device compute —
    # citus.executor_prefetch_depth.  0 = decode inline on the
    # dispatching thread (no host/device overlap).
    executor_prefetch_depth: int = 2
    # Worker threads for the native stripe read+decompress pool
    # (storage/reader.py) — citus.decode_threads.  0 = auto:
    # min(8, cpu_count).
    decode_threads: int = 0
    # Prefer replica (non-primary) placements for reads — the
    # citus.use_secondary_nodes='always' analog; failover to the
    # primary still applies when no replica answers.
    use_secondary_nodes: bool = False
    # Lower the scan->filter->partial-agg worker through a Pallas
    # kernel (VMEM row blocks, on-core accumulation) instead of the
    # XLA-fused jnp worker.  Off by default: the fused path is the
    # reference; this is the hand-scheduled alternative (interpreter
    # mode off-TPU).  Scope: the SINGLE-DEVICE streaming path only —
    # the multi-device mesh path always runs the fused sharded worker.
    # Pad scan batches to power-of-two row counts to bound recompiles.
    batch_row_buckets: bool = True
    # Smallest padded batch (rows) a kernel will ever see.
    min_batch_rows: int = 8192
    # Seconds a writer waits for a shard/colocation write lock before
    # erroring (analog of lock_timeout; deadlocks are detected and
    # cancelled immediately regardless).
    lock_timeout_s: float = 30.0
    # Routing for SELECTs over placements hosted by another
    # coordinator: "push" executes the worker half of the plan on the
    # owning host and ships only partial-agg/result rows
    # (executor/worker_tasks.py; the reference's task-push model,
    # worker_sql_task_protocol.c), "pull" mirrors placement files here
    # first (sync_placement), "auto" pushes whenever the task codec can
    # express the plan and falls back to pull otherwise.
    remote_task_execution: str = "auto"
    # Entry cap of the process-wide compiled-kernel LRU keyed by
    # structural plan fingerprint (executor/kernel_cache.py) —
    # citus.kernel_cache_size.
    kernel_cache_size: int = 512
    # Directory for JAX's persistent on-disk XLA compilation cache so
    # process restarts skip compiles — citus.jit_cache_dir ("" = off).
    jit_cache_dir: str = ""
    # Same-family query coalescing (executor/megabatch.py): queries
    # whose plans share a fingerprint and arrive within this window
    # (ms) stack into ONE vmap-lifted device dispatch —
    # citus.megabatch_window_ms.  0 (the default) disables coalescing:
    # the serial path runs byte-identical to before.  SET ... = auto
    # stores -1: the dispatcher sizes the window per plan family from
    # an arrival-rate EWMA (wait only when another arrival is likely).
    megabatch_window_ms: float = 0.0
    # Upper bound on queries per coalesced dispatch; a full batch
    # dispatches before the window closes — citus.megabatch_max_size.
    megabatch_max_size: int = 32
    # Wire codec for execute_task results and placement-sync bundles —
    # citus.wire_format.  "frame" (default) ships the zero-copy
    # columnar frame (versioned header + raw little-endian buffers,
    # decoded as np.frombuffer views); "npz" keeps the legacy
    # zip-container encode for rollback.  Decode always sniffs the
    # frame magic, so mixed-version clusters interoperate.
    wire_format: str = "frame"


@dataclass
class WorkloadSettings:
    """Multi-tenant admission defaults (workload/scheduler.py) — the
    fallback class for tenants without an explicit
    citus_add_tenant_quota() row."""

    # Fair-share weight of an unregistered tenant —
    # citus.tenant_default_weight.  Slot share converges to
    # weight / sum(weights of queued tenants).
    tenant_default_weight: float = 1.0
    # Per-tenant admission queue bound — citus.tenant_queue_depth.
    # A tenant with this many queries already queued has new arrivals
    # fast-failed with the retryable shed error.  0 = unbounded (the
    # legacy pool behavior).
    tenant_queue_depth: int = 0
    # Per-tenant sustained QPS admission rate (token bucket with one
    # second of burst) — citus.tenant_rate_limit_qps.  0 = unlimited.
    tenant_rate_limit_qps: float = 0.0
    # Priority class a tenant without an explicit class lands in —
    # citus.tenant_default_priority_class.  Classes partition the
    # stride scheduler into a two-level tree (class weight splits the
    # slot supply between classes, tenant weight splits a class's
    # share); one class degenerates to the flat PR 9 ring.
    tenant_default_priority_class: str = "default"


@dataclass
class ObservabilitySettings:
    """Distributed tracing + slow-query capture (observability/)."""

    # Fraction of queries recorded as full span trees (0.0-1.0) —
    # citus.trace_sample_rate.  0.0 keeps the hot path on the no-op
    # recorder (allocation-free; the near-zero-overhead default).
    trace_sample_rate: float = 0.0
    # Queries at/above this wall time (ms) are captured into the
    # bounded in-memory slow-query ring with their span tree; any
    # non-negative value force-samples every query so the tree exists
    # when the threshold verdict lands — citus.log_min_duration_ms
    # (-1 disables, the log_min_duration_statement analog).
    log_min_duration_ms: float = -1.0
    # Directory receiving one Chrome trace-event JSON (Perfetto-
    # loadable) per sampled query — citus.trace_export_dir ("" = off).
    trace_export_dir: str = ""
    # Per-node budget (seconds) for the cluster stat fan-out
    # (observability/cluster_stats.py): a node that does not answer
    # get_node_stats within this window degrades to a node_unreachable
    # row instead of hanging the view — citus.stat_fanout_timeout_s.
    stat_fanout_timeout_s: float = 2.0
    # Sampling cadence (ms) of the flight recorder's background metric
    # history (observability/flight_recorder.py) —
    # citus.flight_recorder_interval_ms.  0 (the default) keeps the
    # recorder off: no sampler thread, no disk segments.
    flight_recorder_interval_ms: float = 0.0
    # Retention (seconds) for the recorder's rotated on-disk history
    # segments under <data_dir>/flight_recorder/ — segments whose
    # start timestamp ages past this are pruned at rotation time —
    # citus.flight_recorder_retention_s.
    flight_recorder_retention_s: float = 3600.0


@dataclass
class RollupSettings:
    """Continuous aggregation (rollup/manager.py): CDC-fed incremental
    refresh of sketch rollup tables."""

    # Cadence (ms) of the background refresh consumer —
    # citus.rollup_refresh_interval_ms.  0 (the default) keeps the
    # consumer thread off; refresh can still be driven explicitly via
    # citus_refresh_rollups() / RollupManager.refresh_once().
    rollup_refresh_interval_ms: float = 0.0
    # Percentile sketch backend newly created rollups store —
    # citus.percentile_backend: "ddsketch" (log-bucket histogram,
    # device psum-combinable, ~2.7% relative value error) or "tdigest"
    # (fixed-slot centroid digest, host-compressed, ~2% rank error —
    # the reference's planner/tdigest_extension.c backend).
    percentile_backend: str = "ddsketch"
    # Max CDC delta rows folded into one rollup per refresh tick —
    # citus.rollup_max_batch_rows; the tail beyond it stays in the
    # stream for the next tick (the watermark only advances past what
    # was applied).
    rollup_max_batch_rows: int = 65536
    # citus.enable_rollup_routing: answer matching dashboard queries
    # from rollup state (stale by the refresh lag) instead of a raw
    # scan.  Off gives benchmarks and tests their raw-scan arm.
    enable_rollup_routing: bool = True


@dataclass
class MetadataSettings:
    """Multi-coordinator metadata sync (metadata/sync.py): pull-on-
    mismatch catalog replication so any attached coordinator plans and
    admits identically to the authority."""

    # Cadence (ms) of the attached coordinator's background sync loop —
    # citus.metadata_sync_interval_ms.  0 (the default) keeps the loop
    # off: convergence still happens at statement start when a
    # catalog_changed invalidation arrived, and on demand via
    # SELECT citus_sync_metadata().
    metadata_sync_interval_ms: float = 0.0
    # Master switch for incremental pull-on-mismatch sync —
    # citus.enable_metadata_sync.  Off = invalidations fall back to the
    # legacy full-document fetch (correct, O(catalog) per reload).
    enable_metadata_sync: bool = True


@dataclass
class AutopilotSettings:
    """Self-driving rebalance loop (services/autopilot.py): a
    maintenance-daemon duty that turns health events + per-placement
    load attribution into rebalance actions with hysteresis."""

    # citus.autopilot — "off" (default: duty is a no-op), "observe"
    # (evaluate + log every decision with evidence, execute nothing),
    # "on" (execute through the operation registry).
    mode: str = "off"
    # Evaluation cadence (seconds) of the autopilot duty —
    # citus.autopilot_interval_s.
    interval_s: float = 1.0
    # A plan step must recur for this many consecutive evaluation
    # ticks before the autopilot acts on it (hysteresis against
    # transient spikes) — citus.autopilot_sustain_ticks.
    sustain_ticks: int = 3
    # Quiet period (seconds) after any executed/adopted action before
    # the next one may run — citus.autopilot_cooldown_s.  Persisted in
    # autopilot_state.json, so the cooldown survives a restart.
    cooldown_s: float = 60.0
    # Greedy-balance trigger: a plan step only counts when the hi-lo
    # load gap exceeds this fraction of the mean node load —
    # citus.autopilot_threshold.
    threshold: float = 0.5


@dataclass
class ShardingSettings:
    # Default shard count for create_distributed_table
    # (reference GUC citus.shard_count, default 32).
    shard_count: int = 8
    # Replication factor for distributed tables
    # (reference citus.shard_replication_factor).
    shard_replication_factor: int = 1
    # Non-blocking shard moves (operations/shard_transfer.py).  The
    # catch-up loop keeps replaying source deltas to the target while
    # the replication lag (pending CDC records committed after the last
    # pass started) stays above this; only below it does the move take
    # the colocation group's EXCLUSIVE lock for the final micro
    # catch-up + metadata flip (citus.shard_move_catchup_threshold).
    shard_move_catchup_threshold: int = 16
    # Bounded retries: after this many catch-up rounds the move stops
    # chasing a hot writer and proceeds to the locked final catch-up
    # (citus.shard_move_max_catchup_rounds).
    shard_move_max_catchup_rounds: int = 10
    # Keep the source placement until the next cleaner pass so readers
    # that planned against it finish safely; False drops it inline
    # right after the flip (citus.defer_drop_after_shard_move).
    defer_drop_after_shard_move: bool = True


@dataclass
class Settings:
    columnar: ColumnarSettings = field(default_factory=ColumnarSettings)
    planner: PlannerSettings = field(default_factory=PlannerSettings)
    executor: ExecutorSettings = field(default_factory=ExecutorSettings)
    sharding: ShardingSettings = field(default_factory=ShardingSettings)
    workload: WorkloadSettings = field(default_factory=WorkloadSettings)
    observability: ObservabilitySettings = field(
        default_factory=ObservabilitySettings)
    rollup: RollupSettings = field(default_factory=RollupSettings)
    metadata: MetadataSettings = field(default_factory=MetadataSettings)
    autopilot: AutopilotSettings = field(default_factory=AutopilotSettings)
    # reference GUC citus.enable_change_data_capture
    enable_change_data_capture: bool = False
    # start the maintenance daemon with the cluster (reference: the
    # per-database daemon starts with the database, maintenanced.c:138);
    # opt-out for embedded/test uses that drive run_once() themselves
    start_maintenance_daemon: bool = True
    # cross-process deadlock detection cadence (reference default: every
    # 2 s, citus.distributed_deadlock_detection_factor x deadlock_timeout)
    deadlock_detection_interval_s: float = 2.0
    # authority health / lease-based promotion cadence
    authority_watch_interval_s: float = 2.0

    def replace(self, **kw) -> "Settings":
        return dataclasses.replace(self, **kw)


_CURRENT = Settings()


def current_settings() -> Settings:
    return _CURRENT


def set_settings(settings: Settings) -> None:
    global _CURRENT
    _CURRENT = settings


@contextlib.contextmanager
def settings_override(**sections):
    """Temporarily override settings sections, e.g.
    ``settings_override(executor=ExecutorSettings(task_executor_backend="cpu"))``.
    """
    global _CURRENT
    old = _CURRENT
    _CURRENT = dataclasses.replace(old, **sections)
    try:
        yield _CURRENT
    finally:
        _CURRENT = old
