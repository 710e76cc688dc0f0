"""Error hierarchy.

The reference reports errors through PostgreSQL's ereport machinery; here we
use a small exception tree so callers can distinguish user errors (bad SQL,
unsupported features) from internal invariant failures.
"""


class CitusTpuError(Exception):
    """Base class for all citus_tpu_torch errors."""


class SqlSyntaxError(CitusTpuError):
    """The SQL text could not be parsed."""

    def __init__(self, message, position=None, text=None):
        self.position = position
        self.text = text
        if position is not None and text is not None:
            line = text[:position].count("\n") + 1
            col = position - (text.rfind("\n", 0, position) + 1) + 1
            message = f"{message} (line {line}, column {col})"
        super().__init__(message)


class AnalysisError(CitusTpuError):
    """Semantically invalid query (unknown column, type mismatch, ...)."""


class UnsupportedFeatureError(CitusTpuError):
    """Valid SQL that this engine does not (yet) support."""


class CatalogError(CitusTpuError):
    """Metadata/catalog inconsistency or misuse."""


class StorageError(CitusTpuError):
    """Columnar storage corruption or IO failure."""


class ExecutionError(CitusTpuError):
    """Runtime failure while executing a plan."""


class AdmissionTimeoutError(ExecutionError):
    """No device dispatch slot came free within the lock timeout
    (citus.max_shared_pool_size slots busy)."""


class AdmissionShedError(ExecutionError):
    """A query was load-shed by the workload scheduler before taking a
    slot (tenant queue depth or QPS rate limit exceeded).  Distinct and
    retryable: the client should back off and resend — nothing ran, no
    state changed (the reference fast-fails with a dedicated sqlstate
    when shared_connection_stats denies a connection)."""

    retryable = True


class TransactionError(CitusTpuError):
    """Distributed transaction / 2PC failure."""
