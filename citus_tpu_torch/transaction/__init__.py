"""Distributed transaction machinery.

Reference: src/backend/distributed/transaction/ — the coordinated
transaction callback (transaction_management.c), the pg_dist_transaction
2PC log + recovery (transaction_recovery.c), and distributed deadlock
detection (distributed_deadlock_detection.c, lock_graph.c).

Shape: device state is cache-only, so transactional truth
lives entirely in host metadata + immutable stripe files.  "2PC" is a
write-ahead transaction log gating the visibility flip of staged shard
metadata across placements; recovery reconciles the log against staged
files exactly like RecoverTwoPhaseCommits reconciles pg_dist_transaction
against workers' pg_prepared_xacts.
"""

from citus_tpu_torch.transaction.manager import TransactionLog, TxState
from citus_tpu_torch.transaction.locks import LockManager, DeadlockDetected, LockTimeout
from citus_tpu_torch.transaction.session import InFailedTransaction, Session

__all__ = ["TransactionLog", "TxState", "LockManager", "DeadlockDetected",
           "LockTimeout", "Session", "InFailedTransaction"]
