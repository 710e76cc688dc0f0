"""Background services: job scheduler + maintenance daemon
(reference: src/backend/distributed/utils/background_jobs.c and
utils/maintenanced.c)."""

from citus_tpu_torch.services.background_jobs import BackgroundJobRunner, JobStatus
from citus_tpu_torch.services.maintenance import MaintenanceDaemon

__all__ = ["BackgroundJobRunner", "JobStatus", "MaintenanceDaemon"]
