"""Distributed tracing + metrics export (the observability layer).

- trace.py   — span trees per query, cross-RPC context propagation,
               the package's single span-timing clock
- export.py  — Chrome trace-event JSON (Perfetto) + Prometheus text
- slowlog.py — bounded in-memory slow-query ring

Reference analogs: the stats family under
src/backend/distributed/stats/ plus log_min_duration_statement; the
span tree itself is the Dapper-style layer the reference lacks.
"""
