"""Cluster operations: deferred cleanup records (``cleaner``)."""
