"""Cluster operations: deferred cleanup records (``cleaner``) and
table redistribution (``alter_table``)."""
