"""Shared utilities (clock, helpers)."""
