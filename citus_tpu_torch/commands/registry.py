"""Statement-type handler registry (DistributeObjectOps analog).

Each handler is ``fn(cl, stmt) -> Result`` where ``cl`` is the Cluster.
Handlers register against AST node types; ``dispatch`` resolves the
statement's type (exact match — AST nodes are flat dataclasses with no
inheritance between statement kinds).

Reference: commands/distribute_object_ops.c maps parse-tree node tags to
{deparse, qualify, preprocess, postprocess, address, markDistributed}
operation sets; our per-task executable form is a plan + jitted kernel
spec rather than SQL text, so one ``execute`` hook suffices.
"""

from __future__ import annotations

from typing import Callable, Optional

STATEMENT_HANDLERS: dict[type, Callable] = {}

UTILITY_HANDLERS: dict[str, Callable] = {}


def handles(*ast_types):
    """Register a handler for one or more AST statement types."""
    def deco(fn):
        for t in ast_types:
            if t in STATEMENT_HANDLERS:
                raise RuntimeError(f"duplicate handler for {t.__name__}")
            STATEMENT_HANDLERS[t] = fn
        return fn
    return deco


def utility(*names):
    """Register a handler for a UDF-style admin call by name."""
    def deco(fn):
        for n in names:
            if n in UTILITY_HANDLERS:
                raise RuntimeError(f"duplicate utility handler for {n}")
            UTILITY_HANDLERS[n] = fn
        return fn
    return deco


def lookup(stmt) -> Optional[Callable]:
    return STATEMENT_HANDLERS.get(type(stmt))
