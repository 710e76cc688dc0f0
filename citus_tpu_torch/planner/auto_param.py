"""Literal auto-parameterization: every query is a prepared statement.

The reference plans ad-hoc SQL from scratch per statement and only
prepared statements reach the deferred-pruning generic-plan path
(``Job->deferredPruning``, local_plan_cache.c, plancache.c's
``plan_cache_mode``).  Here the compile being amortized is an XLA
program, so the payoff is much larger: hoisting the comparison and
arithmetic literals of a bound filter into synthetic trailing ``$N``
params makes ``WHERE v < 100`` and ``WHERE v < 200`` byte-identical
plan structures — one structural fingerprint, one set of compiled
kernels (executor/kernel_cache.py) for the whole query family.

Hoisting happens at the BOUND level, after the binder's literal
coercion/alignment: each ``BLiteral`` already carries its exact
physical value (dates -> epoch days, decimals -> scaled ints, text ->
dictionary ids), so the synthetic param spec is ``(type, "__physical__")``
and ``encode_params`` ships the value straight to the device dtype with
no re-coercion.  ``substitute_params`` is the inverse: at bind time the
hoisted values are substituted back so interval extraction, shard
pruning and index-equality matching (planner/physical.py) see exactly
the tree the binder would have produced for the literal SQL — generic
plan, custom-plan pruning.

Gated by ``citus.plan_cache_mode``: ``auto`` (default) hoists ad-hoc
SELECT literals, ``force_custom`` disables hoisting (every literal
variant plans and compiles on its own), ``force_generic`` is the
explicit-prepared behavior both share once params exist.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from citus_tpu_torch.planner.bound import (
    BBinOp, BCast, BExpr, BLiteral, BParam, BScale, BUnOp,
)

#: param_specs source marker: the stored value is already physical
#: (bound-level), encode_params must not re-coerce it
PHYSICAL_SRC = "__physical__"

_LOGIC_OPS = ("and", "or")
#: literal operands of these ops are safe to hoist: the kernel consumes
#: them as 0-d env arrays and the pruning passes re-see them at bind
#: time via substitute_params
_HOIST_OPS = ("=", "<>", "<", "<=", ">", ">=", "+", "-", "*", "/", "%")


def auto_parameterize(bound) -> Optional[tuple]:
    """Hoist filter literals into synthetic trailing params.

    Returns ``(generic_bound, values)`` where ``values`` are the
    bound-level physical literal values (positionally matching the new
    specs), or ``None`` when the filter holds nothing hoistable — the
    custom plan is already as generic as it gets.
    """
    if bound.filter is None:
        return None
    start = len(bound.param_specs)
    specs: list = []
    values: list = []

    def hoist(lit: BLiteral) -> BParam:
        p = BParam(start + len(values), lit.type)
        specs.append((lit.type, PHYSICAL_SRC))
        values.append(lit.value)
        return p

    def rewrite(e: BExpr, hoistable: bool) -> BExpr:
        # ``hoistable``: this position is a direct operand of a
        # comparison/arithmetic op (possibly through the binder's
        # scale/cast alignment wrappers)
        if isinstance(e, BLiteral):
            return hoist(e) if hoistable and e.value is not None else e
        if isinstance(e, BBinOp):
            if e.op in _LOGIC_OPS:
                l = rewrite(e.left, False)
                r = rewrite(e.right, False)
            elif e.op in _HOIST_OPS:
                l = rewrite(e.left, True)
                r = rewrite(e.right, True)
            else:
                return e
            if l is e.left and r is e.right:
                return e
            return dataclasses.replace(e, left=l, right=r)
        if isinstance(e, BUnOp) and e.op == "not":
            op = rewrite(e.operand, False)
            return e if op is e.operand else dataclasses.replace(e, operand=op)
        if isinstance(e, (BScale, BCast)):
            op = rewrite(e.operand, hoistable)
            return e if op is e.operand else dataclasses.replace(e, operand=op)
        return e

    new_filter = rewrite(bound.filter, False)
    if not values:
        return None
    generic = dataclasses.replace(
        bound, filter=new_filter,
        param_specs=list(bound.param_specs) + specs)
    return generic, values


def substitute_params(e: Optional[BExpr], values: list) -> Optional[BExpr]:
    """Replace every ``BParam`` with a ``BLiteral`` of its bind-time
    physical value (None for absent/NULL), recovering the literal tree
    the pruning passes understand.  Identity-preserving: returns the
    original node when nothing underneath changed."""
    if e is None or not isinstance(e, BExpr):
        return e
    if isinstance(e, BParam):
        v = values[e.index] if e.index < len(values) else None
        return BLiteral(v, e.type)
    changed = {}
    for f in dataclasses.fields(e):
        val = getattr(e, f.name)
        new = _sub_value(val, values)
        if new is not val:
            changed[f.name] = new
    return dataclasses.replace(e, **changed) if changed else e


def _sub_value(v, values):
    if isinstance(v, BExpr):
        return substitute_params(v, values)
    if isinstance(v, tuple):
        subbed = tuple(_sub_value(x, values) for x in v)
        if any(a is not b for a, b in zip(subbed, v)):
            return subbed
    return v
