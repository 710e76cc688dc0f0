"""Advisory flags of the cluster flight recorder.

The JAX package's flight recorder samples the counter plane into a
ring and an on-disk log and runs a health engine over it; its
saturation events double as an advisory signal that the tenant
scheduler reads (``workload/scheduler.py`` sheds earlier while
``ADVISORY.pool_saturated`` is raised).  This port carries only that
advisory holder: the sampler, the disk log and the health engine wait
for ROADMAP.md A14, so here the flag stays at its default until they
land.
"""

from __future__ import annotations


class _Advisory:
    """Process-wide advisory flags the health engine raises for other
    subsystems (plain bool attributes: single-writer, torn reads are
    impossible for bools, and readers only ever branch on them)."""

    def __init__(self) -> None:
        self.pool_saturated = False


ADVISORY = _Advisory()
