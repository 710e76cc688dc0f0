"""Import-time registration of all command handler modules.

Importing a handler module runs its ``@handles``/``@utility``
decorators, populating the registries.  Lazy (first dispatch) so the
handler modules may import citus_tpu_torch.cluster helpers at module
level without a cycle.
"""

from __future__ import annotations

_loaded = False


def ensure_loaded() -> None:
    global _loaded
    if _loaded:
        return
    from citus_tpu_torch.commands import (  # noqa: F401
        config_cmds, ddl_objects, dml, explain, insert, tables, utility,
    )
    _loaded = True
