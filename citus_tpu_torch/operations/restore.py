"""Cluster-consistent restore points.

Reference: citus_create_restore_point
(src/backend/distributed/operations/citus_create_restore_point.c) —
quiesces 2PC and creates a named WAL restore point on every node so
external backup tooling can restore the whole cluster to one instant.

Here data stripes are immutable-append, so a consistent snapshot is just
the metadata closure at one instant: the catalog document, every
placement's shard_meta/deletes side files, and the transaction log
position.  Restoring (external tooling's job in the reference; we ship
it) copies the metadata back — stripe files referenced by the snapshot
still exist unless VACUUM/TRUNCATE cleanup dropped them.
"""

from __future__ import annotations

import json
import os
import shutil
from citus_tpu_torch.utils.clock import now as wall_now

from citus_tpu_torch.catalog import Catalog
from citus_tpu_torch.errors import CatalogError
from citus_tpu_torch.storage.deletes import DELETES_FILE
from citus_tpu_torch.storage.writer import SHARD_META


def _root(cat: Catalog) -> str:
    return os.path.join(cat.data_dir, "restore_points")


def create_restore_point(cat: Catalog, name: str) -> str:
    if "/" in name or name.startswith("."):
        raise CatalogError(f"invalid restore point name {name!r}")
    dst = os.path.join(_root(cat), name)
    if os.path.isdir(dst):
        raise CatalogError(f"restore point {name!r} already exists")
    os.makedirs(dst)
    shutil.copy2(os.path.join(cat.data_dir, Catalog.FILE), os.path.join(dst, Catalog.FILE))
    # dictionaries (small) + every placement's metadata side files
    for f in os.listdir(cat.data_dir):
        if f.startswith("dict__"):
            shutil.copy2(os.path.join(cat.data_dir, f), os.path.join(dst, f))
    metas = []
    data_root = os.path.join(cat.data_dir, "data")
    if os.path.isdir(data_root):
        for root, _dirs, files in os.walk(data_root):
            rel = os.path.relpath(root, cat.data_dir)
            for f in files:
                if f in (SHARD_META, DELETES_FILE):
                    os.makedirs(os.path.join(dst, rel), exist_ok=True)
                    shutil.copy2(os.path.join(root, f), os.path.join(dst, rel, f))
                    metas.append(os.path.join(rel, f))
    with open(os.path.join(dst, "restore_point.json"), "w") as fh:
        json.dump({"name": name, "created_at": wall_now(), "metas": metas}, fh)
    return dst


def list_restore_points(cat: Catalog) -> list[tuple]:
    root = _root(cat)
    if not os.path.isdir(root):
        return []
    out = []
    for name in sorted(os.listdir(root)):
        info = os.path.join(root, name, "restore_point.json")
        if os.path.exists(info):
            with open(info) as fh:
                d = json.load(fh)
            out.append((name, d["created_at"]))
    return out


def restore_to_point(cat: Catalog, name: str) -> None:
    """Copy the snapshot's metadata back over the live cluster.  The
    caller must reopen the Cluster afterwards."""
    src = os.path.join(_root(cat), name)
    if not os.path.isdir(src):
        raise CatalogError(f"restore point {name!r} does not exist")
    with open(os.path.join(src, "restore_point.json")) as fh:
        info = json.load(fh)
    shutil.copy2(os.path.join(src, Catalog.FILE), os.path.join(cat.data_dir, Catalog.FILE))
    for f in os.listdir(src):
        if f.startswith("dict__"):
            shutil.copy2(os.path.join(src, f), os.path.join(cat.data_dir, f))
    # restore side files; remove deletes files that didn't exist then
    for rel in info["metas"]:
        live = os.path.join(cat.data_dir, rel)
        os.makedirs(os.path.dirname(live), exist_ok=True)
        shutil.copy2(os.path.join(src, rel), live)
    snap_metas = set(info["metas"])
    data_root = os.path.join(cat.data_dir, "data")
    if os.path.isdir(data_root):
        for root, _dirs, files in os.walk(data_root):
            rel_dir = os.path.relpath(root, cat.data_dir)
            for f in files:
                if f == DELETES_FILE and os.path.join(rel_dir, f) not in snap_metas:
                    os.remove(os.path.join(root, f))
