"""Relation schemas.

A Schema is an ordered list of named, typed columns — the equivalent of a
pg_attribute row set for one relation in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

from citus_tpu_torch.errors import AnalysisError
from citus_tpu_torch.types import (
    UUID, ColumnType, is_uuid_lane, type_from_sql, uuid_lane_base,
    uuid_lane_name,
)


@dataclass(frozen=True)
class Column:
    name: str
    type: ColumnType
    not_null: bool = False
    # immutable on-disk stream key; stays stable across RENAME COLUMN
    storage_name: str = ""
    # DEFAULT expression as SQL text (literal or nextval('seq')),
    # evaluated per missing-column row at ingest (reference:
    # pg_attrdef; sequences back serial columns)
    default_sql: str = ""

    def __post_init__(self):
        if not self.storage_name:
            object.__setattr__(self, "storage_name", self.name)


@dataclass
class Schema:
    columns: list[Column] = field(default_factory=list)

    def __post_init__(self):
        seen = set()
        for c in self.columns:
            if c.name in seen:
                raise AnalysisError(f"duplicate column {c.name!r}")
            seen.add(c.name)

    def __iter__(self) -> Iterator[Column]:
        return iter(self.columns)

    def __len__(self) -> int:
        return len(self.columns)

    @property
    def names(self) -> list[str]:
        return [c.name for c in self.columns]

    def has(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    def column(self, name: str) -> Column:
        for c in self.columns:
            if c.name == name:
                return c
        raise AnalysisError(f"column {name!r} does not exist")

    def index_of(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise AnalysisError(f"column {name!r} does not exist")

    def to_json(self) -> list:
        out = []
        for c in self.columns:
            d = {"name": c.name, "kind": c.type.kind,
                 "precision": c.type.precision, "scale": c.type.scale,
                 "not_null": c.not_null, "storage_name": c.storage_name}
            if c.type.elem is not None:
                d["elem"] = c.type.elem
            if c.default_sql:
                d["default"] = c.default_sql
            out.append(d)
        return out

    @staticmethod
    def from_json(data: list) -> "Schema":
        return Schema([
            Column(d["name"],
                   ColumnType(d["kind"], d["precision"], d["scale"],
                              d.get("elem")),
                   d["not_null"], d.get("storage_name", d["name"]),
                   d.get("default", ""))
            for d in data
        ])

    # ---- uuid lane resolution ------------------------------------------
    # A uuid column owns a companion int64 stream named
    # "<name>::lo" (types.UUID_LANE_SUFFIX).  Lane names are valid scan/
    # storage identifiers everywhere below the planner, but are not
    # schema columns: resolve them through these helpers.

    def scan_column(self, name: str) -> Column:
        """Like column(), but lane names resolve to their base uuid
        column (the lane inherits nullability from it)."""
        if is_uuid_lane(name):
            base = self.column(uuid_lane_base(name))
            if base.type.kind != UUID:
                raise AnalysisError(f"column {name!r} does not exist")
            return base
        return self.column(name)

    def scan_storage_name(self, name: str) -> str:
        """Scan name -> on-disk stream key (lane streams derive theirs
        from the base column's storage_name, so RENAME stays free)."""
        if is_uuid_lane(name):
            return uuid_lane_name(self.scan_column(name).storage_name)
        return self.column(name).storage_name

    def scan_dtype(self, name: str, device: bool = False):
        """Scan name -> storage (or device) dtype; uuid lanes are int64
        either way."""
        col = self.scan_column(name)
        return col.type.device_dtype if device else col.type.storage_dtype

    def physical_names(self, names=None) -> list[str]:
        """Expand column names to physical stream names: every uuid
        column contributes its lane companion right after itself.
        Already-expanded lane names pass through unchanged."""
        out: list[str] = []
        for n in (self.names if names is None else names):
            out.append(n)
            if not is_uuid_lane(n) and self.has(n) \
                    and self.column(n).type.kind == UUID:
                lane = uuid_lane_name(n)
                if names is None or lane not in names:
                    out.append(lane)
        return out

    @staticmethod
    def of(*cols: tuple) -> "Schema":
        """Schema.of(("a", "bigint"), ("b", "decimal(12,2)")) convenience."""
        out = []
        for name, tspec in cols:
            if isinstance(tspec, ColumnType):
                out.append(Column(name, tspec))
                continue
            tspec = tspec.strip().lower()
            if "(" in tspec:
                base, rest = tspec.split("(", 1)
                args = [int(x) for x in rest.rstrip(")").split(",")]
                out.append(Column(name, type_from_sql(base.strip(), args)))
            else:
                out.append(Column(name, type_from_sql(tspec)))
        return Schema(out)
