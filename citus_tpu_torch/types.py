"""Column type system.

Design goal: every SQL type maps to a fixed-width *physical* representation
that a TPU kernel can process, with exact (bit-identical) aggregate
semantics for the types the reference's analytics path cares about
(reference: the NUMERIC/aggregate machinery used by
multi_logical_optimizer.c's worker/master aggregate split).

Physical encodings:

=============  =====================  ============================
SQL type       storage dtype          semantics
=============  =====================  ============================
BOOL           int8                   0/1
SMALLINT       int16                  widened to int64 on device
INT/INTEGER    int32                  widened to int64 on device
BIGINT         int64
REAL           float32
DOUBLE         float64
DECIMAL(p,s)   int64                  value * 10**s (exact fixed point)
DATE           int32                  days since 1970-01-01
TIMESTAMP      int64                  microseconds since epoch
TEXT/VARCHAR   int32                  table-global dictionary id
=============  =====================  ============================

Exactness: DECIMAL arithmetic and SUM/AVG run on scaled int64, so results
are bit-identical regardless of reduction order — this is what lets the
per-shard partial aggregate + ``psum`` combine reproduce the single-node
answer exactly (the reference gets the same property from PostgreSQL's
arbitrary-precision NUMERIC).

Nulls are carried in a separate validity bitmap (storage) / bool mask
(device); the value slot under a null is 0.
"""

from __future__ import annotations

import datetime
import decimal
import re
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from citus_tpu_torch.errors import AnalysisError

# type kinds
BOOL = "bool"
INT16 = "int16"
INT32 = "int32"
INT64 = "int64"
FLOAT32 = "float32"
FLOAT64 = "float64"
DECIMAL = "decimal"
DATE = "date"
TIMESTAMP = "timestamp"
TIMESTAMPTZ = "timestamptz"
TIME = "time"
INTERVAL = "interval"
TEXT = "text"
UUID = "uuid"
BYTEA = "bytea"
ARRAY = "array"
SKETCH = "sketch"

_EPOCH_DATE = datetime.date(1970, 1, 1)

_TZ_SUFFIX = re.compile(r"([+-]\d{2})(?::?(\d{2}))?$")


def _iso_compat(s: str) -> str:
    """Normalize ISO timestamp/time strings for fromisoformat on
    Python < 3.11, which rejects 'Z', bare '+HH'/'+HHMM' offsets
    (e.g. '2024-01-02 00:00:00+00' as PostgreSQL emits), and
    fractional seconds that are not exactly 3 or 6 digits."""
    if s.endswith(("Z", "z")):
        s = s[:-1] + "+00:00"
    # a trailing [+-]HH only means a zone offset after a time component;
    # without the colon guard a bare date's '-DD' would match
    off = ""
    m = _TZ_SUFFIX.search(s)
    if m and ":" in s[:m.start()]:
        off = m.group(1) + ":" + (m.group(2) or "00")
        s = s[:m.start()]
    fm = re.search(r"\.(\d{1,6})$", s)
    if fm and len(fm.group(1)) not in (3, 6):
        s = s[:fm.start(1)] + fm.group(1).ljust(6, "0")
    return s + off


def parse_datetime(s: str) -> datetime.datetime:
    return datetime.datetime.fromisoformat(_iso_compat(s))


def parse_time(s: str) -> datetime.time:
    return datetime.time.fromisoformat(_iso_compat(s))

_STORAGE_DTYPES = {
    BOOL: np.int8,
    INT16: np.int16,
    INT32: np.int32,
    INT64: np.int64,
    FLOAT32: np.float32,
    FLOAT64: np.float64,
    DECIMAL: np.int64,
    DATE: np.int32,
    TIMESTAMP: np.int64,
    TIMESTAMPTZ: np.int64,
    TIME: np.int64,
    INTERVAL: np.int64,
    TEXT: np.int32,
    UUID: np.int64,
    BYTEA: np.int32,
    ARRAY: np.int32,
    SKETCH: np.int32,
}

# dtype the expression/aggregate kernels compute in
_DEVICE_DTYPES = {
    BOOL: np.int32,
    INT16: np.int64,
    INT32: np.int64,
    INT64: np.int64,
    FLOAT32: np.float32,
    FLOAT64: np.float64,
    DECIMAL: np.int64,
    DATE: np.int32,
    TIMESTAMP: np.int64,
    TIMESTAMPTZ: np.int64,
    TIME: np.int64,
    INTERVAL: np.int64,
    TEXT: np.int32,
    UUID: np.int64,
    BYTEA: np.int32,
    ARRAY: np.int32,
    SKETCH: np.int32,
}


#: sketch word prefixes the SKETCH kind accepts ("<kind>:<version>:<b64>")
SKETCH_WORD_KINDS = ("hll", "ddsk", "topk", "tdg")

#: kinds whose physical value is a table-global dictionary id — the
#: fixed-width projection of variable-width data onto the TPU's shape
#: constraints (SURVEY "hard parts": dictionary/offset encodings at
#: write time so kernels see fixed-width ids).  The reference stores
#: arbitrary varlena datums in columnar chunks
#: (columnar/columnar_tableam.c:718); here every variable-width type
#: rides the dictionary machinery with kind-specific canonicalization
#: (normalize_word) and rendering (render_word).  UUID left this club:
#: it is already fixed-width (128 bits), so it stores as two int64
#: lanes per column and never touches the table-global dictionary.
_DICTIONARY_KINDS = (TEXT, BYTEA, ARRAY, SKETCH)


# ---- uuid lane encoding --------------------------------------------------
#
# A uuid column stores as TWO int64 streams: the base column holds the
# high 64 bits, a companion "<name>::lo" stream holds the low 64 bits.
# Both lanes are offset-binary (bit 63 flipped), so SIGNED int64 order
# on (hi, lo) equals unsigned 128-bit order equals canonical lowercase
# hex text order — chunk min/max stats on the lanes prune correctly and
# equality/ordering run directly on fixed-width lanes in the kernels.

#: companion-stream suffix ("::" cannot appear in a SQL identifier path
#: that reaches storage, so derived names never collide with user columns)
UUID_LANE_SUFFIX = "::lo"

_LANE_BIAS = 1 << 63
_U64 = (1 << 64) - 1


def is_uuid_lane(name: str) -> bool:
    return name.endswith(UUID_LANE_SUFFIX)


def uuid_lane_name(name: str) -> str:
    return name + UUID_LANE_SUFFIX


def uuid_lane_base(name: str) -> str:
    return name[:-len(UUID_LANE_SUFFIX)] if is_uuid_lane(name) else name


def uuid_int_to_lanes(value: int) -> tuple[int, int]:
    """128-bit uuid int -> (hi, lo) signed offset-binary int64 lanes."""
    return (((value >> 64) & _U64) - _LANE_BIAS), ((value & _U64) - _LANE_BIAS)


def uuid_lanes_to_int(hi: int, lo: int) -> int:
    """(hi, lo) signed offset-binary lanes -> 128-bit uuid int."""
    return (((int(hi) + _LANE_BIAS) & _U64) << 64) | ((int(lo) + _LANE_BIAS) & _U64)


def uuid_lane_arrays(values) -> tuple[np.ndarray, np.ndarray]:
    """Iterable of uuid spellings (str/UUID/None) -> (hi, lo) int64
    arrays (0 under nulls; validity is tracked separately)."""
    n = len(values)
    hi = np.zeros(n, np.int64)
    lo = np.zeros(n, np.int64)
    for i, v in enumerate(values):
        if v is None:
            continue
        h, l = uuid_int_to_lanes(UUID_T.to_physical(v))
        hi[i] = h
        lo[i] = l
    return hi, lo


def uuid_from_lane_pair(hi, lo) -> str:
    """One (hi, lo) lane pair -> canonical lowercase uuid string."""
    import uuid as _uuid
    return str(_uuid.UUID(int=uuid_lanes_to_int(hi, lo)))


@dataclass(frozen=True)
class ColumnType:
    kind: str
    precision: int = 0  # DECIMAL only
    scale: int = 0      # DECIMAL only
    elem: Optional[str] = None  # ARRAY only: element type name

    # ---- classification ------------------------------------------------
    @property
    def is_integer(self) -> bool:
        return self.kind in (INT16, INT32, INT64)

    @property
    def is_float(self) -> bool:
        return self.kind in (FLOAT32, FLOAT64)

    @property
    def is_decimal(self) -> bool:
        return self.kind == DECIMAL

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_float or self.is_decimal

    @property
    def is_text(self) -> bool:
        """Dictionary-encoded (text-routed) kinds: the physical value is
        a table-global dictionary id, and every code path that encodes/
        decodes through the dictionary treats these identically."""
        return self.kind in _DICTIONARY_KINDS

    @property
    def is_orderable_physical(self) -> bool:
        """True when physical-value order == logical order (everything but
        the dictionary kinds, whose ids are assigned in insertion order,
        and uuid, whose single-lane physical is only a partial order —
        the full order needs both lanes)."""
        return self.kind not in _DICTIONARY_KINDS and self.kind != UUID

    # ---- dictionary-kind canonicalization ------------------------------
    def normalize_word(self, value: Any) -> str:
        """Python value -> canonical dictionary word.  Different inputs
        that denote the same logical value must map to one word, or
        equality comparisons break (e.g. uppercase/lowercase uuids)."""
        k = self.kind
        if k == UUID:
            import uuid as _uuid
            try:
                return str(_uuid.UUID(str(value)))
            except (ValueError, AttributeError, TypeError):
                raise AnalysisError(
                    f"invalid input syntax for type uuid: {value!r}")
        if k == BYTEA:
            if isinstance(value, (bytes, bytearray, memoryview)):
                return "\\x" + bytes(value).hex()
            s = str(value)
            if s.startswith("\\x"):
                try:
                    bytes.fromhex(s[2:])
                except ValueError:
                    raise AnalysisError(
                        f"invalid hexadecimal data for bytea: {value!r}")
                return "\\x" + s[2:].lower()
            # PG escape-format / raw string: store its utf-8 bytes
            return "\\x" + s.encode().hex()
        if k == ARRAY:
            import json as _json
            if isinstance(value, str):
                try:
                    value = _json.loads(value)
                except ValueError:
                    raise AnalysisError(
                        f"invalid input syntax for type array: {value!r}")
            if isinstance(value, np.ndarray):
                value = value.tolist()
            if not isinstance(value, (list, tuple)):
                raise AnalysisError(
                    f"invalid input syntax for type array: {value!r}")
            et = _SQL_NAMES.get(self.elem or "")
            out = []
            for v in value:
                if v is None:
                    out.append(None)
                elif et is not None and et.is_numeric:
                    out.append(float(v) if et.is_float else int(v))
                else:
                    out.append(str(v) if not isinstance(
                        v, (int, float, bool)) else v)
            return _json.dumps(out, separators=(",", ":"))
        if k == SKETCH:
            # self-describing "<kind>:<version>:<base64 payload>" word;
            # the payload codec lives in rollup/sketches.py — the type
            # layer only guards the envelope so a stray string can't
            # enter a sketch column and break merges later
            s = str(value)
            parts = s.split(":", 2)
            if len(parts) != 3 or parts[0] not in SKETCH_WORD_KINDS \
                    or not parts[1].isdigit():
                raise AnalysisError(
                    f"invalid input syntax for type sketch: {value!r}")
            return s
        return str(value)

    def render_word(self, word: str) -> Any:
        """Canonical dictionary word -> Python value (result decode)."""
        k = self.kind
        if k == BYTEA:
            return bytes.fromhex(word[2:]) if word.startswith("\\x") \
                else word.encode()
        if k == ARRAY:
            import json as _json
            return _json.loads(word)
        return word

    # ---- dtypes --------------------------------------------------------
    @property
    def storage_dtype(self) -> np.dtype:
        return np.dtype(_STORAGE_DTYPES[self.kind])

    @property
    def device_dtype(self) -> np.dtype:
        return np.dtype(_DEVICE_DTYPES[self.kind])

    # ---- value conversion ----------------------------------------------
    def to_physical(self, value: Any) -> int | float:
        """Python value -> physical scalar (dictionary ids handled by caller
        for TEXT)."""
        if value is None:
            return 0
        k = self.kind
        if k == BOOL:
            return 1 if value else 0
        if k in (INT16, INT32, INT64):
            return int(value)
        if k in (FLOAT32, FLOAT64):
            return float(value)
        if k == DECIMAL:
            d = value if isinstance(value, decimal.Decimal) else decimal.Decimal(str(value))
            q = d.scaleb(self.scale).to_integral_value(rounding=decimal.ROUND_HALF_UP)
            return int(q)
        if k == DATE:
            if isinstance(value, (int, np.integer)):
                # already-physical (days since epoch), matching the
                # numeric ndarray fast path in ingest.encode_columns
                return int(value)
            if isinstance(value, str):
                value = datetime.date.fromisoformat(value)
            return (value - _EPOCH_DATE).days
        if k == TIMESTAMP:
            if isinstance(value, str):
                value = parse_datetime(value)
            # integer arithmetic: float .timestamp() loses sub-us precision
            delta = value.replace(tzinfo=None) - datetime.datetime(1970, 1, 1)
            return delta // datetime.timedelta(microseconds=1)
        if k == TIMESTAMPTZ:
            if isinstance(value, str):
                value = parse_datetime(value)
            if value.tzinfo is None:
                # PostgreSQL interprets a naive input in the session
                # TimeZone; ours is pinned to UTC
                value = value.replace(tzinfo=datetime.timezone.utc)
            value = value.astimezone(datetime.timezone.utc)
            delta = value.replace(tzinfo=None) - datetime.datetime(1970, 1, 1)
            return delta // datetime.timedelta(microseconds=1)
        if k == TIME:
            if isinstance(value, str):
                value = parse_time(value)
            if isinstance(value, datetime.datetime):
                value = value.time()
            return (value.hour * 3_600_000_000
                    + value.minute * 60_000_000
                    + value.second * 1_000_000 + value.microsecond)
        if k == INTERVAL:
            if isinstance(value, datetime.timedelta):
                return value // datetime.timedelta(microseconds=1)
            return _parse_interval_us(str(value))
        if k == UUID:
            import uuid as _uuid
            if isinstance(value, _uuid.UUID):
                return value.int
            try:
                return _uuid.UUID(str(value)).int
            except (ValueError, AttributeError, TypeError):
                raise AnalysisError(
                    f"invalid input syntax for type uuid: {value!r}")
        raise AnalysisError(f"cannot convert value for type {self}")

    def from_physical(self, raw: int | float, null: bool = False) -> Any:
        """Physical scalar -> Python value (TEXT handled by caller)."""
        if null:
            return None
        k = self.kind
        if k == BOOL:
            return bool(raw)
        if k in (INT16, INT32, INT64):
            return int(raw)
        if k in (FLOAT32, FLOAT64):
            return float(raw)
        if k == DECIMAL:
            return decimal.Decimal(int(raw)).scaleb(-self.scale)
        if k == DATE:
            return _EPOCH_DATE + datetime.timedelta(days=int(raw))
        if k == TIMESTAMP:
            return datetime.datetime.fromtimestamp(raw / 1_000_000, tz=datetime.timezone.utc).replace(tzinfo=None)
        if k == TIMESTAMPTZ:
            # tz-aware, pinned UTC (our session TimeZone)
            return datetime.datetime.fromtimestamp(
                raw / 1_000_000, tz=datetime.timezone.utc)
        if k == TIME:
            us = int(raw)
            return datetime.time(us // 3_600_000_000,
                                 us // 60_000_000 % 60,
                                 us // 1_000_000 % 60, us % 1_000_000)
        if k == INTERVAL:
            return datetime.timedelta(microseconds=int(raw))
        if k == UUID:
            import uuid as _uuid
            return str(_uuid.UUID(int=int(raw)))
        raise AnalysisError(f"cannot convert value for type {self}")

    def __str__(self) -> str:
        if self.kind == DECIMAL:
            return f"decimal({self.precision},{self.scale})"
        if self.kind == ARRAY:
            return f"{self.elem or 'text'}[]"
        return self.kind


#: microseconds per named interval unit (day-time intervals only: a
#: month has no fixed length in microseconds, so PG-style month/year
#: components are rejected rather than silently approximated)
_INTERVAL_UNITS_US = {
    "microsecond": 1, "microseconds": 1, "us": 1,
    "millisecond": 1_000, "milliseconds": 1_000, "ms": 1_000,
    "second": 1_000_000, "seconds": 1_000_000, "sec": 1_000_000,
    "secs": 1_000_000, "s": 1_000_000,
    "minute": 60_000_000, "minutes": 60_000_000, "min": 60_000_000,
    "mins": 60_000_000, "m": 60_000_000,
    "hour": 3_600_000_000, "hours": 3_600_000_000, "h": 3_600_000_000,
    "day": 86_400_000_000, "days": 86_400_000_000, "d": 86_400_000_000,
    "week": 7 * 86_400_000_000, "weeks": 7 * 86_400_000_000,
}


def _parse_interval_us(s: str) -> int:
    """'1 day 02:30:00', '3 hours', '-90 minutes', '00:00:01.5' ->
    microseconds.  Month/year components raise (no fixed us length)."""
    import re
    total = 0
    rest = s.strip().lower()
    if not rest:
        raise AnalysisError("invalid input syntax for type interval: ''")
    # leading sign applies to the whole literal (PG: '-1 day 02:00' is
    # compound; we keep the simpler whole-literal sign)
    sign = 1
    if rest.startswith("-") and not re.match(r"-\d+:\d", rest):
        sign, rest = -1, rest[1:].strip()
    # hh:mm:ss[.ffffff] tail
    m = re.search(r"(-?)(\d+):(\d{1,2})(?::(\d{1,2})(\.\d+)?)?\s*$", rest)
    if m:
        tsign = -1 if m.group(1) else 1
        us = (int(m.group(2)) * 3_600_000_000
              + int(m.group(3)) * 60_000_000
              + int(m.group(4) or 0) * 1_000_000)
        if m.group(5):
            us += round(float(m.group(5)) * 1_000_000)
        total += tsign * us
        rest = rest[:m.start()].strip()
    for num, unit in re.findall(r"(-?\d+(?:\.\d+)?)\s*([a-z]+)", rest):
        if unit in ("month", "months", "mon", "mons", "year", "years",
                    "y", "yr", "yrs"):
            raise AnalysisError(
                "interval month/year components are not supported "
                "(no fixed microsecond length); use days")
        mult = _INTERVAL_UNITS_US.get(unit)
        if mult is None:
            raise AnalysisError(
                f"invalid input syntax for type interval: {s!r}")
        total += round(float(num) * mult)
    consumed = re.sub(r"(-?\d+(?:\.\d+)?)\s*([a-z]+)", "", rest).strip()
    if consumed:
        raise AnalysisError(
            f"invalid input syntax for type interval: {s!r}")
    return sign * total


# canonical singletons
BOOL_T = ColumnType(BOOL)
INT16_T = ColumnType(INT16)
INT32_T = ColumnType(INT32)
INT64_T = ColumnType(INT64)
FLOAT32_T = ColumnType(FLOAT32)
FLOAT64_T = ColumnType(FLOAT64)
DATE_T = ColumnType(DATE)
TIMESTAMP_T = ColumnType(TIMESTAMP)
TIMESTAMPTZ_T = ColumnType(TIMESTAMPTZ)
TIME_T = ColumnType(TIME)
INTERVAL_T = ColumnType(INTERVAL)
TEXT_T = ColumnType(TEXT)
UUID_T = ColumnType(UUID)
BYTEA_T = ColumnType(BYTEA)
SKETCH_T = ColumnType(SKETCH)


def array_t(elem: str = "text") -> ColumnType:
    return ColumnType(ARRAY, elem=elem)


def decimal_t(precision: int, scale: int) -> ColumnType:
    if scale < 0 or precision <= 0 or scale > precision:
        raise AnalysisError(f"invalid decimal({precision},{scale})")
    return ColumnType(DECIMAL, precision, scale)


_SQL_NAMES = {
    "bool": BOOL_T,
    "boolean": BOOL_T,
    "smallint": INT16_T,
    "int2": INT16_T,
    "int": INT32_T,
    "integer": INT32_T,
    "int4": INT32_T,
    "bigint": INT64_T,
    "int8": INT64_T,
    "real": FLOAT32_T,
    "float4": FLOAT32_T,
    "double": FLOAT64_T,
    "float8": FLOAT64_T,
    "date": DATE_T,
    "timestamp": TIMESTAMP_T,
    "timestamptz": TIMESTAMPTZ_T,
    "time": TIME_T,
    "interval": INTERVAL_T,
    "text": TEXT_T,
    "varchar": TEXT_T,
    "char": TEXT_T,
    "uuid": UUID_T,
    "bytea": BYTEA_T,
    "sketch": SKETCH_T,
}


def type_from_sql(name: str, args: Optional[list[int]] = None) -> ColumnType:
    name = name.lower()
    if name.endswith("[]"):
        elem = name[:-2].strip()
        if elem not in _SQL_NAMES and elem not in ("decimal", "numeric"):
            raise AnalysisError(f"unknown array element type: {elem}")
        return array_t(elem)
    if name in ("decimal", "numeric"):
        if not args:
            # NUMERIC without precision: default a wide fixed-point
            return decimal_t(18, 4)
        if len(args) == 1:
            return decimal_t(args[0], 0)
        return decimal_t(args[0], args[1])
    if name in ("double",) and args is None:
        return FLOAT64_T
    t = _SQL_NAMES.get(name)
    if t is None:
        raise AnalysisError(f"unknown type name: {name}")
    return t


# ---- arithmetic result typing ------------------------------------------

def common_super_type(a: ColumnType, b: ColumnType) -> ColumnType:
    """Result type for +,-,* style binary arithmetic and for comparisons'
    operand alignment.  Mirrors (simplified) PostgreSQL numeric promotion."""
    if a == b:
        return a
    if a.is_float or b.is_float:
        return FLOAT64_T
    if a.is_decimal or b.is_decimal:
        # int op decimal -> decimal with the larger scale
        sa = a.scale if a.is_decimal else 0
        sb = b.scale if b.is_decimal else 0
        return decimal_t(38, max(sa, sb))
    if a.is_integer and b.is_integer:
        return INT64_T
    if a.kind == b.kind:
        return a
    if {a.kind, b.kind} == {DATE, TIMESTAMP}:
        return TIMESTAMP_T
    raise AnalysisError(f"no common type for {a} and {b}")


def arith_result_type(op: str, a: ColumnType, b: ColumnType) -> ColumnType:
    if not (a.is_numeric and b.is_numeric):
        # allow date +/- int (day arithmetic)
        if op in ("+", "-") and a.kind == DATE and b.is_integer:
            return DATE_T
        # timestamp[tz]/interval arithmetic: both sides are microsecond
        # int64 physicals, so device addition is exact
        ts_kinds = (TIMESTAMP, TIMESTAMPTZ)
        if op in ("+", "-") and a.kind in ts_kinds and b.kind == INTERVAL:
            return ColumnType(a.kind)
        if op == "+" and a.kind == INTERVAL and b.kind in ts_kinds:
            return ColumnType(b.kind)
        if op == "-" and a.kind in ts_kinds and b.kind == a.kind:
            return INTERVAL_T
        if op in ("+", "-") and a.kind == INTERVAL and b.kind == INTERVAL:
            return INTERVAL_T
        if op == "*" and ((a.kind == INTERVAL and b.is_integer)
                          or (a.is_integer and b.kind == INTERVAL)):
            return INTERVAL_T
        raise AnalysisError(f"operator {op} not defined for {a}, {b}")
    if op == "/":
        # exact decimal division is finalized on host; device computes
        # float64 (documented divergence from PG NUMERIC division)
        if a.is_float or b.is_float or a.is_decimal or b.is_decimal:
            return FLOAT64_T
        return INT64_T  # SQL integer division truncates
    if op == "%":
        if a.is_integer and b.is_integer:
            return INT64_T
        raise AnalysisError("% requires integers")
    if op == "*" and (a.is_decimal or b.is_decimal) and not (a.is_float or b.is_float):
        sa = a.scale if a.is_decimal else 0
        sb = b.scale if b.is_decimal else 0
        return decimal_t(38, sa + sb)  # scales add on multiply
    return common_super_type(a, b)
