"""Schema objects: field types and options.

Reference: field.go:126-391 (FieldOptions / type constants
FieldTypeSet/Int/Timestamp/Bool/Mutex/Decimal/Time), index.go:1078
(IndexOptions). Copied from ``pilosa_tpu/core/schema.py`` so both
packages read and write the same option documents.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class FieldType(str, enum.Enum):
    SET = "set"
    MUTEX = "mutex"
    BOOL = "bool"
    INT = "int"
    DECIMAL = "decimal"
    TIMESTAMP = "timestamp"
    TIME = "time"  # set with time-quantum views

    @property
    def is_bsi(self) -> bool:
        return self in (FieldType.INT, FieldType.DECIMAL, FieldType.TIMESTAMP)


# Bool fields store false=row 0, true=row 1 (reference: field.go bool rows).
BOOL_FALSE_ROW = 0
BOOL_TRUE_ROW = 1


@dataclasses.dataclass
class FieldOptions:
    type: FieldType = FieldType.SET
    keys: bool = False  # row keys are strings, translated
    # BSI options (reference: field.go:239 OptFieldTypeInt min/max).
    min: Optional[int] = None
    max: Optional[int] = None
    base: int = 0
    scale: int = 0  # decimal scale: stored = value * 10^scale
    # timestamp granularity: stored = epoch units since Unix epoch
    time_unit: str = "s"
    # time fields (reference: field.go:309 OptFieldTypeTime).
    time_quantum: str = ""  # subset of "YMDH"
    ttl_seconds: int = 0
    # TopN cache config kept for API parity; the engine recounts
    # instead of caching (reference: cache.go, SURVEY.md §7).
    cache_type: str = "ranked"
    cache_size: int = 50000

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["type"] = self.type.value
        return d

    @staticmethod
    def from_json(d: dict) -> "FieldOptions":
        d = dict(d)
        d["type"] = FieldType(d.get("type", "set"))
        return FieldOptions(**d)


@dataclasses.dataclass
class IndexOptions:
    keys: bool = False  # record keys are strings, translated
    track_existence: bool = True  # maintain the `_exists` field (index.go:384)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "IndexOptions":
        return IndexOptions(**d)
