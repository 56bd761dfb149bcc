"""SQL type system <-> field options mapping.

Reference: sql3's data types (ID/STRING/IDSET/STRINGSET/INT/DECIMAL/
TIMESTAMP/BOOL and the time-quantum'd IDSETQ/STRINGSETQ) map onto the
engine field types the same way the reference maps them onto pilosa
fields (sql3/planner field mapping): scalar ID/STRING are mutex fields,
*SET are set fields, *SETQ are time fields.

Port of ``pilosa_tpu/sql/types.py`` over the port's field options.
"""

from __future__ import annotations

import re

from pilosa_tpu_torch.core.schema import FieldOptions, FieldType
from pilosa_tpu_torch.sql import ast
from pilosa_tpu_torch.sql.lexer import SQLError

_TTL_RE = re.compile(r"^(\d+)([smhd])$")
_TTL_SECONDS = {"s": 1, "m": 60, "h": 3600, "d": 86400}


def parse_ttl(spec: str) -> int:
    m = _TTL_RE.match(spec)
    if not m:
        raise SQLError(f"bad TTL spec {spec!r} (want e.g. '30d')")
    return int(m.group(1)) * _TTL_SECONDS[m.group(2)]


def column_to_field_options(cd: ast.ColumnDef) -> FieldOptions:
    t = cd.type
    if t == "ID":
        return FieldOptions(type=FieldType.MUTEX, keys=False,
                            cache_type=cd.cache_type or "ranked",
                            cache_size=cd.cache_size or 50000)
    if t == "STRING":
        return FieldOptions(type=FieldType.MUTEX, keys=True,
                            cache_type=cd.cache_type or "ranked",
                            cache_size=cd.cache_size or 50000)
    if t == "IDSET":
        return FieldOptions(type=FieldType.SET, keys=False)
    if t == "STRINGSET":
        return FieldOptions(type=FieldType.SET, keys=True)
    if t in ("IDSETQ", "STRINGSETQ"):
        return FieldOptions(
            type=FieldType.TIME, keys=(t == "STRINGSETQ"),
            time_quantum=cd.time_quantum or "YMD",
            ttl_seconds=parse_ttl(cd.ttl) if cd.ttl else 0)
    if t == "INT":
        return FieldOptions(type=FieldType.INT, min=cd.min, max=cd.max)
    if t == "DECIMAL":
        return FieldOptions(type=FieldType.DECIMAL, scale=cd.type_arg or 2)
    if t == "TIMESTAMP":
        return FieldOptions(type=FieldType.TIMESTAMP,
                            time_unit=cd.time_unit or "s")
    if t == "BOOL":
        return FieldOptions(type=FieldType.BOOL)
    raise SQLError(f"unsupported SQL type {t!r}")


def column_to_options_dict(cd: ast.ColumnDef) -> dict:
    """ColumnDef -> the JSON options dict the api/cluster create_field
    surface takes (so SQL DDL broadcasts like any schema change)."""
    fo = column_to_field_options(cd)
    d = {"type": fo.type.value, "keys": fo.keys}
    if fo.min is not None:
        d["min"] = fo.min
    if fo.max is not None:
        d["max"] = fo.max
    if fo.scale:
        d["scale"] = fo.scale
    if fo.time_unit != "s":
        d["timeUnit"] = fo.time_unit
    if fo.time_quantum:
        d["timeQuantum"] = fo.time_quantum
    if fo.ttl_seconds:
        d["ttl"] = fo.ttl_seconds
    d["cacheType"] = fo.cache_type
    d["cacheSize"] = fo.cache_size
    return d


def field_to_sql_type(opts: FieldOptions) -> str:
    ft = opts.type
    if ft == FieldType.MUTEX:
        return "STRING" if opts.keys else "ID"
    if ft == FieldType.SET:
        return "STRINGSET" if opts.keys else "IDSET"
    if ft == FieldType.TIME:
        return "STRINGSETQ" if opts.keys else "IDSETQ"
    if ft == FieldType.INT:
        return "INT"
    if ft == FieldType.DECIMAL:
        return f"DECIMAL({opts.scale})"
    if ft == FieldType.TIMESTAMP:
        return "TIMESTAMP"
    if ft == FieldType.BOOL:
        return "BOOL"
    return "STRINGSET" if opts.keys else "IDSET"  # plain set fields


def id_sql_type(keyed: bool) -> str:
    return "STRING" if keyed else "ID"
