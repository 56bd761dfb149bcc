"""Extended ingest sources: SQL databases, Kinesis, Avro.

Port of ``pilosa_tpu/ingest/sources_ext.py``.

Reference: idk/sql/ (database source), idk/kinesis/ (stream source),
idk/ Avro schema-registry decoding for Kafka payloads. Each source
yields the same Record dicts the CSV/Kafka sources do, so the Ingester
driver (ingest.py) is unchanged.

Dependency policy (no boto3, avro or DB driver is required beyond
sqlite3): SQLSource takes any DB-API 2.0 connection (sqlite3 works out
of the box); KinesisSource takes an injected boto3-compatible client —
constructing one from a region requires boto3 and is gated; AvroSource
ships its own minimal Avro-binary decoder for record schemas of
primitive/array-of-primitive fields (the wire format is public and
small), so schema-registry payloads decode without the avro package.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from pilosa_tpu_torch.core.schema import FieldOptions, FieldType
from pilosa_tpu_torch.ingest.source import Record, Source

_SQL_TYPE_MAP = {
    "int": FieldOptions(type=FieldType.INT),
    "integer": FieldOptions(type=FieldType.INT),
    "bigint": FieldOptions(type=FieldType.INT),
    "real": FieldOptions(type=FieldType.DECIMAL, scale=4),
    "float": FieldOptions(type=FieldType.DECIMAL, scale=4),
    "double": FieldOptions(type=FieldType.DECIMAL, scale=4),
    "text": FieldOptions(type=FieldType.MUTEX, keys=True),
    "varchar": FieldOptions(type=FieldType.MUTEX, keys=True),
    "string": FieldOptions(type=FieldType.MUTEX, keys=True),
    "bool": FieldOptions(type=FieldType.BOOL),
    "boolean": FieldOptions(type=FieldType.BOOL),
}


class SQLSource(Source):
    """Rows of a SQL query as Records (reference: idk/sql/ — a database
    table/query drives ingest). Works with any DB-API 2.0 connection;
    column types come from an explicit map or default to string
    (mirroring the reference's column-type flags)."""

    def __init__(self, conn, query: str, id_col: Optional[str] = "id",
                 types: Optional[Dict[str, str]] = None,
                 batch_rows: int = 10_000):
        self._conn = conn
        self._query = query
        self._id_col = id_col
        self._types = {k.lower(): v.lower() for k, v in (types or {}).items()}
        self._batch = batch_rows
        cur = conn.cursor()
        cur.execute(query)
        self._cursor = cur
        self._cols = [d[0] for d in cur.description]

    def schema(self) -> List[Tuple[str, FieldOptions]]:
        out = []
        for c in self._cols:
            if c == self._id_col:
                continue
            t = self._types.get(c.lower(), "string")
            out.append((c, _SQL_TYPE_MAP.get(t,
                        FieldOptions(type=FieldType.MUTEX, keys=True))))
        return out

    def id_column(self) -> Optional[str]:
        return self._id_col

    def records(self) -> Iterator[Record]:
        while True:
            rows = self._cursor.fetchmany(self._batch)
            if not rows:
                return
            for row in rows:
                yield dict(zip(self._cols, row))


class KinesisSource(Source):
    """JSON records from a Kinesis stream (reference: idk/kinesis/).

    Takes an injected boto3-compatible client (``get_shard_iterator`` /
    ``get_records``); pass ``boto3.client("kinesis")`` in AWS
    environments. Without an injected client and without boto3,
    construction raises a clear error instead of importing lazily at
    first poll."""

    def __init__(self, stream: str, client=None,
                 schema: Optional[List[Tuple[str, FieldOptions]]] = None,
                 id_col: Optional[str] = "id",
                 iterator_type: str = "TRIM_HORIZON",
                 max_empty_polls: int = 1):
        if client is None:
            try:
                import boto3  # noqa: F401
            except ImportError as exc:
                raise RuntimeError(
                    "KinesisSource needs an injected client or boto3 "
                    "installed") from exc
            import boto3

            client = boto3.client("kinesis")
        self._client = client
        self._stream = stream
        self._schema = schema or []
        self._id_col = id_col
        self._iterator_type = iterator_type
        self._max_empty = max_empty_polls

    def schema(self) -> List[Tuple[str, FieldOptions]]:
        return self._schema

    def id_column(self) -> Optional[str]:
        return self._id_col

    def records(self) -> Iterator[Record]:
        desc = self._client.describe_stream(StreamName=self._stream)
        shards = [s["ShardId"]
                  for s in desc["StreamDescription"]["Shards"]]
        for shard_id in shards:
            it = self._client.get_shard_iterator(
                StreamName=self._stream, ShardId=shard_id,
                ShardIteratorType=self._iterator_type)["ShardIterator"]
            empty = 0
            while it and empty < self._max_empty:
                out = self._client.get_records(ShardIterator=it)
                recs = out.get("Records", [])
                if not recs:
                    empty += 1
                for r in recs:
                    data = r["Data"]
                    if isinstance(data, bytes):
                        data = data.decode()
                    yield json.loads(data)
                it = out.get("NextShardIterator")


# -- minimal Avro binary decoding --------------------------------------------

def _zigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _read_long(buf: bytes, i: int) -> Tuple[int, int]:
    shift, acc = 0, 0
    while True:
        b = buf[i]
        i += 1
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            return _zigzag(acc), i
        shift += 7


def _read_value(typ, buf: bytes, i: int) -> Tuple[Any, int]:
    if isinstance(typ, list):  # union: long index + value
        branch, i = _read_long(buf, i)
        return _read_value(typ[branch], buf, i)
    if isinstance(typ, dict):
        if typ.get("type") == "array":
            out = []
            while True:
                n, i = _read_long(buf, i)
                if n == 0:
                    return out, i
                if n < 0:  # block with byte size prefix
                    _, i = _read_long(buf, i)
                    n = -n
                for _ in range(n):
                    v, i = _read_value(typ["items"], buf, i)
                    out.append(v)
        typ = typ.get("type")
    if typ == "null":
        return None, i
    if typ == "boolean":
        return buf[i] != 0, i + 1
    if typ in ("int", "long"):
        return _read_long(buf, i)
    if typ == "float":
        return struct.unpack("<f", buf[i:i + 4])[0], i + 4
    if typ == "double":
        return struct.unpack("<d", buf[i:i + 8])[0], i + 8
    if typ in ("bytes", "string"):
        n, i = _read_long(buf, i)
        raw = buf[i:i + n]
        return (raw.decode() if typ == "string" else bytes(raw)), i + n
    raise ValueError(f"unsupported Avro type {typ!r}")


def avro_decode(schema: dict, payload: bytes) -> Dict[str, Any]:
    """Decode one Avro-binary record given its parsed schema (record of
    primitive / union-with-null / array-of-primitive fields)."""
    if schema.get("type") != "record":
        raise ValueError("top-level Avro schema must be a record")
    out: Dict[str, Any] = {}
    i = 0
    for f in schema["fields"]:
        out[f["name"]], i = _read_value(f["type"], payload, i)
    return out


_AVRO_FIELD_TYPES = {
    "int": FieldOptions(type=FieldType.INT),
    "long": FieldOptions(type=FieldType.INT),
    "float": FieldOptions(type=FieldType.DECIMAL, scale=4),
    "double": FieldOptions(type=FieldType.DECIMAL, scale=4),
    "string": FieldOptions(type=FieldType.MUTEX, keys=True),
    "boolean": FieldOptions(type=FieldType.BOOL),
}


def _avro_field_options(typ) -> FieldOptions:
    if isinstance(typ, list):  # union with null
        non_null = [t for t in typ if t != "null"]
        return _avro_field_options(non_null[0] if non_null else "string")
    if isinstance(typ, dict):
        if typ.get("type") == "array":
            inner = _avro_field_options(typ["items"])
            keys = inner.keys
            return FieldOptions(type=FieldType.SET, keys=keys)
        return _avro_field_options(typ.get("type"))
    return _AVRO_FIELD_TYPES.get(
        typ, FieldOptions(type=FieldType.MUTEX, keys=True))


class AvroSource(Source):
    """Avro-binary payloads with a schema-registry framing (reference:
    idk Avro support: Confluent wire format = magic 0x00 + 4-byte
    schema id + Avro binary). ``registry`` maps schema id -> parsed
    schema JSON; pass a dict (tests, static registries) or any object
    with ``__getitem__`` that fetches from a live registry."""

    MAGIC = 0

    def __init__(self, payloads: Sequence[bytes], registry,
                 id_col: Optional[str] = "id"):
        self._payloads = list(payloads)
        self._registry = registry
        self._id_col = id_col
        self._schema_cache: Dict[int, dict] = {}

    def _schema_for(self, sid: int) -> dict:
        if sid not in self._schema_cache:
            s = self._registry[sid]
            self._schema_cache[sid] = json.loads(s) if isinstance(s, str) \
                else s
        return self._schema_cache[sid]

    def schema(self) -> List[Tuple[str, FieldOptions]]:
        if not self._payloads:
            return []
        sid = int.from_bytes(self._payloads[0][1:5], "big")
        avro_schema = self._schema_for(sid)
        return [(f["name"], _avro_field_options(f["type"]))
                for f in avro_schema["fields"]
                if f["name"] != self._id_col]

    def id_column(self) -> Optional[str]:
        return self._id_col

    def records(self) -> Iterator[Record]:
        for p in self._payloads:
            if not p or p[0] != self.MAGIC:
                raise ValueError("bad schema-registry magic byte")
            sid = int.from_bytes(p[1:5], "big")
            yield avro_decode(self._schema_for(sid), p[5:])
