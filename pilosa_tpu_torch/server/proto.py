"""Minimal protobuf wire codec for the Pilosa gRPC service.

Port of ``pilosa_tpu/server/proto.py``: its encodings are the JAX
package's bytes.

Clean-room implementation of the public protobuf wire format (varints +
tag/length-delimited fields); the message shapes and field numbers
mirror the reference's proto/pilosa.proto so reference gRPC clients
decode the responses byte-compatibly (format-spec parity, like the
roaring wire codec in storage/roaring.py).

Messages (proto/pilosa.proto): QueryPQLRequest{index=1,pql=2},
QuerySQLRequest{sql=1}, StatusError{Code=1,Message=2},
ColumnInfo{name=1,datatype=2}, ColumnResponse oneof{string=1,uint64=2,
int64=3,bool=4,blob=5,uint64Array=6,stringArray=7,float64=8,decimal=9,
timestamp=10}, Decimal{value=1,scale=2}, Row{columns=1},
RowResponse{headers=1,columns=2,StatusError=3,duration=4},
TableResponse{headers=1,rows=2,StatusError=3,duration=4},
Index{name=1}, CreateIndexRequest{name=1,keys=2},
GetIndexesResponse{indexes=1}, DeleteIndexRequest{name=1}.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

_VARINT = 0
_I64 = 1
_LEN = 2
_I32 = 5


def _encode_varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _decode_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    out = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _tag(field: int, wt: int) -> bytes:
    return _encode_varint((field << 3) | wt)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, _LEN) + _encode_varint(len(payload)) + payload


def _str_field(field: int, s: str) -> bytes:
    return _len_field(field, s.encode()) if s else b""


def _varint_field(field: int, v: int) -> bytes:
    return (_tag(field, _VARINT) + _encode_varint(v)) if v else b""


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """(field number, wire type, raw value) over a message's fields."""
    i = 0
    while i < len(buf):
        key, i = _decode_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == _VARINT:
            v, i = _decode_varint(buf, i)
        elif wt == _LEN:
            n, i = _decode_varint(buf, i)
            v = buf[i:i + n]
            i += n
        elif wt == _I64:
            v = struct.unpack("<q", buf[i:i + 8])[0]
            i += 8
        elif wt == _I32:
            v = struct.unpack("<i", buf[i:i + 4])[0]
            i += 4
        else:
            raise ValueError(f"bad wire type {wt}")
        yield field, wt, v


# -- requests (decode) --------------------------------------------------------

def decode_query_pql_request(buf: bytes) -> Dict[str, str]:
    out = {"index": "", "pql": ""}
    for field, _, v in iter_fields(buf):
        if field == 1:
            out["index"] = v.decode()
        elif field == 2:
            out["pql"] = v.decode()
    return out


def decode_query_sql_request(buf: bytes) -> Dict[str, str]:
    out = {"sql": ""}
    for field, _, v in iter_fields(buf):
        if field == 1:
            out["sql"] = v.decode()
    return out


def decode_name_request(buf: bytes) -> Dict[str, Any]:
    """CreateIndexRequest / GetIndexRequest / DeleteIndexRequest."""
    out = {"name": "", "keys": False}
    for field, _, v in iter_fields(buf):
        if field == 1:
            out["name"] = v.decode()
        elif field == 2:
            out["keys"] = bool(v)
    return out


def decode_inspect_request(buf: bytes) -> Dict[str, Any]:
    """InspectRequest{index=1, columns(IdsOrKeys)=2, filterFields=3,
    limit=4, offset=5, query=6}."""
    out: Dict[str, Any] = {"index": "", "ids": [], "keys": [],
                           "filterFields": [], "limit": 0, "offset": 0,
                           "query": ""}
    for field, _, v in iter_fields(buf):
        if field == 1:
            out["index"] = v.decode()
        elif field == 2:
            for f2, _, v2 in iter_fields(v):
                for f3, wt3, v3 in iter_fields(v2):
                    if f3 != 1:
                        continue
                    if f2 == 1:
                        if wt3 == _LEN:  # packed (proto3 default)
                            j = 0
                            while j < len(v3):
                                val, j = _decode_varint(v3, j)
                                out["ids"].append(val)
                        else:
                            out["ids"].append(v3)
                    elif f2 == 2:
                        out["keys"].append(v3.decode())
        elif field == 3:
            out["filterFields"].append(v.decode())
        elif field == 4:
            out["limit"] = v
        elif field == 5:
            out["offset"] = v
        elif field == 6:
            out["query"] = v.decode()
    return out


# -- responses (encode) -------------------------------------------------------

def encode_column_info(name: str, datatype: str) -> bytes:
    return _str_field(1, name) + _str_field(2, datatype)


def encode_decimal(value: int, scale: int) -> bytes:
    return _varint_field(1, value & ((1 << 64) - 1)) + \
        _varint_field(2, scale)


def encode_column_response(value: Any, datatype: str) -> bytes:
    """One ColumnResponse with the oneof member matching the SQL type
    (reference: proto/interface.go ToRowser value mapping)."""
    if value is None:
        return b""  # unset oneof = NULL
    if datatype.startswith("DECIMAL"):
        scale = 2
        if "(" in datatype:
            scale = int(datatype.split("(")[1].rstrip(")"))
        return _len_field(9, encode_decimal(round(value * 10 ** scale),
                                            scale))
    if isinstance(value, bool):
        return _varint_field(4, 1 if value else 0) or \
            _tag(4, _VARINT) + _encode_varint(0)
    if isinstance(value, int):
        if datatype in ("ID",):
            return _tag(2, _VARINT) + _encode_varint(value)
        return _tag(3, _VARINT) + _encode_varint(value & ((1 << 64) - 1))
    if isinstance(value, float):
        return _tag(8, _I64) + struct.pack("<d", value)
    if isinstance(value, str):
        # oneof members must encode even when empty ('' != NULL)
        field = 10 if datatype == "TIMESTAMP" else 1
        return _len_field(field, value.encode())
    if isinstance(value, (list, tuple)):
        if all(isinstance(x, int) for x in value):
            inner = b"".join(_tag(1, _VARINT) + _encode_varint(x)
                             for x in value)
            return _len_field(6, inner)
        inner = b"".join(_len_field(1, str(x).encode()) for x in value)
        return _len_field(7, inner)
    if isinstance(value, bytes):
        return _len_field(5, value)
    return _str_field(1, str(value))


def encode_row_response(headers: List[Tuple[str, str]], row: List[Any],
                        types: Optional[List[str]] = None,
                        duration_ns: int = 0) -> bytes:
    """``headers`` ride only the FIRST message of a stream; ``types``
    always carries the column datatypes for value encoding."""
    if types is None:
        types = [t for _, t in headers]
    out = b"".join(_len_field(1, encode_column_info(n, t))
                   for n, t in headers)
    for t, v in zip(types, row):
        out += _len_field(2, encode_column_response(v, t))
    if duration_ns:
        out += _varint_field(4, duration_ns)
    return out


def encode_table_response(headers: List[Tuple[str, str]],
                          rows: List[List[Any]],
                          duration_ns: int = 0) -> bytes:
    out = b"".join(_len_field(1, encode_column_info(n, t))
                   for n, t in headers)
    for row in rows:
        inner = b"".join(
            _len_field(1, encode_column_response(v, t))
            for (name, t), v in zip(headers, row))
        out += _len_field(2, inner)
    if duration_ns:
        out += _varint_field(4, duration_ns)
    return out


def encode_get_indexes_response(names: List[str]) -> bytes:
    return b"".join(_len_field(1, _str_field(1, n)) for n in names)


def decode_table_response(buf: bytes) -> Tuple[List[Tuple[str, str]],
                                               List[List[Any]]]:
    """Decoder for round-trip tests (and Python clients)."""
    headers: List[Tuple[str, str]] = []
    rows: List[List[Any]] = []
    for field, _, v in iter_fields(buf):
        if field == 1:
            name, dt = "", ""
            for f2, _, v2 in iter_fields(v):
                if f2 == 1:
                    name = v2.decode()
                elif f2 == 2:
                    dt = v2.decode()
            headers.append((name, dt))
        elif field == 2:
            row: List[Any] = []
            for f2, _, v2 in iter_fields(v):
                if f2 == 1:
                    row.append(decode_column_response(v2))
            rows.append(row)
    return headers, rows


def decode_row_response(buf: bytes) -> Tuple[List[Tuple[str, str]],
                                             List[Any]]:
    headers: List[Tuple[str, str]] = []
    row: List[Any] = []
    for field, _, v in iter_fields(buf):
        if field == 1:
            name, dt = "", ""
            for f2, _, v2 in iter_fields(v):
                if f2 == 1:
                    name = v2.decode()
                elif f2 == 2:
                    dt = v2.decode()
            headers.append((name, dt))
        elif field == 2:
            row.append(decode_column_response(v))
    return headers, row


def decode_column_response(buf: bytes) -> Any:
    for field, wt, v in iter_fields(buf):
        if field == 1 or field == 10:
            return v.decode()
        if field == 2:
            return v
        if field == 3:
            return _signed64(v)
        if field == 4:
            return bool(v)
        if field == 5:
            return bytes(v)
        if field == 6:
            return [x for f2, _, x in iter_fields(v) if f2 == 1]
        if field == 7:
            return [x.decode() for f2, _, x in iter_fields(v) if f2 == 1]
        if field == 8:
            return struct.unpack("<d", struct.pack("<q", v))[0]
        if field == 9:
            val, scale = 0, 0
            for f2, _, x in iter_fields(v):
                if f2 == 1:
                    val = _signed64(x)
                elif f2 == 2:
                    scale = x
            return val / 10 ** scale
    return None
