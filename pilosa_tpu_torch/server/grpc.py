"""Pilosa gRPC service: QuerySQL/QueryPQL (streaming + unary) and index
CRUD. Port of ``pilosa_tpu/server/grpc.py``.

Reference: server/grpc.go:38 (grpcServer), :160-409 (the handlers), with
result marshaling per proto/interface.go (ToRowser/ToTabler). The
servicer here is transport-agnostic:

- :func:`serve_grpc` runs it on real grpcio when the package is present
  (runtime-gated: a machine without grpcio raises ``RuntimeError`` — the
  serializers are the hand-rolled wire codec in server/proto.py, no
  protoc/generated stubs needed);
- the stock HTTP server exposes the same methods with standard gRPC
  message framing (1-byte flag + 4-byte big-endian length + protobuf) at
  ``POST /grpc/pilosa.Pilosa/{Method}`` — a gRPC-Web-style mapping onto
  HTTP/1.1, byte-identical messages, grpc-status carried in headers.
"""

from __future__ import annotations

import time
from typing import Any, Iterator, List, Tuple

from pilosa_tpu_torch.server import proto

SERVICE = "pilosa.Pilosa"


class UnknownGRPCMethod(KeyError):
    """Distinguishes 'no such rpc' (UNIMPLEMENTED) from KeyErrors raised
    by the service logic (NOT_FOUND, e.g. a missing index)."""


def _sql_headers(schema) -> List[Tuple[str, str]]:
    return [(n, t) for n, t in schema]


def _pql_table(api, index: str, pql: str) -> Tuple[List[Tuple[str, str]],
                                                   List[List[Any]]]:
    """PQL results -> tabular rows (reference: proto/interface.go
    ToTabler implementations per result type)."""
    from pilosa_tpu_torch.pql import result as R

    results = api.query(index, pql)
    headers: List[Tuple[str, str]] = []
    rows: List[List[Any]] = []
    def _set_headers(h):
        nonlocal headers
        if headers and h != headers:
            raise ValueError(
                "QueryPQL over gRPC supports one result shape per "
                "request; split calls with different shapes")
        headers = h

    for r in results:
        if isinstance(r, R.RowResult):
            if r.keys is not None:
                _set_headers([("_id", "STRING")])
                rows += [[k] for k in r.keys]
            else:
                _set_headers([("_id", "ID")])
                rows += [[c] for c in r.columns]
        elif isinstance(r, R.PairsField):
            keyed = any(p.key is not None for p in r.pairs)
            _set_headers([(r.field, "STRING" if keyed else "ID"),
                          ("count", "INT")])
            rows += [[p.key if keyed else p.id, p.count] for p in r.pairs]
        elif isinstance(r, R.ValCount):
            _set_headers([("value", "INT"), ("count", "INT")])
            rows += [[r.val, r.count]]
        elif isinstance(r, (int, bool)):
            _set_headers([("result", "INT" if isinstance(r, int)
                           and not isinstance(r, bool) else "BOOL")])
            rows += [[r]]
        elif isinstance(r, list):  # GroupBy / Rows / Distinct
            if r and isinstance(r[0], R.GroupCount):
                gfields = [fr.field for fr in r[0].group]
                _set_headers([(f, "ID") for f in gfields]
                             + [("count", "INT")])
                for gc in r:
                    rows.append([fr.row_key if fr.row_key is not None
                                 else fr.row_id for fr in gc.group]
                                + [gc.count])
            else:
                _set_headers([("value", "INT")])
                rows += [[v] for v in r]
        else:
            _set_headers([("result", "STRING")])
            rows += [[str(r)]]
    return headers, rows


class PilosaServicer:
    """The service logic, independent of transport (reference:
    server/grpc.go method bodies)."""

    def __init__(self, api):
        self.api = api

    # -- queries -----------------------------------------------------------

    def query_sql_rows(self, sql: str, parsed=None) -> Iterator[bytes]:
        """QuerySQL: one RowResponse per row, headers on the first
        (reference: grpc.go:160 QuerySQL streaming contract)."""
        t0 = time.monotonic_ns()
        res = self.api.sql(sql, parsed=parsed)
        headers = _sql_headers(res.schema)
        types = [t for _, t in headers]
        first = True
        for row in res.data:
            yield proto.encode_row_response(
                headers if first else [], row, types,
                duration_ns=(time.monotonic_ns() - t0) if first else 0)
            first = False
        if first:  # no rows: still emit the headers
            yield proto.encode_row_response(
                headers, [], types, duration_ns=time.monotonic_ns() - t0)

    def query_sql_unary(self, sql: str, parsed=None) -> bytes:
        t0 = time.monotonic_ns()
        res = self.api.sql(sql, parsed=parsed)
        return proto.encode_table_response(
            _sql_headers(res.schema), res.data, time.monotonic_ns() - t0)

    def query_pql_rows(self, index: str, pql: str) -> Iterator[bytes]:
        t0 = time.monotonic_ns()
        headers, rows = _pql_table(self.api, index, pql)
        types = [t for _, t in headers]
        first = True
        for row in rows:
            yield proto.encode_row_response(
                headers if first else [], row, types,
                duration_ns=(time.monotonic_ns() - t0) if first else 0)
            first = False
        if first:
            yield proto.encode_row_response(
                headers, [], types, duration_ns=time.monotonic_ns() - t0)

    def query_pql_unary(self, index: str, pql: str) -> bytes:
        t0 = time.monotonic_ns()
        headers, rows = _pql_table(self.api, index, pql)
        return proto.encode_table_response(headers, rows,
                                           time.monotonic_ns() - t0)

    def inspect(self, req: dict) -> Iterator[bytes]:
        """Inspect: per-record field values for chosen columns
        (reference: grpc.go Inspect — an Extract over the given record
        ids/keys, optionally restricted to filterFields and/or filtered
        by a PQL row query)."""
        from pilosa_tpu_torch.core.schema import FieldType
        from pilosa_tpu_torch.pql.executor import has_write_calls
        from pilosa_tpu_torch.pql.parser import parse

        index = req["index"]
        idx = self.api.holder.index(index)
        known = {f.name for f in idx.public_fields()}
        for f in req["filterFields"]:
            # strict validation: field names are interpolated into PQL
            if f not in known:
                raise KeyError(f"unknown field {f!r}")
        fields = req["filterFields"] or sorted(known)
        if req["keys"]:
            cols = ", ".join(
                "'" + k.replace("\\", "\\\\").replace("'", "\\'") + "'"
                for k in req["keys"])
        else:
            cols = ", ".join(str(int(i)) for i in req["ids"])
        if req["query"]:
            q = parse(req["query"])
            if has_write_calls(q):
                raise ValueError("Inspect query must be read-only")
            target = req["query"]
            if cols:
                target = f"Intersect({target}, ConstRow(columns=[{cols}]))"
        else:
            target = f"ConstRow(columns=[{cols}])" if cols else "All()"
        rows_calls = "".join(f", Rows({f})" for f in fields)
        pql = f"Extract({target}{rows_calls})"
        table = self.api.query(index, pql)[0]
        ftypes = {f: idx.field(f).options for f in fields}
        headers = [("_id", "STRING" if idx.options.keys else "ID")]
        for ef in table.fields:
            fo = ftypes[ef.name]
            if fo.type == FieldType.DECIMAL:
                dt = f"DECIMAL({fo.scale})"
            else:
                dt = {"int": "INT", "bool": "BOOL",
                      "timestamp": "TIMESTAMP"}.get(
                    ef.type, "STRING" if fo.keys else "ID")
            headers.append((ef.name, dt))
        types = [t for _, t in headers]
        offset, limit = int(req["offset"]), int(req["limit"])
        out_cols = table.columns[offset:]
        if limit:
            out_cols = out_cols[:limit]
        scalar = {f: ftypes[f].type in (FieldType.MUTEX, FieldType.BOOL)
                  for f in fields}

        def conv(fname: str, v):
            if scalar[fname] and isinstance(v, list):
                v = v[0] if v else None
                if v is not None and ftypes[fname].type == FieldType.BOOL:
                    v = bool(v)
            return v

        first = True
        for col in out_cols:
            ident = col.key if col.key is not None else col.column
            row = [ident] + [conv(f, v)
                             for f, v in zip(fields, col.rows)]
            yield proto.encode_row_response(
                headers if first else [], row, types)
            first = False
        if first:
            yield proto.encode_row_response(headers, [], types)

    # -- index CRUD (reference: grpc.go CreateIndex/GetIndexes/...) --------

    def create_index(self, name: str, keys: bool) -> bytes:
        self.api.create_index(name, {"keys": keys})
        return b""

    def get_indexes(self) -> bytes:
        names = sorted(i["name"] if isinstance(i, dict) else i
                       for i in self.api.holder.indexes)
        return proto.encode_get_indexes_response(names)

    def get_index(self, name: str) -> bytes:
        if name not in self.api.holder.indexes:
            raise KeyError(name)
        return proto._len_field(1, proto._str_field(1, name))

    def delete_index(self, name: str) -> bytes:
        self.api.delete_index(name)
        return b""

    # -- framed dispatch (shared by HTTP fallback and tests) ---------------

    def call(self, method: str, request: bytes,
             parsed_sql=None) -> List[bytes]:
        """Execute one method on a decoded request; returns the response
        message(s) (one per stream element). ``parsed_sql`` reuses a
        statement the authed HTTP handler already parsed."""
        if method == "QuerySQL":
            req = proto.decode_query_sql_request(request)
            return list(self.query_sql_rows(req["sql"], parsed=parsed_sql))
        if method == "QuerySQLUnary":
            req = proto.decode_query_sql_request(request)
            return [self.query_sql_unary(req["sql"], parsed=parsed_sql)]
        if method == "QueryPQL":
            req = proto.decode_query_pql_request(request)
            return list(self.query_pql_rows(req["index"], req["pql"]))
        if method == "QueryPQLUnary":
            req = proto.decode_query_pql_request(request)
            return [self.query_pql_unary(req["index"], req["pql"])]
        if method == "CreateIndex":
            req = proto.decode_name_request(request)
            return [self.create_index(req["name"], req["keys"])]
        if method == "GetIndexes":
            return [self.get_indexes()]
        if method == "GetIndex":
            req = proto.decode_name_request(request)
            return [self.get_index(req["name"])]
        if method == "DeleteIndex":
            req = proto.decode_name_request(request)
            return [self.delete_index(req["name"])]
        if method == "Inspect":
            return list(self.inspect(proto.decode_inspect_request(request)))
        raise UnknownGRPCMethod(f"unknown gRPC method {method!r}")


# -- gRPC message framing (shared with HTTP fallback) -------------------------

def frame(message: bytes) -> bytes:
    """Standard gRPC length-prefixed framing."""
    return b"\x00" + len(message).to_bytes(4, "big") + message


def unframe(buf: bytes) -> List[bytes]:
    out = []
    i = 0
    while i < len(buf):
        if buf[i] != 0:
            raise ValueError("compressed gRPC frames not supported")
        n = int.from_bytes(buf[i + 1:i + 5], "big")
        out.append(buf[i + 5:i + 5 + n])
        i += 5 + n
    return out


_METHODS_STREAMING = {"QuerySQL", "QueryPQL", "Inspect"}


def serve_grpc(api, host: str = "127.0.0.1", port: int = 20101):
    """Run the servicer on real grpcio (runtime-gated: without grpcio
    this raises; the HTTP framing endpoint works everywhere). The generic method
    handlers use the wire codec directly, so no protoc stubs exist."""
    try:
        import grpc
    except ImportError as exc:  # pragma: no cover - env without grpcio
        raise RuntimeError(
            "grpcio is not installed in this environment; use the "
            "HTTP-framed endpoint POST /grpc/pilosa.Pilosa/{Method} "
            "(same messages, gRPC framing over HTTP/1.1)") from exc

    servicer = PilosaServicer(api)
    ident = lambda b: b  # raw bytes in/out; proto.py is the codec

    def unary(method):
        def h(request, context):
            return servicer.call(method, request)[0]
        return grpc.unary_unary_rpc_method_handler(
            h, request_deserializer=ident, response_serializer=ident)

    def streaming(method):
        def h(request, context):
            yield from servicer.call(method, request)
        return grpc.unary_stream_rpc_method_handler(
            h, request_deserializer=ident, response_serializer=ident)

    handlers = {}
    for m in ("QuerySQLUnary", "QueryPQLUnary", "CreateIndex",
              "GetIndexes", "GetIndex", "DeleteIndex"):
        handlers[m] = unary(m)
    for m in ("QuerySQL", "QueryPQL", "Inspect"):
        handlers[m] = streaming(m)
    from concurrent.futures import ThreadPoolExecutor

    server = grpc.server(ThreadPoolExecutor(max_workers=8))
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE, handlers),))
    server.add_insecure_port(f"{host}:{port}")
    server.start()
    return server
