"""HTTP client (reference: client/client.go — Client with query
execution, schema sync, and shard-aware imports client/importer.go).
Port of ``pilosa_tpu/client/client.py``.

Stdlib-only (urllib); Bearer-token support matches the server's auth
gate. Shard-aware imports group bits client-side by shard and post each
group through the shard-transactional roaring endpoint — one request
per (field, shard), the same wire path the reference's importer uses
(batch.go:753 Import -> /index/{i}/shard/{s}/import-roaring).
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Tuple

from pilosa_tpu_torch.client.orm import PQLQuery, Schema
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


class ClientError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class Client:
    def __init__(self, uri: str = "http://127.0.0.1:10101",
                 token: Optional[str] = None, timeout: float = 30.0):
        self.uri = uri.rstrip("/")
        self.token = token
        self.timeout = timeout

    # -- transport ---------------------------------------------------------

    def _request(self, method: str, path: str, body: Optional[bytes] = None,
                 ctype: str = "application/json") -> bytes:
        req = urllib.request.Request(self.uri + path, data=body,
                                     method=method)
        req.add_header("Content-Type", ctype)
        if self.token:
            req.add_header("Authorization", "Bearer " + self.token)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            raise ClientError(e.code, e.read().decode(errors="replace"))

    def _json(self, method: str, path: str,
              payload: Optional[dict] = None) -> dict:
        body = json.dumps(payload).encode() if payload is not None else b""
        return json.loads(self._request(method, path, body) or b"{}")

    # -- schema (reference: client.go Schema/SyncSchema) -------------------

    def schema(self) -> Schema:
        out = self._json("GET", "/schema")
        schema = Schema()
        for idx in out.get("indexes", []):
            i = schema.index(idx["name"],
                             keys=bool(idx.get("options", {}).get("keys")))
            for f in idx.get("fields", []):
                i.field(f["name"], **(f.get("options") or {}))
        return schema

    def sync_schema(self, schema: Schema) -> None:
        """Create any locally-declared indexes/fields missing on the
        server (reference: client.go SyncSchema)."""
        have = self._json("GET", "/schema").get("indexes", [])
        have_map = {i["name"]: {f["name"] for f in i.get("fields", [])}
                    for i in have}
        for idx in schema.indexes():
            if idx.name not in have_map:
                self._json("POST", f"/index/{idx.name}",
                           {"options": {"keys": idx.keys}})
                have_map[idx.name] = set()
            for f in idx.fields():
                if f.name not in have_map[idx.name]:
                    self._json("POST", f"/index/{idx.name}/field/{f.name}",
                               {"options": f.options})

    def create_index(self, name: str, keys: bool = False) -> None:
        self._json("POST", f"/index/{name}", {"options": {"keys": keys}})

    def delete_index(self, name: str) -> None:
        self._json("DELETE", f"/index/{name}")

    # -- queries -----------------------------------------------------------

    def query(self, q, index: Optional[str] = None) -> List[Any]:
        """Execute a PQL string or an ORM query; returns the parsed
        results list (reference: client.go Query)."""
        if isinstance(q, PQLQuery):
            index = q.index.name
            q = q.serialize()
        if index is None:
            raise ValueError("query(str) needs index=")
        out = json.loads(self._request(
            "POST", f"/index/{index}/query", q.encode(), "text/plain"))
        return out["results"]

    def sql(self, text: str) -> dict:
        return json.loads(self._request("POST", "/sql", text.encode(),
                                        "text/plain"))

    # -- imports (reference: client/importer.go shard-aware paths) ---------

    def import_bits(self, index: str, field: str,
                    bits: Sequence[Tuple[int, int]],
                    clear: bool = False, roaring: bool = True) -> None:
        """Import (row, column) bits. With roaring=True (default), bits
        group by shard client-side and each shard posts ONE
        pilosa-roaring blob to the shard-transactional endpoint — the
        reference importer's fast path; otherwise a single JSON import
        request carries everything."""
        if not roaring:
            rows = [r for r, _ in bits]
            cols = [c for _, c in bits]
            self._json("POST", f"/index/{index}/import",
                       {"field": field, "rows": rows, "cols": cols,
                        "clear": clear})
            return
        from pilosa_tpu_torch.storage.roaring import encode_positions

        by_shard: Dict[int, List[int]] = {}
        for row, col in bits:
            shard, pos = divmod(int(col), SHARD_WIDTH)
            by_shard.setdefault(shard, []).append(
                int(row) * SHARD_WIDTH + pos)
        for shard, positions in sorted(by_shard.items()):
            blob = encode_positions(sorted(positions))
            self._json(
                "POST", f"/index/{index}/shard/{shard}/import-roaring",
                {"field": field, "clear": clear,
                 "views": {"": base64.b64encode(blob).decode()}})

    def import_values(self, index: str, field: str,
                      values: Sequence[Tuple[int, int]]) -> None:
        """Import (column, value) pairs for a BSI field."""
        cols = [c for c, _ in values]
        vals = [v for _, v in values]
        self._json("POST", f"/index/{index}/import-values",
                   {"field": field, "cols": cols, "values": vals})

    def import_keyed_bits(self, index: str, field: str,
                          bits: Sequence[Tuple[str, str]]) -> None:
        """Keyed (rowKey, columnKey) import; translation happens
        server-side (reference: importer with key translation)."""
        self._json("POST", f"/index/{index}/import",
                   {"field": field, "rowKeys": [r for r, _ in bits],
                    "colKeys": [c for _, c in bits]})

    # -- ops ---------------------------------------------------------------

    def status(self) -> dict:
        return self._json("GET", "/status")

    def info(self) -> dict:
        return self._json("GET", "/info")
