"""Client-side columnar batcher.

Port of ``pilosa_tpu/ingest/batch.py``, without the device profiler's
ingest stages (``obs/devprof`` is not ported yet).

Reference: batch/batch.go:99 (Batch) — accumulate records, do ONE bulk
key-translation round per flush (batch.go:860 doTranslation), convert to
per-shard columnar buffers, and hand the whole batch to the import API
(batch.go:753 Import). Bulk translation + shard-grouped imports are what
keep the device fed: one ``set_many``/``set_values`` per (field, shard),
and so one ``scatter_merge`` launch per bulk call, instead of per-record
writes.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

from pilosa_tpu_torch.core.schema import FieldType
from pilosa_tpu_torch.obs import devprof


class Batch:
    """Accumulates up to ``size`` records for one index, then imports.

    ``add({"<idcol>": id_or_key, field: value, ...})`` — value conventions
    follow the reference's batch: scalar for mutex/bool/BSI fields, list
    for set fields, None skips.
    """

    def __init__(self, api, index: str, size: int = 65536,
                 id_column: str = "id"):
        self.api = api
        self.index = index
        self.size = size
        self.id_column = id_column
        self._idx = api.holder.index(index)
        self._records: List[Dict[str, Any]] = []
        self.imported = 0

    def __len__(self) -> int:
        return len(self._records)

    def add(self, record: Dict[str, Any]) -> bool:
        """Add a record; flushes automatically when full. Returns True if
        a flush happened (reference: batch.Add returns ErrBatchNowFull)."""
        if self.id_column not in record:
            raise ValueError(f"record missing id column {self.id_column!r}")
        self._records.append(record)
        if len(self._records) >= self.size:
            self.flush()
            return True
        return False

    # -- flush = translate + columnarize + import ---------------------------

    def flush(self) -> int:
        if not self._records:
            return 0
        n = len(self._records)
        scope = devprof.ingest_scope() if devprof.ENABLED \
            else devprof.NULL_SCOPE
        with scope, self.api.txf.qcx():  # one group commit per flush
            ids = self._translate_ids()
            self._import_fields(ids)
            if self._idx.options.track_existence:
                # Field-level so the bits are WAL-logged — a record whose
                # non-id fields are all None is marked existing ONLY here,
                # and must survive crash recovery like any other write.
                self._idx.field("_exists").import_bits([0] * len(ids), ids)
        self._records.clear()
        self.imported += n
        return n

    def _translate_ids(self) -> List[int]:
        """One bulk key-translation round for record ids (reference:
        batch.go:860 doTranslation)."""
        raw = [r[self.id_column] for r in self._records]
        if self._idx.options.keys:
            keys = [str(v) for v in raw]
            if not devprof.ENABLED:
                m = self._idx.translate.create_keys(keys)
                return [m[k] for k in keys]
            t0 = time.perf_counter()
            m = self._idx.translate.create_keys(keys)
            devprof.record_stage("key_translate",
                                 time.perf_counter() - t0, rows=len(keys))
            return [m[k] for k in keys]
        return [int(v) for v in raw]

    def _import_fields(self, ids: List[int]) -> None:
        # column-major: gather per-field, translate row keys in bulk, then
        # one import call per field (which shard-groups internally)
        fields: Dict[str, List[Tuple[int, Any]]] = {}
        for col, rec in zip(ids, self._records):
            for fname, v in rec.items():
                if fname == self.id_column or v is None:
                    continue
                fields.setdefault(fname, []).append((col, v))
        for fname, pairs in fields.items():
            fld = self._idx.field(fname)
            t = fld.options.type
            if t.is_bsi:
                cols = [c for c, _ in pairs]
                vals = [v for _, v in pairs]
                self.api.import_values(self.index, fname, cols=cols,
                                       values=vals)
                continue
            rows: List[Any] = []
            cols = []
            for c, v in pairs:
                items = v if isinstance(v, list) else [v]
                for item in items:
                    rows.append(item)
                    cols.append(c)
            if t == FieldType.BOOL:
                rows = [1 if bool(r) else 0 for r in rows]
                self.api.import_bits(self.index, fname, rows=rows, cols=cols)
            elif fld.options.keys:
                self.api.import_bits(self.index, fname, rows=[],
                                     cols=cols, row_keys=[str(r) for r in rows])
            else:
                self.api.import_bits(self.index, fname,
                                     rows=[int(r) for r in rows], cols=cols)
