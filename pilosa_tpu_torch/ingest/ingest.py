"""Ingester driver: source -> schema sync -> batch -> import.

Port of ``pilosa_tpu/ingest/ingest.py``, without the device profiler's
parse and key-translate stages (``obs/devprof`` is not ported yet).

Reference: idk/ingest.go:59 (Main) — pulls records from a Source,
ensures the target index/fields exist (schema inference), assigns
auto-ids through the allocator when the source has no id column
(idk/idallocator.go), and feeds a Batch.
"""

from __future__ import annotations

import time
import uuid
from typing import Optional

import numpy as np

from pilosa_tpu_torch.core.schema import FieldType
from pilosa_tpu_torch.core.translate import bulk_translate_ids
from pilosa_tpu_torch.ingest.batch import Batch
from pilosa_tpu_torch.ingest.idalloc import IDAllocator
from pilosa_tpu_torch.ingest.source import Source, coerce_column
from pilosa_tpu_torch.obs import devprof
from pilosa_tpu_torch.obs import metrics as M


class Ingester:
    def __init__(self, api, index: str, source: Source,
                 batch_size: int = 65536, keys: bool = False,
                 allocator: Optional[IDAllocator] = None):
        self.api = api
        self.index = index
        self.source = source
        self.batch_size = batch_size
        self.keys = keys
        self.allocator = allocator or IDAllocator()

    def _ensure_schema(self) -> None:
        """Create index/fields to match the source schema (reference:
        idk/ingest.go batchFromSchema / field creation)."""
        holder = self.api.holder
        if self.index not in holder.indexes:
            self.api.create_index(self.index, {"keys": self.keys})
        idx = holder.index(self.index)
        created = False
        for name, opts in self.source.schema():
            if name not in idx.fields:
                idx.create_field(name, opts)
                created = True
        if created:
            # index-level create_field skips the API layer's schema.json
            # write; a crash mid-ingest would otherwise replay the WAL
            # into an index with no fields
            holder.save_schema()

    def run(self) -> int:
        """Ingest everything; returns record count (reference:
        idk/ingest.go:255 Main.Run)."""
        self._ensure_schema()
        if hasattr(self.source, "columns"):
            return self._run_columnar()
        id_col = self.source.id_column()
        batch = Batch(self.api, self.index, size=self.batch_size,
                      id_column=id_col or "__auto_id")
        session = uuid.uuid4().hex
        n = 0
        pending = []
        for rec in self.source.records():
            if id_col is None:
                pending.append(rec)
                if len(pending) >= self.batch_size:
                    n += self._flush_auto(batch, pending, session, n)
            else:
                batch.add(rec)
                n += 1
        if id_col is None and pending:
            n += self._flush_auto(batch, pending, session, n)
        batch.flush()
        self.allocator.commit(session)
        return n

    def _run_columnar(self) -> int:
        """Vectorized whole-column ingest (reference: batch/batch.go:459
        columnar accumulate + :860 bulk doTranslation): no per-record
        dicts — raw string columns become numpy id/row arrays, keys are
        translated in bulk per column, and each field gets ONE
        import_bits/set_values call with arrays. The per-record Batch
        path remains for record-stream sources (Kafka etc.)."""
        if devprof.ENABLED:
            # whole-column parse is the host-side front of the pipeline
            t0 = time.perf_counter()
            n, cols = self.source.columns()
            devprof.record_stage("parse", time.perf_counter() - t0, rows=n)
        else:
            n, cols = self.source.columns()
        idx = self.api.holder.index(self.index)
        id_col = self.source.id_column()
        # -- record ids: bulk-translate keys or parse ints ----------------
        if id_col is not None:
            _, raw_ids = cols.pop(id_col)
            if idx.options.keys:
                ids = self._translate_bulk(idx.translate, raw_ids)
            else:
                ids = np.asarray(raw_ids, dtype=np.int64)
        else:
            session = uuid.uuid4().hex
            rng = self.allocator.reserve(session, n, offset=0)
            ids = np.arange(rng.base, rng.base + n, dtype=np.int64)
            self.allocator.commit(session)
        imported = 0
        scope = devprof.ingest_scope() if devprof.ENABLED \
            else devprof.NULL_SCOPE
        with scope, self.api.txf.qcx():  # one group commit per load
            for name, (opts, raw) in cols.items():
                fld = idx.field(name)
                t = fld.options.type
                if t.is_bsi:
                    vals, valid = coerce_column(raw, fld.options)
                    if vals is None:  # timestamps etc: element-wise
                        pairs = [(c, _v) for c, _v in zip(ids, raw) if _v]
                        fld.set_values([c for c, _ in pairs],
                                       [v for _, v in pairs])
                        imported += len(pairs)
                        continue
                    sel = ids if valid is None else ids[valid]
                    vv = vals if valid is None else vals[valid]
                    fld.set_values(sel, vv)
                    imported += int(sel.size)
                    continue
                if fld.options.keys:
                    if t == FieldType.SET:
                        # split ';'-joined cells, then ONE translate round
                        parts: list = []
                        owners: list = []
                        for c, cell in zip(ids, raw):
                            if not cell:
                                continue
                            for part in str(cell).split(";"):
                                if part:
                                    parts.append(part)
                                    owners.append(int(c))
                        rows = self._translate_bulk(fld.translate, parts)
                        fld.import_bits(
                            rows, np.asarray(owners, dtype=np.int64))
                        imported += len(parts)
                        continue
                    arr = np.asarray(raw, dtype=object)
                    valid = arr != ""
                    rows = self._translate_bulk(
                        fld.translate, arr[valid].tolist())
                    sel = ids[valid]
                    fld.import_bits(rows, sel)
                    imported += int(sel.size)
                    continue
                vals, valid = coerce_column(raw, fld.options)
                if vals is None:  # ';'-joined set cells: expand per cell
                    rows_l, cols_l = [], []
                    for c, cell in zip(ids, raw):
                        if not cell:
                            continue
                        for part in str(cell).split(";"):
                            if not part:  # trailing/double ';'
                                continue
                            rows_l.append(int(part))
                            cols_l.append(int(c))
                    fld.import_bits(rows_l, cols_l)
                    imported += len(cols_l)
                    continue
                sel = ids if valid is None else ids[valid]
                vv = vals if valid is None else vals[valid]
                fld.import_bits(vv.astype(np.int64), sel)
                imported += int(sel.size)
            if idx.options.track_existence:
                idx.field("_exists").import_bits(
                    np.zeros(ids.size, dtype=np.int64), ids)
        M.REGISTRY.count(M.METRIC_IMPORTED, imported)
        return n

    @staticmethod
    def _translate_bulk(store, raw):
        """Bulk key->id translation (reference: batch.go:860
        doTranslation)."""
        if not devprof.ENABLED:
            return bulk_translate_ids(store, [str(k) for k in raw])
        t0 = time.perf_counter()
        out = bulk_translate_ids(store, [str(k) for k in raw])
        devprof.record_stage("key_translate", time.perf_counter() - t0,
                             rows=len(raw))
        return out

    def _flush_auto(self, batch: Batch, pending: list, session: str,
                    offset: int) -> int:
        """Assign a contiguous auto-id range to a pending chunk
        (reference: idk auto-id via /internal/idalloc reserve)."""
        rng = self.allocator.reserve(session, len(pending), offset=offset)
        for i, rec in enumerate(pending):
            rec["__auto_id"] = rng.base + i
            batch.add(rec)
        count = len(pending)
        pending.clear()
        return count
