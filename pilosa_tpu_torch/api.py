"""API facade: the programmatic surface over holder + executor.

Port of the core of ``pilosa_tpu/api.py`` (reference: api.go:209): create
indexes and fields (set, mutex, bool, time, int, decimal, timestamp; a
``time`` field's ``timeQuantum`` is validated as in the JAX package),
bulk-import bits (by row id or row key) and BSI values (by column id or
key), keeping
the ``_exists`` field up to date, ingest and read dataframe changesets,
and run PQL reads and writes (a query with write calls, and a dataframe
changeset, runs as one write request, ``storage/txn.py``). Reads may go
through the micro-batching scheduler (``enable_scheduler``, ``sched/``)
and the version-keyed result cache (``enable_cache``, ``cache/``).
``API()`` runs on the card, ``cuda:0``; ``API(device="cpu")`` runs every
kernel's plain PyTorch version on the CPU. Without a card, ``API()``
raises.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from pilosa_tpu_torch import platform
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import EXISTENCE_FIELD, Index
from pilosa_tpu_torch.core.schema import FieldOptions, FieldType, IndexOptions
from pilosa_tpu_torch.core.translate import bulk_translate_ids
from pilosa_tpu_torch.obs import metrics as M
from pilosa_tpu_torch.obs.tracing import get_tracer
from pilosa_tpu_torch.pql.executor import Executor, has_write_calls
from pilosa_tpu_torch.pql.parser import parse
from pilosa_tpu_torch.storage.txn import write_qcx


class API:
    def __init__(self, device: platform.DeviceLike = None):
        self.device = platform.resolve_device(device)
        self.holder = Holder(self.device)
        self.executor = Executor(self.holder)
        # optional serving layers; None keeps the read path direct
        self.scheduler = None
        self.cache = None

    # -- schema (reference: api.go CreateIndex/CreateField) -----------------

    def create_index(self, name: str, options: Optional[dict] = None) -> Index:
        opts = IndexOptions(
            keys=bool((options or {}).get("keys", False)),
            track_existence=bool((options or {}).get("trackExistence", True)),
        )
        return self.holder.create_index(name, opts)

    def create_field(self, index: str, field: str,
                     options: Optional[dict] = None) -> None:
        o = dict(options or {})
        fo = FieldOptions(
            type=FieldType(o.pop("type", "set")),
            keys=bool(o.pop("keys", False)),
            min=o.pop("min", None),
            max=o.pop("max", None),
            base=int(o.pop("base", 0)),
            scale=int(o.pop("scale", 0)),
            time_unit=o.pop("timeUnit", "s"),
            time_quantum=o.pop("timeQuantum", ""),
            cache_type=o.pop("cacheType", "ranked"),
            cache_size=int(o.pop("cacheSize", 50000)),
        )
        if o:
            raise ValueError(f"not ported yet: field options {sorted(o)}")
        self.holder.index(index).create_field(field, fo)

    # -- scheduler (sched/: admission + micro-batching) --------------------

    def enable_scheduler(self, config=None, **overrides):
        """Route concurrent reads through a micro-batching scheduler
        (amortizes the per-dispatch host cost and wait). ``config`` is a
        pilosa_tpu_torch.config.Config; kwargs override individual knobs
        (window_ms, max_batch, max_queue, default_deadline_ms,
        fuse_waste_ratio, adaptive_window, window_min_ms, window_max_ms,
        clock, registry)."""
        from pilosa_tpu_torch.sched import QueryScheduler

        if self.scheduler is not None:
            self.disable_scheduler()
        if config is not None:
            self.scheduler = QueryScheduler.from_config(
                self.executor, config, **overrides)
        else:
            self.scheduler = QueryScheduler(self.executor, **overrides)
        return self.scheduler

    def disable_scheduler(self) -> None:
        sched, self.scheduler = self.scheduler, None
        if sched is not None:
            sched.close()

    def read_executor(self):
        """The executor read-only callers should use: the scheduling
        facade when enabled, the raw executor otherwise."""
        if self.scheduler is not None:
            return self.scheduler.as_executor()
        return self.executor

    # -- result cache (cache/: version-keyed + single-flight) --------------

    def enable_cache(self, config=None, **overrides):
        """Cache read results keyed on (index, PQL, shard set, fragment
        versions): repeated reads of unchanged data launch nothing, and
        identical in-flight reads share one dispatch. ``config`` is a
        pilosa_tpu_torch.config.Config; kwargs override individual knobs
        (max_bytes, max_entries, ttl_ms, registry, clock). Attaching to
        the executor covers both the direct and the scheduled read path
        (the scheduler consults executor.cache on admission)."""
        from pilosa_tpu_torch.cache import ResultCache

        self.cache = ResultCache.from_config(config, **overrides)
        self.executor.cache = self.cache
        return self.cache

    def disable_cache(self) -> None:
        self.cache = None
        self.executor.cache = None

    # -- query (reference: api.go:209 Query) -------------------------------

    def query(self, index: str, pql: str,
              shards: Optional[Sequence[int]] = None,
              priority: Optional[str] = None,
              deadline_ms: Optional[float] = None) -> List[Any]:
        """Run a PQL query under a ``query.pql`` trace span. One with
        write calls is a write request: it holds the holder's write lock,
        and the stacks it builds or advances are not published to
        lock-free readers. A read takes no lock; with the scheduler on it
        is admitted with ``priority`` and ``deadline_ms`` and may share a
        fused dispatch with concurrent reads."""
        M.REGISTRY.count(M.METRIC_PQL_QUERIES)
        with get_tracer().start_trace("query.pql", index=index):
            parsed = parse(pql) if isinstance(pql, str) else pql
            sched = self.scheduler
            if has_write_calls(parsed):
                with write_qcx(self.holder):
                    return self.executor.execute(index, parsed,
                                                 shards=shards)
            if sched is not None:
                kw = {}
                if priority is not None:
                    kw["priority"] = priority
                if deadline_ms is not None:
                    kw["deadline_ms"] = deadline_ms
                return sched.execute(index, parsed, shards=shards, **kw)
            return self.executor.execute(index, parsed, shards=shards)

    # -- bulk import (reference: api.go:1438 Import) -------------------------

    def import_bits(self, index: str, field: str,
                    rows: Sequence[int] = (),
                    cols: Optional[Sequence[int]] = None,
                    row_keys: Optional[Sequence[str]] = None,
                    col_keys: Optional[Sequence[str]] = None) -> int:
        """Bulk (row, col) import, translating keys when given; marks
        every column in ``_exists`` when the index tracks existence."""
        idx = self.holder.index(index)
        fld = idx.field(field)
        if row_keys is not None:
            if fld.translate is None:
                raise ValueError(f"field {field!r} does not use string keys")
            rows = bulk_translate_ids(fld.translate, row_keys)
        if col_keys is not None:
            if idx.translate is None:
                raise ValueError(f"index {index!r} does not use string keys")
            cols = bulk_translate_ids(idx.translate, col_keys)
        if cols is None or len(rows) != len(cols):
            raise ValueError("rows and cols must be the same length")
        with self.holder.write_lock:
            changed = fld.import_bits(rows, cols)
            self._mark_exists(idx, cols)
        return changed

    def import_values(self, index: str, field: str,
                      cols: Optional[Sequence[int]] = None,
                      values: Sequence = (),
                      col_keys: Optional[Sequence[str]] = None) -> int:
        """Bulk BSI import of external values (reference: api.go
        ImportValue -> fragment.importValue): later duplicates of a column
        win; returns the number of values written."""
        idx = self.holder.index(index)
        fld = idx.field(field)
        if not fld.options.type.is_bsi:
            raise ValueError(f"field {field!r} is not an int-like field")
        if col_keys is not None:
            if idx.translate is None:
                raise ValueError(f"index {index!r} does not use string keys")
            cols = bulk_translate_ids(idx.translate, col_keys)
        if cols is None or len(cols) != len(values):
            raise ValueError("cols and values must be the same length")
        cols = np.asarray(cols, dtype=np.int64)
        with self.holder.write_lock:
            fld.set_values(cols, values)
            self._mark_exists(idx, cols)
        return len(cols)

    @staticmethod
    def _mark_exists(idx: Index, cols) -> None:
        if idx.options.track_existence:
            idx.field(EXISTENCE_FIELD).import_bits(
                np.zeros(len(cols), dtype=np.int64), cols)

    # -- dataframe (reference: apply.go ingest, http_handler.go:506-509) --

    def import_dataframe(self, index: str, shard: int,
                         shard_ids: Sequence[int],
                         columns: Dict[str, Sequence]) -> None:
        """Apply a columnar changeset to one shard's frame (reference:
        apply.go:400 ShardFile.Process)."""
        idx = self.holder.index(index)
        with write_qcx(self.holder):
            idx.dataframe.apply_changeset(shard, shard_ids, columns)

    def dataframe_schema(self, index: str) -> List[dict]:
        return self.holder.index(index).dataframe.schema()

    def dataframe_shard(self, index: str, shard: int) -> dict:
        """Raw frame contents for one shard (reference: handleGetDataframe)."""
        frame = self.holder.index(index).dataframe.frames.get(shard)
        if frame is None:
            return {"shard": shard, "columns": {}}
        out = {}
        for name, col in frame.columns.items():
            pos = np.nonzero(frame.valid[name])[0]
            vals = col[pos]
            out[name] = {
                "positions": [int(p) for p in pos],
                "values": [int(v) if col.dtype.kind == "i" else float(v)
                           for v in vals],
            }
        return {"shard": shard, "columns": out}

    def delete_dataframe(self, index: str) -> None:
        with write_qcx(self.holder):
            self.holder.index(index).dataframe.delete()
