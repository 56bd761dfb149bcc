"""API facade: the programmatic surface over holder + executor.

Port of ``pilosa_tpu/api.py`` (reference: api.go:209): create and delete
indexes and fields (set, mutex, bool, time, int, decimal, timestamp; a
``time`` field's ``timeQuantum`` is validated as in the JAX package),
bulk-import bits (by row id or row key, or as roaring blobs) and BSI
values (by column id or key), keeping the ``_exists`` field up to date,
ingest and read dataframe changesets, run PQL reads and writes (JSON
results and a profiled span tree from ``query_json``) and SQL statements
(``sql``, over ``sql/``), each recorded in the query-history ring
(``history``) and, when ``set_query_logger`` names a file, the query
log; and back up,
restore and checksum the holder. Every write runs as one write request
(``storage/txn.py``): with a data directory, ``API(path)`` logs it to
the WAL and group-commits it when the request finishes, and opening
``API(path)`` recovers the last checkpoint and the WAL tail — the JAX
package's data directory layout, so either package recovers the
other's. Reads may go through the micro-batching scheduler
(``enable_scheduler``, ``sched/``) and the version-keyed result cache
(``enable_cache``, ``cache/``); ``enable_stream`` attaches the pipelined
streaming ingester (``stream/``) and ``enable_health`` the health plane
(``obs/health.py``: timeline, SLOs, flight recorder), which every
query, SQL statement and bulk import then feeds. ``API()`` runs on the
card, ``cuda:0``;
``API(device="cpu")`` runs every kernel's plain PyTorch version on the
CPU. Without a card, ``API()`` raises.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tarfile
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from pilosa_tpu_torch import platform
from pilosa_tpu_torch.config import env_bool
from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.core.fragment import group_sorted
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import EXISTENCE_FIELD, Index
from pilosa_tpu_torch.core.schema import FieldOptions, FieldType, IndexOptions
from pilosa_tpu_torch.core.translate import bulk_translate_ids
from pilosa_tpu_torch.ingest.idalloc import IDAllocator
from pilosa_tpu_torch.obs import metrics as M
from pilosa_tpu_torch.obs.history import ExecutionRequestsAPI
from pilosa_tpu_torch.obs.tracing import get_tracer
from pilosa_tpu_torch.ops.bitmap import bits_to_plane
from pilosa_tpu_torch.pql.executor import Executor, has_write_calls
from pilosa_tpu_torch.pql.parser import parse
from pilosa_tpu_torch.pql.result import result_to_json
from pilosa_tpu_torch.shardwidth import (SHARD_WIDTH, SHARD_WIDTH_EXP,
                                         WORDS_PER_SHARD)
from pilosa_tpu_torch.storage.roaring import decode_to_positions
from pilosa_tpu_torch.storage.store import export_holder, save_holder_data
from pilosa_tpu_torch.storage.txn import TxFactory
from pilosa_tpu_torch.transaction import TransactionManager

_NULL_SCOPE = contextlib.nullcontext()


@contextlib.contextmanager
def _slo_scope(hp, surface: str):
    """One request of ``surface`` into the health plane's SLO tracker,
    an error when the body raises."""
    t0 = time.monotonic()
    try:
        yield
    except Exception:
        hp.record(surface, time.monotonic() - t0, error=True)
        raise
    hp.record(surface, time.monotonic() - t0)


class API:
    def __init__(self, path: Optional[str] = None, wal_sync: str = "batch",
                 segment_bytes: Optional[int] = None,
                 device: platform.DeviceLike = None):
        self.device = platform.resolve_device(device)
        self.holder = Holder(self.device, path, wal_sync=wal_sync,
                             segment_bytes=segment_bytes)
        self.executor = Executor(self.holder)
        self.txf = TxFactory(self.holder)
        # query history (reference: tracker.go), cluster transactions
        # (reference: transaction.go) and the auto-ID reservation service
        # (reference: idalloc.go)
        self.history = ExecutionRequestsAPI()
        self.transactions = TransactionManager()
        self.idalloc = IDAllocator(
            os.path.join(path, "idalloc.jsonl") if path else None)
        self._sql_engine = None
        # optional serving layers; None keeps the read path direct
        self.scheduler = None
        self.cache = None
        # optional structured query log (reference: server.go:792);
        # set via set_query_logger
        self.query_logger = None
        # optional streaming ingest service (stream/): in-process broker
        # topic + pipelined exactly-once ingester; enable_stream
        self.stream = None
        # optional health plane (obs/health.py): timeline sampler + SLO
        # burn tracking + flight recorder. None = the query and import
        # paths pay one attribute check.
        self.health = None
        # the tenant registry and the degradation ladder are not ported;
        # the health plane's ``tenants`` / ``degrade`` probes read these
        # and report ``{"enabled": false}``
        self.tenants = None
        self.degrade = None
        if path:
            # checkpoint load + WAL replay (reference: rbf/db.go open)
            self.holder.recover()
        if env_bool("PILOSA_TPU_OBS_TIMELINE"):
            # zero-thread mode: sampling piggybacks on request
            # accounting, so a whole test run can hold the plane live
            # and leak no threads
            self.enable_health(
                interval_ms=float(os.environ.get(
                    "PILOSA_TPU_OBS_TIMELINE_INTERVAL_MS", "1000")),
                start=False)

    def set_query_logger(self, path: str) -> None:
        from pilosa_tpu_torch.obs.logger import QueryLogger

        self.query_logger = QueryLogger(path)

    # -- schema (reference: api.go CreateIndex/CreateField/Schema) ---------

    def create_index(self, name: str, options: Optional[dict] = None) -> Index:
        opts = IndexOptions(
            keys=bool((options or {}).get("keys", False)),
            track_existence=bool((options or {}).get("trackExistence", True)),
        )
        idx = self.holder.create_index(name, opts)
        M.REGISTRY.count(M.METRIC_CREATE_INDEX)
        return idx

    def delete_index(self, name: str) -> None:
        self.holder.delete_index(name)
        M.REGISTRY.count(M.METRIC_DELETE_INDEX)

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
            ttl_seconds=int(o.pop("ttl", 0)),
            cache_type=o.pop("cacheType", "ranked"),
            cache_size=int(o.pop("cacheSize", 50000)),
        )
        if o:
            raise ValueError(f"not ported yet: field options {sorted(o)}")
        self.holder.index(index).create_field(field, fo)
        M.REGISTRY.count(M.METRIC_CREATE_FIELD)
        self.holder.save_schema()

    def delete_field(self, index: str, field: str) -> None:
        with self.txf.qcx():  # flushes the delete_field WAL tombstone
            self.holder.index(index).delete_field(field)
        M.REGISTRY.count(M.METRIC_DELETE_FIELD)
        self.holder.save_schema()

    def schema(self) -> List[dict]:
        return self.holder.schema()

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

    # -- health plane (obs/: timeline + SLO + flight recorder) -------------

    def enable_health(self, config=None, start: bool = False, **overrides):
        """Attach the health plane: a timeline ring sampling the metrics
        registry + live probes, per-surface SLO burn tracking, and the
        anomaly-triggered flight recorder. ``config`` is a
        pilosa_tpu_torch.config.Config ([obs.timeline]); kwargs override
        individual HealthPlane knobs (interval_ms, capacity, clock,
        objectives, fast_burn_alert, dump_dir, ...). ``start=True`` runs
        the sampler on a daemon thread; otherwise sampling piggybacks on
        request accounting (deterministic under an injected clock)."""
        from pilosa_tpu_torch.obs.health import HealthPlane

        if self.health is not None:
            self.disable_health()
        self.health = HealthPlane.from_config(config, **overrides)
        self.health.attach_api(self)
        if config is not None and config.obs_timeline_exemplars \
                and not M.REGISTRY.exemplars:
            M.REGISTRY.exemplars = True
            self._health_set_exemplars = True
        if start:
            self.health.start()
        return self.health

    def disable_health(self) -> None:
        """Detach the plane; a running sampler thread is joined."""
        hp, self.health = self.health, None
        if hp is not None:
            hp.stop()
        if getattr(self, "_health_set_exemplars", False):
            M.REGISTRY.exemplars = False
            self._health_set_exemplars = False

    def _ingest_slo(self):
        """SLO accounting scope for the bulk-import surface (the shared
        no-op when the health plane is off)."""
        hp = self.health
        if hp is None:
            return _NULL_SCOPE
        return _slo_scope(hp, "ingest")

    # -- streaming ingest (stream/: broker + pipelined ingester) -----------

    def enable_stream(self, index: str, config=None, **overrides):
        """Attach the continuous-ingest service for ``index``: an
        in-process Kafka-shaped broker topic feeding the two-stage
        pipelined ingester with exactly-once WAL offsets. ``config`` is a
        pilosa_tpu_torch.config.Config ([stream]); kwargs override
        individual StreamService knobs (schema, topic, group, partitions,
        batch_rows, queue_depth, max_backlog_rows, id_field, keys, clock,
        plan). Records arrive via ``api.stream.push`` or direct
        ``api.stream.broker.produce``; ``api.stream.step()`` drains them
        through the pipeline."""
        from pilosa_tpu_torch.stream.pipeline import StreamService

        if self.stream is not None:
            self.disable_stream()
        self.stream = StreamService.from_config(self, index, config=config,
                                                **overrides)
        return self.stream

    def disable_stream(self) -> None:
        svc, self.stream = self.stream, None
        if svc is not None:
            svc.close()

    # -- query (reference: api.go:209 Query) -------------------------------

    def query(self, index: str, pql: str,
              shards: Optional[Sequence[int]] = None,
              priority: Optional[str] = None,
              deadline_ms: Optional[float] = None) -> List[Any]:
        """Run a PQL query under a ``query.pql`` trace span, recorded in
        the history ring and the query log. One with write calls is a
        write request: it holds the holder's write lock, and the stacks
        it builds or advances are not published to lock-free readers. A
        read takes no lock; with the scheduler on it is admitted with
        ``priority`` and ``deadline_ms`` and may share a fused dispatch
        with concurrent reads."""
        M.REGISTRY.count(M.METRIC_PQL_QUERIES)
        text = pql if isinstance(pql, str) else "".join(
            c.to_pql() for c in getattr(pql, "calls", []))

        def run():
            parsed = parse(pql) if isinstance(pql, str) else pql
            sched = self.scheduler
            if has_write_calls(parsed):
                with self.txf.qcx():
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

        return self._recorded("pql", index, text, run,
                              get_tracer().start_trace("query.pql",
                                                       index=index))

    def sql(self, query: str, parsed=None):
        """Execute a SQL statement (reference: server/sql.go:17 execSQL)
        under a ``query.sql`` trace span, recorded in the history ring
        and the query log. Returns a pilosa_tpu_torch.sql.SQLResult.
        ``parsed`` reuses a statement the caller already parsed."""
        eng = self._sql_engine
        if eng is None:
            # benign if two threads race (same-state engines)
            from pilosa_tpu_torch.sql import SQLEngine
            eng = self._sql_engine = SQLEngine(self)
        M.REGISTRY.count(M.METRIC_SQL_QUERIES)
        return self._recorded("sql", "", query,
                              lambda: eng.query(query, parsed=parsed),
                              get_tracer().start_trace("query.sql"))

    def _recorded(self, kind: str, index: str, text: str, run, span):
        """Run one request under ``span``: a history record (its
        request id tagged on the span), a query-log line and, above the
        tracer's slow threshold, a slow-query line."""
        rec = self.history.begin(index, text, kind)
        rec.trace_id = span.trace_id
        span.set_tag("request_id", rec.request_id)
        surface = "query" if kind == "pql" else kind
        t0 = time.monotonic()
        try:
            out = run()
            self.history.end(rec)
            if self.query_logger is not None:
                self.query_logger.log(kind, index, text,
                                      time.monotonic() - t0)
            if self.health is not None:
                self.health.record(surface, time.monotonic() - t0)
            return out
        except Exception as e:
            span.set_tag("error", str(e) or type(e).__name__)
            self.history.end(rec, error=str(e))
            if self.query_logger is not None:
                self.query_logger.log(kind, index, text,
                                      time.monotonic() - t0, error=str(e))
            if self.health is not None:
                self.health.record(surface, time.monotonic() - t0,
                                   error=True)
            raise
        finally:
            span.finish()
            self._maybe_slow_log(kind, index, text,
                                 time.monotonic() - t0, rec)

    def _maybe_slow_log(self, kind: str, index: str, text: str,
                        duration_s: float, rec) -> None:
        """Structured slow-query line above the tracer's threshold,
        linking request_id <-> trace_id (obs/tracing.py slow_ms)."""
        tracer = get_tracer()
        if tracer.slow_ms <= 0 or duration_s * 1e3 < tracer.slow_ms:
            return
        M.REGISTRY.count(M.METRIC_TRACE_SLOW_QUERIES, kind=kind)
        if self.query_logger is not None:
            self.query_logger.log(
                "slow", index, text, duration_s,
                trace_id=rec.trace_id, request_id=rec.request_id)

    def query_json(self, index: str, pql: str,
                   priority: Optional[str] = None,
                   deadline_ms: Optional[float] = None,
                   profile: bool = False) -> dict:
        """``{"results": [...]}`` in the reference's JSON shapes.
        ``profile=True`` forces a sampled trace for this query and returns
        its span tree beside the results (the reference's ProfiledSpan)."""
        if profile:
            with get_tracer().profile("query.profile", index=index) as root:
                out = self.query_json(index, pql, priority=priority,
                                      deadline_ms=deadline_ms)
            out["profile"] = root.to_json()
            return out
        return {"results": [result_to_json(r) for r in self.query(
            index, pql, priority=priority, deadline_ms=deadline_ms)]}

    # -- bulk import (reference: api.go:1438 Import) -------------------------

    def import_bits(self, index: str, field: str,
                    rows: Sequence[int] = (),
                    cols: Optional[Sequence[int]] = None,
                    row_keys: Optional[Sequence[str]] = None,
                    col_keys: Optional[Sequence[str]] = None,
                    clear: bool = False) -> int:
        """Bulk (row, col) import, translating keys when given; marks
        every column in ``_exists`` when the index tracks existence.
        ``clear`` clears the bits instead (and marks nothing). One write
        request: with a data directory, one group commit."""
        idx = self.holder.index(index)
        fld = idx.field(field)
        if fld.options.type.is_bsi:
            raise ValueError(
                f"field {field!r} is int-like; use import_values")
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
        with self._ingest_slo(), self.txf.qcx():
            changed = fld.import_bits(rows, cols, clear=clear)
            if not clear:
                self._mark_exists(idx, cols)
        M.REGISTRY.count(M.METRIC_CLEARED if clear else M.METRIC_IMPORTED,
                         len(cols))
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
        with self._ingest_slo(), self.txf.qcx():
            fld.set_values(cols, values)
            self._mark_exists(idx, cols)
        M.REGISTRY.count(M.METRIC_IMPORTED, len(cols))
        return len(cols)

    def import_roaring(self, index: str, field: str, shard: int,
                       views: Dict[str, bytes], clear: bool = False) -> None:
        """Shard-transactional roaring import (reference: api.go:1647
        ImportRoaringShard): per view, a pilosa-roaring blob addressed as
        row * ShardWidth + column within the shard, merged (or cleared)
        into the fragment row by row."""
        idx = self.holder.index(index)
        fld = idx.field(field)
        if fld.options.type.is_bsi:
            raise ValueError(
                f"field {field!r} is int-like; roaring imports target "
                "bitmap-row fields")
        all_cols = []
        with self.txf.qcx():
            for view, blob in views.items():
                view = view or timeq.VIEW_STANDARD
                positions = decode_to_positions(blob)
                rows = (positions >> np.uint64(SHARD_WIDTH_EXP)
                        ).astype(np.int64)
                cols = (positions & np.uint64(SHARD_WIDTH - 1)
                        ).astype(np.int64)
                for row, (sel,) in group_sorted(rows, cols):
                    plane = bits_to_plane(sel, WORDS_PER_SHARD)
                    if clear:
                        fld.clear_row_plane_bits(shard, row, plane,
                                                 view=view)
                    else:
                        fld.write_row_plane(shard, row, plane, view=view)
                all_cols.append(cols)
            cols = np.unique(np.concatenate(all_cols)) if all_cols else ()
            if not clear and idx.options.track_existence and len(cols):
                idx.field(EXISTENCE_FIELD).import_bits(
                    np.zeros(len(cols), dtype=np.int64),
                    shard * SHARD_WIDTH + cols)

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
        with self.txf.qcx():
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
        with self.txf.qcx():  # flushes the df_delete WAL tombstone
            self.holder.index(index).dataframe.delete()

    # -- backup / restore / checksum (reference: ctl/backup.go,
    #    ctl/backup_tar.go, ctl/restore.go, ctl/chksum.go) ------------------

    def backup_tar(self, fileobj) -> None:
        """Stream a tar snapshot: schema, fragments, BSI planes, dataframe
        and translate journals, consistent under the write lock (the
        reference holds a cluster transaction instead, ctl/backup.go:30)."""
        with self.holder.write_lock:
            with tempfile.TemporaryDirectory(prefix="pilosa-backup") as tmp:
                export_holder(self.holder, tmp)
                with tarfile.open(fileobj=fileobj, mode="w|gz") as tar:
                    tar.add(tmp, arcname=".")

    def restore_tar(self, fileobj) -> None:
        """Replace ALL holder contents with a ``backup_tar`` snapshot
        (reference: ctl/restore.go). The archive's holder opens
        ``readonly``: its checkpoint loads, and no WAL in it is replayed
        (unpickling a foreign log would run untrusted bytes)."""
        with tempfile.TemporaryDirectory(prefix="pilosa-restore") as tmp:
            with tarfile.open(fileobj=fileobj, mode="r|*") as tar:
                tar.extractall(tmp, filter="data")
            with self.holder.write_lock:
                for name in list(self.holder.indexes):
                    self.holder.delete_index(name)
                src = Holder(self.device, tmp, readonly=True)
                src.recover()
                # rebuilt through this holder, so WALs and paths attach to
                # this data dir; then the loaded planes are copied over
                for sidx in src.indexes.values():
                    didx = self.holder.create_index(sidx.name, sidx.options)
                    for f in sidx.public_fields():
                        didx.create_field(f.name, f.options)
                    for fname, sf in sidx.fields.items():
                        df_ = didx.fields[fname]
                        for view, frags in sf.views.items():
                            for shard, frag in frags.items():
                                for slot, row in enumerate(frag.row_ids):
                                    df_.write_row_plane(
                                        shard, row, frag.planes[slot],
                                        clear=True, view=view)
                        # BSI planes are copied, not logged; the
                        # checkpoint below persists them
                        for shard, bfrag in sf.bsi.items():
                            b = df_.bsi_fragment(shard, create=True)
                            b._ensure_depth(bfrag.depth)
                            b.planes[: bfrag.planes.shape[0]] = bfrag.planes
                            b.version += 1
                        if sf.translate is not None \
                                and df_.translate is not None:
                            df_.translate.replace_all(sf.translate.key_to_id)
                    if sidx.translate is not None \
                            and didx.translate is not None:
                        didx.translate.replace_all(sidx.translate.key_to_id)
                    for shard, frame in sidx.dataframe.frames.items():
                        didx.dataframe.frames[shard] = frame
                        frame.version += 1
                self.holder.save_schema()
            if self.holder.path:
                self.holder.checkpoint()

    def checksum(self) -> str:
        """Deterministic digest of all data (reference: ctl/chksum.go),
        computed as the JAX package computes it, so two holders with the
        same bits digest equal whichever package holds them. Rows hash in
        row-id order, not insertion order."""
        h = hashlib.sha256()
        with self.holder.write_lock:
            h.update(json.dumps(self.holder.schema(),
                                sort_keys=True).encode())
            for iname in sorted(self.holder.indexes):
                idx = self.holder.indexes[iname]
                for fname in sorted(idx.fields):
                    field = idx.fields[fname]
                    for view in sorted(field.views):
                        for shard in sorted(field.views[view]):
                            frag = field.views[view][shard]
                            h.update(f"{iname}/{fname}/{view}/{shard}"
                                     .encode())
                            n = len(frag.row_ids)
                            rows = np.asarray(frag.row_ids, dtype=np.uint64)
                            order = np.argsort(rows, kind="stable")
                            h.update(rows[order].tobytes())
                            h.update(np.ascontiguousarray(
                                np.asarray(frag.planes[:n])[order]).tobytes())
                    for shard in sorted(field.bsi):
                        h.update(f"{iname}/{fname}/bsi/{shard}".encode())
                        h.update(np.ascontiguousarray(
                            field.bsi[shard].planes).tobytes())
                    if field.translate is not None:
                        h.update(json.dumps(sorted(
                            field.translate.key_to_id.items())).encode())
                if idx.translate is not None:
                    h.update(json.dumps(sorted(
                        idx.translate.key_to_id.items())).encode())
                for shard in sorted(idx.dataframe.frames):
                    frame = idx.dataframe.frames[shard]
                    for name in sorted(frame.columns):
                        h.update(f"df/{iname}/{shard}/{name}".encode())
                        h.update(np.ascontiguousarray(
                            frame.columns[name]).tobytes())
                        h.update(np.packbits(frame.valid[name]).tobytes())
        return h.hexdigest()

    def save(self) -> None:
        """Checkpoint: snapshot all planes and prune the WAL segments they
        subsume (reference: rbf checkpoint, rbf/db.go:149)."""
        if self.holder.path:
            self.holder.checkpoint()
        else:
            save_holder_data(self.holder)

    def info(self) -> dict:
        if self.device.type == "cuda":
            devices = [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [str(self.device)]
        return {
            "shardWidth": SHARD_WIDTH,
            "devices": devices,
            "indexes": sorted(self.holder.indexes),
        }
