"""PipelinedIngester: stage-decoupled continuous ingest.

Port of ``pilosa_tpu/stream/pipeline.py``, without the device
profiler's parse, key-translate and ingest stages (``obs/devprof`` is
not ported yet). The device thread's imports launch ``scatter_merge``
(one launch per ``set_many`` call, ``ops/scatter.py``) on the same
stream as the reads the scheduler runs beside it; the staging buffers
are held under one lock from the host fill to the copy back, and every
launch leaves the shared count accumulator zero, so the two threads
share the stream safely.

PIMDAL's overlap discipline applied to the ingest path: the host thread
parses + bulk-key-translates batch N+1 while the device thread runs the
``h2d_copy`` / ``fragment_advance`` / ``wal_commit`` half of batch N.
The hand-off is a bounded queue (double-buffered at the default depth
2), whose free slots are the pipeline's *credit* signal — when the
device side falls behind, the host pauses the consumer (broker) and the
push endpoint 429s (HTTP), so sustained full-rate ingest sheds writes
instead of starving interactive reads (the device stage rides
``scheduler.admit(priority=batch)``, which only ever fills the batch
half of the admission queue AND yields outright while interactive work
is active or within ``scheduler.batch-holdoff-ms`` of the last read —
the ingester backs off and retries instead of contending).

Exactly-once offsets: every device-side group commit appends ONE
``("stream_offsets", group, {"topic:partition": next})`` record to the
index WAL *after* the batch's data records, inside the same Qcx — the
qcx-exit flush makes data + watermark durable together. A torn tail can
only cut the watermark off the END of the commit, leaving
data-without-offsets; the re-poll then re-applies the batch, which
converges because every import is idempotent (set bits, BSI re-set of
the same values, ``_exists``, key translation returning existing ids,
and auto-id reservation keyed by a deterministic
``group:topic:partition:first_offset`` session so a crash retry
re-reserves the SAME range). The watermark is stamped into
``checkpoint.json`` at every fuzzy checkpoint so it survives segment
pruning; :meth:`PipelinedIngester.resume` seeks the consumer to the
WAL-derived offsets, which are authoritative over the broker's group
offsets.

Crash sites (storage/recovery.STREAM_CRASH_SITES) cover the stage
boundaries: ``stream.handoff`` (host side, before enqueue),
``stream.apply`` (device side, inside the Qcx before imports),
``stream.commit`` (after the durable group commit, before the consumer
offset commit). The classic single-threaded ``Ingester.run`` stays
untouched as the bit-identity oracle.

Once a kill site has fired, the simulated process is dead, and both
threads stop where they stand: the device thread applies no more and
commits no offsets to the consumer. (The JAX package's device thread
goes on to commit the in-flight batch's offsets to the consumer; a
resume then trusts them for a partition the WAL holds no watermark for,
and that batch is lost.)
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pilosa_tpu_torch.core.schema import FieldType
from pilosa_tpu_torch.core.translate import bulk_translate_ids
from pilosa_tpu_torch.errors import AdmissionError
from pilosa_tpu_torch.ingest.idalloc import IDAllocator
from pilosa_tpu_torch.obs import devprof
from pilosa_tpu_torch.obs import metrics as M
from pilosa_tpu_torch.sched.clock import MonotonicClock
from pilosa_tpu_torch.sched.scheduler import PRIORITY_BATCH
from pilosa_tpu_torch.storage.recovery import SimulatedCrash
from pilosa_tpu_torch.stream.broker import (StreamBroker, StreamConsumer,
                                            chunk_columns, iter_rows,
                                            split_tp, tp_key)

_SENTINEL = object()


class PreparedBatch:
    """Host-side output of parse + translate: per-field import arrays
    plus the offset watermark this batch advances to."""

    __slots__ = ("ids", "ops", "offsets", "n", "session")

    def __init__(self, ids, ops, offsets, n, session=None):
        self.ids = ids
        self.ops = ops          # [("bits"|"values", fname, a, b), ...]
        self.offsets = offsets  # {"topic:partition": next_offset}
        self.n = n
        self.session = session  # idalloc session to commit, or None


class PipelinedIngester:
    """Two-stage runner over a :class:`StreamConsumer`.

    ``run()`` drains the stream (host + device threads, bounded queue),
    returns rows ingested, and re-raises any worker failure — including
    :class:`SimulatedCrash` from an armed CrashPlan, after which the
    holder must be abandoned and reopened like any crashed process.
    """

    def __init__(self, api, index: str, consumer: StreamConsumer,
                 schema=None, id_field: Optional[str] = "id",
                 batch_rows: int = 65536, queue_depth: int = 2,
                 group: str = "ingest", keys: bool = False,
                 allocator: Optional[IDAllocator] = None,
                 plan=None, poll_timeout_s: float = 0.0,
                 backoff_s: float = 0.002, clock=None):
        self.api = api
        self.index = index
        self.consumer = consumer
        self.schema = list(schema) if schema else None
        self.id_field = id_field
        self.batch_rows = max(1, int(batch_rows))
        self.queue_depth = max(1, int(queue_depth))
        self.group = group
        self.keys = keys
        self.poll_timeout_s = poll_timeout_s
        self.backoff_s = backoff_s
        self.plan = plan if plan is not None else \
            getattr(api.holder, "crash_plan", None)
        if allocator is None:
            hp = api.holder.path
            allocator = IDAllocator(
                os.path.join(hp, "stream_idalloc.jsonl") if hp else None)
        self.allocator = allocator
        self._clock = clock or MonotonicClock()
        self._queue: "queue_mod.Queue" = queue_mod.Queue(self.queue_depth)
        self._stop = threading.Event()
        self._host_done = False
        self._errors: List[BaseException] = []
        self._idx = None
        self.rows = 0
        self.batches = 0
        self.shed = 0
        self.paused_s = 0.0
        self.running = False

    # -- schema / resume ---------------------------------------------------

    def _ensure_schema(self) -> None:
        holder = self.api.holder
        if self.index not in holder.indexes:
            self.api.create_index(self.index, {"keys": self.keys})
        idx = holder.index(self.index)
        created = False
        for name, opts in (self.schema or []):
            if name not in idx.fields:
                idx.create_field(name, opts)
                created = True
        if created:
            # index-level create_field skips the API layer's schema.json
            # write; without it a crash before the next save_schema()
            # replays every field record into a fieldless index
            holder.save_schema()
        self._idx = idx

    def resume(self) -> Dict[str, int]:
        """Seek the consumer to the WAL-committed watermark — the
        offsets the data state actually reflects, authoritative over
        whatever the broker thinks the group committed (the two can
        disagree by exactly one batch after a ``stream.commit`` crash)."""
        committed = dict(self._idx.stream_offsets.get(self.group, {}))
        for k, off in committed.items():
            topic, part = split_tp(k)
            self.consumer.seek(topic, part, int(off))
        return committed

    # -- observability -----------------------------------------------------

    def credits(self) -> int:
        """Free hand-off slots: 0 = saturated (the HTTP push surface and
        the flight recorder's ``ingest_stall`` trigger read this)."""
        return max(0, self.queue_depth - self._queue.qsize())

    def stats(self) -> dict:
        return {
            "queue_depth": self._queue.qsize(),
            "queue_capacity": self.queue_depth,
            "credits": self.credits(),
            "paused": bool(getattr(self.consumer, "paused", False)),
            "paused_s": self.paused_s + (
                self.consumer.paused_s()
                if hasattr(self.consumer, "paused_s") else 0.0),
            "rows": self.rows,
            "batches": self.batches,
            "shed": self.shed,
            "running": self.running,
        }

    # -- host side: poll -> parse -> translate -> enqueue ------------------

    def _fire(self, site: str) -> bool:
        """Pass a kill site: False once the simulated process is dead,
        and the caller then does nothing more (a dead process performs
        no IO, and commits no offsets to the consumer)."""
        return self.plan is None or self.plan.fire(site)

    def _translate(self, store, raw) -> np.ndarray:
        keys = [str(k) for k in raw]
        if not devprof.ENABLED:
            return bulk_translate_ids(store, keys)
        t0 = time.perf_counter()
        out = bulk_translate_ids(store, keys)
        devprof.record_stage("key_translate", time.perf_counter() - t0,
                             rows=len(keys))
        return out

    def _record_ids(self, values, records):
        idf = self.id_field
        if idf and values and idf in values[0]:
            raw = [v[idf] for v in values]
            if self._idx.options.keys:
                # translate stores persist their own appends; the holder
                # lock keeps them serialized against checkpoints exactly
                # like the classic path (which translates inside the Qcx)
                with self.api.holder.write_lock:
                    ids = self._translate(self._idx.translate, raw)
                return np.asarray(ids, dtype=np.int64), None
            return np.asarray([int(r) for r in raw], dtype=np.int64), None
        # auto-ids: the session key is a pure function of the stream
        # position, so a crash retry of the same batch re-reserves the
        # SAME contiguous range — zero duplicate ids across resume
        first = records[0]
        session = f"{self.group}:{first.topic}:{first.partition}" \
                  f":{first.offset}"
        rng = self.allocator.reserve(session, len(values), offset=0)
        ids = np.arange(rng.base, rng.base + len(values), dtype=np.int64)
        return ids, session

    def _prepare(self, records) -> PreparedBatch:
        vals = [r.value for r in records]
        if all(chunk_columns(v) is not None for v in vals):
            return self._prepare_columnar(records)
        idx = self._idx
        # a mixed batch (rare) expands its chunks onto the row path
        values = [row for v in vals for row in iter_rows(v)]
        ids, session = self._record_ids(values, records)
        offsets: Dict[str, int] = {}
        for r in records:
            k = tp_key(r.topic, r.partition)
            offsets[k] = max(offsets.get(k, 0), r.offset + 1)
        # columnarize with the Batch value conventions: scalar for
        # mutex/bool/BSI, list for set fields, None skips
        per_field: Dict[str, List[Tuple[int, Any]]] = {}
        for col, rec in zip(ids, values):
            for fname, v in rec.items():
                if fname == self.id_field or v is None:
                    continue
                per_field.setdefault(fname, []).append((int(col), v))
        ops: List[Tuple[str, str, Any, Any]] = []
        for fname, pairs in per_field.items():
            fld = idx.field(fname)
            t = fld.options.type
            if t.is_bsi:
                ops.append(("values",
                            fname,
                            np.asarray([c for c, _ in pairs],
                                       dtype=np.int64),
                            [v for _, v in pairs]))
                continue
            rows: List[Any] = []
            cols: List[int] = []
            for c, v in pairs:
                items = v if isinstance(v, list) else [v]
                for item in items:
                    rows.append(item)
                    cols.append(c)
            if t == FieldType.BOOL:
                row_arr = np.asarray(
                    [1 if bool(r) else 0 for r in rows], dtype=np.int64)
            elif fld.options.keys:
                with self.api.holder.write_lock:
                    row_arr = np.asarray(self._translate(fld.translate,
                                                         rows),
                                         dtype=np.int64)
            else:
                row_arr = np.asarray([int(r) for r in rows],
                                     dtype=np.int64)
            ops.append(("bits", fname, row_arr,
                        np.asarray(cols, dtype=np.int64)))
        return PreparedBatch(ids, ops, offsets, len(values), session)

    def _prepare_columnar(self, records) -> PreparedBatch:
        """Chunked fast path (broker.make_chunk): every message already
        carries equal-length columns, so parse + translate collapse to
        one numpy conversion per field instead of a Python loop per
        cell — this is what holds the sustained-rate bound (bench
        config 17). Chunk cells are dense scalars by contract."""
        idx = self._idx
        # name -> list of column sequences (concatenated lazily so numpy
        # columns never round-trip through Python objects)
        merged: Dict[str, List[Any]] = {}
        n = 0
        for r in records:
            cols = chunk_columns(r.value)
            rows = len(next(iter(cols.values()))) if cols else 0
            if merged and set(cols) != set(merged):
                raise ValueError(
                    "chunks in one batch must share columns: "
                    f"{sorted(cols)} vs {sorted(merged)}")
            for name, col in cols.items():
                merged.setdefault(name, []).append(col)
            n += rows

        def cat(chunks, dtype=np.int64):
            if len(chunks) == 1:
                return np.asarray(chunks[0], dtype=dtype)
            return np.concatenate(
                [np.asarray(c, dtype=dtype) for c in chunks])
        offsets: Dict[str, int] = {}
        for r in records:
            k = tp_key(r.topic, r.partition)
            offsets[k] = max(offsets.get(k, 0), r.offset + 1)
        session = None
        raw_ids = merged.pop(self.id_field, None) if self.id_field else None
        if raw_ids is not None:
            if idx.options.keys:
                keys = [k for c in raw_ids for k in c]
                with self.api.holder.write_lock:
                    ids = np.asarray(self._translate(idx.translate, keys),
                                     dtype=np.int64)
            else:
                ids = cat(raw_ids)
        else:
            first = records[0]
            session = f"{self.group}:{first.topic}:{first.partition}" \
                      f":{first.offset}"
            rng = self.allocator.reserve(session, n, offset=0)
            ids = np.arange(rng.base, rng.base + n, dtype=np.int64)
        ops: List[Tuple[str, str, Any, Any]] = []
        for fname, chunks in merged.items():
            fld = idx.field(fname)
            t = fld.options.type
            if t.is_bsi:
                ops.append(("values", fname, ids, cat(chunks)))
            elif t == FieldType.BOOL:
                ops.append(("bits", fname,
                            cat(chunks, dtype=bool).astype(np.int64), ids))
            elif fld.options.keys:
                keys = [k for c in chunks for k in c]
                with self.api.holder.write_lock:
                    row_arr = np.asarray(self._translate(fld.translate,
                                                         keys),
                                         dtype=np.int64)
                ops.append(("bits", fname, row_arr, ids))
            else:
                ops.append(("bits", fname, cat(chunks), ids))
        return PreparedBatch(ids, ops, offsets, n, session)

    def _enqueue(self, batch: PreparedBatch) -> None:
        try:
            self._queue.put_nowait(batch)
            return
        except queue_mod.Full:
            pass
        # credits exhausted: the device side is behind — pause the
        # consumer while we block so producers see backpressure, and
        # account the stall for the ingest_stall trigger
        self.consumer.pause()
        t0 = self._clock.now()
        try:
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.02)
                    return
                except queue_mod.Full:
                    continue
        finally:
            self.paused_s += self._clock.now() - t0
            self.consumer.resume()

    def _host_loop(self, max_batches: Optional[int]) -> None:
        try:
            n = 0
            while not self._stop.is_set():
                if max_batches is not None and n >= max_batches:
                    break
                records = self.consumer.poll(
                    self.batch_rows, timeout_s=self.poll_timeout_s)
                if not records:
                    break  # drained
                if devprof.ENABLED:
                    t0 = time.perf_counter()
                    batch = self._prepare(records)
                    devprof.record_stage(
                        "parse", time.perf_counter() - t0, rows=batch.n)
                else:
                    batch = self._prepare(records)
                if not self._fire("stream.handoff"):
                    break
                self._enqueue(batch)
                n += 1
        except BaseException as e:
            self._died(e)
        finally:
            self._host_done = True
            try:
                self._queue.put_nowait(_SENTINEL)
            except queue_mod.Full:
                pass  # device is dead or will see _host_done on timeout

    # -- device side: admit -> apply -> commit -----------------------------

    def _apply(self, batch: PreparedBatch) -> None:
        idx = self._idx
        scope = devprof.ingest_scope() if devprof.ENABLED \
            else devprof.NULL_SCOPE
        with scope, self.api.txf.qcx():
            if not self._fire("stream.apply"):
                return
            for kind, fname, a, b in batch.ops:
                fld = idx.field(fname)
                if kind == "values":
                    fld.set_values(a, b)
                else:
                    fld.import_bits(a, b)
            if idx.options.track_existence and batch.ids.size:
                idx.field("_exists").import_bits(
                    np.zeros(batch.ids.size, dtype=np.int64), batch.ids)
            # the watermark rides the SAME group commit as the data
            # records it covers — and strictly after them, so a torn
            # tail can only leave data-without-offsets (re-applied on
            # resume; idempotent), never offsets-without-data (lost rows)
            if idx.wal is not None:
                idx.wal.append(
                    ("stream_offsets", self.group, dict(batch.offsets)))
            cur = idx.stream_offsets.setdefault(self.group, {})
            for k, v in batch.offsets.items():
                cur[k] = max(int(v), int(cur.get(k, 0)))

    def _apply_admitted(self, batch: PreparedBatch) -> None:
        sched = getattr(self.api, "scheduler", None)
        if sched is None:
            return self._apply(batch)
        while not self._stop.is_set():
            try:
                with sched.admit(priority=PRIORITY_BATCH):
                    return self._apply(batch)
            except AdmissionError:
                # the batch half of the admission queue is full: reads
                # keep their headroom, we back off and retry — writes
                # shed, reads don't
                self.shed += 1
                M.REGISTRY.count(M.METRIC_STREAM_SHED)
                time.sleep(self.backoff_s)

    def _device_loop(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    item = self._queue.get(timeout=0.02)
                except queue_mod.Empty:
                    if self._host_done:
                        break
                    continue
                if item is _SENTINEL:
                    break
                if self._stop.is_set():
                    break  # crashed mid-flight: in-queue batches are lost
                self._apply_admitted(item)
                if not self._fire("stream.commit"):
                    break  # died mid-batch: no consumer or idalloc commit
                self.consumer.commit(dict(item.offsets))
                if item.session:
                    self.allocator.commit(item.session)
                self.batches += 1
                self.rows += item.n
                M.REGISTRY.count(M.METRIC_STREAM_ROWS, item.n)
                M.REGISTRY.count(M.METRIC_STREAM_BATCHES)
                M.REGISTRY.gauge(M.METRIC_STREAM_CREDITS, self.credits())
        except BaseException as e:
            self._died(e)

    def _died(self, e: BaseException) -> None:
        self._errors.append(e)
        self._stop.set()

    # -- lifecycle ---------------------------------------------------------

    def run(self, max_batches: Optional[int] = None) -> int:
        """Drain the stream through the two-stage pipeline; returns rows
        ingested this run. Re-raises worker failures (SimulatedCrash
        first, so crash tests see the kill, not a secondary symptom)."""
        self._ensure_schema()
        self.resume()
        self._stop.clear()
        self._host_done = False
        self._errors = []
        self.running = True
        try:
            dev = threading.Thread(target=self._device_loop,
                                   name="stream-device", daemon=True)
            host = threading.Thread(target=self._host_loop,
                                    args=(max_batches,),
                                    name="stream-host", daemon=True)
            dev.start()
            host.start()
            host.join()
            dev.join()
        finally:
            self.running = False
            # drop batches stranded by a crash so a later run starts clean
            while True:
                try:
                    self._queue.get_nowait()
                except queue_mod.Empty:
                    break
        if self._errors:
            for e in self._errors:
                if isinstance(e, SimulatedCrash):
                    raise e
            raise self._errors[0]
        return self.rows


class StreamService:
    """What ``API.enable_stream`` wires: an in-process broker topic plus
    a :class:`PipelinedIngester` consuming it, with the push surface and
    the stats read that the JAX package serves at
    ``POST /index/{index}/stream/push`` and ``GET /internal/stats/stream``
    (the port's HTTP front end is not ported yet)."""

    def __init__(self, api, index: str, schema=None, topic: str = "ingest",
                 group: str = "ingest", partitions: int = 1,
                 batch_rows: int = 8192, queue_depth: int = 2,
                 max_backlog_rows: Optional[int] = None,
                 id_field: Optional[str] = "id", keys: bool = False,
                 clock=None, allocator=None, plan=None):
        self.api = api
        self.index = index
        self.topic = topic
        self.group = group
        self.broker = StreamBroker(partitions=partitions, clock=clock)
        self.broker.create_topic(topic)
        self.consumer = self.broker.consumer(group, [topic])
        self.ingester = PipelinedIngester(
            api, index, self.consumer, schema=schema, id_field=id_field,
            batch_rows=batch_rows, queue_depth=queue_depth, group=group,
            keys=keys, allocator=allocator, plan=plan, clock=clock)
        self.max_backlog_rows = int(
            max_backlog_rows or batch_rows * queue_depth * 8)
        self.rejected = 0
        self.last_error: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()

    @classmethod
    def from_config(cls, api, index: str, config=None,
                    **overrides) -> "StreamService":
        from pilosa_tpu_torch.config import Config

        cfg = config or Config()
        kw = dict(
            batch_rows=cfg.stream_batch_rows,
            queue_depth=cfg.stream_queue_depth,
            group=cfg.stream_group,
            max_backlog_rows=cfg.stream_max_backlog_rows or None,
        )
        kw.update(overrides)
        return cls(api, index, **kw)

    def saturated(self) -> bool:
        """Pipeline out of credits, consumer paused, or backlog beyond
        the bound — push must 429 rather than grow the lag unboundedly."""
        return (self.ingester.credits() == 0
                or bool(getattr(self.consumer, "paused", False))
                or self.consumer.lag() >= self.max_backlog_rows)

    def push(self, records: List[dict]) -> dict:
        if self.saturated():
            self.rejected += 1
            M.REGISTRY.count(M.METRIC_STREAM_REJECTED)
            raise AdmissionError(
                f"stream pipeline saturated (lag {self.consumer.lag()}, "
                f"credits {self.ingester.credits()})")
        n = 0
        for rec in records:
            if not isinstance(rec, dict):
                raise ValueError("stream push records must be objects")
            self.broker.produce(self.topic, rec)
            n += 1
        return {"accepted": n, "lag": self.consumer.lag(),
                "credits": self.ingester.credits()}

    def step(self, max_batches: Optional[int] = None) -> int:
        """Drain what the broker currently holds through the pipeline
        (synchronous; the serve loop or a test calls this)."""
        before = self.ingester.rows
        self.ingester.run(max_batches=max_batches)
        return self.ingester.rows - before

    def start(self, interval_s: float = 0.05) -> None:
        """Continuous drain loop on a daemon thread — the server wiring
        (ctl/cli.py stream.enabled); tests and embedders call ``step()``
        directly instead. A failure escaping the pipeline (e.g. a real
        storage error) stops the loop and surfaces in ``stats()``."""
        if self._thread is not None:
            return
        self._stopped.clear()

        def loop():
            while not self._stopped.is_set():
                try:
                    if self.step() == 0:
                        self._stopped.wait(interval_s)
                except Exception as e:
                    self.last_error = repr(e)
                    break

        self._thread = threading.Thread(target=loop, name="stream-drain",
                                        daemon=True)
        self._thread.start()

    def stats(self) -> dict:
        out = self.ingester.stats()
        lag = self.consumer.lag()
        out.update({
            "enabled": True,
            "index": self.index,
            "topic": self.topic,
            "group": self.group,
            "lag": lag,
            "rejected": self.rejected,
            "backlog_limit": self.max_backlog_rows,
            "saturated": self.saturated(),
        })
        if self.last_error:
            out["last_error"] = self.last_error
        M.REGISTRY.gauge(M.METRIC_STREAM_LAG, lag)
        return out

    def close(self) -> None:
        self._stopped.set()
        self.ingester._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    stop = close
