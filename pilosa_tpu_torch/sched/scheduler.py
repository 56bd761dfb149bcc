"""Admission queue + micro-batching worker.

One daemon worker drains a bounded queue: it picks the oldest highest-
priority pending query, waits out the remainder of that query's batching
window (new compatible arrivals pile in meanwhile), then takes every
queued query with the same :class:`~pilosa_tpu_torch.sched.batch.GroupKey` and
dispatches the group fused. Backpressure is by rejection, not blocking —
a full queue raises :class:`~pilosa_tpu_torch.errors.AdmissionError`
immediately (429 at the HTTP edge) so overload sheds load instead of
growing latency unboundedly.
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import CancelledError, Future
from typing import List, Optional, Sequence, Union

from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.errors import AdmissionError, QueryDeadlineError
from pilosa_tpu_torch.obs import metrics as obs_metrics
from pilosa_tpu_torch.obs.tenants import (DEFAULT_TENANT, current_tenant_id,
                                    tenant_scope)
from pilosa_tpu_torch.obs.tracing import active_span
from pilosa_tpu_torch.pql.ast import Call, Query
from pilosa_tpu_torch.pql.executor import has_write_calls, query_maskable
from pilosa_tpu_torch.pql.parser import parse
from pilosa_tpu_torch.sched.batch import (GroupKey, execute_batch, fusible_family,
                                    group_key)
from pilosa_tpu_torch.sched.clock import MonotonicClock
from pilosa_tpu_torch.sched.window import ArrivalWindow

PRIORITY_INTERACTIVE = "interactive"
PRIORITY_BATCH = "batch"
_PRIORITY_RANK = {PRIORITY_INTERACTIVE: 0, PRIORITY_BATCH: 1}


class _Pending:
    __slots__ = ("index", "query", "shards", "priority", "rank", "deadline",
                 "future", "enqueued", "seq", "key", "fusible", "span",
                 "tenant", "vtime")

    def __init__(self, index: str, query: Query,
                 shards: Optional[Sequence[int]], priority: str,
                 deadline: Optional[float], enqueued: float, seq: int):
        self.index = index
        self.query = query
        self.shards = tuple(shards) if shards is not None else None
        self.priority = priority
        self.rank = _PRIORITY_RANK[priority]
        self.deadline = deadline
        self.future: Future = Future()
        self.enqueued = enqueued
        self.seq = seq
        self.key: GroupKey = group_key(index, query, shards)
        # eligible for cross-shard-set (superset) fusion: explicit shard
        # set + a family AND a call tree the executor can mask exactly
        self.fusible = (self.key.shards is not None
                        and fusible_family(self.key.family)
                        and query_maskable(query))
        # the submitter's trace scope, captured at the pool boundary so
        # the dispatch worker can restore parentage (obs/tracing.py)
        self.span = active_span()
        # submitter's tenant (None when the tenant plane is off) and the
        # stride-scheduling virtual time; seq as the default keeps the
        # fair-share-off ordering exactly (rank, seq)
        self.tenant = current_tenant_id()
        self.vtime = float(seq)


class _Resolved:
    """Minimal _Pending stand-in for a cache hit: just a completed
    future, so ScheduledQuery works unchanged (done() is True, cancel()
    is False — the "dispatch" already happened)."""

    __slots__ = ("future",)

    def __init__(self, future: Future):
        self.future = future


class ScheduledQuery:
    """Caller-side handle: block on :meth:`result` or :meth:`cancel`."""

    def __init__(self, pending: _Pending):
        self._pending = pending

    def result(self, timeout: Optional[float] = None) -> List:
        try:
            return self._pending.future.result(timeout)
        except CancelledError:
            raise QueryDeadlineError("query cancelled before dispatch")

    def done(self) -> bool:
        return self._pending.future.done()

    def cancel(self) -> bool:
        """Best-effort: succeeds only while still queued."""
        return self._pending.future.cancel()


class QueryScheduler:
    """Bounded-admission micro-batcher over a PQL executor.

    ``window_ms`` is the batching horizon: the worker holds the oldest
    pending query at most this long so concurrent arrivals can join its
    dispatch. 0 disables coalescing-by-time (still batches whatever is
    queued at take time). ``default_deadline_ms`` ≤ 0 means no deadline.

    ``fuse_waste_ratio`` > 0 enables cross-shard-set fusion: after the
    exact-key take, queued fusible queries in the same (index, family)
    merge into the batch over the union of their shard sets, each masked
    to its own subset by the executor, as long as the union stays within
    ``fuse_waste_ratio`` x the largest member set. 0 disables merging.

    ``adaptive_window=True`` replaces the fixed window with one sized
    from the EWMA of arrival gaps, clamped to [window_min_ms,
    window_max_ms]: near-idle traffic dispatches almost immediately
    (solo queries don't idle out the full horizon), bursty traffic earns
    the full window so batches fill.
    """

    def __init__(self, executor, *, window_ms: float = 0.5,
                 max_batch: int = 64, max_queue: int = 1024,
                 default_deadline_ms: float = 0.0,
                 fuse_waste_ratio: float = 2.0,
                 adaptive_window: bool = False,
                 window_min_ms: float = 0.2, window_max_ms: float = 5.0,
                 batch_holdoff_ms: float = 5.0,
                 fair_share: bool = False,
                 clock=None, registry=None):
        self.executor = executor
        self.window_s = max(0.0, float(window_ms)) / 1000.0
        self.max_batch = max(1, int(max_batch))
        self.max_queue = max(1, int(max_queue))
        self.default_deadline_s = max(0.0, float(default_deadline_ms)) / 1e3
        self.fuse_waste_ratio = max(0.0, float(fuse_waste_ratio))
        # superset merges need the executor's masked execute_many
        self._fusion_ok = (
            self.fuse_waste_ratio > 0
            and getattr(executor, "supports_shard_masks", False)
            and callable(getattr(executor, "execute_many", None)))
        self.adaptive_window = bool(adaptive_window)
        self.window_min_s = max(0.0, float(window_min_ms)) / 1e3
        self.window_max_s = max(self.window_min_s, float(window_max_ms) / 1e3)
        # shared with cluster/batch.py's leg coalescer (sched/window.py)
        self._arrival = ArrivalWindow(
            self.window_s, adaptive=self.adaptive_window,
            window_min_s=self.window_min_s, window_max_s=self.window_max_s,
            max_batch=self.max_batch)
        self.clock = clock if clock is not None else MonotonicClock()
        self.registry = registry if registry is not None else (
            obs_metrics.REGISTRY)
        self._lock = locktrace.tracked_lock("sched.scheduler")
        self._cv = threading.Condition(self._lock)
        self.clock.attach(self._cv)
        self._queue: List[_Pending] = []
        self._seq = 0
        self._claim_window_s = 0.0
        self._paused = False
        self._closed = False
        self._inflight_admits = 0
        # read protection: batch-priority admit tickets yield while
        # interactive work is queued, dispatching, or admitted — and for
        # batch_holdoff after the last read finishes, so back-to-back
        # reads don't interleave with ingest applies (writes shed, reads
        # keep the machine)
        self.batch_holdoff_s = max(0.0, float(batch_holdoff_ms)) / 1e3
        self._inflight_interactive = 0
        self._dispatch_interactive = 0
        self._last_interactive = float("-inf")
        # weighted-fair admission ordering (stride scheduling): each
        # tenant's arrivals advance its virtual time by 1/weight, and the
        # head pick orders by (rank, vtime, seq) — a tenant flooding the
        # queue runs its vtime ahead and naturally yields to the others.
        # Toggled live by API.enable_tenants (order-independent wiring).
        self.fair_share = bool(fair_share)
        self.tenant_weight = None  # callable tenant -> weight, else 1.0
        self._tenant_vtime = {}
        self._vclock = 0.0
        self._worker = threading.Thread(
            target=self._loop, name="pilosa-sched", daemon=True)
        self._worker.start()

    @classmethod
    def from_config(cls, executor, config, **overrides):
        kw = dict(
            window_ms=config.scheduler_window_ms,
            max_batch=config.scheduler_max_batch,
            max_queue=config.scheduler_max_queue,
            default_deadline_ms=config.scheduler_default_deadline_ms,
            fuse_waste_ratio=config.scheduler_fuse_waste_ratio,
            adaptive_window=config.scheduler_adaptive_window,
            window_min_ms=config.scheduler_window_min_ms,
            window_max_ms=config.scheduler_window_max_ms,
            batch_holdoff_ms=config.scheduler_batch_holdoff_ms,
            fair_share=(config.tenants_enabled
                        and config.tenants_fair_share),
        )
        kw.update(overrides)
        return cls(executor, **kw)

    # -- admission ---------------------------------------------------------

    def submit(self, index: str, query: Union[str, Query, Call],
               shards: Optional[Sequence[int]] = None,
               priority: str = PRIORITY_INTERACTIVE,
               deadline_ms: Optional[float] = None) -> ScheduledQuery:
        if isinstance(query, str):
            query = parse(query)
        elif isinstance(query, Call):
            query = Query([query])
        if priority not in _PRIORITY_RANK:
            raise ValueError(f"unknown priority: {priority!r}")
        if has_write_calls(query):
            raise ValueError(
                "scheduler accepts read-only queries; execute writes "
                "directly through API.query")
        hit = self._cache_lookup(index, query, shards)
        if hit is not None:
            return hit
        if deadline_ms is None:
            deadline_s = self.default_deadline_s
        else:
            deadline_s = max(0.0, float(deadline_ms)) / 1e3
        now = self.clock.now()
        with self._cv:
            if self._closed:
                raise AdmissionError("scheduler is closed")
            limit = self.max_queue
            if priority == PRIORITY_BATCH:
                # batch traffic may only fill half the queue, reserving
                # headroom so interactive admits survive ingest storms
                limit = max(1, self.max_queue // 2)
            if len(self._queue) >= limit:
                self.registry.count(obs_metrics.METRIC_SCHED_REJECTED,
                                  priority=priority, reason="queue_full")
                raise AdmissionError(
                    f"admission queue full ({len(self._queue)} queued, "
                    f"limit {limit} for priority={priority})",
                    retry_after_s=self._retry_after_locked(
                        len(self._queue)))
            # gap EWMA feeds both the adaptive window and the
            # Retry-After drain estimate, so observe unconditionally
            self._observe_arrival(now)
            pending = _Pending(
                index, query, shards, priority,
                now + deadline_s if deadline_s > 0 else None, now, self._seq)
            self._seq += 1
            if self.fair_share:
                self._assign_vtime_locked(pending)
            self._queue.append(pending)
            self.registry.gauge(obs_metrics.METRIC_SCHED_QUEUE_DEPTH,
                                len(self._queue))
            self._cv.notify_all()
        return ScheduledQuery(pending)

    def _cache_lookup(self, index: str, query: Query,
                      shards) -> Optional[ScheduledQuery]:
        """Result-cache hit fast-path: a hit resolves the future
        immediately and never occupies queue or batch slots. Misses are
        NOT claimed here — single-flight leadership happens inside the
        executor, where the group actually dispatches (counting the
        authoritative miss there too, so this peek never double-counts).
        """
        cache = getattr(self.executor, "cache", None)
        if cache is None:
            return None
        key_fn = getattr(self.executor, "cache_key", None)
        if key_fn is None:
            return None
        try:
            key = key_fn(index, query, shards)
        except Exception:
            return None  # unknown index etc.: surface at dispatch
        if key is None:
            return None  # executor counts the bypass at dispatch
        hit, value = cache.lookup(
            key, count_miss=False,
            allow_stale=not getattr(self.executor, "remote", False))
        if not hit:
            return None
        fut: Future = Future()
        fut.set_result(value)
        return ScheduledQuery(_Resolved(fut))

    def execute(self, index: str, query: Union[str, Query, Call],
                shards: Optional[Sequence[int]] = None,
                priority: str = PRIORITY_INTERACTIVE,
                deadline_ms: Optional[float] = None) -> List:
        """Drop-in for ``Executor.execute`` on reads: submit and wait.

        Calls from the worker thread itself (a batched query whose
        evaluation recurses into execute) and writes bypass the queue —
        re-entrant submission would deadlock the single worker.
        """
        if threading.current_thread() is self._worker:
            return self.executor.execute(index, query, shards=shards)
        if isinstance(query, str):
            query = parse(query)
        elif isinstance(query, Call):
            query = Query([query])
        if has_write_calls(query):
            return self.executor.execute(index, query, shards=shards)
        return self.submit(index, query, shards, priority,
                           deadline_ms).result()

    def _interactive_busy_locked(self) -> bool:
        """Interactive work is queued, dispatching, holding an admit
        ticket, or finished less than ``batch_holdoff`` ago (held lock)."""
        if self._dispatch_interactive or self._inflight_interactive:
            return True
        rank = _PRIORITY_RANK[PRIORITY_INTERACTIVE]
        if any(p.rank == rank for p in self._queue):
            return True
        return self.clock.now() < self._last_interactive + \
            self.batch_holdoff_s

    @contextlib.contextmanager
    def admit(self, priority: str = PRIORITY_INTERACTIVE):
        """Admission-control-only ticket for work the batcher cannot fuse
        (SQL scans, streaming-ingest applies): bounds concurrent admitted
        work by ``max_queue`` without routing execution through the
        queue. Batch-priority tickets additionally yield whenever
        interactive work is active — the caller is expected to back off
        and retry, so sustained ingest sheds writes, never reads."""
        with self._cv:
            if self._closed:
                raise AdmissionError("scheduler is closed")
            limit = self.max_queue
            if priority == PRIORITY_BATCH:
                limit = max(1, self.max_queue // 2)
                if self._interactive_busy_locked():
                    self.registry.count(
                        obs_metrics.METRIC_SCHED_REJECTED,
                        priority=priority, reason="interactive_busy")
                    raise AdmissionError(
                        "interactive work active: batch admission yields",
                        retry_after_s=self._retry_after_locked(
                            self._inflight_admits + len(self._queue)))
            if self._inflight_admits + len(self._queue) >= limit:
                self.registry.count(obs_metrics.METRIC_SCHED_REJECTED,
                                  priority=priority, reason="admit_full")
                raise AdmissionError(
                    f"admission limit reached ({self._inflight_admits} "
                    f"inflight, limit {limit} for priority={priority})",
                    retry_after_s=self._retry_after_locked(
                        self._inflight_admits + len(self._queue)))
            self._inflight_admits += 1
            if priority == PRIORITY_INTERACTIVE:
                self._inflight_interactive += 1
            self.registry.gauge(obs_metrics.METRIC_SCHED_INFLIGHT,
                                self._inflight_admits)
        try:
            yield
        finally:
            with self._cv:
                self._inflight_admits -= 1
                if priority == PRIORITY_INTERACTIVE:
                    self._inflight_interactive -= 1
                    self._last_interactive = self.clock.now()
                self.registry.gauge(obs_metrics.METRIC_SCHED_INFLIGHT,
                                    self._inflight_admits)

    def as_executor(self) -> "SchedulingExecutor":
        return SchedulingExecutor(self)

    # -- weighted-fair ordering (stride scheduling) ------------------------

    def set_fair_share(self, enabled: bool, weight_fn=None) -> None:
        """Toggle weighted-fair ordering; ``weight_fn(tenant) -> float``
        (typically TenantRegistry.weight) scales each tenant's stride."""
        with self._lock:
            self.fair_share = bool(enabled)
            if weight_fn is not None:
                self.tenant_weight = weight_fn
            if not enabled:
                self._tenant_vtime.clear()

    def _assign_vtime_locked(self, pending: _Pending) -> None:
        t = pending.tenant or DEFAULT_TENANT
        pending.tenant = t
        wf = self.tenant_weight
        w = wf(t) if wf is not None else 1.0
        v = (max(self._vclock, self._tenant_vtime.get(t, 0.0))
             + 1.0 / max(1e-6, w))
        self._tenant_vtime[t] = v
        pending.vtime = v
        if len(self._tenant_vtime) > 256:  # hostile-ID bound; the
            # vclock floor keeps post-clear arrivals ordered sanely
            self._tenant_vtime.clear()

    # -- adaptive window ---------------------------------------------------

    def _observe_arrival(self, now: float) -> None:
        """EWMA of inter-arrival gaps (locked; called from submit)."""
        self._arrival.observe(now)

    #: Retry-After clamp: never tell a client "now", never park it for
    #: more than 30 s on one hint
    RETRY_AFTER_MIN_S = 0.05
    RETRY_AFTER_MAX_S = 30.0

    def _retry_after_locked(self, backlog: int) -> float:
        """Honest Retry-After for an admission shed: the live arrival
        window's drain estimate for the current backlog (the time that
        backlog took to accumulate), clamped; 1.0 s until any gap has
        been observed (a cold scheduler has no live signal yet)."""
        drain = self._arrival.drain_s(backlog)
        if drain is None:
            return 1.0
        return min(max(drain, self.RETRY_AFTER_MIN_S),
                   self.RETRY_AFTER_MAX_S)

    def _window_s(self) -> float:
        """Effective batching window; policy shared with the cluster leg
        coalescer in sched/window.py (full-length window exactly when a
        max_batch cohort is expected within window_max; idle collapses
        to window_min so solo queries dispatch promptly)."""
        if not self.adaptive_window:
            return self.window_s
        w = self._arrival.window_s()
        self.registry.gauge(obs_metrics.METRIC_SCHED_WINDOW_MS, w * 1e3)
        return w

    def current_window_ms(self) -> float:
        with self._lock:
            return self._window_s() * 1e3

    # -- worker ------------------------------------------------------------

    def _loop(self) -> None:
        rank = _PRIORITY_RANK[PRIORITY_INTERACTIVE]
        while True:
            with self._cv:
                batch = self._next_batch_locked()
                if batch is None:
                    return
                live = sum(1 for p in batch if p.rank == rank)
                self._dispatch_interactive += live
            if batch:
                try:
                    self._dispatch(batch)
                finally:
                    with self._cv:
                        self._dispatch_interactive -= live
                        if live:
                            self._last_interactive = self.clock.now()

    def _next_batch_locked(self) -> Optional[List[_Pending]]:
        """Wait (held lock) until a group is ripe; take it. None = stop."""
        while True:
            if self._closed:
                for p in self._queue:
                    if p.future.set_running_or_notify_cancel():
                        p.future.set_exception(
                            AdmissionError("scheduler closed"))
                self._queue.clear()
                self.registry.gauge(obs_metrics.METRIC_SCHED_QUEUE_DEPTH, 0)
                return None
            if self._paused or not self._queue:
                self._cv.wait()
                continue
            head = min(self._queue, key=lambda p: (p.rank, p.vtime, p.seq))
            now = self.clock.now()
            same = sum(1 for p in self._queue if p.key == head.key)
            window_s = self._window_s()
            ripe = (same >= self.max_batch
                    or now >= head.enqueued + window_s)
            if not ripe:
                self.clock.wait(self._cv, head.enqueued + window_s - now)
                continue
            # coalescing share of each claimed entry's queue wait (the
            # head paid up to the full window; later arrivals less)
            self._claim_window_s = min(max(0.0, now - head.enqueued),
                                       window_s)
            if self.fair_share:
                # global virtual time chases the dispatched head so an
                # idle tenant re-enters at "now", not with banked credit
                self._vclock = max(self._vclock, head.vtime)
            return self._take_locked(head.key, now)

    def _claim_locked(self, p: _Pending, now: float,
                      batch: List[_Pending]) -> None:
        """Move one queued entry into ``batch`` (or fail it), honoring
        cancellation and deadlines — shared by the exact-key take and
        the superset merge so claimed entries behave identically."""
        if not p.future.set_running_or_notify_cancel():
            return  # caller cancelled while queued
        if p.deadline is not None and now > p.deadline:
            self.registry.count(obs_metrics.METRIC_SCHED_DEADLINE_MISS,
                              priority=p.priority)
            p.future.set_exception(QueryDeadlineError(
                f"deadline exceeded after "
                f"{(now - p.enqueued) * 1e3:.1f} ms in queue"))
            return
        wait = now - p.enqueued
        self.registry.observe(obs_metrics.METRIC_SCHED_BATCH_WAIT, wait)
        p.span.record("sched.queue_wait", wait, priority=p.priority)
        window = min(wait, self._claim_window_s)
        if window > 0:
            p.span.record("sched.batch_window", window)
        batch.append(p)

    def _take_locked(self, key: GroupKey, now: float) -> List[_Pending]:
        batch: List[_Pending] = []
        keep: List[_Pending] = []
        for p in self._queue:
            if p.key != key or len(batch) >= self.max_batch:
                keep.append(p)
                continue
            self._claim_locked(p, now, batch)
        if (self._fusion_ok and batch and key.shards is not None
                and len(batch) < self.max_batch
                and all(p.fusible for p in batch)):
            keep = self._merge_superset_locked(key, batch, keep, now)
        self._queue = keep
        self.registry.gauge(obs_metrics.METRIC_SCHED_QUEUE_DEPTH, len(keep))
        return batch

    def _merge_superset_locked(self, key: GroupKey, batch: List[_Pending],
                               keep: List[_Pending], now: float
                               ) -> List[_Pending]:
        """Cross-shard-set fusion: grow the just-taken batch with queued
        fusible queries of the same (index, family) whose shard sets
        merge within the padding budget — the running union may exceed
        the largest member set by at most ``fuse_waste_ratio`` x.
        Admitted entries leave the queue and are claimed exactly like
        exact-key takes; everything else stays queued untouched."""
        union = set(key.shards)
        max_sub = max(len(p.key.shards) for p in batch)
        candidates = sorted(
            (p for p in keep
             if (p.fusible and p.key.index == key.index
                 and p.key.family == key.family)),
            key=lambda p: (p.rank, p.vtime, p.seq))
        admitted: List[_Pending] = []
        merged_keys = set()
        for p in candidates:
            if len(batch) + len(admitted) >= self.max_batch:
                break
            cand = set(p.key.shards)
            new_union = union | cand
            biggest = max(max_sub, len(cand))
            if len(new_union) > self.fuse_waste_ratio * biggest:
                continue  # too much padding; stays queued for later
            union = new_union
            max_sub = biggest
            admitted.append(p)
            merged_keys.add(p.key.shards)
        if not admitted:
            return keep
        admitted_ids = set(map(id, admitted))
        keep = [p for p in keep if id(p) not in admitted_ids]
        before = len(batch)
        for p in admitted:
            self._claim_locked(p, now, batch)
        if len(batch) > before:
            self.registry.count(obs_metrics.METRIC_SCHED_SUPERSET_MERGES,
                              len(merged_keys), family=key.family)
            self.registry.count(obs_metrics.METRIC_SCHED_FUSED_QUERIES,
                              len(batch), family=key.family)
            self.registry.observe_bucketed(
                obs_metrics.METRIC_SCHED_PADDING_WASTE,
                len(union) / max(1, max_sub),
                obs_metrics.PADDING_WASTE_BUCKETS, family=key.family)
        return keep

    def _dispatch(self, batch: List[_Pending]) -> None:
        from pilosa_tpu_torch.sched.deadline import Deadline, deadline_scope

        family = batch[0].key.family
        # Publish the batch's tightest deadline as the dispatch-side
        # budget: downstream layers (cluster fan-out leg timeouts,
        # hedges) cap their waits by what's left of it.
        deadlines = [p.deadline for p in batch if p.deadline is not None]
        scope = (deadline_scope(Deadline(min(deadlines), self.clock.now))
                 if deadlines else deadline_scope(None))
        # single-tenant batches dispatch under the submitter's tenant so
        # cache fills land in the tenant-scoped namespace; a mixed batch
        # (cross-tenant fusion) fills the shared namespace instead
        tenants = {p.tenant for p in batch}
        tscope = (tenant_scope(batch[0].tenant)
                  if len(tenants) == 1 and batch[0].tenant is not None
                  else contextlib.nullcontext())
        # counted before the dispatch: execute_batch completes the
        # callers' futures, and a caller that reads the counters after
        # its result must see the batch that made it
        self.registry.count(obs_metrics.METRIC_SCHED_BATCHES, family=family)
        self.registry.count(obs_metrics.METRIC_SCHED_QUERIES, len(batch),
                          family=family)
        self.registry.observe_bucketed(
            obs_metrics.METRIC_SCHED_BATCH_SIZE, len(batch),
            obs_metrics.BATCH_SIZE_BUCKETS, family=family)
        t0 = time.perf_counter()
        with scope, tscope:
            execute_batch(self.executor, batch)
        elapsed = time.perf_counter() - t0
        self.registry.observe(obs_metrics.METRIC_SCHED_DISPATCH, elapsed)
        self.registry.observe(obs_metrics.METRIC_SCHED_AMORTIZED_DISPATCH,
                              elapsed / len(batch))

    # -- control / test hooks ---------------------------------------------

    def pause(self) -> None:
        """Hold the worker so tests can stage a queue, then resume()."""
        with self._cv:
            self._paused = True
            self._cv.notify_all()

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def wait_queued(self, n: int, timeout: float = 5.0) -> int:
        """Spin (real time) until ≥ n entries are queued; test helper."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                depth = len(self._queue)
            if depth >= n or time.monotonic() >= deadline:
                return depth
            time.sleep(0.0005)

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def stats(self) -> dict:
        """One consistent queue/admission snapshot (the health-plane
        timeline's scheduler probe)."""
        with self._lock:
            return {"queue_depth": len(self._queue),
                    "inflight_admits": self._inflight_admits,
                    "max_queue": self.max_queue,
                    "fair_share": self.fair_share}

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=5.0)


class SchedulingExecutor:
    """Executor facade: ``execute`` routes reads through the scheduler;
    everything else (qcx/holder attrs, write paths) proxies the wrapped
    executor, so call sites built against ``Executor`` keep working."""

    def __init__(self, scheduler: QueryScheduler):
        self.scheduler = scheduler

    def execute(self, index: str, query, shards=None):
        return self.scheduler.execute(index, query, shards=shards)

    def __getattr__(self, name):
        return getattr(self.scheduler.executor, name)
