"""Per-node remote-leg coalescer: concurrent read legs bound for the
same peer ship as ONE multi-query RPC.

Port of ``pilosa_tpu/cluster/batch.py``. The scheduler's fusion
(``sched/``) helps only the LOCAL leg of a fan-out; without this module
every remote leg pays one HTTP round trip per (query, node). Legs
targeting the same node wait out a shared arrival-rate-adaptive window
(``sched/window.py``, the scheduler's own policy), then one leg is
elected leader and ships the whole cohort through
``InternalClient.query_node_batch`` (``POST /internal/query-batch``).
The serving node runs the batch through its ``execute_many``
superset merge, so a 32-query batch costs it one fused dispatch of its
kernels on its card, with the answers of solo runs.

Leadership is borrowed from the calling leg's thread (no daemon): the
first waiter whose slot has no leader becomes leader, drains up to
``max_batch`` pending legs, sends, demuxes under the lock and hands
leadership back. Per-query failures come back as per-slot errors, so
one bad query never fails its batch-mates; a transport failure of the
whole RPC goes to EVERY member leg, whose own fan-out replica loop then
re-targets only its shards at the next rank. Hedged legs call the same
entry point, so hedge waves coalesce per target node too, and the
remote trace tree rides each batch RPC once, grafted under a
``cluster.batch`` span (a child of the leader's ``cluster.leg``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.cluster.client import LegCancelled, RemoteError
from pilosa_tpu_torch.obs import metrics as obs_metrics
from pilosa_tpu_torch.obs.tracing import active_span, get_tracer
from pilosa_tpu_torch.sched.clock import MonotonicClock
from pilosa_tpu_torch.sched.window import ArrivalWindow


class _BatchToken:
    """Cancellation/timeout view over a batch's member tokens, presented
    through the same interface as resilience.CancellationToken: the
    shared wire call is cancelled only when EVERY member leg cancelled
    (one live member keeps it running), and the transport timeout is the
    laxest member's. A member without a token (or without a timeout)
    pins the batch uncancellable/untimed, matching its solo semantics."""

    __slots__ = ("_tokens", "timeout_s")

    def __init__(self, tokens: Sequence[Optional[object]]):
        self._tokens = list(tokens)
        timeout = None
        if self._tokens and all(
                t is not None and t.timeout_s is not None
                for t in self._tokens):
            timeout = max(t.timeout_s for t in self._tokens)
        self.timeout_s = timeout

    @property
    def cancelled(self) -> bool:
        return bool(self._tokens) and all(
            t is not None and t.cancelled for t in self._tokens)

    def wait(self, timeout: float) -> bool:
        """Interruptible sleep: True if fully cancelled meanwhile. Polls
        in short slices — there is no single event to block on."""
        deadline = time.monotonic() + max(0.0, timeout)
        while True:
            if self.cancelled:
                return True
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            time.sleep(min(0.005, left))


class _Leg:
    __slots__ = ("index", "pql", "shards", "token", "result", "error",
                 "done", "batch_n")

    def __init__(self, index: str, pql: str, shards: List[int], token):
        self.index = index
        self.pql = pql
        self.shards = shards
        self.token = token
        self.result: Optional[List[dict]] = None
        self.error: Optional[Exception] = None
        self.done = False
        self.batch_n = 0  # how many legs shared my RPC (span tag)


class _Slot:
    """Per-target-node coalescing point. The cv shares the batcher-wide
    lock so a notify wakes exactly this node's waiters."""

    __slots__ = ("cv", "pending", "leader")

    def __init__(self, lock: threading.Lock):
        self.cv = threading.Condition(lock)
        self.pending: List[_Leg] = []
        self.leader = False


class NodeBatcher:
    """Coalesces concurrent remote read legs per target node.

    ``run`` is a drop-in for the executor's per-leg
    ``client.query_node`` call (same return shape, same error surface:
    NodeDownError/RemoteError/LegCancelled), so every layer above —
    caches, hedging, replica failover, breakers — composes unchanged.
    """

    def __init__(self, client, *, window_ms: float = 0.2,
                 max_batch: int = 32, adaptive_window: bool = True,
                 window_min_ms: float = 0.05, window_max_ms: float = 2.0,
                 clock=None, registry=None):
        self.client = client
        self.max_batch = max(1, int(max_batch))
        self.clock = clock if clock is not None else MonotonicClock()
        self.registry = registry if registry is not None else (
            obs_metrics.REGISTRY)
        self._arrival = ArrivalWindow(
            max(0.0, float(window_ms)) / 1e3, adaptive=bool(adaptive_window),
            window_min_s=max(0.0, float(window_min_ms)) / 1e3,
            window_max_s=max(0.0, float(window_max_ms)) / 1e3,
            max_batch=self.max_batch)
        self._lock = locktrace.tracked_lock("cluster.batch")
        self._slots: Dict[str, _Slot] = {}

    @classmethod
    def from_config(cls, client, config=None, **overrides) -> "NodeBatcher":
        kw = {}
        if config is not None:
            kw = dict(
                window_ms=config.cluster_batch_window_ms,
                max_batch=config.cluster_batch_max_batch,
                adaptive_window=config.cluster_batch_adaptive_window,
                window_min_ms=config.cluster_batch_window_min_ms,
                window_max_ms=config.cluster_batch_window_max_ms,
            )
        kw.update(overrides)
        return cls(client, **kw)

    # -- leg entry ---------------------------------------------------------

    def run(self, node, index: str, pql: str, shards: Sequence[int],
            token=None) -> List[dict]:
        """Run one remote read leg through the coalescer; blocks until
        the leg's slice of some batch RPC resolves. Returns the same
        wire-results list ``client.query_node`` would; failures raise
        this leg's own error (a per-query remote error, the shared
        transport error, or LegCancelled)."""
        leg = _Leg(index, pql, [int(s) for s in shards], token)
        with self._lock:
            slot = self._slot_locked(node.id)
            self._arrival.observe(self.clock.now())
            slot.pending.append(leg)
            slot.cv.notify_all()
        try:
            self._pump(node, slot, leg)
        except BaseException:
            # never leave an orphan behind for a later leader to ship
            with self._lock:
                if not leg.done:
                    leg.done = True
                    if leg in slot.pending:
                        slot.pending.remove(leg)
            raise
        span = active_span()
        span.set_tag("batched", True)
        if leg.batch_n:
            span.set_tag("batch_queries", leg.batch_n)
        if leg.error is not None:
            raise leg.error
        return leg.result

    def _slot_locked(self, node_id: str) -> _Slot:
        s = self._slots.get(node_id)
        if s is None:
            s = self._slots[node_id] = _Slot(self._lock)
            self.clock.attach(s.cv)
        return s

    def _pump(self, node, slot: _Slot, leg: _Leg) -> None:
        """Wait for the leg to resolve, volunteering as the slot's
        leader whenever it has none (leadership is borrowed from leg
        threads — no background worker to own or leak)."""
        while True:
            with self._lock:
                while True:
                    if leg.done:
                        return
                    tok = leg.token
                    if (tok is not None and tok.cancelled
                            and leg in slot.pending):
                        # not yet shipped: withdraw, mirroring the
                        # unbatched client's pre-send cancel check
                        slot.pending.remove(leg)
                        leg.done = True
                        raise LegCancelled(
                            f"batched leg to {node.id} cancelled")
                    if not slot.leader:
                        slot.leader = True
                        break
                    self.clock.wait(slot.cv, 0.01)
            try:
                self._lead(node, slot)
            finally:
                with self._lock:
                    slot.leader = False
                    slot.cv.notify_all()

    # -- leader ------------------------------------------------------------

    def _lead(self, node, slot: _Slot) -> None:
        """One coalescing round: wait out the adaptive window (or a full
        cohort), take up to max_batch pending legs, ship and demux."""
        deadline: Optional[float] = None
        with self._lock:
            while len(slot.pending) < self.max_batch:
                now = self.clock.now()
                if deadline is None:
                    deadline = now + self._arrival.window_s()
                if now >= deadline:
                    break
                self.clock.wait(slot.cv, deadline - now)
            batch = list(slot.pending[:self.max_batch])
            del slot.pending[:len(batch)]
        if batch:
            self._send(node, batch, slot)

    def _send(self, node, batch: List[_Leg], slot: _Slot) -> None:
        entries = [{"index": l.index, "query": l.pql, "shards": l.shards}
                   for l in batch]
        token = batch[0].token if len(batch) == 1 else _BatchToken(
            [l.token for l in batch])
        self.registry.observe_bucketed(
            obs_metrics.METRIC_CLUSTER_BATCH_SIZE, float(len(batch)),
            obs_metrics.CLUSTER_BATCH_SIZE_BUCKETS)
        self.registry.count(obs_metrics.METRIC_CLUSTER_BATCHED_RPCS,
                            node=node.id)
        try:
            # the remote trace tree grafts here (client._apply_trace),
            # so the peer's rpc.* spans hang under cluster.batch which
            # itself is a child of the leader's cluster.leg
            with get_tracer().start_span("cluster.batch", node=node.id,
                                         queries=len(batch)):
                out = self.client.query_node_batch(node, entries,
                                                   token=token)
            if len(out) != len(batch):
                raise RemoteError(
                    500, f"batch demux: {len(out)} slots for "
                         f"{len(batch)} queries")
        except Exception as exc:
            # whole-RPC failure: every member gets the shared error; each
            # leg's own fan-out replica loop re-targets just its shards
            # (partial-batch failover — batch-mates that already resolved
            # elsewhere are never re-sent)
            with self._lock:
                for leg in batch:
                    if leg.done:
                        continue
                    leg.error = exc
                    leg.batch_n = len(batch)
                    leg.done = True
                    self.registry.count(
                        obs_metrics.METRIC_CLUSTER_BATCH_DEMUX_FAILURES,
                        node=node.id, why="transport")
                slot.cv.notify_all()
            return
        with self._lock:
            for leg, entry in zip(batch, out):
                if leg.done:
                    continue
                if "error" in entry:
                    leg.error = RemoteError(int(entry.get("status", 400)),
                                            str(entry["error"]))
                    self.registry.count(
                        obs_metrics.METRIC_CLUSTER_BATCH_DEMUX_FAILURES,
                        node=node.id, why="query")
                else:
                    leg.result = entry["results"]
                leg.batch_n = len(batch)
                leg.done = True
            slot.cv.notify_all()
