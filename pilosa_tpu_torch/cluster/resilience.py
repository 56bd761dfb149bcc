"""Remote fan-out resilience: hedged legs, breakers, adaptive timeouts.

Port of ``pilosa_tpu/cluster/resilience.py``. The coordinator's fan-out
latency is the ``max`` over its per-node legs
(``cluster/executor.py:_fan_shards``), so one straggling or flapping
node sets the tail of every distributed query. This module makes the
remote leg defend itself:

- **Hedged requests**: once a leg has been outstanding longer than a
  rolling per-node latency percentile, its shards are duplicated onto
  the next live replica rank; the first complete answer wins and the
  loser is cancelled through a :class:`CancellationToken` that
  ``InternalClient`` honours. Partials reduce under shard-partition
  monoids, so a hedge wave's per-node partials give the same answer as
  the original leg's single partial. Only READ fan-outs hedge
  (``_WRITE_CALLS`` take the replica-mirroring write path, never this
  module).
- **Per-node circuit breakers**: consecutive transport failures or leg
  timeouts open a node's breaker, so later fan-outs route its shards
  straight to replicas instead of paying the timeout again; after
  ``breaker_open_ms`` one half-open probe leg goes through, and its
  success closes the breaker (the node rejoins membership).
- **Adaptive per-leg timeouts**: ``timeout_factor`` x the node's p99
  leg latency, clamped to [timeout_min, timeout_max] and to the query's
  deadline budget (``sched/deadline.py``), so a retry or a hedge never
  outlives its query.
- **Deterministic fault injection**: :class:`FaultPlan` injects seeded
  drops, delays and flaps per target node at the ``InternalClient``
  transport boundary, so every behaviour above is reproducible in tests
  (``PILOSA_TPU_FAULT_SEED`` picks the seed).

The legs carry host-to-host traffic only: each node's own kernels run
on its card inside the leg that the peer serves.
"""

from __future__ import annotations

import contextvars
import os
import random
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.cluster.client import LegCancelled, NodeDownError
from pilosa_tpu_torch.obs import metrics as obs_metrics
from pilosa_tpu_torch.obs.tracing import get_tracer
from pilosa_tpu_torch.sched.clock import MonotonicClock
from pilosa_tpu_torch.sched.deadline import remaining_budget_s


class CancellationToken:
    """Cooperative leg cancellation + per-leg timeout carrier, plumbed
    through ``InternalClient._request``: a cancelled token aborts before
    the next send / between retries, and ``timeout_s`` caps the
    transport timeout of every request made under it."""

    __slots__ = ("_ev", "timeout_s")

    def __init__(self, timeout_s: Optional[float] = None):
        self._ev = threading.Event()
        self.timeout_s = timeout_s

    def cancel(self) -> None:
        self._ev.set()

    @property
    def cancelled(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: float) -> bool:
        """Interruptible sleep: returns True if cancelled meanwhile."""
        return self._ev.wait(max(0.0, timeout))


# -- rolling per-node latency ------------------------------------------------


class LatencyTracker:
    """Rolling per-node leg-latency window with percentile reads.

    A bounded deque per node (plus a cluster-wide fallback window for
    nodes without samples yet) — the exact-percentile analog of a P²
    estimator at the window sizes fan-out cares about (<= a few hundred
    samples), without its convergence caveats."""

    def __init__(self, window: int = 64):
        self.window = max(4, int(window))
        self._lock = locktrace.tracked_lock("cluster.resilience.latency")
        self._per_node: Dict[str, deque] = {}
        self._global: deque = deque(maxlen=self.window)

    def observe(self, node_id: str, seconds: float) -> None:
        with self._lock:
            d = self._per_node.get(node_id)
            if d is None:
                d = self._per_node[node_id] = deque(maxlen=self.window)
            d.append(seconds)
            self._global.append(seconds)

    def percentile(self, node_id: Optional[str], q: float) -> Optional[float]:
        """q in [0, 100]; falls back to the cluster-wide window when the
        node has no samples; None when nothing was ever observed."""
        with self._lock:
            d = self._per_node.get(node_id) if node_id is not None else None
            if not d:
                d = self._global
            if not d:
                return None
            xs = sorted(d)
        i = min(len(xs) - 1, int(q / 100.0 * len(xs)))
        return xs[i]


# -- per-node circuit breakers ----------------------------------------------

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half-open"
# gauge encoding for cluster_breaker_state{node=...}
_BREAKER_GAUGE = {BREAKER_CLOSED: 0.0, BREAKER_HALF_OPEN: 1.0,
                  BREAKER_OPEN: 2.0}


class _BreakerSlot:
    __slots__ = ("state", "failures", "changed_at", "probe_at", "remote")

    def __init__(self):
        self.state = BREAKER_CLOSED
        self.failures = 0
        self.changed_at = 0.0
        self.probe_at: Optional[float] = None
        # True while the current state came from a peer's gossiped
        # observation rather than our own evidence; local evidence
        # (record_success/record_failure) always clears it
        self.remote = False


class CircuitBreaker:
    """Per-node closed -> open -> half-open -> closed state machine.

    ``threshold`` consecutive failures open a node's breaker; while open,
    :meth:`allow` vetoes it (the executor routes its shards to replicas
    at assign time). After ``open_s`` the next :meth:`allow` grants ONE
    half-open probe leg; its success closes the breaker, its failure
    re-opens. A probe that never reports (e.g. the probing query died
    elsewhere) expires after another ``open_s`` so the node is not
    stranded half-open forever."""

    def __init__(self, threshold: int = 3, open_s: float = 3.0,
                 clock=None, registry=None,
                 on_transition: Optional[
                     Callable[[str, str, str], None]] = None):
        self.threshold = max(1, int(threshold))
        self.open_s = max(0.0, float(open_s))
        self.clock = clock if clock is not None else MonotonicClock()
        self.registry = registry if registry is not None else (
            obs_metrics.REGISTRY)
        self._on_transition = on_transition
        self._lock = locktrace.tracked_lock("cluster.resilience.breaker")
        self._slots: Dict[str, _BreakerSlot] = {}
        # extra observers of LOCAL transitions (gossip publishes these to
        # peers); not fired for apply_remote, so a gossiped state never
        # echoes back out as our own observation
        self._listeners: List[Callable[[str, str, str], None]] = []

    def add_listener(self, fn: Callable[[str, str, str], None]) -> None:
        self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[str, str, str], None]) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def _slot(self, node_id: str) -> _BreakerSlot:
        s = self._slots.get(node_id)
        if s is None:
            s = self._slots[node_id] = _BreakerSlot()
        return s

    def _transition(self, node_id: str, slot: _BreakerSlot,
                    to: str, notify: bool = True
                    ) -> Optional[Tuple[str, str, str]]:
        """State change + metrics, under the caller's lock. Returns the
        (node_id, frm, to) event the caller must pass to :meth:`_fire`
        AFTER releasing ``self._lock`` (None when nothing to fire):
        ``on_transition``/listeners are arbitrary external callbacks —
        gossip publishes, health-plane hooks — and invoking one while
        holding the breaker lock is the exact deadlock shape the health
        plane once dodged (a listener that calls back into ``state()``/
        ``allow()`` self-deadlocks; one that takes its own lock inverts
        against that lock's holders calling into the breaker)."""
        frm = slot.state
        if frm == to:
            return None
        slot.state = to
        slot.changed_at = self.clock.now()
        self.registry.gauge(obs_metrics.METRIC_CLUSTER_BREAKER_STATE,
                            _BREAKER_GAUGE[to], node=node_id)
        self.registry.count(obs_metrics.METRIC_CLUSTER_BREAKER_TRANSITIONS,
                            node=node_id, to=to)
        return (node_id, frm, to) if notify else None

    def _fire(self, event: Optional[Tuple[str, str, str]]) -> None:
        """Deliver a transition event outside the lock (no-op on None)."""
        if event is None:
            return
        node_id, frm, to = event
        if self._on_transition is not None:
            self._on_transition(node_id, frm, to)
        for fn in list(self._listeners):
            fn(node_id, frm, to)

    def apply_remote(self, node_id: str, state: str) -> bool:
        """Adopt a peer's gossiped breaker observation. Open/half-open
        always apply (a peer saw the node fail; pre-warm instead of
        re-learning the hard way) — adopted as OPEN so OUR open_s
        countdown gates our own probe. A gossiped close only applies if
        our current state itself came from gossip: local failure
        evidence outranks a peer's recovery claim. Listeners are not
        notified (this is not our observation). Returns True when a
        transition happened."""
        if state not in _BREAKER_GAUGE:
            return False
        with self._lock:
            slot = self._slot(node_id)
            if state in (BREAKER_OPEN, BREAKER_HALF_OPEN):
                if slot.state != BREAKER_CLOSED:
                    return False  # already defending; keep our countdown
                self._transition(node_id, slot, BREAKER_OPEN, notify=False)
                slot.remote = True
                slot.probe_at = None
                return True
            # state == closed
            if slot.state == BREAKER_CLOSED or not slot.remote:
                return False
            slot.remote = False
            slot.failures = 0
            slot.probe_at = None
            self._transition(node_id, slot, BREAKER_CLOSED, notify=False)
            return True

    def state(self, node_id: str) -> str:
        with self._lock:
            return self._slot(node_id).state

    def states(self) -> Dict[str, str]:
        """Every tracked node's current state (closed slots included) —
        the health-plane timeline's breaker probe. Read-only: no
        open->half-open promotion side effects (unlike ``allow``)."""
        with self._lock:
            return {nid: s.state for nid, s in sorted(self._slots.items())}

    def allow(self, node_id: str) -> bool:
        """May a leg be routed at this node right now? Grants the
        half-open probe as a side effect, so only call when a granted
        leg will actually be sent."""
        now = self.clock.now()
        event = None
        try:
            with self._lock:
                slot = self._slot(node_id)
                if slot.state == BREAKER_CLOSED:
                    return True
                if slot.state == BREAKER_OPEN:
                    if now - slot.changed_at >= self.open_s:
                        event = self._transition(node_id, slot,
                                                 BREAKER_HALF_OPEN)
                        slot.probe_at = now
                        return True
                    return False
                # half-open: one probe outstanding; re-grant if expired
                if slot.probe_at is None or \
                        now - slot.probe_at >= self.open_s:
                    slot.probe_at = now
                    return True
                return False
        finally:
            self._fire(event)

    def record_success(self, node_id: str) -> None:
        with self._lock:
            slot = self._slot(node_id)
            slot.failures = 0
            slot.probe_at = None
            slot.remote = False  # our own evidence from here on
            event = self._transition(node_id, slot, BREAKER_CLOSED)
        self._fire(event)

    def record_failure(self, node_id: str) -> None:
        event = None
        with self._lock:
            slot = self._slot(node_id)
            slot.probe_at = None
            slot.remote = False  # our own evidence from here on
            if slot.state == BREAKER_HALF_OPEN:
                event = self._transition(node_id, slot, BREAKER_OPEN)
            else:
                slot.failures += 1
                if slot.failures >= self.threshold:
                    event = self._transition(node_id, slot, BREAKER_OPEN)
        self._fire(event)


# -- deterministic fault injection ------------------------------------------


class InjectedFault(OSError):
    """A FaultPlan drop: subclasses OSError so InternalClient's
    transport-error handling (retry -> NodeDownError) treats it exactly
    like a real connection failure."""


class _FaultRule:
    __slots__ = ("kind", "seconds", "first", "count", "prob", "period",
                 "op")

    def __init__(self, kind: str, seconds: float = 0.0, first: int = 0,
                 count: Optional[int] = None, prob: Optional[float] = None,
                 period: int = 2, op: Optional[str] = None):
        self.kind = kind
        self.seconds = seconds
        self.first = first
        self.count = count
        self.prob = prob
        self.period = max(1, int(period))
        self.op = op

    def matches(self, k: int, rng_hit: Callable[[], float],
                op: Optional[str] = None) -> bool:
        if self.op is not None and self.op != op:
            return False
        if k < self.first:
            return False
        if self.count is not None and k >= self.first + self.count:
            return False
        if self.kind == "flap" and (k - self.first) % self.period != 0:
            return False
        if self.prob is not None and rng_hit() >= self.prob:
            return False
        return True


class _LinkRule(_FaultRule):
    """A directed network-partition rule: drop requests whose SOURCE is
    in ``srcs`` and TARGET in ``dsts``. Only acts when the client
    declares its identity (``InternalClient.self_id``, set by
    ClusterNode) — an anonymous client sees no link faults, so external
    callers and test doubles are unaffected."""

    __slots__ = ("srcs", "dsts")

    def __init__(self, srcs, dsts, **kw):
        super().__init__("partition", **kw)
        self.srcs = frozenset(srcs)
        self.dsts = frozenset(dsts)


class FaultPlan:
    """Seeded, deterministic faults at the internode-RPC boundary.

    Attach to an ``InternalClient`` (``client.fault_plan = plan`` or via
    ``LocalCluster(fault_plan=...)``); every request consults the plan
    keyed on the TARGET node id, in per-node arrival order, so a given
    (seed, rule set, request sequence) always injects the same faults —
    chaos coverage that is reproducible and gateable in CI.

    Rules (evaluated in insertion order; first match acts):

    - ``drop(node)``      raise :class:`InjectedFault` (a transport
                          error: retried, then surfaced as NodeDownError)
    - ``delay(node, s)``  sleep ``s`` before sending (token-interruptible
                          so cancelled hedge losers don't linger)
    - ``flap(node)``      drop every ``period``-th request starting at
                          ``first`` — an intermittently failing node

    Each accepts ``first`` (0-based per-node request index the rule arms
    at), ``count`` (how many matching indices it stays armed for),
    ``prob`` (seeded per-request probability; omitted = always) and
    ``op`` (scope the rule to one RPC boundary — the client tags
    "query" / "query_batch" / "import" / "translate" / "sql" /
    "broadcast" / "gossip" / "recovery" / "stats"; omitted = every
    op). Per-node request indices count ALL ops, so
    op-scoped rules see the same arrival order the wire does. The seed
    defaults to ``PILOSA_TPU_FAULT_SEED`` (0 when unset)."""

    def __init__(self, seed: Optional[int] = None, sleep=None):
        if seed is None:
            seed = int(os.environ.get("PILOSA_TPU_FAULT_SEED", "0"))
        self.seed = int(seed)
        self._sleep = sleep if sleep is not None else time.sleep
        self._lock = locktrace.tracked_lock("cluster.resilience.faultplan")
        self._rules: Dict[str, List[_FaultRule]] = {}
        self._links: List[_LinkRule] = []
        self._counts: Dict[str, int] = {}
        self.events: List[Tuple[str, int, str]] = []  # (node, k, action)

    # -- rule builders (chainable) ----------------------------------------

    def drop(self, node_id: str, first: int = 0,
             count: Optional[int] = None,
             prob: Optional[float] = None,
             op: Optional[str] = None) -> "FaultPlan":
        self._rules.setdefault(node_id, []).append(
            _FaultRule("drop", first=first, count=count, prob=prob, op=op))
        return self

    def delay(self, node_id: str, seconds: float, first: int = 0,
              count: Optional[int] = None,
              prob: Optional[float] = None,
              op: Optional[str] = None) -> "FaultPlan":
        self._rules.setdefault(node_id, []).append(
            _FaultRule("delay", seconds=seconds, first=first, count=count,
                       prob=prob, op=op))
        return self

    def flap(self, node_id: str, period: int = 2, first: int = 0,
             count: Optional[int] = None,
             op: Optional[str] = None) -> "FaultPlan":
        self._rules.setdefault(node_id, []).append(
            _FaultRule("flap", first=first, count=count, period=period,
                       op=op))
        return self

    def partition(self, nodes_a, nodes_b, *, symmetric: bool = True,
                  op: Optional[str] = None, first: int = 0,
                  count: Optional[int] = None,
                  prob: Optional[float] = None) -> "FaultPlan":
        """Network partition between node sets A and B: requests whose
        declared source is on one side and target on the other raise
        :class:`InjectedFault`. ``symmetric=False`` drops only the
        A->B direction (the asymmetric-link case: A cannot reach B but
        B still reaches A). ``op`` scopes the cut to one RPC boundary
        (e.g. ``op="ping"`` severs only membership probes while gossip
        and queries deliver). ``first``/``count``/``prob`` use the
        TARGET node's per-node arrival index, like every other rule.
        Omit ``prob`` for a clean deterministic cut."""
        a, b = list(nodes_a), list(nodes_b)
        self._links.append(_LinkRule(a, b, op=op, first=first, count=count,
                                     prob=prob))
        if symmetric:
            self._links.append(_LinkRule(b, a, op=op, first=first,
                                         count=count, prob=prob))
        return self

    def heal(self) -> "FaultPlan":
        """Remove every partition rule (per-node drop/delay/flap rules
        stay; use :meth:`clear` for those)."""
        with self._lock:
            self._links.clear()
        return self

    def seen(self, node_id: str) -> int:
        """Requests observed for ``node_id`` while rules were armed —
        the per-node index the NEXT matching request will get. Use as
        ``first=plan.seen(node)`` to arm a rule at "from now on"."""
        with self._lock:
            return self._counts.get(node_id, 0)

    def clear(self, node_id: Optional[str] = None) -> "FaultPlan":
        with self._lock:
            if node_id is None:
                self._rules.clear()
            else:
                self._rules.pop(node_id, None)
        return self

    # -- injection point (called by InternalClient._request) ---------------

    def _hit_rng(self, node_id: str, k: int) -> Callable[[], float]:
        # string-seeded Random is PYTHONHASHSEED-independent (seeded via
        # sha512), so the decision stream is stable across processes
        return random.Random(f"{self.seed}:{node_id}:{k}").random

    def on_request(self, node_id: str,
                   token: Optional[CancellationToken] = None,
                   op: Optional[str] = None,
                   source: Optional[str] = None) -> None:
        with self._lock:
            rules = list(self._rules.get(node_id, ()))
            links = ([] if source is None else
                     [l for l in self._links if source in l.srcs
                      and node_id in l.dsts])
            if not rules and not links:
                return
            k = self._counts.get(node_id, 0)
            self._counts[node_id] = k + 1
            rule = next(
                (r for r in rules
                 if r.matches(k, self._hit_rng(node_id, k), op)),
                None)
            if rule is None:
                rule = next(
                    (l for l in links
                     if l.matches(k, self._hit_rng(node_id, k), op)),
                    None)
            if rule is not None:
                self.events.append((node_id, k, rule.kind))
        if rule is None:
            return
        if rule.kind == "delay":
            if token is not None:
                token.wait(rule.seconds)
            else:
                self._sleep(rule.seconds)
            if token is not None and token.cancelled:
                raise LegCancelled(f"leg to {node_id} cancelled mid-delay")
            return
        raise InjectedFault(
            f"injected {rule.kind} on {node_id} (request #{k})")


# -- the manager -------------------------------------------------------------


class _Leg:
    __slots__ = ("node_id", "shards", "token", "t0", "fut", "is_hedge",
                 "group", "done", "span", "tags")

    def __init__(self, node_id: str, shards: Tuple[int, ...],
                 token: CancellationToken, t0: float, is_hedge: bool,
                 group: "_LegGroup"):
        self.node_id = node_id
        self.shards = shards
        self.token = token
        self.t0 = t0
        self.fut = None
        self.is_hedge = is_hedge
        self.group = group
        self.done = False
        self.span = None  # cluster.leg span, set by the pool worker
        # terminal tags decided for this leg; a span that opens after the
        # race was decided (its worker started late) still gets them
        self.tags: Dict[str, Any] = {}


class _LegGroup:
    """One primary remote leg and (optionally) its hedge wave. The wave
    is a set of legs whose shard sets partition the primary's, so either
    side's partials reduce to the same answer."""

    __slots__ = ("shards", "primary", "wave", "wave_parts", "hedged",
                 "primary_failed", "wave_broken", "resolved")

    def __init__(self, shards: Tuple[int, ...]):
        self.shards = shards
        self.primary: Optional[_Leg] = None
        self.wave: Optional[List[_Leg]] = None
        self.wave_parts: Dict[int, Any] = {}
        self.hedged = False
        self.primary_failed = False
        self.wave_broken = False
        self.resolved = False


class Resilience:
    """Fan-out resilience manager, attached to a ClusterExecutor
    (``ClusterNode.enable_resilience``). Owns the latency tracker, the
    per-node breakers and the hedged-leg race; the executor keeps the
    placement math and the reduce."""

    def __init__(self, *, hedge: bool = True,
                 hedge_percentile: float = 95.0,
                 hedge_min_ms: float = 2.0, hedge_max_ms: float = 2000.0,
                 breaker_threshold: int = 3, breaker_open_ms: float = 3000.0,
                 timeout_factor: float = 4.0, timeout_min_ms: float = 50.0,
                 timeout_max_ms: float = 30000.0, latency_window: int = 64,
                 clock=None, registry=None,
                 on_node_up: Optional[Callable[[str], None]] = None,
                 on_breaker_transition: Optional[
                     Callable[[str, str, str], None]] = None):
        self.hedge = bool(hedge)
        self.hedge_percentile = min(100.0, max(0.0, float(hedge_percentile)))
        self.hedge_min_s = max(0.0, float(hedge_min_ms)) / 1e3
        self.hedge_max_s = max(self.hedge_min_s, float(hedge_max_ms) / 1e3)
        self.timeout_factor = max(1.0, float(timeout_factor))
        self.timeout_min_s = max(0.0, float(timeout_min_ms)) / 1e3
        self.timeout_max_s = max(self.timeout_min_s,
                                 float(timeout_max_ms) / 1e3)
        self.clock = clock if clock is not None else MonotonicClock()
        self.registry = registry if registry is not None else (
            obs_metrics.REGISTRY)
        self.tracker = LatencyTracker(window=latency_window)
        self._on_node_up = on_node_up

        def _transition(nid: str, frm: str, to: str) -> None:
            if to == BREAKER_CLOSED and frm != BREAKER_CLOSED \
                    and self._on_node_up is not None:
                self._on_node_up(nid)
            if on_breaker_transition is not None:
                on_breaker_transition(nid, frm, to)

        self.breaker = CircuitBreaker(
            threshold=breaker_threshold, open_s=breaker_open_ms / 1e3,
            clock=self.clock, registry=self.registry,
            on_transition=_transition)

    @classmethod
    def from_config(cls, config=None, **overrides) -> "Resilience":
        kw: Dict[str, Any] = {}
        if config is not None:
            kw = dict(
                hedge=config.cluster_resilience_hedge,
                hedge_percentile=config.cluster_resilience_hedge_percentile,
                hedge_min_ms=config.cluster_resilience_hedge_min_ms,
                hedge_max_ms=config.cluster_resilience_hedge_max_ms,
                breaker_threshold=config.cluster_resilience_breaker_threshold,
                breaker_open_ms=config.cluster_resilience_breaker_open_ms,
                timeout_factor=config.cluster_resilience_timeout_factor,
                timeout_min_ms=config.cluster_resilience_timeout_min_ms,
                timeout_max_ms=config.cluster_resilience_timeout_max_ms,
                latency_window=config.cluster_resilience_latency_window,
            )
        kw.update(overrides)
        return cls(**kw)

    # -- per-node policy ---------------------------------------------------

    def hedge_delay_s(self, node_id: str) -> float:
        p = self.tracker.percentile(node_id, self.hedge_percentile)
        if p is None:
            p = self.hedge_min_s
        return min(max(p, self.hedge_min_s), self.hedge_max_s)

    def leg_timeout_s(self, node_id: str) -> float:
        """Adaptive transport timeout for one leg: factor x the node's
        p99, clamped, then capped by the query's remaining deadline
        budget (a hedge/retry must never outlive its query)."""
        p = self.tracker.percentile(node_id, 99.0)
        t = self.timeout_max_s if p is None else self.timeout_factor * p
        t = min(max(t, self.timeout_min_s), self.timeout_max_s)
        budget = remaining_budget_s()
        if budget is not None:
            t = max(0.0, min(t, budget))
        return t

    def vetoed(self, candidates: Sequence[str]) -> Set[str]:
        """Nodes whose breaker refuses traffic right now. Half-open
        probes are granted here (the caller routes legs to every
        non-vetoed candidate immediately after)."""
        return {nid for nid in candidates if not self.breaker.allow(nid)}

    # -- the hedged leg race ----------------------------------------------

    def run_legs(self, remote: Dict[str, List[int]], nodes: Dict[str, Any],
                 run_remote, next_owners, *, hedgeable: bool = True,
                 local_fn=None,
                 mark_failed: Callable[[str, bool], None] = lambda n, t: None,
                 ) -> Tuple[List[Any], List[int]]:
        """Run one fan-out wave with hedging/timeouts/breaker accounting.

        ``remote`` maps node id -> shard list (one primary leg each);
        ``run_remote(node, shards, token)`` produces a partial;
        ``next_owners(shards, racing_node_id)`` re-assigns shards onto
        the next live replica rank, never the racing node;
        ``local_fn`` runs the coordinator-local leg on this thread while
        remote legs are in flight; ``mark_failed(node_id, transport)``
        lets the executor grow its per-query dead set (and membership,
        for real transport errors). Returns ``(parts, failed_shards)`` —
        failed shards re-enter the executor's replica-failover loop."""
        clock = self.clock
        parts: List[Any] = []
        failed: List[int] = []
        groups: List[_LegGroup] = []
        active: Dict[Any, _Leg] = {}
        pool = ThreadPoolExecutor(
            max_workers=max(2, 2 * len(remote)),
            thread_name_prefix="pilosa-fanout")

        def submit(leg: _Leg) -> None:
            # capture the submitting context (span scope AND deadline
            # scope — the leg timeout was already budgeted pre-submit, so
            # re-entering the full context changes no timing semantics)
            # and re-enter it on the pool worker: the leg's span stays a
            # child of the coordinator's query span across the thread hop
            ctx = contextvars.copy_context()

            def traced():
                with get_tracer().start_span(
                        "cluster.leg", node=leg.node_id,
                        hedge=leg.is_hedge,
                        shards=len(leg.shards)) as sp:
                    leg.span = sp
                    for k, v in list(leg.tags.items()):
                        sp.set_tag(k, v)
                    return run_remote(nodes[leg.node_id], list(leg.shards),
                                      leg.token)

            def call():
                return ctx.run(traced)
            leg.fut = pool.submit(call)
            active[leg.fut] = leg

        def start_leg(nid: str, shards: Sequence[int], group: _LegGroup,
                      is_hedge: bool) -> _Leg:
            token = CancellationToken(timeout_s=self.leg_timeout_s(nid))
            leg = _Leg(nid, tuple(shards), token, clock.now(), is_hedge,
                       group)
            submit(leg)
            return leg

        for nid, s in remote.items():
            g = _LegGroup(tuple(s))
            g.primary = start_leg(nid, s, g, is_hedge=False)
            groups.append(g)

        def observe(leg: _Leg, ok: bool) -> None:
            elapsed = clock.now() - leg.t0
            if ok:
                self.tracker.observe(leg.node_id, elapsed)
                self.breaker.record_success(leg.node_id)
            else:
                self.breaker.record_failure(leg.node_id)
            self.registry.observe_bucketed(
                obs_metrics.METRIC_CLUSTER_LEG_LATENCY, elapsed * 1e3,
                obs_metrics.LEG_LATENCY_BUCKETS_MS,
                outcome="ok" if ok else "err",
                kind="hedge" if leg.is_hedge else "primary")

        def cancel_wave(g: _LegGroup) -> None:
            for leg in g.wave or ():
                if not leg.done:
                    leg.token.cancel()

        def tag_span(leg: Optional[_Leg], **tags) -> None:
            # the tags go on the leg first and then on its span if it is
            # open; the worker opens the span first and then copies the
            # leg's tags, so a tag lands whichever thread runs first
            if leg is None:
                return
            leg.tags.update(tags)
            if leg.span is not None:
                for k, v in tags.items():
                    leg.span.set_tag(k, v)

        def group_failed(g: _LegGroup) -> None:
            if not g.resolved:
                g.resolved = True
                failed.extend(g.shards)

        def leg_success(leg: _Leg, result: Any) -> None:
            g = leg.group
            observe(leg, ok=True)
            if g.resolved:
                # loser finished after the race was decided: result is
                # discarded, so the span gets its terminal tag here
                if leg.token.cancelled:
                    tag_span(leg, cancelled=True)
                return
            if not leg.is_hedge:
                g.resolved = True
                parts.append(result)
                if g.wave:
                    tag_span(leg, hedge_won=True)
                    for l in g.wave:
                        tag_span(l, hedge_won=False)
                cancel_wave(g)
                return
            g.wave_parts[id(leg)] = result
            if all(l.done and id(l) in g.wave_parts for l in g.wave):
                g.resolved = True
                parts.extend(g.wave_parts[id(l)] for l in g.wave)
                self.registry.count(obs_metrics.METRIC_CLUSTER_HEDGE_WINS)
                for l in g.wave:
                    tag_span(l, hedge_won=True)
                tag_span(g.primary, hedge_won=False)
                if g.primary is not None and not g.primary.done:
                    g.primary.token.cancel()

        def leg_failure(leg: _Leg, transport: bool) -> None:
            g = leg.group
            observe(leg, ok=False)
            mark_failed(leg.node_id, transport)
            if g.resolved:
                return
            if not leg.is_hedge:
                g.primary_failed = True
                if g.wave is None or g.wave_broken:
                    group_failed(g)
                return
            g.wave_broken = True
            cancel_wave(g)
            if g.primary_failed:
                group_failed(g)

        def maybe_hedge(g: _LegGroup, now: float) -> None:
            if (not hedgeable or not self.hedge or g.hedged or g.resolved
                    or g.primary_failed):
                return
            if now - g.primary.t0 < self.hedge_delay_s(g.primary.node_id):
                return
            g.hedged = True
            budget = remaining_budget_s()
            if budget is not None and budget <= 0:
                return  # query already out of budget: nothing to win
            try:
                assign = next_owners(list(g.shards), g.primary.node_id)
            except NodeDownError:
                return  # no live replica to hedge onto
            wave = []
            for hnid, hshards in assign.items():
                if hnid == g.primary.node_id:
                    raise AssertionError(
                        f"hedge re-targeted the racing node {hnid}")
                wave.append(start_leg(hnid, hshards, g, is_hedge=True))
                self.registry.count(obs_metrics.METRIC_CLUSTER_HEDGES)
            g.wave = wave or None

        def check_timeouts(now: float) -> None:
            for leg in list(active.values()):
                if leg.done or leg.token.timeout_s is None:
                    continue
                # small grace over the transport timeout: the socket
                # layer enforces the hard bound, this reaps legs stuck
                # pre-connect (e.g. an injected delay)
                if now - leg.t0 <= leg.token.timeout_s + 1e-3:
                    continue
                leg.done = True
                active.pop(leg.fut, None)
                leg.token.cancel()
                self.registry.count(obs_metrics.METRIC_CLUSTER_LEG_TIMEOUTS,
                                    node=leg.node_id)
                tag_span(leg, timeout=True)
                leg_failure(leg, transport=False)

        if local_fn is not None:
            parts.append(local_fn())
        try:
            while any(not g.resolved for g in groups):
                now = clock.now()
                for g in groups:
                    maybe_hedge(g, now)
                check_timeouts(now)
                if not active:
                    # every outstanding leg timed out or failed; any
                    # still-unresolved group can make no progress
                    for g in groups:
                        if not g.resolved:
                            group_failed(g)
                    break
                done, _ = futures_wait(list(active), timeout=0.01,
                                       return_when=FIRST_COMPLETED)
                for fut in done:
                    leg = active.pop(fut, None)
                    if leg is None or leg.done:
                        continue
                    leg.done = True
                    err = fut.exception()
                    if err is None:
                        leg_success(leg, fut.result())
                    elif isinstance(err, LegCancelled):
                        # cancelled loser: no penalty, no result — but a
                        # terminal tag, so trace-derived latency
                        # attribution can drop parked legs instead of
                        # counting their wait as real node time
                        tag_span(leg, cancelled=True)
                    elif isinstance(err, NodeDownError):
                        leg_failure(leg, transport=True)
                    else:
                        raise err  # application errors surface unchanged
        finally:
            # losers may still be draining a socket; don't block the
            # query on them — their tokens are cancelled and results
            # are discarded on arrival
            for leg in active.values():
                leg.token.cancel()
                tag_span(leg, cancelled=True)
            pool.shutdown(wait=False)
        return parts, failed
