"""HealthPlane: the standing composition of timeline + SLO + flight.

Port of ``pilosa_tpu/obs/health.py``: ``from_config``, ``attach_api``,
``attach_node``, ``on_breaker_transition``, ``record``,
``slow_traces``, ``timeline_json``, ``start`` and ``stop``. The probes
keep the JAX package's names; the ``tenants`` and ``degrade`` probes
read ``api.tenants`` / ``api.degrade``, and the ``gossip`` and
``membership`` probes the node's gossip agent and membership
(``{"enabled": false}`` until ``enable_gossip`` / ``enable_membership``;
the membership's transitions feed the ``membership_flap`` trigger).
``attach_dax`` waits for the serverless plane.

One object owns the three health-plane parts and the wiring between
them: every timeline sample is handed to the flight recorder's trigger
evaluation, SLO burn gauges are re-published right before each sample
(so the timeline ring records burn history), and request accounting
(`record`) feeds the SLO tracker — piggybacking a cadence check when no
sampler thread runs, which is how `PILOSA_TPU_OBS_TIMELINE=1` exercises
every sampler/trigger/bundle path under the full test suite with zero
background threads.

``attach_api`` registers the probes any API process has (scheduler
queue, cache hit ratio, WAL flush lag, device residency, streaming
ingest, kernel profiles); ``attach_node`` upgrades them to a cluster
node's live subsystems and adds the breaker-state, gossip and
membership reads. Probes read through the owning object at
sample time (``api.scheduler`` may be None now and real after
``enable_scheduler``) so enable order never matters.
"""

from __future__ import annotations

from typing import List, Optional

from pilosa_tpu_torch.analysis import locktrace

from . import metrics as obs_metrics
from .flight import FlightRecorder
from .slo import Objective, SLOTracker
from .timeline import TimelineSampler

__all__ = ["HealthPlane", "Objective"]


def _sched_probe(owner):
    sched = getattr(owner, "scheduler", None)
    if sched is None:
        return {"enabled": False}
    out = {"enabled": True}
    stats = getattr(sched, "stats", None)
    if callable(stats):
        out.update(stats())
    else:
        out["queue_depth"] = sched.queue_depth()
    return out


def _cache_probe(owner):
    cache = getattr(owner, "cache", None)
    if cache is None:
        return {"enabled": False}
    stats = cache.stats()
    hits, misses = stats.get("hits", 0), stats.get("misses", 0)
    total = hits + misses
    return {"enabled": True, "hit_ratio": (hits / total) if total else 0.0,
            "entries": stats.get("entries", 0),
            "bytes": stats.get("bytes", 0),
            "evictions": stats.get("evictions", 0)}


def _wal_probe(holder):
    return {"pending_bytes": holder.wal_bytes(),
            "flush_lag_s": holder.wal_flush_lag_s(),
            "last_lsn": holder.last_lsn()}


def _stream_probe(owner):
    svc = getattr(owner, "stream", None)
    if svc is None:
        return {"enabled": False}
    return svc.stats()


def _tenants_probe(owner):
    reg = getattr(owner, "tenants", None)
    if reg is None:
        return {"enabled": False}
    return reg.timeline_probe()


def _degrade_probe(owner):
    deg = getattr(owner, "degrade", None)
    if deg is None:
        return {"enabled": False}
    return deg.probe()


class HealthPlane:
    """Timeline sampler + SLO tracker + flight recorder, wired."""

    def __init__(self, interval_ms: float = 1000.0, capacity: int = 300,
                 objectives: Optional[List[Objective]] = None,
                 slo_fast_window_s: float = 300.0,
                 slo_slow_window_s: float = 3600.0,
                 slo_bucket_s: float = 5.0,
                 fast_burn_alert: float = 10.0,
                 min_events: int = 5,
                 flight_capacity: int = 16,
                 flight_cooldown_s: float = 30.0,
                 bundle_window_s: float = 60.0,
                 eviction_rate: float = 10.0,
                 wal_stall_s: float = 5.0,
                 ingest_stall_s: float = 5.0,
                 slow_burst_per_s: float = 5.0,
                 membership_flap_transitions: float = 6.0,
                 directive_churn_bumps: float = 8.0,
                 dump_dir: str = "",
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 clock=None, node_id: str = "local"):
        self.registry = registry or obs_metrics.REGISTRY
        self.node_id = node_id
        self.timeline = TimelineSampler(
            interval_ms=interval_ms, capacity=capacity,
            registry=self.registry, clock=clock)
        self.clock = self.timeline.clock
        self.slo = SLOTracker(
            objectives=objectives, fast_window_s=slo_fast_window_s,
            slow_window_s=slo_slow_window_s, bucket_s=slo_bucket_s,
            fast_burn_alert=fast_burn_alert, min_events=min_events,
            registry=self.registry, clock=self.clock)
        self.flight = FlightRecorder(
            capacity=flight_capacity, cooldown_s=flight_cooldown_s,
            bundle_window_s=bundle_window_s, eviction_rate=eviction_rate,
            wal_stall_s=wal_stall_s, ingest_stall_s=ingest_stall_s,
            slow_burst_per_s=slow_burst_per_s,
            flap_transitions=membership_flap_transitions,
            directive_churn_bumps=directive_churn_bumps,
            dump_dir=dump_dir, registry=self.registry, clock=self.clock)
        self.flight.bind(self)
        # the slo probe re-evaluates burn on every sample: the sample's
        # probes.slo carries the current burn and the published gauges
        # land in the registry for /metrics and the next sample
        self.timeline.add_probe("slo", self._slo_probe)
        # lock tracer (analysis/locktrace.py): {"enabled": false} noise-
        # free when PILOSA_TPU_LOCKCHECK is off; the flight recorder's
        # lock_violation trigger watches the violation count
        self.timeline.add_probe("locks", locktrace.timeline_probe)
        self.timeline.add_observer(self.flight.observe)

    @classmethod
    def from_config(cls, config=None, **overrides) -> "HealthPlane":
        from ..config import Config
        cfg = config or Config()
        kw = dict(
            interval_ms=cfg.obs_timeline_interval_ms,
            capacity=cfg.obs_timeline_capacity,
            slo_fast_window_s=cfg.obs_timeline_slo_fast_window_s,
            slo_slow_window_s=cfg.obs_timeline_slo_slow_window_s,
            fast_burn_alert=cfg.obs_timeline_slo_fast_burn_alert,
            flight_capacity=cfg.obs_timeline_flight_capacity,
            flight_cooldown_s=cfg.obs_timeline_flight_cooldown_s,
            dump_dir=cfg.obs_timeline_flight_dump_dir,
            ingest_stall_s=cfg.stream_ingest_stall_s,
        )
        kw.update(overrides)
        return cls(**kw)

    def _slo_probe(self) -> dict:
        rows = self.slo.burn_rates()
        return {"max_fast_burn": max((r["fast_burn"] for r in rows),
                                     default=0.0),
                "alerting": [r["name"] for r in rows if r["alerting"]]}

    # -- attachment --------------------------------------------------------

    def attach_api(self, api) -> None:
        from pilosa_tpu_torch.obs import devprof

        self.timeline.add_probe("scheduler", lambda: _sched_probe(api))
        self.timeline.add_probe("cache", lambda: _cache_probe(api))
        self.timeline.add_probe("wal", lambda: _wal_probe(api.holder))
        self.timeline.add_probe("residency",
                                lambda: api.holder.residency_stats())
        # streaming ingest saturation/pause feeds the ingest_stall trigger
        self.timeline.add_probe("stream", lambda: _stream_probe(api))
        # kernel profiles ride every timeline sample, so flight-recorder
        # bundles capture MFU/roofline state at anomaly time
        self.timeline.add_probe("kernels", devprof.timeline_probe)
        # per-tenant top-K rates ride the samples too, so flight bundles
        # capture WHICH tenant was burning during an anomaly
        self.timeline.add_probe("tenants", lambda: _tenants_probe(api))
        # graceful-degradation ladder (sched/degrade.py): both reads go
        # through api.degrade at sample time, so enable_degrade before
        # or after enable_health both wire up. The observer closes the
        # control loop — every timeline sample ticks the state machine.
        self.timeline.add_probe("degrade", lambda: _degrade_probe(api))
        self.timeline.add_observer(
            lambda sample: (api.degrade.observe(sample)
                            if api.degrade is not None else None))

    def attach_node(self, node) -> None:
        """Upgrade probes to the cluster node's live subsystems (the
        executor's scheduler and cache, not the base API's) and add the
        cluster-only reads."""
        self.node_id = node.node.id
        self.timeline.add_probe(
            "scheduler", lambda: _sched_probe(node.executor))
        self.timeline.add_probe(
            "cache", lambda: _cache_probe(node.executor))

        def breakers():
            res = node.executor.resilience
            if res is None:
                return {"enabled": False}
            return {"enabled": True, "states": res.breaker.states()}

        def gossip():
            agent = node.executor.gossip
            if agent is None:
                return {"enabled": False}
            ages = agent.state.origin_ages()
            return {"enabled": True, "origins": ages,
                    "staleness_s": max(ages.values(), default=0.0)}

        def membership():
            m = getattr(node, "membership", None)
            if m is None:
                return {"enabled": False}
            return m.probe()

        self.timeline.add_probe("breakers", breakers)
        self.timeline.add_probe("gossip", gossip)
        self.timeline.add_probe("membership", membership)

    def on_breaker_transition(self, node_id: str, frm: str,
                              to: str) -> None:
        """CircuitBreaker listener: an event-ring append only (a capture
        here would read breaker state back through the probe while the
        breaker is notifying). The open state fires the
        ``breaker_open`` trigger at the next sample."""
        self.flight.record_event("breaker", node=node_id, frm=frm, to=to)

    # -- request accounting ------------------------------------------------

    def record(self, surface: str, latency_s: float,
               error: bool = False, tenant=None) -> None:
        """One request outcome into the SLO tracker; when no sampler
        thread runs, also the piggyback cadence check."""
        self.slo.record(surface, latency_s * 1e3, error=error,
                        tenant=tenant)
        if not self.timeline.running:
            self.timeline.maybe_sample()

    def slow_traces(self, limit: int = 8) -> List[dict]:
        """Newest slow traces from the installed tracer's store (bundle
        material; IDs resolve at /internal/traces/{id})."""
        from . import tracing as T
        tracer = T.get_tracer()
        store = getattr(tracer, "store", None)
        if store is None:
            return []
        slow_ms = getattr(tracer, "slow_ms", 0.0) or 0.0
        slow_ns = slow_ms * 1e6
        out = [t for t in store.list() if t["duration_ns"] >= slow_ns]
        return out[:limit]

    # -- serving -----------------------------------------------------------

    def timeline_json(self, window_s: Optional[float] = None) -> dict:
        return {
            "enabled": True,
            "node": self.node_id,
            "interval_ms": self.timeline.interval_s * 1e3,
            "window_s": window_s,
            "samples": self.timeline.window(window_s),
        }

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self.timeline.start()

    def stop(self) -> None:
        self.timeline.stop()

    close = stop
