"""Graceful-degradation (brownout) controller.

A four-level ladder — NORMAL -> SHED_BATCH -> BROWNOUT -> SATURATED —
closed over the signals the health timeline already samples, so overload
degrades service in a chosen order instead of collapsing it:

* **SHED_BATCH** (level 1): batch-priority admissions are rejected with
  429 + Retry-After; interactive traffic is untouched.
* **BROWNOUT** (level 2): the result cache may serve the previous entry
  for a query whose version fingerprint has moved on — tagged
  ``stale=true`` on the response — and per-query deadlines tighten
  (``deadline_factor``, with ``brownout_deadline_ms`` imposed on queries
  that carried none), trading freshness and tail work for good-put.
* **SATURATED** (level 3): interactive admissions shed too, with an
  honest Retry-After derived from the live arrival window.

The controller is a passive timeline observer: ``observe(sample)`` is
registered via ``timeline.add_observer`` (the same hook the flight
recorder uses) and reads queue depth from the scheduler probe, SLO
fast-burn from the slo probe, and deadline-miss / device-budget-eviction
rates from the counter-delta map. It never owns a thread; with the
sampler off it ticks on the health plane's piggyback cadence, and under
a ``ManualClock`` soak it ticks deterministically.

Hysteresis, so the ladder cannot flap: escalation may jump straight to
the hottest indicated level but needs ``up_hold`` consecutive samples
past an ENTER edge; recovery steps down ONE level at a time and needs
``down_hold`` consecutive samples below the EXIT edge (ENTER *
``exit_ratio``); and every transition must be ``min_dwell_s`` after the
previous one. Each transition moves the ``degrade_state`` gauge, ticks
``degrade_transitions_total{from=,to=,reason=}``, records a flight-
recorder event (and a bundle via the trigger path when escalating), and
lands a span on the trace store.

``PILOSA_TPU_DEGRADE=0`` (the default) costs nothing: no controller is
constructed, scheduler/cache consult a ``None`` attribute, and no
degrade metric ever ticks.

Port of ``pilosa_tpu/sched/degrade.py``: the same samples drive the same
ladder, transitions and probe in both packages.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.errors import AdmissionError
from pilosa_tpu_torch.obs.metrics import (REGISTRY, METRIC_DEGRADE_SHED,
                                    METRIC_DEGRADE_STATE,
                                    METRIC_DEGRADE_TRANSITIONS,
                                    METRIC_DEVICE_BUDGET_EVICTIONS,
                                    METRIC_DEVICE_STACK_EVICTIONS,
                                    METRIC_SCHED_DEADLINE_MISS)

NORMAL, SHED_BATCH, BROWNOUT, SATURATED = 0, 1, 2, 3
STATE_NAMES = ("normal", "shed_batch", "brownout", "saturated")


class DegradeController:
    """Hysteresis-bounded overload ladder driven by timeline samples."""

    def __init__(self, *,
                 queue_shed: float = 0.50,
                 queue_brownout: float = 0.75,
                 queue_saturate: float = 0.92,
                 burn_shed: float = 2.0,
                 burn_brownout: float = 6.0,
                 burn_saturate: float = 14.0,
                 miss_rate_brownout: float = 1.0,
                 eviction_rate_shed: float = 50.0,
                 exit_ratio: float = 0.7,
                 up_hold: int = 1,
                 down_hold: int = 3,
                 min_dwell_s: float = 1.0,
                 deadline_factor: float = 0.5,
                 brownout_deadline_ms: float = 250.0,
                 stale_ttl_ms: float = 30000.0,
                 retry_after_s: float = 1.0,
                 registry=None,
                 flight=None,
                 retry_after_fn: Optional[Callable[[], float]] = None):
        self.queue_edges = (queue_shed, queue_brownout, queue_saturate)
        self.burn_edges = (burn_shed, burn_brownout, burn_saturate)
        self.miss_rate_brownout = miss_rate_brownout
        self.eviction_rate_shed = eviction_rate_shed
        self.exit_ratio = exit_ratio
        self.up_hold = max(1, int(up_hold))
        self.down_hold = max(1, int(down_hold))
        self.min_dwell_s = min_dwell_s
        self.deadline_factor = deadline_factor
        self.brownout_deadline_s = brownout_deadline_ms / 1e3
        self.stale_ttl_s = stale_ttl_ms / 1e3
        self.default_retry_after_s = retry_after_s
        self.registry = registry if registry is not None else REGISTRY
        #: flight recorder to event/bundle transitions into (set by the
        #: wiring in api.enable_degrade; read at transition time so the
        #: enable order of the health and degrade planes is irrelevant)
        self.flight = flight
        #: live Retry-After source (the scheduler's arrival-window drain
        #: estimate); falls back to the static default until wired
        self.retry_after_fn = retry_after_fn
        self._lock = locktrace.tracked_lock("sched.degrade")
        self._level = NORMAL
        self._up_streak = 0
        self._down_streak = 0
        self._last_transition_t: Optional[float] = None
        self._transitions = 0
        self._last_signals: Dict[str, float] = {}
        self.registry.gauge(METRIC_DEGRADE_STATE, float(NORMAL))

    @classmethod
    def from_config(cls, config=None, **overrides) -> "DegradeController":
        from pilosa_tpu_torch.config import Config

        cfg = config or Config()
        kw: Dict[str, Any] = dict(
            queue_shed=cfg.degrade_queue_shed,
            queue_brownout=cfg.degrade_queue_brownout,
            queue_saturate=cfg.degrade_queue_saturate,
            burn_shed=cfg.degrade_burn_shed,
            burn_brownout=cfg.degrade_burn_brownout,
            burn_saturate=cfg.degrade_burn_saturate,
            miss_rate_brownout=cfg.degrade_miss_rate_brownout,
            eviction_rate_shed=cfg.degrade_eviction_rate_shed,
            exit_ratio=cfg.degrade_exit_ratio,
            up_hold=cfg.degrade_up_hold,
            down_hold=cfg.degrade_down_hold,
            min_dwell_s=cfg.degrade_min_dwell_s,
            deadline_factor=cfg.degrade_deadline_factor,
            brownout_deadline_ms=cfg.degrade_brownout_deadline_ms,
            stale_ttl_ms=cfg.degrade_stale_ttl_ms,
            retry_after_s=cfg.degrade_retry_after_s,
        )
        kw.update(overrides)
        return cls(**kw)

    # -- ladder state ------------------------------------------------------

    @property
    def level(self) -> int:
        return self._level

    def state(self) -> str:
        return STATE_NAMES[self._level]

    def brownout_active(self) -> bool:
        """True at BROWNOUT or hotter — the cache's stale-serve gate."""
        return self._level >= BROWNOUT

    def shed_reason(self, priority: str) -> Optional[str]:
        """Admission verdict for the current level: the 429 reason when
        this priority class is being shed, else None. Batch sheds from
        SHED_BATCH up; interactive only at SATURATED (the ladder's
        whole point is that order)."""
        lvl = self._level
        if lvl >= SHED_BATCH and priority == "batch":
            return "degrade_shed_batch"
        if lvl >= SATURATED:
            return "degrade_saturated"
        return None

    def shed(self, priority: str,
             retry_after_s: Optional[float] = None) -> AdmissionError:
        """Build the 429 for a ladder shed (counted here so every shed
        is attributable to the level that caused it). The scheduler
        passes its live arrival-window drain estimate as
        ``retry_after_s``; otherwise ``retry_after_fn`` / the static
        default supply the hint."""
        reason = self.shed_reason(priority) or "degrade_saturated"
        self.registry.count(METRIC_DEGRADE_SHED, priority=priority,
                            level=STATE_NAMES[self._level])
        retry = retry_after_s
        if retry is None and self.retry_after_fn is not None:
            try:
                retry = self.retry_after_fn()
            except Exception:
                retry = None
        if retry is None or retry <= 0:
            retry = self.default_retry_after_s
        return AdmissionError(
            f"degraded ({self.state()}): shedding {priority} work "
            f"({reason})", retry_after_s=retry)

    def tighten_deadline(self, deadline_s: float) -> float:
        """BROWNOUT+ tightens per-query deadlines: scale the caller's
        budget by ``deadline_factor``, or impose the brownout default on
        queries that carried none (<= 0)."""
        if self._level < BROWNOUT:
            return deadline_s
        if deadline_s > 0:
            return deadline_s * self.deadline_factor
        return self.brownout_deadline_s

    # -- timeline observer -------------------------------------------------

    def observe(self, sample: Dict[str, Any]) -> None:
        """Timeline observer: fold one sample's signals into the ladder."""
        sig = self._signals(sample)
        now = float(sample.get("t", 0.0))
        with self._lock:
            self._last_signals = sig
            target_enter = self._target_level(sig, 1.0)
            target_exit = self._target_level(sig, self.exit_ratio)
            lvl = self._level
            if target_enter > lvl:
                self._up_streak += 1
                self._down_streak = 0
                if self._up_streak >= self.up_hold and self._dwelled(now):
                    self._transition(target_enter, now, sig)
            elif target_exit < lvl:
                self._down_streak += 1
                self._up_streak = 0
                if self._down_streak >= self.down_hold \
                        and self._dwelled(now):
                    # recovery is deliberate: one rung at a time
                    self._transition(lvl - 1, now, sig)
            else:
                self._up_streak = 0
                self._down_streak = 0

    def _signals(self, sample: Dict[str, Any]) -> Dict[str, float]:
        probes = sample.get("probes") or {}
        sched = probes.get("scheduler") or {}
        queue_frac = 0.0
        try:
            mq = float(sched.get("max_queue") or 0)
            if mq > 0:
                depth = float(sched.get("queue_depth") or 0)
                depth += float(sched.get("inflight_admits") or 0)
                queue_frac = depth / mq
        except (TypeError, ValueError):
            pass
        slo = probes.get("slo") or {}
        try:
            burn = float(slo.get("max_fast_burn") or 0.0)
        except (TypeError, ValueError):
            burn = 0.0
        rates = sample.get("rates") or {}

        def _rate(prefix: str) -> float:
            return sum(v for series, v in rates.items()
                       if series.startswith(prefix))

        return {
            "queue_frac": queue_frac,
            "fast_burn": burn,
            "deadline_miss_rate": _rate(METRIC_SCHED_DEADLINE_MISS),
            "eviction_rate": (_rate(METRIC_DEVICE_BUDGET_EVICTIONS)
                              + _rate(METRIC_DEVICE_STACK_EVICTIONS)),
        }

    def _target_level(self, sig: Dict[str, float], scale: float) -> int:
        """Hottest level any signal indicates, with edges scaled by
        ``scale`` (1.0 = ENTER edges; ``exit_ratio`` = EXIT edges)."""
        q, b = sig["queue_frac"], sig["fast_burn"]
        lvl = NORMAL
        for i, edge in enumerate(self.queue_edges):
            if q >= edge * scale:
                lvl = max(lvl, i + 1)
        for i, edge in enumerate(self.burn_edges):
            if b >= edge * scale:
                lvl = max(lvl, i + 1)
        if sig["deadline_miss_rate"] >= self.miss_rate_brownout * scale:
            lvl = max(lvl, BROWNOUT)
        if sig["eviction_rate"] >= self.eviction_rate_shed * scale:
            lvl = max(lvl, SHED_BATCH)
        return lvl

    def _dwelled(self, now: float) -> bool:
        last = self._last_transition_t
        return last is None or (now - last) >= self.min_dwell_s

    def _transition(self, to: int, now: float,
                    sig: Dict[str, float]) -> None:
        frm = self._level
        self._level = to
        self._last_transition_t = now
        self._up_streak = 0
        self._down_streak = 0
        self._transitions += 1
        reason = self._reason(sig, to) if to > frm else "recovered"
        self.registry.gauge(METRIC_DEGRADE_STATE, float(to))
        self.registry.count(METRIC_DEGRADE_TRANSITIONS,
                            **{"from": STATE_NAMES[frm],
                               "to": STATE_NAMES[to], "reason": reason})
        from pilosa_tpu_torch.obs.tracing import get_tracer

        with get_tracer().start_trace("degrade.transition", frm=frm,
                                      to=to, reason=reason):
            pass
        fl = self.flight
        if fl is not None:
            fl.record_event("degrade_transition",
                            frm=STATE_NAMES[frm], to=STATE_NAMES[to],
                            reason=reason,
                            **{k: round(v, 4) for k, v in sig.items()})
            if to > frm:
                # escalations are worth a full diagnostic bundle (the
                # trigger path is cooldown-gated, so a storm of rungs
                # cannot flood the ring)
                fl.trigger("degrade_escalation",
                           f"{STATE_NAMES[frm]}->{STATE_NAMES[to]} "
                           f"({reason})",
                           {"t": now, "signals": dict(sig)})

    def _reason(self, sig: Dict[str, float], to: int) -> str:
        """Name the signal that pushed the ladder to ``to``."""
        if sig["queue_frac"] >= self.queue_edges[min(to, 3) - 1]:
            return "queue_depth"
        if sig["fast_burn"] >= self.burn_edges[min(to, 3) - 1]:
            return "slo_fast_burn"
        if to >= BROWNOUT \
                and sig["deadline_miss_rate"] >= self.miss_rate_brownout:
            return "deadline_miss_rate"
        if sig["eviction_rate"] >= self.eviction_rate_shed:
            return "eviction_storm"
        return "composite"

    # -- introspection -----------------------------------------------------

    def probe(self) -> Dict[str, Any]:
        """Timeline probe / /internal/degrade payload."""
        with self._lock:
            return {
                "enabled": True,
                "state": STATE_NAMES[self._level],
                "level": self._level,
                "transitions": self._transitions,
                "up_streak": self._up_streak,
                "down_streak": self._down_streak,
                "signals": dict(self._last_signals),
            }

    def reset(self) -> None:
        """Drop back to NORMAL (test/ops hook; not a transition)."""
        with self._lock:
            self._level = NORMAL
            self._up_streak = self._down_streak = 0
            self._last_transition_t = None
            self.registry.gauge(METRIC_DEGRADE_STATE, float(NORMAL))
