"""SLO tracker: declarative per-surface objectives + multi-window burn.

Port of ``pilosa_tpu/obs/slo.py``, unchanged in behaviour.

"Is the cluster healthy" needs a definition; an SLO gives one: "99% of
queries complete under 250ms". The tracker counts good/bad events per
surface (query / sql / ingest) in coarse time buckets and computes the
**burn rate** — the fraction of events violating the objective divided
by the error budget (1 - target) — over two windows:

- fast (default 5m): catches a sharp regression within minutes
- slow (default 1h): catches a slow leak that would exhaust the
  monthly budget anyway

This is the standard multi-window multi-burn-rate alerting shape (the
Google SRE workbook pairing); a fast burn >= the alert threshold is the
flight recorder's primary trigger. Burn rates are re-published as
``slo_burn_rate{slo=,window=}`` gauges on every evaluation so the
timeline ring records the burn history too; ``status()`` is the full
status (the /internal/slo route waits for the port's server slice).
The clock is injectable for deterministic tests.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Dict, List, Optional

from . import metrics as obs_metrics
from .timeline import WallClock

from pilosa_tpu_torch.analysis import locktrace


@dataclasses.dataclass(frozen=True)
class Objective:
    name: str            # gauge label, e.g. "query-latency"
    surface: str         # "query" | "sql" | "ingest"
    kind: str            # "latency" | "errors"
    target: float        # good fraction, e.g. 0.99
    threshold_ms: float = 0.0  # latency objectives: bad above this

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def default_objectives() -> List[Objective]:
    """The per-surface defaults the health plane ships with. Latency
    thresholds sit just above the warm-path p99 on CPU; error objectives
    budget one failure per thousand requests."""
    return [
        Objective("query-latency", "query", "latency", 0.99,
                  threshold_ms=250.0),
        Objective("sql-latency", "sql", "latency", 0.99,
                  threshold_ms=500.0),
        Objective("ingest-latency", "ingest", "latency", 0.95,
                  threshold_ms=1000.0),
        Objective("query-errors", "query", "errors", 0.999),
        Objective("sql-errors", "sql", "errors", 0.999),
        Objective("ingest-errors", "ingest", "errors", 0.999),
    ]


class SLOTracker:
    """Coarse-bucketed good/bad accounting with burn-rate evaluation."""

    def __init__(self, objectives: Optional[List[Objective]] = None,
                 fast_window_s: float = 300.0,
                 slow_window_s: float = 3600.0,
                 bucket_s: float = 5.0,
                 fast_burn_alert: float = 10.0,
                 min_events: int = 5,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 clock=None):
        self.objectives = list(objectives) if objectives is not None \
            else default_objectives()
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = max(float(slow_window_s), self.fast_window_s)
        self.bucket_s = max(0.001, float(bucket_s))
        self.fast_burn_alert = float(fast_burn_alert)
        self.min_events = int(min_events)
        self.registry = registry or obs_metrics.REGISTRY
        self.clock = clock or WallClock()
        self._lock = locktrace.tracked_lock("obs.slo")
        # each bucket: {"t": start, "surfaces": {surface:
        #   {"total": n, "errors": n, "bad": {objective_name: n}}}}
        maxlen = int(self.slow_window_s / self.bucket_s) + 2
        self._buckets: deque = deque(maxlen=maxlen)
        self._lat_objs: Dict[str, List[Objective]] = {}
        for o in self.objectives:
            if o.kind == "latency":
                self._lat_objs.setdefault(o.surface, []).append(o)
        # tenant dimension: bounded set of tenant IDs ever recorded —
        # past the cap new tenants fold into one overflow cell so a
        # hostile ID stream can't grow the evaluation (or gauge labels)
        self.tenant_cap = 32
        self._tenant_ids: set = set()

    # -- recording ---------------------------------------------------------

    def _accumulate(self, cell: dict, surface: str, latency_ms: float,
                    error: bool) -> None:
        cell["total"] += 1
        if error:
            cell["errors"] += 1
        else:
            for o in self._lat_objs.get(surface, ()):
                if latency_ms > o.threshold_ms:
                    cell["bad"][o.name] = cell["bad"].get(o.name, 0) + 1

    def record(self, surface: str, latency_ms: float,
               error: bool = False, tenant: Optional[str] = None) -> None:
        now = self.clock.now()
        start = (now // self.bucket_s) * self.bucket_s
        with self._lock:
            if not self._buckets or self._buckets[-1]["t"] != start:
                self._buckets.append({"t": start, "surfaces": {}})
            bucket = self._buckets[-1]
            cell = bucket["surfaces"].setdefault(
                surface, {"total": 0, "errors": 0, "bad": {}})
            self._accumulate(cell, surface, latency_ms, error)
            if tenant is None:
                return
            if tenant not in self._tenant_ids:
                if len(self._tenant_ids) >= self.tenant_cap:
                    tenant = "__other__"
                self._tenant_ids.add(tenant)
            tcell = bucket.setdefault("tenants", {}).setdefault(
                tenant, {}).setdefault(
                    surface, {"total": 0, "errors": 0, "bad": {}})
            self._accumulate(tcell, surface, latency_ms, error)

    # -- evaluation --------------------------------------------------------

    def _window_counts(self, surface: str, window_s: float,
                       now: float) -> Dict[str, float]:
        cutoff = now - window_s
        total = errors = 0
        bad: Dict[str, int] = {}
        for b in self._buckets:
            if b["t"] + self.bucket_s <= cutoff:
                continue
            cell = b["surfaces"].get(surface)
            if cell is None:
                continue
            total += cell["total"]
            errors += cell["errors"]
            for name, n in cell["bad"].items():
                bad[name] = bad.get(name, 0) + n
        return {"total": total, "errors": errors, "bad": bad}

    def _burn(self, o: Objective, counts: dict) -> float:
        total = counts["total"]
        if total <= 0:
            return 0.0
        bad = counts["errors"] if o.kind == "errors" \
            else counts["bad"].get(o.name, 0)
        budget = max(1e-9, 1.0 - o.target)
        return (bad / total) / budget

    def burn_rates(self, now: Optional[float] = None) -> List[dict]:
        """Evaluate every objective over both windows, publish the
        ``slo_burn_rate`` gauges, and return the per-objective status."""
        if now is None:
            now = self.clock.now()
        out = []
        with self._lock:
            per_surface = {}
            for o in self.objectives:
                if o.surface not in per_surface:
                    per_surface[o.surface] = {
                        "fast": self._window_counts(
                            o.surface, self.fast_window_s, now),
                        "slow": self._window_counts(
                            o.surface, self.slow_window_s, now),
                    }
                c = per_surface[o.surface]
                fast = self._burn(o, c["fast"])
                slow = self._burn(o, c["slow"])
                out.append({
                    "name": o.name, "surface": o.surface, "kind": o.kind,
                    "target": o.target, "threshold_ms": o.threshold_ms,
                    "fast_burn": fast, "slow_burn": slow,
                    "events_fast": c["fast"]["total"],
                    "events_slow": c["slow"]["total"],
                    "alerting": (fast >= self.fast_burn_alert
                                 and c["fast"]["total"] >= self.min_events),
                })
        for row in out:
            self.registry.gauge(obs_metrics.METRIC_SLO_BURN_RATE,
                                row["fast_burn"], slo=row["name"],
                                window="fast")
            self.registry.gauge(obs_metrics.METRIC_SLO_BURN_RATE,
                                row["slow_burn"], slo=row["name"],
                                window="slow")
        return out

    def alerting(self, now: Optional[float] = None) -> List[dict]:
        """Objectives whose fast burn crossed the alert threshold (with
        at least ``min_events`` in the window — a single bad request must
        not page anyone)."""
        return [r for r in self.burn_rates(now) if r["alerting"]]

    # -- tenant dimension --------------------------------------------------

    def _tenant_window(self, window_s: float,
                       now: float) -> Dict[tuple, dict]:
        """(tenant, surface) -> counts over the window (locked callers
        only)."""
        cutoff = now - window_s
        agg: Dict[tuple, dict] = {}
        for b in self._buckets:
            if b["t"] + self.bucket_s <= cutoff:
                continue
            for tenant, surfaces in b.get("tenants", {}).items():
                for surface, cell in surfaces.items():
                    a = agg.setdefault((tenant, surface),
                                       {"total": 0, "errors": 0, "bad": {}})
                    a["total"] += cell["total"]
                    a["errors"] += cell["errors"]
                    for name, n in cell["bad"].items():
                        a["bad"][name] = a["bad"].get(name, 0) + n
        return agg

    def tenant_burn_rates(self, now: Optional[float] = None) -> List[dict]:
        """Per-(tenant, objective) burn over both windows, published as
        ``slo_burn_rate{slo=,tenant=,window=}`` gauges. Returns []
        without touching the buckets when no tenant-tagged event was
        ever recorded — the plane-off path stays free."""
        if now is None:
            now = self.clock.now()
        out: List[dict] = []
        empty = {"total": 0, "errors": 0, "bad": {}}
        with self._lock:
            if not self._tenant_ids:
                return out
            fast = self._tenant_window(self.fast_window_s, now)
            slow = self._tenant_window(self.slow_window_s, now)
            # union of both windows: a tenant quiet for the last few
            # minutes must still report (and decay) its slow burn
            for tenant, surface in sorted(set(fast) | set(slow)):
                c_fast = fast.get((tenant, surface), empty)
                c_slow = slow.get((tenant, surface), empty)
                for o in self.objectives:
                    if o.surface != surface:
                        continue
                    fb = self._burn(o, c_fast)
                    out.append({
                        "tenant": tenant, "name": o.name,
                        "surface": surface, "kind": o.kind,
                        "fast_burn": fb,
                        "slow_burn": self._burn(o, c_slow),
                        "events_fast": c_fast["total"],
                        "events_slow": c_slow["total"],
                        "alerting": (fb >= self.fast_burn_alert
                                     and c_fast["total"] >= self.min_events),
                    })
        for row in out:
            self.registry.gauge(obs_metrics.METRIC_SLO_BURN_RATE,
                                row["fast_burn"], slo=row["name"],
                                tenant=row["tenant"], window="fast")
            self.registry.gauge(obs_metrics.METRIC_SLO_BURN_RATE,
                                row["slow_burn"], slo=row["name"],
                                tenant=row["tenant"], window="slow")
        return out

    def tenant_alerting(self, now: Optional[float] = None) -> List[dict]:
        """Tenant rows whose fast burn crossed the alert threshold —
        the ``tenant_burn`` flight-recorder trigger's input."""
        return [r for r in self.tenant_burn_rates(now) if r["alerting"]]

    def status(self, now: Optional[float] = None) -> dict:
        rows = self.burn_rates(now)
        out = {
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "fast_burn_alert": self.fast_burn_alert,
            "objectives": rows,
            "alerting": [r["name"] for r in rows if r["alerting"]],
        }
        trows = self.tenant_burn_rates(now)
        if trows:
            out["tenants"] = trows
        return out
