"""Tenant attribution plane: who consumed what, and the quotas that
make the numbers actionable.

Three layers, smallest first:

- ``TenantContext``: a contextvar (same shape as the query deadline in
  sched/deadline.py) carrying the current tenant ID. HTTP extracts it
  from the ``X-Tenant`` header (or ``?tenant=``), the internal client
  re-injects it on fan-out RPCs alongside ``traceparent``, and trace
  roots tag it — so one tenant's work is attributable across the whole
  cluster hop graph.
- ``TenantRegistry``: a BOUNDED per-tenant accounting table (queries,
  errors, rejections, rows ingested, device-seconds via the device
  profiler's fold hook, cache hits/bytes via the ResultCache tenant
  hook, WAL bytes via the storage.wal append hook).
  Published as ``tenant_*`` gauges under a top-K label guard and served
  raw at ``GET /internal/tenants``.
- quotas: per-tenant token buckets (QPS, ingest rows/s) whose
  exhaustion raises QuotaExceededError -> HTTP 429 + Retry-After, and
  per-tenant weights the scheduler's weighted-fair admission ordering
  reads.

Unknown/absent/garbage tenant values NEVER fail the request: they clamp
to the ``"default"`` tenant and bump ``tenant_unattributed_total``.

When the plane is disabled (``api.tenants is None``) the request path
does no tenant work at all beyond one ``is None`` check — the
module-level ``SCOPE_COUNT`` proves zero scopes are entered then.

Port of ``pilosa_tpu/obs/tenants.py``. One departure: a tenant's
``device_seconds`` is the card's own clock of its launches, charged when
a launch folds (``obs/devprof.py``), not the wall time of a synchronous
dispatch. The launch carries the tenant that opened it, so the charge
lands on that tenant whatever thread folds it.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Dict, Optional, Tuple

from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.errors import QuotaExceededError

from . import metrics as obs_metrics

__all__ = [
    "DEFAULT_TENANT", "TenantRegistry", "current_tenant_id",
    "normalize_tenant", "reset_current_tenant", "set_current_tenant",
    "tenant_scope",
]

DEFAULT_TENANT = "default"

#: tenant IDs are operator-facing labels: printable ASCII slug, bounded
MAX_TENANT_LEN = 64
_ALLOWED = frozenset(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789._-")

_CURRENT: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "pilosa_tenant", default=None)

#: scopes entered since import — the disabled-path allocation proof
#: (it must not move while the plane is off)
SCOPE_COUNT = 0


def current_tenant_id() -> Optional[str]:
    """The tenant the calling context acts as (None = no tenant plane
    touched this request)."""
    return _CURRENT.get()


def set_current_tenant(tenant_id: Optional[str]):
    """Low-level scope entry returning the reset token — for the HTTP
    handler, whose enter/exit spans a try/finally rather than a with."""
    global SCOPE_COUNT
    SCOPE_COUNT += 1
    return _CURRENT.set(tenant_id)


def reset_current_tenant(token) -> None:
    _CURRENT.reset(token)


@contextlib.contextmanager
def tenant_scope(tenant_id: Optional[str]):
    """All work inside the block is attributed to ``tenant_id``."""
    token = set_current_tenant(tenant_id)
    try:
        yield tenant_id
    finally:
        _CURRENT.reset(token)


def normalize_tenant(raw) -> Tuple[str, bool]:
    """Clamp an untrusted tenant value to a safe ID; returns
    ``(tenant_id, attributed)``. Never raises: absent/empty values and
    garbage (oversized, non-ASCII, disallowed characters) all map to
    the default tenant with ``attributed=False``."""
    if raw is None:
        return DEFAULT_TENANT, False
    if not isinstance(raw, str):
        try:
            raw = str(raw)
        except Exception:
            return DEFAULT_TENANT, False
    raw = raw.strip()
    if not raw or len(raw) > MAX_TENANT_LEN or not _ALLOWED.issuperset(raw):
        return DEFAULT_TENANT, False
    return raw, True


class TokenBucket:
    """Classic token bucket; ``rate`` units/s refill up to ``burst``.
    ``rate <= 0`` means unlimited (every take succeeds)."""

    __slots__ = ("rate", "burst", "tokens", "_last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self._last = now

    def take(self, n: float, now: float) -> Optional[float]:
        """Consume ``n`` tokens; returns None on success, else the
        seconds until enough tokens will have refilled (Retry-After)."""
        if self.rate <= 0:
            return None
        self.tokens = min(self.burst,
                          self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= n:
            self.tokens -= n
            return None
        return (n - self.tokens) / self.rate


class _TenantStats:
    __slots__ = ("queries", "errors", "rejected", "rows_ingested",
                 "device_seconds", "cache_hits", "cache_bytes",
                 "wal_bytes")

    def __init__(self):
        self.queries = 0
        self.errors = 0
        self.rejected = 0
        self.rows_ingested = 0
        self.device_seconds = 0.0
        self.cache_hits = 0
        self.cache_bytes = 0
        self.wal_bytes = 0

    def to_json(self) -> dict:
        return {
            "queries": self.queries,
            "errors": self.errors,
            "rejected": self.rejected,
            "rows_ingested": self.rows_ingested,
            "device_seconds": round(self.device_seconds, 6),
            "cache_hits": self.cache_hits,
            "cache_bytes": self.cache_bytes,
            "wal_bytes": self.wal_bytes,
        }


#: tenants beyond the tracked bound aggregate here — the table stays
#: finite no matter how many distinct IDs a hostile client invents
OVERFLOW_TENANT = "__other__"


class TenantRegistry:
    """Bounded per-tenant accounting + token-bucket quotas + fair-share
    weights. One instance per API process (``api.tenants``)."""

    def __init__(self, max_tracked: int = 64, top_k: int = 8,
                 default_qps: float = 0.0,
                 default_ingest_rows_s: float = 0.0,
                 cache_quota_bytes: int = 0,
                 qps_burst_s: float = 2.0,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 clock=None):
        self.max_tracked = max(2, int(max_tracked))
        self.top_k = max(1, int(top_k))
        self.default_qps = float(default_qps)
        self.default_ingest_rows_s = float(default_ingest_rows_s)
        self.cache_quota_bytes = int(cache_quota_bytes)
        #: burst window: a bucket holds qps_burst_s seconds of rate
        self.qps_burst_s = max(0.1, float(qps_burst_s))
        self.registry = registry or obs_metrics.REGISTRY
        self.clock = clock or time.monotonic
        self._lock = locktrace.tracked_lock("obs.tenants")
        self._stats: Dict[str, _TenantStats] = {}
        self._qps: Dict[str, TokenBucket] = {}
        self._ingest: Dict[str, TokenBucket] = {}
        self._quotas: Dict[str, Dict[str, float]] = {}
        self._weights: Dict[str, float] = {}
        self._dropped = 0
        # timeline-probe rate state: last counter snapshot + timestamp
        self._probe_t: Optional[float] = None
        self._probe_snap: Dict[str, Tuple[int, int]] = {}
        self._hooks_installed = False
        self._prev_fold_hook = None
        self._prev_wal_hook = None

    @classmethod
    def from_config(cls, config=None, **overrides) -> "TenantRegistry":
        from pilosa_tpu_torch.config import Config
        cfg = config or Config()
        kw = dict(
            max_tracked=cfg.tenants_max_tracked,
            top_k=cfg.tenants_top_k,
            default_qps=cfg.tenants_default_qps,
            default_ingest_rows_s=cfg.tenants_default_ingest_rows_s,
            cache_quota_bytes=cfg.tenants_cache_quota_bytes,
        )
        kw.update(overrides)
        return cls(**kw)

    # -- attribution -------------------------------------------------------

    def resolve(self, raw) -> str:
        """Normalize an untrusted tenant value, counting unattributed
        requests. Never raises (satellite 3's contract)."""
        tenant, attributed = normalize_tenant(raw)
        if not attributed:
            self.registry.count(obs_metrics.METRIC_TENANT_UNATTRIBUTED)
        return tenant

    def _slot(self, tenant: Optional[str]) -> _TenantStats:
        """The stats cell for ``tenant`` (locked callers only); tenants
        past the tracked bound share the overflow cell."""
        t = tenant or DEFAULT_TENANT
        st = self._stats.get(t)
        if st is None:
            if len(self._stats) >= self.max_tracked:
                self._dropped += 1
                return self._stats.setdefault(OVERFLOW_TENANT,
                                              _TenantStats())
            st = self._stats[t] = _TenantStats()
        return st

    def note(self, tenant: Optional[str], queries: int = 0,
             errors: int = 0, rejected: int = 0, rows: int = 0,
             device_seconds: float = 0.0, cache_hits: int = 0,
             cache_bytes: int = 0, wal_bytes: int = 0) -> None:
        with self._lock:
            st = self._slot(tenant)
            st.queries += queries
            st.errors += errors
            st.rejected += rejected
            st.rows_ingested += rows
            st.device_seconds += device_seconds
            st.cache_hits += cache_hits
            st.cache_bytes += cache_bytes
            st.wal_bytes += wal_bytes

    def note_query(self, tenant: Optional[str],
                   error: bool = False) -> None:
        self.note(tenant, queries=1, errors=1 if error else 0)

    # -- quotas ------------------------------------------------------------

    def set_quota(self, tenant: str, qps: Optional[float] = None,
                  ingest_rows_s: Optional[float] = None,
                  cache_bytes: Optional[int] = None) -> None:
        """Per-tenant overrides; drops any existing bucket so the new
        rate takes effect on the next charge."""
        with self._lock:
            q = self._quotas.setdefault(tenant, {})
            if qps is not None:
                q["qps"] = float(qps)
                self._qps.pop(tenant, None)
            if ingest_rows_s is not None:
                q["ingest_rows_s"] = float(ingest_rows_s)
                self._ingest.pop(tenant, None)
            if cache_bytes is not None:
                q["cache_bytes"] = int(cache_bytes)

    def cache_quota_for(self, tenant: Optional[str]) -> int:
        """Resident-cache byte quota for ``tenant``: its [tenants.<id>]
        override when set, else the registry-wide default (0 = no
        cap). The result cache consults this per insert."""
        with self._lock:
            q = self._quotas.get(tenant or DEFAULT_TENANT, {})
            return int(q.get("cache_bytes", self.cache_quota_bytes))

    def apply_overrides(self, overrides) -> None:
        """Install ``[tenants.<id>]`` config stanzas (config.py
        tenants_overrides): per-tenant qps / ingest-rows-s /
        cache-bytes quotas and fair-share weight."""
        for tid, kv in (overrides or {}).items():
            self.set_quota(tid, qps=kv.get("qps"),
                           ingest_rows_s=kv.get("ingest_rows_s"),
                           cache_bytes=kv.get("cache_bytes"))
            if kv.get("weight") is not None:
                self.set_weight(tid, kv["weight"])

    def set_weight(self, tenant: str, weight: float) -> None:
        with self._lock:
            self._weights[tenant] = max(1e-6, float(weight))

    def weight(self, tenant: Optional[str]) -> float:
        """Fair-share weight the scheduler's stride ordering consumes."""
        with self._lock:
            return self._weights.get(tenant or DEFAULT_TENANT, 1.0)

    def _bucket(self, table: Dict[str, TokenBucket], tenant: str,
                kind: str, default_rate: float,
                now: float) -> Optional[TokenBucket]:
        b = table.get(tenant)
        if b is None:
            rate = self._quotas.get(tenant, {}).get(kind, default_rate)
            if rate <= 0:
                return None
            burst = max(1.0, rate * self.qps_burst_s)
            b = table[tenant] = TokenBucket(rate, burst, now)
            if len(table) > 4 * self.max_tracked:  # hostile-ID bound
                table.clear()
                table[tenant] = b
        return b

    def charge_query(self, tenant: Optional[str]) -> None:
        """One query against the tenant's QPS bucket; raises
        QuotaExceededError (-> 429 + Retry-After) when exhausted."""
        t = tenant or DEFAULT_TENANT
        now = self.clock()
        with self._lock:
            b = self._bucket(self._qps, t, "qps", self.default_qps, now)
            retry = b.take(1.0, now) if b is not None else None
            if retry is not None:
                self._slot(t).rejected += 1
        if retry is not None:
            self.registry.count(obs_metrics.METRIC_TENANT_REJECTED,
                                tenant=t, kind="qps")
            raise QuotaExceededError(
                f"tenant {t!r} over query quota", retry_after_s=retry)

    def charge_ingest(self, tenant: Optional[str], rows: int) -> None:
        """``rows`` against the tenant's ingest bucket; same contract
        as charge_query."""
        if rows <= 0:
            return
        t = tenant or DEFAULT_TENANT
        now = self.clock()
        with self._lock:
            b = self._bucket(self._ingest, t, "ingest_rows_s",
                             self.default_ingest_rows_s, now)
            retry = b.take(float(rows), now) if b is not None else None
            if retry is not None:
                self._slot(t).rejected += 1
        if retry is not None:
            self.registry.count(obs_metrics.METRIC_TENANT_REJECTED,
                                tenant=t, kind="ingest")
            raise QuotaExceededError(
                f"tenant {t!r} over ingest quota", retry_after_s=retry)

    # -- consumption hooks (cache / WAL / device) --------------------------

    def cache_hook(self, kind: str, n: int) -> None:
        """ResultCache tenant hook: ``("hit", 1)`` per tenant-scoped hit,
        ``("bytes", cost)`` per insert."""
        t = current_tenant_id()
        if t is None:
            return
        if kind == "hit":
            self.note(t, cache_hits=n)
        else:
            self.note(t, cache_bytes=n)

    def install_hooks(self) -> None:
        """Chain onto the device profiler's fold hook (device-seconds
        per launch, charged to the tenant that opened the launch when it
        folds) and the WAL append hook (bytes per record). Chaining
        preserves whatever was installed first; while the fold hook is
        installed the launch sites time their launches even with the
        profiler's tables off."""
        if self._hooks_installed:
            return
        from pilosa_tpu_torch.obs import devprof
        from pilosa_tpu_torch.storage import wal as wal_mod

        prev_f = devprof.fold_hook()
        self._prev_fold_hook = prev_f

        def on_fold(tenant: Optional[str], device_s: float) -> None:
            if prev_f is not None:
                prev_f(tenant, device_s)
            if tenant is not None:
                self.note(tenant, device_seconds=device_s)

        devprof.set_fold_hook(on_fold)

        prev_w = wal_mod._APPEND_HOOK
        self._prev_wal_hook = prev_w

        def on_wal(nbytes: int) -> None:
            if prev_w is not None:
                prev_w(nbytes)
            t = current_tenant_id()
            if t is not None:
                self.note(t, wal_bytes=nbytes)

        wal_mod.set_append_hook(on_wal)
        self._hooks_installed = True

    def uninstall_hooks(self) -> None:
        if not self._hooks_installed:
            return
        from pilosa_tpu_torch.obs import devprof
        from pilosa_tpu_torch.storage import wal as wal_mod

        # launches still pending carry their tenant to this registry
        devprof.drain(block=True)
        devprof.set_fold_hook(self._prev_fold_hook)
        wal_mod.set_append_hook(self._prev_wal_hook)
        self._prev_fold_hook = None
        self._prev_wal_hook = None
        self._hooks_installed = False

    # -- publication -------------------------------------------------------

    def _top(self, k: int):
        """(tenant, stats) rows, busiest first, overflow cell last —
        locked callers only."""
        rows = sorted(self._stats.items(),
                      key=lambda kv: (kv[0] == OVERFLOW_TENANT,
                                      -kv[1].queries,
                                      -kv[1].rows_ingested, kv[0]))
        return rows[:k]

    def publish(self) -> None:
        """Per-tenant gauges for the top-K tenants only (the label
        guard): totals keep accumulating for every tracked tenant, but
        the metric label space stays K wide."""
        with self._lock:
            top = [(t, st.to_json()) for t, st in self._top(self.top_k)]
            tracked = len(self._stats)
        g = self.registry.gauge
        g(obs_metrics.METRIC_TENANT_TRACKED, tracked)
        for t, row in top:
            g(obs_metrics.METRIC_TENANT_QUERIES, row["queries"], tenant=t)
            g(obs_metrics.METRIC_TENANT_ERRORS, row["errors"], tenant=t)
            g(obs_metrics.METRIC_TENANT_ROWS, row["rows_ingested"],
              tenant=t)
            g(obs_metrics.METRIC_TENANT_DEVICE_SECONDS,
              row["device_seconds"], tenant=t)
            g(obs_metrics.METRIC_TENANT_CACHE_HITS, row["cache_hits"],
              tenant=t)
            g(obs_metrics.METRIC_TENANT_CACHE_BYTES, row["cache_bytes"],
              tenant=t)
            g(obs_metrics.METRIC_TENANT_WAL_BYTES, row["wal_bytes"],
              tenant=t)

    def stats_json(self) -> dict:
        """GET /internal/tenants payload (every tracked tenant, not just
        top-K — the endpoint is the escape hatch past the label guard).
        Folds every pending launch first (a wait on the card, as the
        profiler's own admin reads wait), so device_seconds is current."""
        if self._hooks_installed:
            from pilosa_tpu_torch.obs import devprof

            devprof.drain(block=True)
        self.publish()
        with self._lock:
            return {
                "tracked": len(self._stats),
                "max_tracked": self.max_tracked,
                "dropped": self._dropped,
                "top_k": [t for t, _ in self._top(self.top_k)],
                "tenants": {t: st.to_json()
                            for t, st in self._stats.items()},
            }

    def timeline_probe(self) -> dict:
        """Per-tenant top-K rates since the previous probe — rides every
        timeline sample so flight bundles capture WHICH tenant was
        burning at anomaly time."""
        now = self.clock()
        with self._lock:
            last_t, self._probe_t = self._probe_t, now
            dt = max(1e-9, now - last_t) if last_t is not None else None
            rates = {}
            snap: Dict[str, Tuple[int, int]] = {}
            for t, st in self._stats.items():
                snap[t] = (st.queries, st.rows_ingested)
                if dt is None:
                    continue
                q0, r0 = self._probe_snap.get(t, (0, 0))
                rates[t] = {
                    "qps": (st.queries - q0) / dt,
                    "rows_per_s": (st.rows_ingested - r0) / dt,
                }
            self._probe_snap = snap
            tracked = len(self._stats)
        top = sorted(rates.items(),
                     key=lambda kv: -kv[1]["qps"])[:self.top_k]
        return {"enabled": True, "tracked": tracked,
                "rates": {t: {k: round(v, 3) for k, v in r.items()}
                          for t, r in top}}

    def close(self) -> None:
        self.uninstall_hooks()
