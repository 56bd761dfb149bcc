"""Bounded, cost-accounted LRU result cache with single-flight dedup.

Keys are opaque hashable tuples built by keys.py: because the fragment
version fingerprint is part of the key, a write makes every covering
entry unreachable — eviction (LRU/bytes/TTL) is purely a memory-bound
concern, never a correctness one.

Single flight: the first thread to miss on a key becomes the *leader*
and computes; concurrent threads missing on the same key become
*followers* and block on the leader's future instead of dispatching a
duplicate kernel. Under the 64-way concurrent bench this collapses
identical cold queries to one dispatch.

Values are deep-copied on insert and on every hit so callers can mutate
their result without corrupting the cached copy. The executor caches
results only once resolved: they are host objects holding no torch
tensor, so a deep copy never touches the card.

Port of ``pilosa_tpu/cache/result_cache.py``, whole. The brownout stale
path (``degrade``) and the tenant hooks stay unset until the degradation
ladder and the tenant registry are ported.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional, Tuple

from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.obs import metrics as M
from pilosa_tpu_torch.obs.tracing import active_span, get_tracer

try:  # cost model only; the cache itself is numpy-free
    import numpy as _np
except Exception:  # pragma: no cover
    _np = None


def estimate_cost(value: Any) -> int:
    """Approximate resident bytes of a result value (iterative, cycle
    safe). Precision doesn't matter — the estimate only drives the
    max-bytes budget, and consistent undercounting across entries keeps
    eviction order sane."""
    total = 0
    stack = [value]
    seen = set()
    while stack:
        v = stack.pop()
        if v is None or isinstance(v, (bool, int, float)):
            total += 16
        elif isinstance(v, str):
            total += 49 + len(v)
        elif isinstance(v, (bytes, bytearray)):
            total += 33 + len(v)
        elif _np is not None and isinstance(v, _np.ndarray):
            total += int(v.nbytes) + 96
        elif _np is not None and isinstance(v, _np.generic):
            total += 32
        else:
            if id(v) in seen:
                continue
            seen.add(id(v))
            if isinstance(v, dict):
                total += 64 + 16 * len(v)
                stack.extend(v.keys())
                stack.extend(v.values())
            elif isinstance(v, (list, tuple, set, frozenset)):
                total += 56 + 8 * len(v)
                stack.extend(v)
            elif dataclasses.is_dataclass(v) and not isinstance(v, type):
                total += 64
                stack.extend(getattr(v, f.name)
                             for f in dataclasses.fields(v))
            elif hasattr(v, "__dict__"):
                total += 64
                stack.extend(vars(v).values())
            else:
                total += 64
    return total


@dataclasses.dataclass
class _Entry:
    value: Any
    cost: int
    expires_at: float  # monotonic deadline; inf = no TTL
    tenant: Optional[str] = None  # inserting tenant (resident quota)
    inserted_at: float = 0.0  # monotonic insert time (stale-age bound)


class ResultCache:
    """Thread-safe LRU keyed by opaque tuples, with byte + entry bounds,
    optional TTL, and single-flight in-flight dedup.

    The primitive API (``fetch``/``complete``/``fail``) exists for call
    sites that batch several keys into one dispatch (executor
    ``execute_many``); ``run`` wraps the common one-key case."""

    def __init__(self, *, max_bytes: int = 64 << 20,
                 max_entries: int = 4096, ttl_ms: float = 0.0,
                 registry: Optional[M.MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.max_bytes = int(max_bytes)
        self.max_entries = int(max_entries)
        self.ttl_ms = float(ttl_ms)
        self.registry = registry if registry is not None else M.REGISTRY
        self.clock = clock
        self._lock = locktrace.tracked_lock("cache.result_cache")
        self._entries: "OrderedDict[Tuple, _Entry]" = OrderedDict()
        self._bytes = 0
        self._inflight: Dict[Tuple, Future] = {}
        # local counters for /internal/cache/stats — independent of the
        # (possibly shared/global) metrics registry
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        # tenant attribution (api.enable_tenants): hook(kind, n) fires
        # ("hit", 1) per hit and ("bytes", cost) per insert; tenant_of
        # (-> current tenant or None) stamps entries so the per-tenant
        # resident-byte quota can bound one tenant's share of the cache
        self.tenant_hook = None
        self.tenant_of = None
        self.tenant_quota_bytes = 0
        # per-tenant override resolver ([tenants.<id>] cache-bytes
        # stanzas): tenant -> byte quota, falling back to
        # tenant_quota_bytes when unset
        self.tenant_quota_of = None
        self._tenant_bytes: Dict[str, int] = {}
        # brownout stale serving (sched/degrade.py, wired by
        # API.enable_degrade): the version fingerprint is the LAST key
        # element, so ``key[:-1]`` names "this query on these shards at
        # any version" and _stale_last maps it to the newest resident
        # full key. During BROWNOUT a miss may fall back to that entry —
        # age-bounded, counted, and flagged on a thread-local so the
        # response layer tags it stale=true. None costs nothing.
        self.degrade = None
        self._stale_last: Dict[Tuple, Tuple] = {}
        self._stale_serves = 0
        self._tls = threading.local()

    @classmethod
    def from_config(cls, config=None, **overrides) -> "ResultCache":
        kw = {}
        if config is not None:
            kw = {"max_bytes": config.cache_max_bytes,
                  "max_entries": config.cache_max_entries,
                  "ttl_ms": config.cache_ttl_ms}
        kw.update(overrides)
        return cls(**kw)

    # -- primitives --------------------------------------------------------

    def lookup(self, key: Tuple, count_miss: bool = True,
               allow_stale: bool = True) -> Tuple[bool, Any]:
        """(hit, value). Counts hit/miss and observes hit latency.
        ``count_miss=False`` makes a miss silent — for peek-style call
        sites (scheduler admission) whose misses fall through to a
        second, authoritative lookup at dispatch. ``allow_stale=False``
        disables the brownout stale path: remote-serving legs pass it so
        a partial served over the internal RPC is never silently stale —
        only the client-facing node stale-serves, and it tags the
        response."""
        t0 = time.perf_counter()
        stale = False
        with self._lock:
            value, hit = self._get_locked(key)
            if not hit and allow_stale:
                deg = self.degrade
                if deg is not None and deg.brownout_active():
                    value, hit, stale = self._get_stale_locked(
                        key, deg.stale_ttl_s)
        if stale:
            self._stale_serves += 1
            self.registry.count(M.METRIC_CACHE_STALE_SERVES)
            self._tls.stale = True
            active_span().record("cache.lookup", time.perf_counter() - t0,
                                 outcome="stale")
            return True, value
        if hit:
            self._hits += 1
            self.registry.count(M.METRIC_CACHE_HITS)
            self.registry.observe_bucketed(
                M.METRIC_CACHE_HIT_LATENCY, time.perf_counter() - t0,
                M.CACHE_LATENCY_BUCKETS)
            if self.tenant_hook is not None:
                self.tenant_hook("hit", 1)
            active_span().record("cache.lookup", time.perf_counter() - t0,
                                 outcome="hit")
            return True, value
        if count_miss:
            self._misses += 1
            self.registry.count(M.METRIC_CACHE_MISSES)
            # peek-style misses (count_miss=False) stay silent in the
            # trace too — the authoritative dispatch-time lookup records
            active_span().record("cache.lookup", time.perf_counter() - t0,
                                 outcome="miss")
        return False, None

    def fetch(self, key: Tuple) -> Tuple[str, Any]:
        """Single lookup + single-flight claim under one lock hold.

        Returns one of:
          ("hit", value)       — cached; counts a hit
          ("leader", None)     — caller must compute, then ``complete``
                                 or ``fail`` the key; counts a miss
          ("follower", future) — another thread is computing; block on
                                 the future (deep-copy its result)
        """
        t0 = time.perf_counter()
        with self._lock:
            value, hit = self._get_locked(key)
            if hit:
                outcome: Tuple[str, Any] = ("hit", value)
            else:
                fut = self._inflight.get(key)
                if fut is not None:
                    outcome = ("follower", fut)
                else:
                    self._inflight[key] = Future()
                    outcome = ("leader", None)
        if outcome[0] == "hit":
            self._hits += 1
            self.registry.count(M.METRIC_CACHE_HITS)
            self.registry.observe_bucketed(
                M.METRIC_CACHE_HIT_LATENCY, time.perf_counter() - t0,
                M.CACHE_LATENCY_BUCKETS)
            if self.tenant_hook is not None:
                self.tenant_hook("hit", 1)
        elif outcome[0] == "leader":
            self._misses += 1
            self.registry.count(M.METRIC_CACHE_MISSES)
        else:
            self.registry.count(M.METRIC_CACHE_SINGLEFLIGHT)
        active_span().record("cache.lookup", time.perf_counter() - t0,
                             outcome=outcome[0])
        return outcome

    def complete(self, key: Tuple, value: Any) -> None:
        """Leader publishes its result: insert + wake followers."""
        self.insert(key, value)
        with self._lock:
            fut = self._inflight.pop(key, None)
        if fut is not None:
            fut.set_result(value)

    def fail(self, key: Tuple, exc: BaseException) -> None:
        """Leader's compute raised: propagate to followers, cache
        nothing (the next request retries)."""
        with self._lock:
            fut = self._inflight.pop(key, None)
        if fut is not None:
            fut.set_exception(exc)

    def insert(self, key: Tuple, value: Any) -> None:
        cost = estimate_cost(value)
        if cost > self.max_bytes:
            return  # would evict the whole cache for one entry
        tenant = self.tenant_of() if self.tenant_of is not None else None
        now = self.clock()
        expires = (now + self.ttl_ms / 1000.0
                   if self.ttl_ms > 0 else float("inf"))
        stored = copy.deepcopy(value)
        quota = (self.tenant_quota_of(tenant)
                 if self.tenant_quota_of is not None
                 else self.tenant_quota_bytes)
        with self._lock:
            if (tenant is not None and quota > 0
                    and self._tenant_bytes.get(tenant, 0) + cost > quota
                    and key not in self._entries):
                # over-quota tenants recompute instead of displacing the
                # others' working set; serving stays correct, just uncached
                self.registry.count(M.METRIC_TENANT_REJECTED,
                                    tenant=tenant, kind="cache")
                return
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.cost
                self._tenant_credit_locked(old)
            self._entries[key] = _Entry(stored, cost, expires, tenant,
                                        inserted_at=now)
            self._bytes += cost
            if isinstance(key, tuple) and len(key) >= 2:
                self._stale_last[key[:-1]] = key
            if tenant is not None:
                self._tenant_bytes[tenant] = \
                    self._tenant_bytes.get(tenant, 0) + cost
            while len(self._entries) > self.max_entries:
                self._evict_locked("entries")
            while self._bytes > self.max_bytes and self._entries:
                self._evict_locked("bytes")
            self._update_gauges_locked()
        if self.tenant_hook is not None:
            self.tenant_hook("bytes", cost)

    def run(self, key: Tuple, compute: Callable[[], Any],
            allow_stale: bool = True) -> Any:
        """Hit → cached copy. Miss as leader → compute (timed into the
        dispatch-latency histogram), publish, return the *original*
        object (the caller may keep mutating it; the cache holds a deep
        copy). Miss as follower → wait for the leader and return a copy.
        """
        deg = self.degrade
        if allow_stale and deg is not None and deg.brownout_active():
            # brownout: prefer any fresh-or-stale resident answer over
            # computing (the stale path flags the thread-local so the
            # caller's response layer can tag it)
            hit, value = self.lookup(key, count_miss=False)
            if hit:
                return value
        state, payload = self.fetch(key)
        if state == "hit":
            return payload
        if state == "follower":
            with get_tracer().start_span("cache.single_flight_wait"):
                value = payload.result()
            return copy.deepcopy(value)
        t0 = time.perf_counter()
        try:
            value = compute()
        except BaseException as exc:
            self.fail(key, exc)
            raise
        self.observe_dispatch(time.perf_counter() - t0)
        self.complete(key, value)
        return value

    # -- accounting helpers ------------------------------------------------

    def bypass(self) -> None:
        """An uncacheable request passed through (key was None)."""
        self.registry.count(M.METRIC_CACHE_BYPASS)

    def mark_stale(self) -> None:
        """Raise the brownout stale flag on the CURRENT thread. The
        cluster fan-out runs remote-leg cache wrappers on pool threads;
        it pops their flags there and forwards with this, so the request
        thread's response layer still sees one honest signal."""
        self._tls.stale = True

    def observe_dispatch(self, seconds: float) -> None:
        """Compute time behind a miss — contrast with the hit
        histogram to read the amortization win off /metrics."""
        self.registry.observe_bucketed(
            M.METRIC_CACHE_DISPATCH_LATENCY, seconds,
            M.CACHE_LATENCY_BUCKETS)

    def flush(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._bytes = 0
            self._tenant_bytes.clear()
            self._stale_last.clear()
            self._update_gauges_locked()
        if n:
            self._evictions += n
            self.registry.count(M.METRIC_CACHE_EVICTIONS, n, reason="flush")
        return n

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_entries": self.max_entries,
                "max_bytes": self.max_bytes,
                "ttl_ms": self.ttl_ms,
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "inflight": len(self._inflight),
                "stale_serves": self._stale_serves,
            }

    def take_stale_flag(self) -> bool:
        """Pop this thread's served-stale marker (set when a brownout
        lookup fell back past the version fingerprint). The response
        layer calls this once per request to tag stale=true; calling it
        before the lookup clears any leftover from an untagged path."""
        was = getattr(self._tls, "stale", False)
        self._tls.stale = False
        return was

    def hit_ratio(self) -> float:
        """Lifetime hits / (hits + misses), 0.0 before any lookup (the
        health-plane timeline's cache probe)."""
        with self._lock:
            total = self._hits + self._misses
            return (self._hits / total) if total else 0.0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- internals (lock held) ---------------------------------------------

    def _get_locked(self, key: Tuple) -> Tuple[Any, bool]:
        e = self._entries.get(key)
        if e is None:
            return None, False
        if e.expires_at <= self.clock():
            del self._entries[key]
            self._bytes -= e.cost
            self._tenant_credit_locked(e)
            self._drop_stale_ref_locked(key)
            self._evictions += 1
            self.registry.count(M.METRIC_CACHE_EVICTIONS, reason="ttl")
            self._update_gauges_locked()
            return None, False
        self._entries.move_to_end(key)
        return copy.deepcopy(e.value), True

    def _evict_locked(self, reason: str) -> None:
        key, e = self._entries.popitem(last=False)
        self._bytes -= e.cost
        self._tenant_credit_locked(e)
        self._drop_stale_ref_locked(key)
        self._evictions += 1
        self.registry.count(M.METRIC_CACHE_EVICTIONS, reason=reason)

    def _drop_stale_ref_locked(self, key: Tuple) -> None:
        """An entry left the cache: if the stale index pointed at it,
        drop the pointer (keeps _stale_last <= live-entry count)."""
        if isinstance(key, tuple) and len(key) >= 2 \
                and self._stale_last.get(key[:-1]) == key:
            del self._stale_last[key[:-1]]

    def _get_stale_locked(self, key: Tuple, max_age_s: float
                          ) -> Tuple[Any, bool, bool]:
        """Brownout fallback: the newest resident entry for this query
        at ANY version fingerprint (``key[:-1]``), provided it is
        younger than ``max_age_s`` and not TTL-expired. Returns
        (value, hit, stale)."""
        if not isinstance(key, tuple) or len(key) < 2:
            return None, False, False
        full = self._stale_last.get(key[:-1])
        if full is None or full == key:
            return None, False, False
        e = self._entries.get(full)
        if e is None:  # pointer outlived a flush/eviction race
            self._stale_last.pop(key[:-1], None)
            return None, False, False
        now = self.clock()
        if e.expires_at <= now:
            return None, False, False  # TTL reaper owns the delete
        if max_age_s > 0 and now - e.inserted_at > max_age_s:
            return None, False, False
        self._entries.move_to_end(full)
        return copy.deepcopy(e.value), True, True

    def _tenant_credit_locked(self, e: _Entry) -> None:
        if e.tenant is None:
            return
        left = self._tenant_bytes.get(e.tenant, 0) - e.cost
        if left > 0:
            self._tenant_bytes[e.tenant] = left
        else:
            self._tenant_bytes.pop(e.tenant, None)

    def _update_gauges_locked(self) -> None:
        self.registry.gauge(M.METRIC_CACHE_ENTRIES, len(self._entries))
        self.registry.gauge(M.METRIC_CACHE_BYTES, self._bytes)
