"""Distributed tracing: contextvar span scopes, W3C-style traceparent
propagation, a bounded in-memory trace store, and slow-query linkage.

Port of ``pilosa_tpu/obs/tracing.py``, whole: the API's ``query.pql``
span, the scheduler's ``sched.*`` records, the result cache's
``cache.*`` records and the stack builds' ``stack.build`` spans land
here.

Reference: tracing/tracing.go — ``Tracer``/``Span`` interfaces with a
swappable global tracer (:12-73), and ``ProfiledSpan`` trees returned
with query results when profiling is on (:22-53).

Span parentage rides a ``contextvars.ContextVar`` (the same pattern as
``sched/deadline.py``) so it survives the two thread hops that used to
drop it: the scheduler's dispatch worker and the cluster fan-out pool.
Both boundaries capture the submitting context explicitly
(``contextvars.copy_context()`` / ``span_scope``) and restore it in the
worker, so a hedged remote leg's span is still a child of the
coordinator's query span.

A trace crosses nodes as a ``traceparent`` header
(``00-<trace_id>-<span_id>-<flags>``) on every InternalClient RPC; the
serving node roots a local span under that parent and ships its finished
tree back piggybacked on the response (the gossip-envelope pattern),
where the coordinator grafts it under the calling leg's span.
"""

from __future__ import annotations

import contextlib
import contextvars
import random
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.obs import metrics as M

_TRACE_ID_LEN = 32
_SPAN_ID_LEN = 16


def _new_trace_id() -> str:
    return uuid.uuid4().hex


def _new_span_id() -> str:
    return uuid.uuid4().hex[:_SPAN_ID_LEN]


class Span:
    """One named, timed stage of a trace. ``children`` holds Span objects
    for local stages and plain dicts for remote subtrees grafted off the
    wire (``add_remote``)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "duration_s", "tags", "children", "sampled", "_tracer",
                 "_token", "_root")

    def __init__(self, name: str, tracer: Optional["Tracer"] = None,
                 trace_id: str = "", parent_id: str = "",
                 root: bool = False):
        self.name = name
        self.trace_id = trace_id or _new_trace_id()
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.start = time.perf_counter()
        self.duration_s: Optional[float] = None
        self.tags: Dict[str, Any] = {}
        self.children: List[Any] = []
        self.sampled = True
        self._tracer = tracer
        self._token: Optional[contextvars.Token] = None
        self._root = root

    @property
    def recording(self) -> bool:
        return self.sampled

    def set_tag(self, key: str, value: Any) -> "Span":
        self.tags[key] = value
        return self

    def record(self, name: str, duration_s: float, **tags) -> "Span":
        """Attach an already-measured child stage — for durations that are
        observed after the fact (queue wait, batch window) rather than
        bracketed by a with-block."""
        child = Span(name, tracer=self._tracer, trace_id=self.trace_id,
                     parent_id=self.span_id)
        child.duration_s = max(0.0, float(duration_s))
        if tags:
            child.tags.update(tags)
        self.children.append(child)
        return child

    def add_remote(self, span_json: Any, **tags) -> None:
        """Graft a remote node's shipped-back span tree (a ``to_json``
        dict) under this span."""
        if not isinstance(span_json, dict):
            return
        if tags:
            span_json.setdefault("tags", {}).update(tags)
        self.children.append(span_json)

    def finish(self) -> None:
        if self.duration_s is None:
            self.duration_s = time.perf_counter() - self.start
        tok, self._token = self._token, None
        if tok is not None:
            try:
                _CURRENT.reset(tok)
            except ValueError:
                # finished on a different context than it started in;
                # clear rather than leak the scope
                _CURRENT.set(None)
        if self._root and self._tracer is not None:
            self._tracer._finish_root(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.tags.setdefault("error", str(exc) or exc_type.__name__)
        self.finish()

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "traceID": self.trace_id,
            "spanID": self.span_id,
            "parentID": self.parent_id,
            "duration_ns": int((self.duration_s or 0) * 1e9),
            "tags": dict(self.tags),
            "children": [c.to_json() if isinstance(c, Span) else c
                         for c in self.children],
        }


class _NopSpan:
    """Shared, immutable, allocation-free span for disabled/unsampled
    paths. Every disabled ``start_span`` returns this same object."""

    __slots__ = ()

    name = ""
    trace_id = ""
    span_id = ""
    parent_id = ""
    duration_s = 0.0
    sampled = False
    recording = False
    tags: Dict[str, Any] = {}
    children: Tuple = ()

    def set_tag(self, key, value):
        return self

    def record(self, name, duration_s, **tags):
        return self

    def add_remote(self, span_json, **tags):
        pass

    def finish(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def to_json(self) -> dict:
        return {"name": "", "duration_ns": 0, "tags": {}, "children": []}


NOP_SPAN = _NopSpan()

_CURRENT: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "pilosa_trace_span", default=None)


def current_span() -> Optional[Span]:
    """The innermost live span in this context, or None outside a trace."""
    return _CURRENT.get()


def active_span():
    """Like current_span but NOP-safe: always returns something with the
    Span surface (set_tag/record/add_remote)."""
    return _CURRENT.get() or NOP_SPAN


@contextlib.contextmanager
def span_scope(span: Optional[Span]):
    """Install ``span`` as the current scope for the block — the explicit
    restore half of cross-thread capture: a pool worker re-enters the
    submitter's span without copying the whole context (so e.g. deadline
    scoping installed by the dispatcher is left intact)."""
    token = _CURRENT.set(span if span is not None and span.sampled else None)
    try:
        yield span
    finally:
        _CURRENT.reset(token)


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    return "00-%s-%s-%s" % (trace_id, span_id, "01" if sampled else "00")


def parse_traceparent(value: Any) -> Optional[Tuple[str, str, bool]]:
    """-> (trace_id, parent_span_id, sampled) or None on malformed input."""
    if not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or len(trace_id) != _TRACE_ID_LEN \
            or len(span_id) != _SPAN_ID_LEN or len(flags) != 2:
        return None
    try:
        int(trace_id, 16), int(span_id, 16), int(flags, 16)
    except ValueError:
        return None
    return trace_id, span_id, bool(int(flags, 16) & 1)


def current_traceparent() -> Optional[str]:
    """The wire form of the current scope, or None when there is nothing
    to propagate (no span, or the trace is unsampled)."""
    sp = _CURRENT.get()
    if sp is None or not sp.sampled:
        return None
    return format_traceparent(sp.trace_id, sp.span_id, True)


class TraceStore:
    """Bounded in-memory store of finished traces, newest-kept (the
    ``/internal/traces`` surface). One entry per trace_id; capacity
    evicts oldest-finished first."""

    def __init__(self, capacity: int = 256,
                 registry: Optional[M.MetricsRegistry] = None):
        self.capacity = max(1, int(capacity))
        self.registry = registry if registry is not None else M.REGISTRY
        self._lock = locktrace.tracked_lock("obs.tracing.store")
        self._traces: "OrderedDict[str, dict]" = OrderedDict()

    def add(self, root: Span) -> None:
        doc = {
            "traceID": root.trace_id,
            "root": root.name,
            "duration_ns": int((root.duration_s or 0) * 1e9),
            "tags": dict(root.tags),
            "spans": root.to_json(),
        }
        with self._lock:
            self._traces[root.trace_id] = doc
            self._traces.move_to_end(root.trace_id)
            while len(self._traces) > self.capacity:
                self._traces.popitem(last=False)
                self.registry.count(M.METRIC_TRACE_STORE_DROPPED)

    def list(self) -> List[dict]:
        """Newest-first summaries (no span trees)."""
        with self._lock:
            docs = list(self._traces.values())
        return [{k: d[k] for k in ("traceID", "root", "duration_ns", "tags")}
                for d in reversed(docs)]

    def get(self, trace_id: str) -> dict:
        with self._lock:
            return dict(self._traces[trace_id])  # KeyError -> 404 upstream

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)


class Tracer:
    """Context-scoped tracer: explicit roots (``start_trace`` /
    ``start_remote``), child spans off the current scope
    (``start_span``), head sampling, and a finish hook that feeds the
    trace store + trace_* metrics."""

    def __init__(self, enabled: bool = True, sample_rate: float = 1.0,
                 slow_ms: float = 0.0, store: Optional[TraceStore] = None,
                 registry: Optional[M.MetricsRegistry] = None,
                 rng: Optional[random.Random] = None):
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self.slow_ms = float(slow_ms)
        self.store = store
        self.registry = registry if registry is not None else M.REGISTRY
        self._rng = rng or random.Random()

    @classmethod
    def from_config(cls, config=None, **overrides) -> "Tracer":
        """Build from the ``[obs.tracing]`` keys of a Config (fields
        trace_enabled / trace_sample_rate / trace_slow_ms /
        trace_store_capacity, env PILOSA_TPU_TRACE_*)."""
        kw = {
            "enabled": getattr(config, "trace_enabled", False),
            "sample_rate": getattr(config, "trace_sample_rate", 1.0),
            "slow_ms": getattr(config, "trace_slow_ms", 0.0),
        }
        capacity = overrides.pop(
            "store_capacity",
            getattr(config, "trace_store_capacity", 256))
        kw.update(overrides)
        if kw.get("store") is None and kw["enabled"]:
            kw["store"] = TraceStore(capacity,
                                     registry=kw.get("registry"))
        return cls(**kw)

    # -- span creation -----------------------------------------------------

    def start_trace(self, name: str, force: bool = False, **tags) -> Span:
        """Root a new trace — or, inside an existing scope, join it as a
        child span (nested roots collapse so a profile wrapper and the
        query path compose). ``force=True`` bypasses enabled/sampling:
        the ``profile=true`` surface works even with tracing off."""
        cur = _CURRENT.get()
        if cur is not None:
            return self.start_span(name, **tags) if cur.sampled else NOP_SPAN
        if not force:
            if not self.enabled:
                return NOP_SPAN
            if self.sample_rate < 1.0 \
                    and self._rng.random() >= self.sample_rate:
                self.registry.count(M.METRIC_TRACE_UNSAMPLED)
                return NOP_SPAN
        span = Span(name, tracer=self, root=True)
        if tags:
            span.tags.update(tags)
        span._token = _CURRENT.set(span)
        self.registry.count(M.METRIC_TRACE_STARTED)
        return span

    def start_span(self, name: str, **tags) -> Span:
        """A child of the current scope. Outside any trace this is a NOP:
        stages never create implicit roots (stray background work stays
        untraced)."""
        parent = _CURRENT.get()
        if parent is None or not parent.sampled:
            return NOP_SPAN
        span = Span(name, tracer=self, trace_id=parent.trace_id,
                    parent_id=parent.span_id)
        if tags:
            span.tags.update(tags)
        parent.children.append(span)
        span._token = _CURRENT.set(span)
        return span

    def start_remote(self, name: str, traceparent: Any, **tags) -> Span:
        """Root a local span under a peer's wire context. Honoured even
        when local tracing is disabled — the coordinator asked for this
        trace, the work is request-scoped either way."""
        ctx = parse_traceparent(traceparent)
        if ctx is None or not ctx[2]:
            return NOP_SPAN
        span = Span(name, tracer=self, trace_id=ctx[0], parent_id=ctx[1])
        if tags:
            span.tags.update(tags)
        span._token = _CURRENT.set(span)
        self.registry.count(M.METRIC_TRACE_REMOTE_SPANS)
        return span

    def profile(self, name: str, **tags) -> Span:
        """A forced root; caller keeps the Span and reads .to_json()
        after finish (the per-query profile)."""
        return self.start_trace(name, force=True, **tags)

    # -- finish hook -------------------------------------------------------

    def _finish_root(self, span: Span) -> None:
        dur_ms = (span.duration_s or 0.0) * 1e3
        self.registry.count(M.METRIC_TRACE_FINISHED)
        # finish runs after the contextvar scope is reset, so the
        # exemplar trace ID is passed explicitly (the provider would
        # see no current span here)
        tid = span.trace_id if span.sampled else None
        self.registry.observe_bucketed(
            M.METRIC_TRACE_DURATION, dur_ms, M.TRACE_DURATION_BUCKETS_MS,
            exemplar_trace_id=tid)
        self._observe_stages(span, tid)
        if self.store is not None:
            self.store.add(span)

    def _observe_stages(self, span: Span,
                        trace_id: Optional[str] = None) -> None:
        stack = list(span.children)
        while stack:
            c = stack.pop()
            if not isinstance(c, Span):
                continue
            self.registry.observe_bucketed(
                M.METRIC_TRACE_STAGE_LATENCY, (c.duration_s or 0.0) * 1e3,
                M.TRACE_DURATION_BUCKETS_MS, stage=c.name,
                exemplar_trace_id=trace_id)
            stack.extend(c.children)


class NopTracer(Tracer):
    """Tracing off: every span call returns the one shared no-op span —
    the disabled hot path allocates nothing."""

    def __init__(self):
        super().__init__(enabled=False, sample_rate=0.0)


_global: Tracer = NopTracer()


def get_tracer() -> Tracer:
    return _global


def set_tracer(t: Tracer) -> Tracer:
    """Swap the global tracer (reference: tracing.RegisterTracer)."""
    global _global
    _global = t
    return t


def configure(config=None, **overrides) -> Tracer:
    """Install the global tracer from config (``[obs.tracing]``)."""
    return set_tracer(Tracer.from_config(config, **overrides))


def _env_bootstrap() -> None:
    """Honour the bare env switch (the tier-1 tracing lane sets
    ``PILOSA_TPU_TRACE=1``) without any server wiring."""
    import os

    if os.environ.get("PILOSA_TPU_TRACE", "").strip().lower() not in (
            "1", "true", "yes", "on"):
        return
    set_tracer(Tracer(
        enabled=True,
        sample_rate=float(
            os.environ.get("PILOSA_TPU_TRACE_SAMPLE_RATE") or 1.0),
        slow_ms=float(os.environ.get("PILOSA_TPU_TRACE_SLOW_MS") or 0.0),
        store=TraceStore(int(
            os.environ.get("PILOSA_TPU_TRACE_STORE_CAPACITY") or 256)),
    ))


_env_bootstrap()

def _exemplar_trace_id():
    """Active sampled trace ID or None — the metrics registry's exemplar
    source (wired here because metrics must not import tracing)."""
    sp = _CURRENT.get()
    return sp.trace_id if sp is not None and sp.sampled else None


M.set_exemplar_provider(_exemplar_trace_id)
