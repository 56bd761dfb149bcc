"""Dynamic lock tracing: acquisition-order graph, cycle + blocking checks.

Port of ``pilosa_tpu/analysis/locktrace.py``, whole. Project locks opt
in via :func:`tracked_lock(name)` (one line at the creation site) and,
when ``PILOSA_TPU_LOCKCHECK=1`` or after :func:`enable`, every
acquisition feeds a process-wide :class:`LockTraceRegistry` that

- records the lock-order graph (edge ``A -> B`` = some thread acquired
  ``B`` while holding ``A``) and flags any **cycle** the moment the
  closing edge appears — a potential AB-BA deadlock, reported with the
  full lock path before two threads ever actually interleave into it;
- flags locks held across a **device dispatch** (a caller notes one
  with :meth:`LockTraceRegistry.note_dispatch`) unless the lock was
  declared ``dispatch_ok``;
- flags locks held across **blocking socket I/O** (a caller notes one
  with :meth:`LockTraceRegistry.note_io`) unless the lock was declared
  ``io_ok``.

In the port the scheduler's and the result cache's locks are tracked;
the tests read the graph to show that a fused wave and concurrent
writes take the scheduler, cache, write and stack locks in one order.

Disabled-path discipline: with the flag off ``tracked_lock`` returns a
**bare** ``threading.Lock``/``RLock`` — no wrapper object exists at
all, asserted via the module-level :data:`WRAPPER_COUNT`. The flag is
read at lock-creation time, so enabling mid-process only affects locks
created afterwards.

Violations surface as :func:`report` and as the
``lock_order_violations_total{kind=}`` counter.

Caveats (documented, not defended): held-lock stacks are per-thread, so
a lock acquired on one thread and released on another leaves a stale
stack entry (no project lock does this); locks created before
``enable()`` are invisible.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set, Tuple

ENABLE_ENV = "PILOSA_TPU_LOCKCHECK"

#: wrappers constructed since import — the disabled-path zero-allocation
#: proof (tests assert this does not move while the plane is off)
WRAPPER_COUNT = 0

#: the live LockTraceRegistry, or None when tracing is off. Call sites
#: on hot paths read the attribute and branch on None (one dict lookup,
#: no function call).
ACTIVE: Optional["LockTraceRegistry"] = None

VIOLATION_CAP = 256  # bounded report ring; dedup keeps real use tiny

KIND_CYCLE = "cycle"
KIND_DISPATCH = "dispatch"
KIND_IO = "io"


class _TrackedLock:
    """Instrumented ``threading.Lock``/``RLock`` stand-in.

    Supports the full lock protocol (``acquire``/``release``/context
    manager) plus ``threading.Condition`` wrapping: Condition's
    non-reentrant fallbacks use ``acquire(False)`` for ownership probes
    and plain ``release``/``acquire`` around waits, all of which keep
    the held-stack bookkeeping consistent (only a successful acquire
    records; re-entrant RLock acquires record once)."""

    __slots__ = ("name", "dispatch_ok", "io_ok", "_inner", "_reg",
                 "_rlock", "_owner", "_depth")

    def __init__(self, name: str, reg: "LockTraceRegistry", *,
                 rlock: bool = False, dispatch_ok: bool = False,
                 io_ok: bool = False):
        global WRAPPER_COUNT
        WRAPPER_COUNT += 1
        self.name = name
        self.dispatch_ok = dispatch_ok
        self.io_ok = io_ok
        self._rlock = rlock
        self._inner = threading.RLock() if rlock else threading.Lock()
        self._reg = reg
        self._owner: Optional[int] = None  # thread ident holding us
        self._depth = 0                    # RLock re-entry depth
        reg.register(self)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if not ok:
            return False
        me = threading.get_ident()
        if self._rlock and self._owner == me:
            self._depth += 1  # re-entry: no new edge, no new stack entry
            return True
        self._owner = me
        self._depth = 1
        self._reg.note_acquired(self)
        return True

    def release(self) -> None:
        me = threading.get_ident()
        if self._owner == me:
            self._depth -= 1
            if self._depth == 0:
                self._owner = None
                self._reg.note_released(self)
        self._inner.release()

    def locked(self) -> bool:
        inner_locked = getattr(self._inner, "locked", None)
        if inner_locked is not None:
            return inner_locked()
        return self._owner is not None  # RLock pre-3.12 has no locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # shows up in assertion messages
        return f"<tracked_lock {self.name!r} held_by={self._owner}>"


class LockTraceRegistry:
    """Process-wide acquisition-order graph + violation ring.

    The internal mutex is deliberately a bare ``threading.Lock``: it is
    a strict leaf (taken only for graph mutation, never while calling
    out), and tracking the tracker would recurse. Per-thread reentrancy
    (``_tls.busy``) keeps the metrics counter's own tracked lock from
    re-entering bookkeeping while a violation is being counted."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        # adjacency: name -> set of names acquired while it was held
        self._edges: Dict[str, Set[str]] = {}
        # (a, b) -> first-observation sample (thread name, held path)
        self._edge_meta: Dict[Tuple[str, str], dict] = {}
        self._lock_names: Dict[str, int] = {}  # name -> instances created
        self._violations: List[dict] = []
        self._vkeys: Set[tuple] = set()

    # -- wrapper callbacks -------------------------------------------------

    def _stack(self) -> List[_TrackedLock]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def register(self, lock: _TrackedLock) -> None:
        with self._lock:
            self._lock_names[lock.name] = \
                self._lock_names.get(lock.name, 0) + 1

    def note_acquired(self, lock: _TrackedLock) -> None:
        if getattr(self._tls, "busy", False):
            return
        stack = self._stack()
        held = [l.name for l in stack if l.name != lock.name]
        stack.append(lock)
        if not held:
            return
        # lock-free fast path: every held->new edge already known
        edges = self._edges
        if all(b in edges.get(a, ()) for a, b in
               ((h, lock.name) for h in held)):
            return
        cycles = []
        with self._lock:
            for a in held:
                b = lock.name
                succ = self._edges.setdefault(a, set())
                if b in succ:
                    continue
                succ.add(b)
                self._edge_meta[(a, b)] = {
                    "thread": threading.current_thread().name,
                    "held": list(held),
                }
                path = self._find_path_locked(b, a)
                if path is not None:
                    cycles.append([a] + path)
        for cycle in cycles:
            self._violation(
                KIND_CYCLE, ("cycle", frozenset(cycle)),
                f"lock-order cycle: {' -> '.join(cycle)}",
                cycle=cycle)

    def note_released(self, lock: _TrackedLock) -> None:
        stack = getattr(self._tls, "stack", None)
        if not stack:
            return
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is lock:
                del stack[i]
                return

    def _find_path_locked(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS over the order graph; returns [src, ..., dst] or None."""
        seen = {src}
        todo = [(src, [src])]
        while todo:
            node, path = todo.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    todo.append((nxt, path + [nxt]))
        return None

    # -- blocking-call checks ------------------------------------------------

    def held_locks(self) -> List[str]:
        """Names of tracked locks the calling thread holds right now —
        the introspection hook tests assert listener/dispatch contracts
        with."""
        return [l.name for l in self._stack()]

    def note_dispatch(self, site: str = "device.dispatch") -> None:
        """A device dispatch is about to run on this thread: any held
        tracked lock not declared ``dispatch_ok`` breaks the
        leaf-lock rule (a lock held across a dispatch serializes every
        contender behind device time)."""
        bad = [l.name for l in self._stack() if not l.dispatch_ok]
        if bad:
            self._violation(
                KIND_DISPATCH, (KIND_DISPATCH, tuple(bad), site),
                f"locks {bad} held across {site}",
                locks=bad, site=site)

    def note_io(self, site: str = "rpc") -> None:
        """Blocking socket I/O is about to run on this thread (the
        InternalClient wire boundary)."""
        bad = [l.name for l in self._stack() if not l.io_ok]
        if bad:
            self._violation(
                KIND_IO, (KIND_IO, tuple(bad), site),
                f"locks {bad} held across blocking I/O ({site})",
                locks=bad, site=site)

    # -- violations --------------------------------------------------------

    def _violation(self, kind: str, key: tuple, message: str, **detail):
        with self._lock:
            if key in self._vkeys or len(self._violations) >= VIOLATION_CAP:
                return
            self._vkeys.add(key)
            v = {"kind": kind, "message": message,
                 "thread": threading.current_thread().name}
            v.update(detail)
            self._violations.append(v)
        # metrics AFTER our leaf lock is released; busy-guarded so the
        # registry's own tracked lock doesn't recurse into bookkeeping
        self._tls.busy = True
        try:
            from pilosa_tpu_torch.obs.metrics import (
                METRIC_LOCK_VIOLATIONS, REGISTRY)
            REGISTRY.count(METRIC_LOCK_VIOLATIONS, kind=kind)
        except Exception:
            pass  # metrics must never turn a report into a crash
        finally:
            self._tls.busy = False

    def violations(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            vs = list(self._violations)
        if kind is not None:
            vs = [v for v in vs if v["kind"] == kind]
        return vs

    def report(self) -> dict:
        """The whole graph: locks, edges and violations."""
        with self._lock:
            return {
                "enabled": True,
                "locks": dict(sorted(self._lock_names.items())),
                "edges": {a: sorted(bs)
                          for a, bs in sorted(self._edges.items())},
                "violations": list(self._violations),
            }

    def timeline_probe(self) -> dict:
        """Cheap per-sample summary: violations, cycles and edges."""
        with self._lock:
            return {
                "enabled": True,
                "violations": len(self._violations),
                "cycles": sum(1 for v in self._violations
                              if v["kind"] == KIND_CYCLE),
                "edges": sum(len(b) for b in self._edges.values()),
            }


def tracked_lock(name: str, *, rlock: bool = False,
                 dispatch_ok: bool = False, io_ok: bool = False):
    """Project-lock factory. Disabled (the default): returns a bare
    ``threading.Lock()``/``RLock()`` — zero wrapper allocations, zero
    per-acquire overhead. Enabled: returns a :class:`_TrackedLock`
    feeding the process registry.

    ``dispatch_ok`` marks locks DESIGNED to be held across a device
    dispatch; ``io_ok`` marks locks designed to be held across a wire
    send. Everything else held at those boundaries is a violation."""
    reg = ACTIVE
    if reg is None:
        return threading.RLock() if rlock else threading.Lock()
    return _TrackedLock(name, reg, rlock=rlock, dispatch_ok=dispatch_ok,
                        io_ok=io_ok)


def held_locks() -> List[str]:
    """Tracked locks held by the calling thread ([] when disabled)."""
    reg = ACTIVE
    return [] if reg is None else reg.held_locks()


def timeline_probe() -> dict:
    reg = ACTIVE
    if reg is None:
        return {"enabled": False, "violations": 0}
    return reg.timeline_probe()


def report() -> dict:
    reg = ACTIVE
    if reg is None:
        return {"enabled": False, "locks": {}, "edges": {},
                "violations": []}
    return reg.report()


def enable() -> LockTraceRegistry:
    """Turn tracing on for locks created from now on (idempotent)."""
    global ACTIVE
    if ACTIVE is None:
        ACTIVE = LockTraceRegistry()
    return ACTIVE


def disable() -> None:
    """Stop tracing. Existing wrappers keep working (their bookkeeping
    still runs against the detached registry) but new ``tracked_lock``
    calls hand out bare locks again and the checks/report go quiet."""
    global ACTIVE
    ACTIVE = None


if os.environ.get(ENABLE_ENV, "") not in ("", "0", "false"):
    enable()
