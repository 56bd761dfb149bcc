"""Controller: the DAX control plane.

Reference: dax/controller/controller.go:30 — worker registry, balancer
assigning shards to compute nodes, directive push (:1033 sendDirectives),
poller health checks (dax/controller/poller/). The balancer here is
*sticky* jump-hash: a shard keeps its owner until that owner dies, then
reassigns over the live set — the minimal-movement property the
reference's balancer also optimizes for. Schema changes and assignment
changes both bump the directive version and push.

Liveness has two sources, in preference order: an attached SWIM
membership view (gossip/membership.py — ``attach_membership``; the
poller then buries exactly the members the protocol CONFIRMED down) and
the injectable-clock checkin sweep (the seed's poller, kept as the
fallback when no gossip plane runs). Push failure remains the third
detector: a directive that cannot be delivered after per-node
retry/backoff buries its target.

Directive delivery is incremental: once a node has acked version V, the
next push is a METHOD_DIFF carrying only the shard delta (and schema
only when it changed) on top of V. A computer that missed a version
answers ``resync`` and gets a METHOD_FULL — the fallback that makes the
diff path safe to be wrong.

Locking: registry/assignment mutations run under one lock, but directive
DELIVERY always happens outside it (a hung computer must never stall the
whole control plane — queries need assignment()/live_nodes() concurrently).
Push failures feed back as deaths, which reassign and push again until
the fleet converges.

The registry is in-memory plus the shared-FS writelog as the durable
source of truth for WHICH shards exist (cold start rediscovers them from
the logs — reference: controller persistence in dax/controller/sqldb/).

Port of ``pilosa_tpu/dax/controller.py``: the same placement (FNV-64a of
``"<table>/<shard>"`` through jump hash over the sorted live ids), so
both packages' controllers assign every shard to the same computer.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.cluster.client import (
    InternalClient, NodeDownError, RemoteError,
)
from pilosa_tpu_torch.cluster.topology import Node
from pilosa_tpu_torch.dax.directive import (
    Directive, METHOD_DIFF, METHOD_FULL,
)
from pilosa_tpu_torch.dax.storage import Snapshotter, WriteLogger
from pilosa_tpu_torch.hashing import fnv64a, jump_hash
from pilosa_tpu_torch.obs import metrics as obs_metrics
from pilosa_tpu_torch.sched.clock import MonotonicClock

# hot-field memory per table (the warm-handoff prewarm set)
_HOT_PER_TABLE = 8


class Controller:
    def __init__(self, shared_dir: str, client: Optional[InternalClient] = None,
                 dead_after_s: float = 5.0, *, clock=None,
                 directive_retries: int = 2,
                 directive_backoff_s: float = 0.05,
                 sleep=None, registry=None):
        self.client = client or InternalClient()
        self.dead_after_s = dead_after_s
        self.shared_dir = shared_dir
        self.wl = WriteLogger(shared_dir)
        self.clock = clock if clock is not None else MonotonicClock()
        self.directive_retries = max(0, int(directive_retries))
        self.directive_backoff_s = max(0.0, float(directive_backoff_s))
        self._sleep = sleep if sleep is not None else time.sleep
        self.registry = registry if registry is not None \
            else obs_metrics.REGISTRY
        self._lock = locktrace.tracked_lock("dax.controller", rlock=True)
        self.nodes: Dict[str, Node] = {}
        self.last_seen: Dict[str, float] = {}
        self.dead: Set[str] = set()
        self.assign: Dict[Tuple[str, int], str] = {}
        self.schema: List[dict] = []
        self.version = 0
        self.schema_rev = 0
        # SWIM membership view (attach_membership); None = clock poller
        self.membership = None
        # per-node ack state driving METHOD_DIFF:
        # nid -> {"version", "assigned": frozenset, "schema_rev"}
        self._acked: Dict[str, dict] = {}
        # recently queried fields per table (queryer note_hot) — what a
        # freshly directed owner prewarms before advertising ready
        self._hot: Dict[str, List[str]] = {}
        # recent directive bumps (clock stamp per version bump): the
        # timeline probe's churn read + directive age
        self._bumps: deque = deque(maxlen=128)
        # in-process computers (harness mode): directive delivery by
        # direct call instead of HTTP when registered with an object
        self._local: Dict[str, object] = {}

    # -- registry (reference: controller.go RegisterNode + poller) ---------

    def register(self, node: Node, computer: Optional[object] = None) -> None:
        with self._lock:
            self.nodes[node.id] = node
            self.last_seen[node.id] = self.clock.now()
            self.dead.discard(node.id)
            self._acked.pop(node.id, None)
            if computer is not None:
                self._local[node.id] = computer
            self._bump_locked()
        self._deliver([node.id])

    def checkin(self, node_id: str) -> None:
        resync = False
        with self._lock:
            if node_id in self.nodes:
                self.last_seen[node_id] = self.clock.now()
                if node_id in self.dead:
                    # back from the dead: full directive resyncs it
                    self.dead.discard(node_id)
                    self._acked.pop(node_id, None)
                    self._bump_locked()
                    resync = True
        if resync:
            self._deliver([node_id])

    def live_ids(self) -> Set[str]:
        with self._lock:
            return set(self.nodes) - self.dead

    def live_nodes(self) -> List[Node]:
        with self._lock:
            return [n for i, n in self.nodes.items() if i not in self.dead]

    def attach_membership(self, membership) -> None:
        """Swap liveness onto the SWIM view: ``poll`` buries exactly
        the members the protocol confirmed down (a silenced node is
        suspected by failed probes, confirmed after the dissemination
        timeout — no wall-clock checkin bookkeeping involved)."""
        self.membership = membership

    def poll(self, now: Optional[float] = None) -> List[str]:
        """Health sweep (reference: dax/controller/poller): with a
        membership view attached, confirmed-down members die; otherwise
        nodes silent past the checkin deadline die. Either way their
        shards reassign. Returns newly dead node ids."""
        if self.membership is not None:
            view = self.membership.view()
            with self._lock:
                newly = [i for i in self.nodes
                         if i not in self.dead
                         and view.get(i, {}).get("status") == "down"]
        else:
            now = now if now is not None else self.clock.now()
            with self._lock:
                newly = [i for i in self.nodes
                         if i not in self.dead
                         and now - self.last_seen[i] > self.dead_after_s]
        for i in newly:
            self.mark_dead(i)
        return newly

    def mark_dead(self, node_id: str) -> None:
        self._deliver(self._bury(node_id))

    def _bury(self, node_id: str) -> List[str]:
        """Mark dead + reassign its shards under the lock; returns the
        owners whose directives must be (re)delivered. Return-only by
        contract: burial must NEVER deliver (callers may already be in
        the delivery loop — reentrancy is how directives double-send)."""
        with self._lock:
            if node_id in self.dead or node_id not in self.nodes:
                return []
            self.dead.add(node_id)
            self._local.pop(node_id, None)
            self._acked.pop(node_id, None)
            touched: Set[str] = set()
            for key in [k for k, nid in self.assign.items()
                        if nid == node_id]:
                owner = self._pick(key)
                if owner is not None:
                    self.assign[key] = owner
                    touched.add(owner)
            self._bump_locked()
            return sorted(touched)

    # -- schema (pushed with every directive) ------------------------------

    def create_table(self, name: str, options: Optional[dict] = None,
                     fields: Optional[List[dict]] = None) -> None:
        with self._lock:
            if any(t["index"] == name for t in self.schema):
                raise ValueError(f"table {name!r} already exists")
            # copy what the caller handed us: create_field mutates the
            # stored record in place, and sharing the caller's list
            # would write through into their schema object
            self.schema.append({"index": name,
                                "options": dict(options or {}),
                                "fields": [dict(f) for f in fields or []]})
            self.schema_rev += 1
            self._bump_locked()
        self._deliver(sorted(self.live_ids()))

    def create_field(self, index: str, field: str,
                     options: Optional[dict] = None) -> None:
        with self._lock:
            for t in self.schema:
                if t["index"] == index:
                    t.setdefault("fields", []).append(
                        {"name": field, "options": options or {}})
                    self.schema_rev += 1
                    self._bump_locked()
                    break
            else:
                raise KeyError(index)
        self._deliver(sorted(self.live_ids()))

    def drop_table(self, name: str) -> None:
        with self._lock:
            self.schema = [t for t in self.schema if t["index"] != name]
            self.assign = {k: v for k, v in self.assign.items()
                           if k[0] != name}
            self._hot.pop(name, None)
            self.schema_rev += 1
            self._bump_locked()
        # the shared-FS logs/snapshots ARE the table's durable data —
        # drop them too or a re-created table resurrects the old rows
        # (and recover_from_logs would re-assign phantom shards)
        self.wl.drop_table(name)
        Snapshotter(self.shared_dir).drop_table(name)
        self._deliver(sorted(self.live_ids()))

    # -- placement (reference: dax/controller/balancer/) -------------------

    def _pick(self, key: Tuple[str, int]) -> Optional[str]:
        live = sorted((set(self.nodes) - self.dead))
        if not live:
            return None
        h = fnv64a(f"{key[0]}/{key[1]}".encode())
        return live[jump_hash(h, len(live))]

    def ensure_shard(self, table: str, shard: int) -> Node:
        """Owner of (table, shard), assigning (and pushing a directive to
        the new owner) if unassigned — how shards come into existence on
        the write path."""
        push_to: Optional[str] = None
        with self._lock:
            key = (table, shard)
            nid = self.assign.get(key)
            if nid is None or nid in self.dead:
                nid = self._pick(key)
                if nid is None:
                    raise NodeDownError("no live compute nodes")
                self.assign[key] = nid
                self._bump_locked()
                push_to = nid
            node = self.nodes[nid]
        if push_to is not None:
            self._deliver([push_to])
        return node

    def rebalance(self) -> int:
        """Re-run placement over the CURRENT live set and move every
        shard whose jump-hash pick changed — the scale-up path: a newly
        registered computer takes ~1/n of the keys (minimal movement),
        and both gainers and losers get directives. Returns the number
        of shards that moved."""
        with self._lock:
            touched: Set[str] = set()
            moved = 0
            for key, nid in list(self.assign.items()):
                owner = self._pick(key)
                if owner is not None and owner != nid:
                    self.assign[key] = owner
                    touched.add(owner)
                    if nid not in self.dead:
                        touched.add(nid)
                    moved += 1
            if moved:
                self._bump_locked()
            pending = sorted(touched)
        if moved:
            self._deliver(pending)
        return moved

    def recover_from_logs(self) -> None:
        """Cold start: the shared-FS writelog is the durable record of
        which shards exist — assign them all (reference: controller boot
        reading its persisted registry). Tables absent from the schema
        are skipped (their logs are garbage awaiting cleanup)."""
        with self._lock:
            known = {t["index"] for t in self.schema}
            for table in self.wl.tables():
                if table not in known:
                    continue
                for shard in self.wl.shards(table):
                    key = (table, shard)
                    if key not in self.assign:
                        owner = self._pick(key)
                        if owner is not None:
                            self.assign[key] = owner
            # cold start may have installed self.schema directly from a
            # persisted record — re-announce it so even diff directives
            # carry the full schema this round
            self.schema_rev += 1
            self._bump_locked()
        self._deliver(sorted(self.live_ids()))

    # -- topology for the queryer ------------------------------------------

    def assignment(self) -> Dict[Tuple[str, int], str]:
        with self._lock:
            return dict(self.assign)

    def shards_of(self, table: str) -> Set[int]:
        with self._lock:
            return {s for (t, s) in self.assign if t == table}

    def note_hot(self, table: str, field: str) -> None:
        """Remember a recently queried field (bounded per table) — the
        prewarm set shipped with directives for warm handoffs."""
        with self._lock:
            fields = self._hot.setdefault(table, [])
            if field in fields:
                fields.remove(field)
            fields.append(field)
            del fields[:-_HOT_PER_TABLE]

    # -- introspection (obs/health.py "dax" timeline probe) ----------------

    def probe(self) -> dict:
        now = self.clock.now()
        with self._lock:
            last = self._bumps[-1] if self._bumps else None
            recent = sum(1 for t in self._bumps if t >= now - 30.0)
            return {
                "enabled": True,
                "version": self.version,
                "live": len(self.nodes) - len(self.dead),
                "dead": len(self.dead),
                "assigned_shards": len(self.assign),
                "recent_directive_bumps": recent,
                "directive_age_s": (now - last) if last is not None else -1.0,
            }

    # -- directive delivery (reference: controller.go:1033 sendDirectives) -

    def _bump_locked(self) -> None:
        self.version += 1
        now = self.clock.now()
        self._bumps.append(now)
        self.registry.gauge(obs_metrics.METRIC_DAX_DIRECTIVE_VERSION,
                            float(self.version))

    def _hot_for_locked(self) -> List[Tuple[str, str]]:
        return [(t, f) for t in sorted(self._hot)
                for f in self._hot[t]]

    def _directive_for(self, node_id: str,
                       force_full: bool = False) -> Directive:
        assigned = sorted(k for k, nid in self.assign.items()
                          if nid == node_id)
        ack = self._acked.get(node_id)
        if not force_full and ack is not None \
                and ack["version"] < self.version:
            have = ack["assigned"]
            want = frozenset(assigned)
            schema_changed = ack["schema_rev"] != self.schema_rev
            return Directive(
                version=self.version, method=METHOD_DIFF,
                schema=([dict(t) for t in self.schema]
                        if schema_changed else []),
                schema_changed=schema_changed,
                base_version=ack["version"],
                add=sorted(want - have), remove=sorted(have - want),
                assigned=assigned, hot=self._hot_for_locked())
        return Directive(
            version=self.version, method=METHOD_FULL,
            schema=[dict(t) for t in self.schema],
            assigned=assigned, hot=self._hot_for_locked())

    def _push_one(self, nid: str, node: Node, d: Directive,
                  local: Optional[object]) -> dict:
        """One directive to one node with per-node retry/backoff. The
        InternalClient tags the RPC op="directive" so FaultPlan rules
        can scope chaos to the control plane."""
        last_exc: Optional[Exception] = None
        for attempt in range(self.directive_retries + 1):
            try:
                if local is not None:
                    return local.apply_directive(d.to_json())
                return self.client.send_directive(node, d.to_json())
            except (NodeDownError, RemoteError, OSError) as exc:
                last_exc = exc
                if attempt < self.directive_retries:
                    self._sleep(self.directive_backoff_s * (2 ** attempt))
        raise last_exc

    def _deliver(self, node_ids: List[str]) -> None:
        """Send directives OUTSIDE the lock; failures mark nodes dead,
        whose shards reassign and push again, until the fleet converges
        (push failure IS failure detection — the poller shortcut)."""
        pending = list(node_ids)
        for _ in range(len(self.nodes) + 2):  # bounded by fleet size
            if not pending:
                return
            with self._lock:
                batch = [(nid, self.nodes[nid],
                          self._directive_for(nid), self._local.get(nid))
                         for nid in dict.fromkeys(pending)
                         if nid in self.nodes and nid not in self.dead]
            failed: List[str] = []
            for nid, node, d, local in batch:
                try:
                    out = self._push_one(nid, node, d, local)
                    if out.get("resync"):
                        # diff gap: the node missed a version — resend
                        # the whole picture (METHOD_FULL fallback)
                        self.registry.count(
                            obs_metrics.METRIC_DAX_FULL_RESYNCS)
                        with self._lock:
                            d = self._directive_for(nid, force_full=True)
                        out = self._push_one(nid, node, d, local)
                    self.registry.count(
                        obs_metrics.METRIC_DAX_DIRECTIVE_PUSHES,
                        method=d.method,
                        outcome="applied" if out.get("applied")
                        else "stale")
                    if out.get("applied"):
                        with self._lock:
                            self._acked[nid] = {
                                "version": d.version,
                                "assigned": frozenset(d.assigned),
                                "schema_rev": self.schema_rev,
                            }
                except (NodeDownError, RemoteError, OSError):
                    self.registry.count(
                        obs_metrics.METRIC_DAX_DIRECTIVE_PUSHES,
                        method=d.method, outcome="failed")
                    failed.append(nid)
            pending = []
            for nid in failed:
                pending.extend(self._bury(nid))
