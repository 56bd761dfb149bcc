"""ClusterNode: one engine process taking part in a cluster.

Port of ``pilosa_tpu/cluster/node.py`` (reference: the Server object,
server.go:46; the API's state gating, api.go:160-187; receiveMessage,
server.go:995). It wraps the single-node API with:

- schema operations broadcast to the peers (broadcast.go semantics);
- client queries routed through the ClusterExecutor;
- the /internal query serving for peers (a remote-mode executor);
- import routing: bits grouped by shard and sent to every replica of the
  owning partition (api.go:1438 Import with the remote flag);
- shard announcements, so every node knows the cluster-wide shard set
  (the reference keeps these bitmaps in etcd, etcd/embed.go Sharder);
- cluster-state gating: writes need NORMAL, reads work in DEGRADED, and
  everything is refused when DOWN (disco/disco.go:53-61);
- transaction changes synced to every peer (server.go:1082).

It offers the surface the HTTP handler uses on the plain API, so the
handler serves a node unchanged. ``ClusterNode(...)`` runs its engine on
``cuda:0``; ``device="cpu"`` runs the plain PyTorch versions; without a
card and without ``device`` it raises.

SQL runs on a node through the single-node ``API.sql``, with the node
as its API: reads plan against ``read_executor`` (the cluster executor),
so PQL pushdowns fan out over the shard owners and host filters and
host aggregates ship to them as SQL subtrees (``sql/fanout.py``, served
on ``/internal/sql/subtree``); DML routes each field's import through
the node's ``import_bits`` / ``import_values`` to the owners and their
replicas.

Fan-out resilience and leg batching: ``enable_resilience`` attaches
hedged legs, breakers and adaptive leg timeouts to the coordinator's
fan-out (a breaker closing marks its node up again);
``enable_cluster_batch`` (or ``PILOSA_TPU_CLUSTER_BATCH=1`` at
construction) coalesces concurrent remote read legs per peer, and
``query_remote_batch`` serves such a batch through ``execute_many``.
``enable_health`` attaches the health plane with the node's probes (a
breaker transition lands in its flight recorder), and ``cluster_stats``
merges every node's timeline window.

Gossip, membership and catch-up: ``enable_gossip`` attaches the gossip
agent (envelopes piggybacked on the node's RPCs, anti-entropy rounds,
the gossip-keyed remote-leg cache, breaker observations shared with the
peers); ``enable_membership`` makes SWIM membership the source of
liveness (``GossipDisCo``) and carries schema messages and translate
entries on the gossip plane too; ``enable_recovery`` attaches the
``RecoveryManager``, which catches a lagging replica up from its peers
and queues the writes that reach it meanwhile.

Tenants and degradation: ``enable_tenants`` attaches the tenant plane
(see ``API.enable_tenants``) and wires it into the cluster executor's
cache and scheduler; ``enable_degrade`` attaches the brownout ladder and
points the node's scheduler and caches at it. The node's queries charge
the calling tenant, and its import ingress sheds batch work first.
"""

from __future__ import annotations

import base64
import contextlib
import time
from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np

from pilosa_tpu_torch import platform
from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.cluster import broadcast as B
from pilosa_tpu_torch.cluster.client import InternalClient
from pilosa_tpu_torch.cluster.disco import DisCo, SingleNodeDisCo
from pilosa_tpu_torch.cluster.executor import ClusterExecutor
from pilosa_tpu_torch.cluster.topology import (
    ClusterSnapshot, Node, STATE_DOWN, STATE_NORMAL,
)
from pilosa_tpu_torch.config import env_bool
from pilosa_tpu_torch.errors import ClusterStateError
from pilosa_tpu_torch.obs.tenants import current_tenant_id
from pilosa_tpu_torch.obs.tracing import get_tracer
from pilosa_tpu_torch.pql.executor import Executor, has_write_calls
from pilosa_tpu_torch.pql.parser import parse
from pilosa_tpu_torch.pql.result import result_to_json, result_to_wire
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

MSG_AVAILABLE_SHARDS = B.MSG_AVAILABLE_SHARDS


class ClusterNode:
    def __init__(self, node_id: str, uri: str = "",
                 disco: Optional[DisCo] = None, path: Optional[str] = None,
                 replica_n: int = 1, client: Optional[InternalClient] = None,
                 device: platform.DeviceLike = None):
        self.api = API(path, device=device)
        self.node = Node(id=node_id, uri=uri)
        self.disco = disco or SingleNodeDisCo(self.node)
        if hasattr(self.disco, "register"):
            self.disco.register(self.node)
        self.replica_n = replica_n
        self.client = client or InternalClient()
        # declare who this client sends AS, so FaultPlan partition rules
        # can match (source, target) pairs; leave clients that lack the
        # attribute (duck-typed test doubles) alone
        if getattr(self.client, "self_id", "") is None:
            self.client.self_id = node_id
        self.broadcaster = B.HTTPBroadcaster(
            self.client, self.disco.nodes, node_id)
        self._remote_exec = Executor(self.api.holder, remote=True)
        self._sql_engine = None  # built on the first sql() by API.sql
        self._remote_shards: Dict[str, Set[int]] = {}
        self._announced: Dict[str, Set[int]] = {}
        self._lock = locktrace.tracked_lock("cluster.node")
        self.executor = ClusterExecutor(
            node_id, self.api.holder, self.client, self.snapshot,
            self.all_shards, on_node_down=self._mark_down,
            live_fn=lambda: set(self.disco.live_ids()))
        self.executor._after_write = self._announce_shards_all
        # SQL subtrees run node-locally through the node API (translator
        # and local engine, sql/fanout.py)
        self.executor._node_api = self
        # Transaction changes sync to peers so an exclusive transaction
        # on any node excludes cluster-wide (reference: server.go:1082).
        self.api.transactions.on_change = self._sync_transaction
        # Replica catch-up manager (storage/recovery.py), None until
        # enable_recovery; remote writes landing mid-catch-up queue
        # through it instead of interleaving with the shipped-tail replay.
        self._recovery = None
        self._membership = None
        self._seed_disco = None
        # Opt-in fan-out leg batching (cluster/batch.py): the env flag
        # attaches the coalescer at construction, so harness-built
        # clusters run every node batched.
        if env_bool("PILOSA_TPU_CLUSTER_BATCH"):
            self.enable_cluster_batch()
        # The env-bootstrapped health plane (PILOSA_TPU_OBS_TIMELINE=1)
        # knows only the base API; upgrade its probes to this node's.
        if self.api.health is not None:
            self.api.health.attach_node(self)
        # likewise the env-bootstrapped tenant plane (PILOSA_TPU_TENANTS=1)
        # needs wiring into the cluster-side executor
        self._wire_node_tenants()

    @property
    def device(self):
        return self.api.device

    # -- topology ----------------------------------------------------------

    def snapshot(self) -> ClusterSnapshot:
        return ClusterSnapshot(self.disco.nodes(), replica_n=self.replica_n)

    def state(self) -> str:
        return self.snapshot().cluster_state(self.disco.live_ids())

    def _mark_down(self, node_id: str) -> None:
        for meth in ("down", "mark_down"):
            fn = getattr(self.disco, meth, None)
            if fn is not None:
                fn(node_id)
                return

    def _mark_up(self, node_id: str) -> None:
        """A recovered node rejoins membership (wired to the resilience
        breaker's open -> closed transition)."""
        for meth in ("up", "mark_up"):
            fn = getattr(self.disco, meth, None)
            if fn is not None:
                fn(node_id)
                return

    def _check_state(self, write: bool) -> None:
        state = self.state()
        if state == STATE_DOWN:
            raise ClusterStateError(f"cluster is {state}; not serving")
        if write and state != STATE_NORMAL:
            raise ClusterStateError(
                f"cluster is {state}; writes require NORMAL")
        if write and self.api.transactions.exclusive_active():
            # local OR mirrored-from-peer exclusive (backup coordination)
            from pilosa_tpu_torch.transaction import TransactionError

            raise TransactionError(
                "an exclusive transaction is active; writes are blocked")

    # -- cluster transactions (reference: transaction.go + server.go:1082) -

    @property
    def transactions(self):
        """The HTTP /transaction* endpoints reach the manager through the
        node (same surface as the plain API)."""
        return self.api.transactions

    def _sync_transaction(self, action: str, tx) -> None:
        self.broadcaster.send_sync({
            "type": B.MSG_TRANSACTION, "action": action,
            "txn": tx.to_json()})

    # -- shard registry ----------------------------------------------------

    def all_shards(self, index: str) -> Set[int]:
        local: Set[int] = set()
        idx = self.api.holder.indexes.get(index)
        if idx is not None:
            local = idx.shards()
        with self._lock:
            return local | self._remote_shards.get(index, set())

    def _announce_shards_all(self, idx=None) -> None:
        for name in list(self.api.holder.indexes):
            self._announce_shards(name)

    def _announce_shards(self, index: str) -> None:
        idx = self.api.holder.indexes.get(index)
        if idx is None:
            return
        # before the announced-subset early return: version bumps matter
        # even when the shard SET is unchanged (the common write case)
        agent = self.executor.gossip
        if agent is not None:
            agent.refresh_index(index)
        shards = idx.shards()
        with self._lock:
            if shards <= self._announced.get(index, set()):
                return
            self._announced[index] = set(shards)
        self.broadcaster.send_async({
            "type": MSG_AVAILABLE_SHARDS, "index": index,
            "shards": sorted(shards), "node": self.node.id,
        })

    # -- schema ops (broadcast to peers; reference: api.go CreateIndex) ----

    def create_index(self, name: str, options: Optional[dict] = None):
        self._check_state(write=True)
        idx = self.api.create_index(name, options)
        self.broadcaster.send_sync(
            {"type": B.MSG_CREATE_INDEX, "index": name, "options": options})
        return idx

    def delete_index(self, name: str, broadcast: bool = True) -> None:
        self.api.delete_index(name)
        with self._lock:
            self._remote_shards.pop(name, None)
            self._announced.pop(name, None)
        if broadcast:
            self.broadcaster.send_sync(
                {"type": B.MSG_DELETE_INDEX, "index": name})

    def create_field(self, index: str, field: str,
                     options: Optional[dict] = None):
        self._check_state(write=True)
        f = self.api.create_field(index, field, options)
        self.broadcaster.send_sync({"type": B.MSG_CREATE_FIELD, "index": index,
                                    "field": field, "options": options})
        return f

    def delete_field(self, index: str, field: str,
                     broadcast: bool = True) -> None:
        self.api.delete_field(index, field)
        if broadcast:
            self.broadcaster.send_sync({"type": B.MSG_DELETE_FIELD,
                                        "index": index, "field": field})

    def ensure_index(self, name: str, options: Optional[dict] = None):
        if name not in self.api.holder.indexes:
            self.api.create_index(name, options)

    def ensure_field(self, index: str, field: str,
                     options: Optional[dict] = None):
        idx = self.api.holder.indexes.get(index)
        if idx is not None and field not in idx.fields:
            self.api.create_field(index, field, options)

    # -- queries -----------------------------------------------------------

    def query(self, index: str, pql: str,
              shards: Optional[Sequence[int]] = None,
              priority: Optional[str] = None,
              deadline_ms: Optional[float] = None) -> List[Any]:
        hp = self.api.health
        reg = self.api.tenants
        if hp is None and reg is None:
            return self._query_impl(index, pql, shards, priority,
                                    deadline_ms)
        tenant = current_tenant_id() if reg is not None else None
        t0 = time.monotonic()
        try:
            out = self._query_impl(index, pql, shards, priority,
                                   deadline_ms)
        except Exception:
            if hp is not None:
                hp.record("query", time.monotonic() - t0, error=True,
                          tenant=tenant)
            if reg is not None:
                reg.note_query(tenant, error=True)
            raise
        if hp is not None:
            hp.record("query", time.monotonic() - t0, tenant=tenant)
        if reg is not None:
            reg.note_query(tenant)
        return out

    def _query_impl(self, index: str, pql: str,
                    shards: Optional[Sequence[int]] = None,
                    priority: Optional[str] = None,
                    deadline_ms: Optional[float] = None) -> List[Any]:
        q = parse(pql) if isinstance(pql, str) else pql
        is_write = has_write_calls(q)
        self._check_state(write=is_write)
        # Per-query deadline budget, visible to every layer below
        # (sched/deadline.py).
        if deadline_ms is not None and deadline_ms > 0:
            from pilosa_tpu_torch.sched.deadline import (Deadline,
                                                         deadline_scope)

            ctx = deadline_scope(Deadline(
                time.monotonic() + deadline_ms / 1e3))
        else:
            ctx = contextlib.nullcontext()
        with ctx, get_tracer().start_trace(
                "query.pql", index=index, node=self.node.id):
            sched = self.executor.scheduler
            if sched is not None and not is_write:
                # one admission ticket per client query; the per-shard
                # local kernels inside the fan-out micro-batch via the
                # scheduler
                kw = {}
                if priority is not None:
                    kw["priority"] = priority
                with sched.admit(**kw):
                    return self.executor.execute(index, q, shards=shards)
            return self.executor.execute(index, q, shards=shards)

    def query_json(self, index: str, pql: str,
                   priority: Optional[str] = None,
                   deadline_ms: Optional[float] = None,
                   profile: bool = False) -> dict:
        if profile:
            with get_tracer().profile("query.profile", index=index,
                                      node=self.node.id) as root:
                out = self.query_json(index, pql, priority=priority,
                                      deadline_ms=deadline_ms)
            out["profile"] = root.to_json()
            return out
        cache = self.cache
        if cache is not None:
            cache.take_stale_flag()  # clear any untagged leftover
        out = {"results": [result_to_json(r) for r in self.query(
            index, pql, priority=priority, deadline_ms=deadline_ms)]}
        if cache is not None and cache.take_stale_flag():
            # a fan-out leg was served past its version key: the
            # freshness contract for degraded reads (executor.cache and
            # executor.local.cache are the same object, so one flag
            # covers both legs)
            out["stale"] = True
        return out

    def query_remote(self, index: str, pql: str,
                     shards: Sequence[int]) -> List[dict]:
        """Serve a peer's sub-query (reference: the Remote:true branch of
        handlePostQuery): local shards only, raw IDs, no truncation."""
        results = self._remote_exec.execute(index, parse(pql), shards=shards)
        self._announce_shards(index)
        return [result_to_wire(r) for r in results]

    def query_remote_batch(self, entries: Sequence[dict]) -> List[dict]:
        """Serve a coordinator's coalesced node batch (cluster/batch.py
        -> /internal/query-batch): each index group of the batch runs
        through the remote executor's ``execute_many``, which
        superset-merges the entries' shard sets into one stacked layout
        with per-query ``ShardMask``s, so a 32-query batch costs one
        fused dispatch here, with the answers of solo runs.

        Per-entry error slots isolate failures: a group-level exception
        re-runs that index group solo, and only the offending entries
        come back as ``{"error", "status"}``. An attached scheduler
        charges the batch ONE admission ticket."""
        out: List[Optional[dict]] = [None] * len(entries)
        by_index: Dict[str, List[int]] = {}
        for i, e in enumerate(entries):
            by_index.setdefault(str(e.get("index", "")), []).append(i)
        sched = self.executor.scheduler
        ticket = sched.admit() if sched is not None else (
            contextlib.nullcontext())
        with ticket:
            for index, slots in by_index.items():
                self._serve_batch_group(index, entries, slots, out)
                if any(out[i] is not None and "error" not in out[i]
                       for i in slots):
                    self._announce_shards(index)
        return [o if o is not None else
                {"error": "batch entry not served", "status": 500}
                for o in out]

    def _serve_batch_group(self, index: str, entries: Sequence[dict],
                           slots: List[int],
                           out: List[Optional[dict]]) -> None:
        per_shards = [[int(s) for s in (entries[i].get("shards") or [])]
                      for i in slots]
        try:
            queries = [parse(entries[i]["query"]) for i in slots]
            fused = self._remote_exec.execute_many(
                index, queries, per_query_shards=per_shards)
        except Exception:
            # isolation fallback: solo runs pin errors to their entries
            for i, shards in zip(slots, per_shards):
                try:
                    res = self._remote_exec.execute(
                        index, parse(entries[i]["query"]), shards=shards)
                    out[i] = {"results": [result_to_wire(r) for r in res]}
                except KeyError as exc:
                    out[i] = {"error": str(exc), "status": 404}
                except Exception as exc:
                    out[i] = {"error": f"{type(exc).__name__}: {exc}",
                              "status": 400}
            return
        for i, res in zip(slots, fused):
            out[i] = {"results": [result_to_wire(r) for r in res]}

    def read_executor(self):
        """SQL read plans run on the cluster executor; its local legs
        consult ``executor.scheduler`` themselves."""
        return self.executor

    # -- SQL: the single-node implementation, planned on the node's surface

    sql = API.sql
    _recorded = API._recorded
    _maybe_slow_log = API._maybe_slow_log
    _degrade_shed_batch = API._degrade_shed_batch

    # -- scheduler (sched/): same surface as the plain API -----------------

    @property
    def scheduler(self):
        return self.executor.scheduler

    def enable_scheduler(self, config=None, **overrides):
        """Attach a micro-batching scheduler over the node's LOCAL engine;
        coordinator fan-outs then coalesce their local shard groups."""
        from pilosa_tpu_torch.sched import QueryScheduler

        self.disable_scheduler()
        if config is not None:
            sched = QueryScheduler.from_config(
                self.executor.local, config, **overrides)
        else:
            sched = QueryScheduler(self.executor.local, **overrides)
        self.executor.scheduler = sched
        self._wire_node_tenants()
        self._wire_node_degrade()
        return sched

    def disable_scheduler(self) -> None:
        sched, self.executor.scheduler = self.executor.scheduler, None
        if sched is not None:
            sched.close()

    # -- result cache (cache/): same surface as the plain API --------------

    @property
    def cache(self):
        return self.executor.cache

    def enable_cache(self, config=None, **overrides):
        """Attach a result cache to the node: the LOCAL fan-out leg gets
        exact fragment-version keying (inside executor.local); remote
        per-shard-leg partials are cached with gossip on (exact gossiped
        keys) or when ttl_ms > 0 — see ClusterExecutor.cache."""
        from pilosa_tpu_torch.cache import ResultCache

        cache = ResultCache.from_config(config, **overrides)
        if self.executor.gossip is not None and cache.ttl_ms > 0:
            from pilosa_tpu_torch.gossip import warn_remote_ttl_deprecated

            warn_remote_ttl_deprecated()
        self.executor.cache = cache
        self.executor.local.cache = cache
        self._wire_node_tenants()
        self._wire_node_degrade()
        return cache

    def disable_cache(self) -> None:
        self.executor.cache = None
        self.executor.local.cache = None

    # -- tenant plane (obs/tenants.py): same surface as the plain API ------

    @property
    def tenants(self):
        return self.api.tenants

    def enable_tenants(self, config=None, **overrides):
        """Attach the tenant attribution plane (see API.enable_tenants)
        and wire it into the node's cluster-side executor — the fan-out
        cache and scheduler hang off ClusterExecutor, not the base API."""
        reg = self.api.enable_tenants(config, **overrides)
        self._wire_node_tenants()
        return reg

    def disable_tenants(self) -> None:
        self.api.disable_tenants()
        self.executor.local.tenant_namespaces = False
        cache = self.executor.cache
        if cache is not None:
            cache.tenant_hook = None
            cache.tenant_of = None
            cache.tenant_quota_bytes = 0
        if self.executor.scheduler is not None:
            self.executor.scheduler.set_fair_share(False)

    def _wire_node_tenants(self) -> None:
        """Wire the tenant plane into whichever node-level planes exist
        right now; enable_cache/enable_scheduler call this again so
        enable order doesn't matter (mirrors API._wire_tenants, which
        only knows the base API's executor)."""
        reg = self.api.tenants
        if reg is None:
            return
        self.executor.local.tenant_namespaces = True
        cache = self.executor.cache
        if cache is not None:
            cache.tenant_hook = reg.cache_hook
            cache.tenant_of = current_tenant_id
            cache.tenant_quota_bytes = reg.cache_quota_bytes
            cache.tenant_quota_of = reg.cache_quota_for
        sched = self.executor.scheduler
        if sched is not None and self.api._tenants_fair:
            sched.set_fair_share(True, reg.weight)

    # -- graceful degradation (sched/degrade.py): node-side wiring ---------

    @property
    def degrade(self):
        return self.api.degrade

    def enable_degrade(self, config=None, **overrides):
        """Attach the brownout ladder (see API.enable_degrade) and wire
        it into the node's cluster-side scheduler/cache — which hang off
        ClusterExecutor, not the base API."""
        deg = self.api.enable_degrade(config, **overrides)
        self._wire_node_degrade()
        return deg

    def disable_degrade(self) -> None:
        self.api.disable_degrade()
        if self.executor.scheduler is not None:
            self.executor.scheduler.degrade = None
        for cache in (self.executor.cache, self.executor.local.cache):
            if cache is not None:
                cache.degrade = None

    def _wire_node_degrade(self) -> None:
        """Mirror of _wire_node_tenants: point whichever node-level
        planes exist at the controller; enable_cache/enable_scheduler/
        enable_health call this again so enable order doesn't matter."""
        deg = self.api.degrade
        if deg is None:
            return
        sched = self.executor.scheduler
        if sched is not None:
            sched.degrade = deg
            deg.retry_after_fn = sched.retry_after_s
        for cache in (self.executor.cache, self.executor.local.cache):
            if cache is not None:
                cache.degrade = deg

    # -- fan-out resilience (cluster/resilience.py) ------------------------

    @property
    def resilience(self):
        return self.executor.resilience

    def enable_resilience(self, config=None, **overrides):
        """Attach hedged remote legs, per-node circuit breakers and
        adaptive leg timeouts to this coordinator's fan-out. A breaker
        closing (the node recovered) marks the node up in membership, so
        it rejoins assignment. With gossip on, the breaker's local
        transitions are published to the peers."""
        from pilosa_tpu_torch.cluster.resilience import Resilience

        overrides.setdefault("on_node_up", self._mark_up)
        res = Resilience.from_config(config, **overrides)
        # a tripped peer's pooled sockets are suspect (whatever failed
        # it may have wedged its half of the connections): drop them so
        # the half-open probe and later traffic reconnect fresh
        res.breaker.add_listener(self._evict_on_breaker_open)
        self.executor.resilience = res
        self._wire_gossip_resilience()
        self._wire_health_resilience()
        return res

    def disable_resilience(self) -> None:
        self.executor.resilience = None

    def _evict_on_breaker_open(self, nid: str, frm: str, to: str) -> None:
        from pilosa_tpu_torch.cluster.resilience import BREAKER_OPEN

        if to == BREAKER_OPEN:
            self.client.evict_node(nid)

    # -- fan-out leg batching (cluster/batch.py) ---------------------------

    @property
    def batcher(self):
        return self.executor.batcher

    def enable_cluster_batch(self, config=None, **overrides):
        """Attach the per-node remote-leg coalescer: concurrent read
        legs bound for the same peer ship as ONE multi-query RPC served
        by the peer's ``execute_many`` superset merge. While it is
        attached EVERY remote read leg takes the batch RPC (a solo leg
        ships as a batch of one), so a fault rule scoped
        ``op="query_batch"`` covers all batched traffic."""
        from pilosa_tpu_torch.cluster.batch import NodeBatcher

        batcher = NodeBatcher.from_config(self.client, config, **overrides)
        self.executor.batcher = batcher
        return batcher

    def disable_cluster_batch(self) -> None:
        self.executor.batcher = None

    # -- health plane (obs/: timeline + SLO + flight recorder) -------------

    @property
    def health(self):
        return self.api.health

    def enable_health(self, config=None, start: bool = False, **overrides):
        """Attach the health plane (see API.enable_health) with this
        node's probes: the executor's scheduler and cache and the
        breaker states, beside the base API's reads."""
        plane = self.api.enable_health(config, start=start, **overrides)
        plane.attach_node(self)
        self._wire_health_resilience()
        self._wire_node_degrade()
        return plane

    def disable_health(self) -> None:
        self.api.disable_health()

    def _wire_health_resilience(self) -> None:
        """Feed the breaker's LOCAL transitions into the flight
        recorder's event ring; enable_health and enable_resilience both
        call it, so their order does not matter. The listener only
        appends (capturing a bundle there would read breaker state back
        under the breaker's notification); the open state fires the
        ``breaker_open`` trigger at the next timeline sample."""
        hp = self.api.health
        res = self.executor.resilience
        if hp is None or res is None:
            return
        old = getattr(self, "_health_listener", None)
        if old is not None:
            res.breaker.remove_listener(old)
        res.breaker.add_listener(hp.on_breaker_transition)
        self._health_listener = hp.on_breaker_transition

    def cluster_stats(self, window_s: float = 60.0) -> dict:
        """GET /internal/stats/cluster: fan the timeline window out to
        every member over the InternalClient (``op="stats"``, so fault
        rules can scope to it; a peer whose breaker is open is skipped,
        not probed) and merge: per-node windows plus a cluster aggregate
        summing each reporting node's newest sample."""
        from pilosa_tpu_torch.cluster.client import NodeDownError, RemoteError
        from pilosa_tpu_torch.cluster.resilience import BREAKER_OPEN

        res = self.executor.resilience
        nodes: Dict[str, dict] = {}
        for n in self.snapshot().nodes:
            if n.id == self.node.id:
                hp = self.api.health
                nodes[n.id] = (hp.timeline_json(window_s)
                               if hp is not None else {"enabled": False})
                continue
            if res is not None and res.breaker.state(n.id) == BREAKER_OPEN:
                nodes[n.id] = {"enabled": False, "error": "breaker open"}
                continue
            try:
                nodes[n.id] = self.client.stats_timeline(n, window_s)
            except (NodeDownError, RemoteError) as e:
                nodes[n.id] = {"enabled": False, "error": str(e)}
        rates: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        latest_t = None
        reporting = 0
        for tl in nodes.values():
            samples = tl.get("samples") or []
            if not tl.get("enabled") or not samples:
                continue
            reporting += 1
            last = samples[-1]
            latest_t = (last["t"] if latest_t is None
                        else max(latest_t, last["t"]))
            for k, v in last.get("rates", {}).items():
                rates[k] = rates.get(k, 0.0) + v
            for k, v in last.get("gauges", {}).items():
                gauges[k] = gauges.get(k, 0.0) + v
        return {"window_s": window_s, "nodes": nodes,
                "cluster": {"nodes_reporting": reporting,
                            "latest_t": latest_t,
                            "rates": rates, "gauges": gauges}}

    # -- cluster metadata gossip (gossip/) ---------------------------------

    @property
    def gossip(self):
        return self.executor.gossip

    def enable_gossip(self, config=None, start: bool = False, **overrides):
        """Attach a gossip agent: fragment version vectors, health and
        breaker digests, piggybacked on the node's RPCs and exchanged in
        periodic anti-entropy rounds. Remote-leg cache entries switch to
        exact fingerprint keys (ClusterExecutor.gossip) and the peers'
        breaker observations pre-warm ours. ``start=True`` launches the
        background round thread (tests drive run_round directly)."""
        from pilosa_tpu_torch.gossip import (GossipAgent,
                                             warn_remote_ttl_deprecated)

        self.disable_gossip()
        agent = GossipAgent.from_config(
            self.node.id, self.client, self._peers, self.api.holder,
            config, **overrides)
        agent.state.on_breaker = self._apply_remote_breaker
        self.executor.gossip = agent
        self.client.gossip = agent if agent.piggyback else None
        self._wire_gossip_resilience()
        cache = self.executor.cache
        if cache is not None and cache.ttl_ms > 0:
            warn_remote_ttl_deprecated()
        agent.refresh_local()
        agent.state.record_health()
        if start:
            agent.start()
        return agent

    def disable_gossip(self) -> None:
        self.disable_membership()  # membership rides the agent
        agent, self.executor.gossip = self.executor.gossip, None
        self.client.gossip = None
        listener = getattr(self, "_gossip_listener", None)
        if listener is not None:
            res = self.executor.resilience
            if res is not None:
                res.breaker.remove_listener(listener)
            self._gossip_listener = None
        if agent is not None:
            agent.stop()

    def _peers(self) -> List[Node]:
        return [n for n in self.disco.nodes() if n.id != self.node.id]

    def _wire_gossip_resilience(self) -> None:
        """Publish the breaker's LOCAL transitions into gossip;
        enable_gossip and enable_resilience both call it, so their order
        does not matter. Remote applies notify no listener, so a
        gossiped state never echoes back out as our own observation."""
        agent = self.executor.gossip
        res = self.executor.resilience
        if agent is None or res is None:
            return
        old = getattr(self, "_gossip_listener", None)
        if old is not None:
            res.breaker.remove_listener(old)

        def listener(target: str, frm: str, to: str,
                     _agent=agent) -> None:
            _agent.record_breaker(target, to)

        res.breaker.add_listener(listener)
        self._gossip_listener = listener

    def _apply_remote_breaker(self, origin: str, target: str,
                              state) -> None:
        """A peer's gossiped breaker observation: pre-warm our breaker
        for the same target (never for ourselves: we know best whether
        we are up)."""
        if target == self.node.id:
            return
        res = self.executor.resilience
        if res is None or not isinstance(state, str):
            return
        if res.breaker.apply_remote(target, state):
            from pilosa_tpu_torch.obs import metrics as M

            res.registry.count(M.METRIC_GOSSIP_BREAKER_PREWARMS,
                               node=target)

    # -- gossip-native membership (gossip/membership.py) -------------------

    @property
    def membership(self):
        return self._membership

    def enable_membership(self, config=None, **overrides):
        """Attach the SWIM membership protocol and make it the source of
        liveness: ``self.disco`` becomes a GossipDisCo over the previous
        (seed) DisCo, the broadcaster carries schema and shard messages
        on the gossip plane too, translate replication rides it as a
        second channel, and the membership tick and the translator's
        outbox flush run on every anti-entropy round. Gossip is enabled
        first when it is off."""
        from pilosa_tpu_torch.cluster.disco import GossipDisCo
        from pilosa_tpu_torch.gossip import (
            KIND_CONTROL, KIND_TRANSLATE, Membership,
        )

        self.disable_membership()
        agent = self.executor.gossip
        if agent is None:
            agent = self.enable_gossip(config)
        m = Membership.from_config(self.node.id, agent, self.client,
                                   self._peers, config, **overrides)
        self._membership = m
        self._seed_disco = self.disco
        self.disco = GossipDisCo(self._seed_disco, m)
        self.broadcaster = B.GossipBroadcaster(self.broadcaster, agent)
        agent.state.add_kind_listener(KIND_CONTROL,
                                      self._apply_control_entry)
        agent.state.add_kind_listener(KIND_TRANSLATE,
                                      self._apply_translate_entry)
        self.executor.translator.gossip_publish = (
            self._publish_translate_entries)
        agent.round_hooks.append(m.tick)
        agent.round_hooks.append(self.executor.translator.flush_outbox)
        return m

    def disable_membership(self) -> None:
        m = self._membership
        if m is None:
            return
        from pilosa_tpu_torch.gossip import (
            KIND_CONTROL, KIND_MEMBER, KIND_TRANSLATE,
        )

        agent = m.agent
        agent.state.remove_kind_listener(KIND_MEMBER, m._on_member_entry)
        agent.state.remove_kind_listener(KIND_CONTROL,
                                         self._apply_control_entry)
        agent.state.remove_kind_listener(KIND_TRANSLATE,
                                         self._apply_translate_entry)
        for hook in (m.tick, self.executor.translator.flush_outbox):
            try:
                agent.round_hooks.remove(hook)
            except ValueError:
                pass
        self.executor.translator.gossip_publish = None
        if isinstance(self.broadcaster, B.GossipBroadcaster):
            self.broadcaster = self.broadcaster.inner
        if self._seed_disco is not None:
            self.disco = self._seed_disco
            self._seed_disco = None
        self._membership = None

    def _apply_control_entry(self, origin: str, key, value) -> None:
        """A peer's gossiped control message (GossipBroadcaster's
        whitelist) reached us through anti-entropy: apply it as a direct
        broadcast. Every whitelisted type is idempotent, so the direct
        push arriving too is harmless."""
        if not isinstance(value, dict):
            return
        try:
            self.receive_message(dict(value))
        except Exception:
            pass  # best-effort second channel; the direct push governs

    def _publish_translate_entries(self, index: str, field, entries,
                                   batch_no: int) -> None:
        agent = self.executor.gossip
        if agent is not None:
            from pilosa_tpu_torch.gossip import KIND_TRANSLATE

            agent.state.bump_local(
                (KIND_TRANSLATE, index, field or "", int(batch_no)),
                entries)

    def _apply_translate_entry(self, origin: str, key, value) -> None:
        """A peer's gossiped translate batch: apply the (key, id)
        entries to the local store. Ids are allocated by the primary
        only, so applying a batch again (direct push and gossip) changes
        nothing."""
        if not isinstance(value, list):
            return
        index, field = key[1], (key[2] or None)
        try:
            self.executor.translator.apply_replicated(
                index, field, [(k, int(i)) for k, i in value])
        except KeyError:
            pass  # index or field not created here yet: the schema
            # control entry (same origin, earlier seq) normally comes
            # first; in a race the direct push delivers later

    def membership_ping(self, body: dict) -> dict:
        """Serve POST /internal/membership/ping: a direct probe ("am I
        up?") or a ping-req relay (``target`` set: probe the target over
        OUR link and report, the indirect path that tells a dead node
        from a dead link to it)."""
        from pilosa_tpu_torch.cluster.client import NodeDownError, RemoteError

        target = body.get("target")
        if target:
            node = Node(id=target.get("id", ""), uri=target.get("uri", ""))
            try:
                out = self.client.membership_ping(
                    node, {"from": self.node.id,
                           "relay_for": body.get("from")})
                return {"ok": bool(out.get("ok")), "relay": self.node.id}
            except (NodeDownError, RemoteError):
                return {"ok": False, "relay": self.node.id}
        # answer even with membership off: an ack proves the process is
        # up, which is all the prober needs
        m = self._membership
        return {"ok": True, "node": self.node.id,
                "inc": m.incarnation if m is not None else 0}

    def membership_json(self) -> dict:
        """GET /internal/membership payload."""
        m = self._membership
        if m is None:
            return {"enabled": False, "node": self.node.id,
                    "live": sorted(self.disco.live_ids())}
        return m.members_json()

    # -- replica catch-up (storage/recovery.py) ----------------------------

    @property
    def recovery(self):
        return self._recovery

    def enable_recovery(self, config=None, **overrides):
        """Attach a RecoveryManager: lag detection against the gossiped
        fragment version vectors, shard snapshot and WAL-tail catch-up
        from replica peers, write queueing while catching up, and
        breaker-gated reads (lag detection and the peers' gating need
        enable_gossip)."""
        from pilosa_tpu_torch.storage.recovery import RecoveryManager

        self._recovery = RecoveryManager.from_config(self, config,
                                                     **overrides)
        return self._recovery

    def disable_recovery(self) -> None:
        self._recovery = None

    # -- what the node reads through the base API -------------------------

    @property
    def history(self):
        return self.api.history

    @property
    def idalloc(self):
        return self.api.idalloc

    @property
    def query_logger(self):
        return self.api.query_logger

    @property
    def txf(self):
        """The DML group commit: the local holder's write lock and WAL
        flush. Remote writes commit per import on their owners, so a SQL
        statement is atomic per node, as in the reference (sql3 inserts
        fan imports out without a cluster transaction)."""
        return self.api.txf

    # -- imports (reference: api.go:1438 Import / :618 ImportRoaring) ------

    def import_bits(self, index: str, field: str, rows=None, cols=None,
                    row_keys=None, col_keys=None, clear: bool = False,
                    remote: bool = False) -> int:
        if remote:
            rm = self._recovery
            if rm is not None and rm.defer(
                    index, lambda: self.import_bits(
                        index, field, rows=rows, cols=cols, clear=clear,
                        remote=True)):
                return 0  # queued: applies once catch-up completes
            n = self.api.import_bits(index, field, rows=rows, cols=cols,
                                     clear=clear)
            self._announce_shards(index)
            return n
        self._check_state(write=True)
        tr = self.executor.translator
        if col_keys is not None and len(col_keys):
            cols = self._key_ids(tr.index_keys, index, col_keys)
        if row_keys is not None and len(row_keys):
            rows = self._key_ids(
                lambda i, keys, create: tr.field_keys(i, field, keys, create),
                index, row_keys)
        total = 0
        for node, shard_rows, shard_cols, primary in self._route_bits(
                index, rows, cols):
            payload = {"field": field, "rows": shard_rows,
                       "cols": shard_cols, "clear": clear, "remote": True}
            if node.id == self.node.id:
                n = self.api.import_bits(index, field, rows=shard_rows,
                                         cols=shard_cols, clear=clear)
            else:
                n = self.client.import_bits(node, index, field,
                                            payload).get("changed", 0)
            if primary:
                total += n
        self._announce_shards(index)
        return total

    def import_values(self, index: str, field: str, cols=None, values=None,
                      col_keys=None, remote: bool = False) -> int:
        if remote:
            rm = self._recovery
            if rm is not None and rm.defer(
                    index, lambda: self.import_values(
                        index, field, cols=cols, values=values,
                        remote=True)):
                return 0
            n = self.api.import_values(index, field, cols=cols,
                                       values=values)
            self._announce_shards(index)
            return n
        self._check_state(write=True)
        tr = self.executor.translator
        if col_keys is not None and len(col_keys):
            cols = self._key_ids(tr.index_keys, index, col_keys)
        total = 0
        for node, shard_vals, shard_cols, primary in self._route_bits(
                index, values, cols):
            payload = {"field": field, "cols": shard_cols,
                       "values": shard_vals, "remote": True}
            if node.id == self.node.id:
                n = self.api.import_values(index, field, cols=shard_cols,
                                           values=shard_vals)
            else:
                n = self.client.import_values(node, index, field,
                                              payload).get("imported", 0)
            if primary:
                total += n
        self._announce_shards(index)
        return total

    @staticmethod
    def _key_ids(translate, index: str, keys) -> List[int]:
        """Ids of ``keys`` from one create call over the distinct keys in
        order of first appearance, so the ids are those that one call
        over every key would allocate."""
        ids = translate(index, list(dict.fromkeys(keys)), create=True)
        return [ids[k] for k in keys]

    def _route_bits(self, index: str, rows, cols):
        """Yield (node, rows-chunk, cols-chunk, is_primary) for every
        replica of every shard touched (reference: internal_client.go:750
        import fan-out by shard). The shards are grouped with numpy; each
        node's chunk holds its shards in order of first appearance, each
        shard's entries in input order, as the JAX package's per-column
        loop groups them."""
        snap = self.snapshot()
        cols = np.asarray(cols, dtype=np.int64)
        rows = np.asarray(rows)
        shard_of = cols // SHARD_WIDTH
        uniq, first = np.unique(shard_of, return_index=True)
        plan: Dict[str, Dict[str, Any]] = {}
        for shard in uniq[np.argsort(first, kind="stable")].tolist():
            sel = np.flatnonzero(shard_of == shard)
            for rank, node in enumerate(snap.shard_nodes(index, shard)):
                ent = plan.setdefault(node.id + f"#{rank == 0}", {
                    "node": node, "cols": [], "primary": rank == 0})
                ent["cols"].append(sel)
        for ent in plan.values():
            sel = np.concatenate(ent["cols"])
            yield (ent["node"], rows[sel].tolist(), cols[sel].tolist(),
                   ent["primary"])

    def import_roaring(self, index: str, field: str, shard: int,
                       views: Dict[str, bytes], clear: bool = False,
                       remote: bool = False) -> None:
        if remote:
            rm = self._recovery
            if rm is not None and rm.defer(
                    index, lambda: self.import_roaring(
                        index, field, shard, views, clear=clear,
                        remote=True)):
                return
            self.api.import_roaring(index, field, shard, views, clear=clear)
            self._announce_shards(index)
            return
        self._check_state(write=True)
        snap = self.snapshot()
        payload = {"field": field, "clear": clear, "remote": True,
                   "views": {v: base64.b64encode(b).decode()
                             for v, b in views.items()}}
        for node in snap.shard_nodes(index, shard):
            if node.id == self.node.id:
                self.api.import_roaring(index, field, shard, views,
                                        clear=clear)
            else:
                self.client.import_roaring_shard(node, index, shard, payload)
        self._announce_shards(index)

    # -- broadcast receive (reference: server.go:995 receiveMessage) -------

    def receive_message(self, msg: dict) -> None:
        t = msg.get("type")
        if t == MSG_AVAILABLE_SHARDS:
            with self._lock:
                self._remote_shards.setdefault(
                    msg["index"], set()).update(msg["shards"])
            return
        if t == B.MSG_TRANSACTION:
            self.api.transactions.apply_remote(
                msg.get("action", ""), msg.get("txn", {}))
            return
        B.apply_message(self, msg)

    # -- passthroughs so the HTTP layer sees one surface -------------------

    @property
    def holder(self):
        return self.api.holder

    def schema(self) -> List[dict]:
        return self.api.schema()

    def info(self) -> dict:
        d = self.api.info()
        d["node"] = self.node.to_json()
        d["state"] = self.state()
        d["replicaN"] = self.replica_n
        return d

    def status(self) -> dict:
        return {"state": self.state(),
                "nodes": [n.to_json() for n in self.disco.nodes()],
                "localID": self.node.id,
                "indexes": sorted(self.api.holder.indexes)}
