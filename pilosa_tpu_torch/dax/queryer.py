"""Queryer: the stateless DAX query front-end.

Reference: dax/queryer/orchestrator.go:83 — a fork of the executor's
plan-walk that asks the Controller for shard->node topology instead of
the etcd snapshot (Topologer :43). Here the fork is free: the classic
ClusterExecutor takes its topology through a snapshot function, so the
Queryer feeds it a controller-backed snapshot and reuses the whole
fan-out/reduce/translate machinery.

``enable_serving`` upgrades the front-end to production shape: reads
route through the QueryScheduler's bounded admission (micro-batching +
deadline shedding) and a ResultCache keyed on the directive version —
any reassignment invalidates every cached result wholesale, so a stale
owner can never serve from cache. Every remote leg already carries
tenant + trace context (the InternalClient attaches both headers on
each request), so the serving plane composes with the attribution and
tracing planes with no code here. Queried field names feed back to the
controller (``note_hot``) — the warm-handoff prewarm set.

Port of ``pilosa_tpu/dax/queryer.py``. The schema-only ``Holder`` is
built on the fleet's ``device`` (``cuda:0`` unless the caller asks for
the CPU), as every port holder is; it holds no planes.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

from pilosa_tpu_torch import platform
from pilosa_tpu_torch.cluster.client import InternalClient
from pilosa_tpu_torch.cluster.executor import ClusterExecutor
from pilosa_tpu_torch.cluster.topology import ClusterSnapshot, Node
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.dax.controller import Controller
from pilosa_tpu_torch.pql.executor import has_write_calls
from pilosa_tpu_torch.pql.parser import parse
from pilosa_tpu_torch.pql.result import result_to_json
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


class DaxSnapshot(ClusterSnapshot):
    """Controller-driven placement: assigned shards resolve to their
    sticky owner; anything else falls back to jump hash over the live
    computers (new shards land where ensure_shard would put them)."""

    def __init__(self, nodes: List[Node],
                 assign: Dict[Tuple[str, int], str]):
        super().__init__(nodes, replica_n=1)
        self._assign = assign
        self._by_id = {n.id: n for n in nodes}

    def shard_nodes(self, index: str, shard: int) -> List[Node]:
        nid = self._assign.get((index, shard))
        if nid is not None and nid in self._by_id:
            return [self._by_id[nid]]
        return super().shard_nodes(index, shard)


class Queryer:
    def __init__(self, controller: Controller,
                 client: Optional[InternalClient] = None, device=None):
        self.controller = controller
        self.client = client or controller.client
        self.device = platform.resolve_device(device)
        # schema-only mirror; no data lives here
        self.holder = Holder(self.device)
        self.executor = ClusterExecutor(
            "queryer", self.holder, self.client, self._snapshot,
            controller.shards_of,
            live_fn=controller.live_ids)
        self.scheduler = None
        self.cache = None
        # recent end-to-end read latencies (ms) — the autoscaler's p99
        self._lat: deque = deque(maxlen=128)
        # bumped on every write routed through THIS front-end and mixed
        # into cache keys: read-your-writes through one queryer (other
        # front-ends converge at directive bumps / TTL, like any
        # stateless serving tier)
        self._write_epoch = 0

    def enable_serving(self, scheduler=None, cache=None, config=None,
                       clock=None, **sched_kw):
        """Production serving shape: reads go through scheduler
        admission and a directive-versioned result cache. Off by
        default — the plain Queryer stays zero-cost (no worker thread,
        no cache memory)."""
        from pilosa_tpu_torch.cache.result_cache import ResultCache
        from pilosa_tpu_torch.sched.scheduler import QueryScheduler

        self.cache = cache if cache is not None \
            else ResultCache.from_config(config)
        self.scheduler = scheduler if scheduler is not None \
            else QueryScheduler(self.executor, clock=clock, **sched_kw)
        return self

    def close(self) -> None:
        if self.scheduler is not None:
            self.scheduler.close()

    def _snapshot(self) -> DaxSnapshot:
        return DaxSnapshot(self.controller.live_nodes(),
                           self.controller.assignment())

    def _sync_schema(self) -> None:
        """Mirror the controller's schema into the local (data-free)
        holder — the executor needs Index/Field objects for planning and
        translation routing."""
        from pilosa_tpu_torch.core.schema import (
            FieldOptions, FieldType, IndexOptions,
        )

        for t in self.controller.schema:
            name = t["index"]
            if name not in self.holder.indexes:
                o = t.get("options") or {}
                self.holder.create_index(name, IndexOptions(
                    keys=bool(o.get("keys", False)),
                    track_existence=bool(o.get("trackExistence", True))))
            idx = self.holder.index(name)
            for f in t.get("fields", []):
                if f["name"] not in idx.fields:
                    o = dict(f.get("options") or {})
                    fo = FieldOptions(
                        type=FieldType(o.get("type", "set")),
                        keys=bool(o.get("keys", False)),
                        min=o.get("min"), max=o.get("max"),
                        base=int(o.get("base", 0)),
                        scale=int(o.get("scale", 0)),
                        time_unit=o.get("timeUnit", "s"),
                        time_quantum=o.get("timeQuantum", ""),
                        ttl_seconds=int(o.get("ttl", 0)))
                    idx.create_field(f["name"], fo)
        for name in list(self.holder.indexes):
            if not any(t["index"] == name for t in self.controller.schema):
                self.holder.delete_index(name)

    # -- queries -----------------------------------------------------------

    def query(self, index: str, pql: str,
              shards: Optional[Sequence[int]] = None) -> List:
        self._sync_schema()
        q = parse(pql)
        # writes to fresh shards must be assigned before fan-out; keyed
        # columns translate FIRST so the owning shard is known (the
        # executor would otherwise route the write through the snapshot
        # fallback and the controller would never learn the shard exists)
        for call in q.calls:
            inner = call
            while inner.name == "Options":
                inner = inner.children[0]
            if inner.name in ("Set", "Clear"):
                col = inner.arg("_col")
                if isinstance(col, str):
                    if not self.holder.index(index).options.keys:
                        continue  # executor raises cleanly; no state
                    ids = self.executor.translator.index_keys(
                        index, [col], create=True)
                    col = ids.get(col)
                if isinstance(col, int):
                    self.controller.ensure_shard(index, col // SHARD_WIDTH)
        self._note_hot(index, q.calls)
        if has_write_calls(q):
            self._write_epoch += 1
        if self.scheduler is not None and not has_write_calls(q):
            # serving path: cache keyed on the directive version — any
            # reassignment bumps the version and invalidates wholesale,
            # then bounded admission + micro-batching under it
            t0 = time.perf_counter()
            key = ("dax", index, pql,
                   tuple(sorted(shards)) if shards is not None else None,
                   self.controller.version, self._write_epoch)
            out = self.cache.run(
                key,
                lambda: self.scheduler.submit(index, q,
                                              shards=shards).result())
            self._lat.append((time.perf_counter() - t0) * 1e3)
            return out
        t0 = time.perf_counter()
        out = self.executor.execute(index, q, shards=shards)
        self._lat.append((time.perf_counter() - t0) * 1e3)
        return out

    def _note_hot(self, index: str, calls) -> None:
        """Feed queried field names back to the controller — the
        prewarm set a future owner of these shards will build before
        advertising ready."""
        for call in calls:
            try:
                pair = call.field_arg()
            except Exception:
                pair = None
            if pair is not None and isinstance(pair[0], str):
                self.controller.note_hot(index, pair[0])
            fname = call.arg("field") if hasattr(call, "arg") else None
            if isinstance(fname, str):
                self.controller.note_hot(index, fname)
            self._note_hot(index, getattr(call, "children", []) or [])

    def probe(self) -> dict:
        """Timeline probe fragment: serving pressure (what the
        autoscaler reads) plus cache shape."""
        lat = sorted(self._lat)
        p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))] if lat else 0.0
        out = {
            "queue_depth": (self.scheduler.queue_depth()
                            if self.scheduler is not None else 0),
            "leg_p99_ms": p99,
            "serving": self.scheduler is not None,
        }
        if self.cache is not None:
            st = self.cache.stats()
            out["cache_hits"] = st.get("hits", 0)
            out["cache_misses"] = st.get("misses", 0)
        return out

    def query_json(self, index: str, pql: str) -> dict:
        return {"results": [result_to_json(r)
                            for r in self.query(index, pql)]}

    # -- imports (routed to shard owners) ----------------------------------

    def import_bits(self, index: str, field: str, rows=None, cols=None,
                    clear: bool = False) -> int:
        self._sync_schema()
        self._write_epoch += 1
        by_shard: Dict[int, Tuple[list, list]] = {}
        for r, c in zip(rows or [], cols or []):
            ent = by_shard.setdefault(int(c) // SHARD_WIDTH, ([], []))
            ent[0].append(int(r))
            ent[1].append(int(c))
        total = 0
        for shard, (rs, cs) in sorted(by_shard.items()):
            node = self.controller.ensure_shard(index, shard)
            total += self._owner_call(
                node, "import_bits", index, field,
                {"field": field, "rows": rs, "cols": cs,
                 "clear": clear, "remote": True}).get("changed", 0)
        return total

    def import_values(self, index: str, field: str, cols=None,
                      values=None) -> int:
        self._sync_schema()
        self._write_epoch += 1
        by_shard: Dict[int, Tuple[list, list]] = {}
        for c, v in zip(cols or [], values or []):
            ent = by_shard.setdefault(int(c) // SHARD_WIDTH, ([], []))
            ent[0].append(int(c))
            ent[1].append(v)
        total = 0
        for shard, (cs, vs) in sorted(by_shard.items()):
            node = self.controller.ensure_shard(index, shard)
            total += self._owner_call(
                node, "import_values", index, field,
                {"field": field, "cols": cs, "values": vs,
                 "remote": True}).get("imported", 0)
        return total

    def _owner_call(self, node: Node, kind: str, index: str, field: str,
                    payload: dict) -> dict:
        local = self.controller._local.get(node.id)
        if local is not None:
            if kind == "import_bits":
                n = local.import_bits(index, field, rows=payload["rows"],
                                      cols=payload["cols"],
                                      clear=payload["clear"], remote=True)
                return {"changed": n}
            n = local.import_values(index, field, cols=payload["cols"],
                                    values=payload["values"], remote=True)
            return {"imported": n}
        if kind == "import_bits":
            return self.client.import_bits(node, index, field, payload)
        return self.client.import_values(node, index, field, payload)
