"""Computer: a stateless DAX compute node.

Reference: the featurebase server in compute mode — check-in loop
(server/server.go:298), directive application (api_directive.go:21-144),
shard state rebuilt from Snapshotter + Writelogger (dax/storage/,
cluster.go daxstorage hooks). Every write is appended to the shared-FS
writelog and GROUP-COMMITTED (one fsync per touched shard per request,
not per op) BEFORE it applies locally and before the client is acked —
the durability contract that makes the node stateless: kill it and the
next owner replays exactly the acked prefix (torn tails past the last
commit were never acknowledged).

Directive handling speaks both METHOD_FULL and METHOD_DIFF: a diff whose
``base_version`` is not our current version means we missed a push — we
answer ``resync`` and the controller falls back to FULL. A warm handoff
finishes shard resume (snapshot install + log-tail replay) and prewarms
the directive's hot fields BEFORE acking, so the first queries routed
here hit resident device planes instead of paying stack build + h2d.

Serves the same /internal/* HTTP surface as a classic cluster node, so
the Queryer talks to it through the unchanged InternalClient (which also
gives every leg trace + tenant propagation for free).

Port of ``pilosa_tpu/dax/computer.py``. Each computer's ``API`` runs on
``device`` (``cuda:0`` unless the caller asks for the CPU), so the
computers of one process share one card. A RESET frees the old
holder's device stacks (``storage/recovery.abandon_holder``) before it
builds the new ``API``: a wiped node must not keep its planes on the
card until the garbage collector finds them.
"""

from __future__ import annotations

import base64
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.cluster.topology import Node
from pilosa_tpu_torch.core.stacked import release_field_cache
from pilosa_tpu_torch.dax.directive import (
    Directive, METHOD_DIFF, METHOD_FULL, METHOD_RESET,
)
from pilosa_tpu_torch.dax.storage import (
    DEFAULT_SEGMENT_BYTES, Snapshotter, WriteLogger)
from pilosa_tpu_torch.obs import metrics as obs_metrics
from pilosa_tpu_torch.pql.executor import Executor, has_write_calls
from pilosa_tpu_torch.pql.parser import parse
from pilosa_tpu_torch.pql.result import result_to_wire
from pilosa_tpu_torch.sched.clock import MonotonicClock
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.storage.recovery import abandon_holder


#: what a writelog op that failed its original client raises again on
#: replay (PQL, parse, value and missing-field errors); replay skips
#: these and lets everything else fail the directive (ROADMAP C)
_APPLY_ERRORS = (ValueError, LookupError)


class Computer:
    def __init__(self, node_id: str, shared_dir: str, uri: str = "",
                 snapshot_every: int = 256, *, sync: str = "batch",
                 warm_handoff: bool = True, crash_plan=None,
                 clock=None, registry=None, device=None,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES):
        self.api = API(device=device)
        self.device = self.api.device
        self.node = Node(id=node_id, uri=uri)
        self.crash_plan = crash_plan
        self.registry = registry if registry is not None \
            else obs_metrics.REGISTRY
        self.clock = clock if clock is not None else MonotonicClock()
        self.wl = WriteLogger(shared_dir, sync=sync, crash_plan=crash_plan,
                              segment_bytes=segment_bytes,
                              registry=self.registry)
        self.snap = Snapshotter(shared_dir, crash_plan=crash_plan)
        self.snapshot_every = snapshot_every
        self.warm_handoff = warm_handoff
        self.directive_version = -1
        self.directive_at: Optional[float] = None
        self.assigned: Set[Tuple[str, int]] = set()
        self._last_snap: Dict[Tuple[str, int], int] = {}
        self._exec = Executor(self.api.holder, remote=True)
        # lazy InternalClient for membership ping relays (gossip plane)
        self._relay_client = None

    # -- directive application (reference: api_directive.go:21) ------------

    def apply_directive(self, d_json: dict) -> dict:
        d = Directive.from_json(d_json)
        if d.method != METHOD_RESET and d.version <= self.directive_version:
            # stale or duplicate push: reject regressions (:26-41)
            return {"version": self.directive_version, "applied": False}
        if d.method == METHOD_DIFF:
            if d.base_version != self.directive_version:
                # we missed a push — the delta doesn't apply on top of
                # what we have; ask the controller for the full picture
                return {"version": self.directive_version,
                        "applied": False, "resync": True}
            if d.schema_changed:
                self._apply_schema(d.schema)
            drop = sorted(set(d.remove) & self.assigned)
            load = sorted(set(d.add) - self.assigned)
            want = (self.assigned - set(d.remove)) | set(d.add)
        else:
            if d.method == METHOD_RESET:
                # wipe and reload from shared storage (:63
                # DirectiveMethodReset); the old holder's stacks leave
                # the card first
                abandon_holder(self.api.holder)
                self.api = API(device=self.device)
                self._exec = Executor(self.api.holder, remote=True)
                self.assigned = set()
                self._last_snap.clear()
            self._apply_schema(d.schema)
            want = set(d.assigned)
            drop = sorted(self.assigned - want)
            load = sorted(want - self.assigned)
        for table, shard in drop:
            self._drop_shard(table, shard)
        if self.crash_plan is not None:
            # kill point between the drop and load phases: a directive
            # observed half-applied must rebuild cleanly on restart
            # (nothing below has acked — the controller re-pushes)
            if not self.crash_plan.fire("dax.directive.mid"):
                return {"version": self.directive_version, "applied": False}
        for table, shard in load:
            self._load_shard(table, shard)
        if self.warm_handoff and load:
            # build device planes for the hot fields BEFORE advertising
            # ready: the ack below is what lets the controller route
            # queries here, so everything after it is on the serving path
            self._prewarm(d.hot, {t for t, _ in load})
        self.assigned = want
        self.directive_version = d.version
        self.directive_at = self.clock.now()
        return {"version": d.version, "applied": True}

    def _apply_schema(self, schema: List[dict]) -> None:
        holder = self.api.holder
        keep = set()
        for t in schema:
            keep.add(t["index"])
            if t["index"] not in holder.indexes:
                self.api.create_index(t["index"], t.get("options"))
            idx = holder.index(t["index"])
            for f in t.get("fields", []):
                if f["name"] not in idx.fields:
                    self.api.create_field(t["index"], f["name"],
                                          f.get("options"))
        for name in list(holder.indexes):
            if name not in keep:
                self.api.delete_index(name)

    def _drop_shard(self, table: str, shard: int) -> None:
        idx = self.api.holder.indexes.get(table)
        if idx is None:
            return
        for field in idx.fields.values():
            for frags in field.views.values():
                frags.pop(shard, None)
            field.bsi.pop(shard, None)
            release_field_cache(field)

    def _prewarm(self, hot: List[Tuple[str, str]],
                 tables: Set[str]) -> None:
        """Warm handoff: pin stacked device planes for the directive's
        hot fields on the tables we just took over. Fields the schema
        no longer has (or whose table we don't own) are skipped — the
        hot list is advisory, never an error source."""
        from pilosa_tpu_torch.core.stacked import stacked_bsi, stacked_set

        built = 0
        for table, fname in hot:
            if table not in tables:
                continue
            idx = self.api.holder.indexes.get(table)
            if idx is None:
                continue
            field = idx.fields.get(fname)
            if field is None:
                continue
            shard_list = sorted(idx.shards())
            if not shard_list:
                continue
            for view in sorted(field.views):
                stacked_set(field, shard_list, view)
                built += 1
            if field.bsi:
                stacked_bsi(field, shard_list)
                built += 1
        if built:
            self.registry.count(obs_metrics.METRIC_DAX_PREWARM_STACKS,
                                built)

    # -- shard resume: snapshot + log replay (reference: dax/storage/) -----

    def _load_shard(self, table: str, shard: int) -> None:
        t0 = time.perf_counter()
        from_version = 0
        latest = self.snap.latest(table, shard)
        if latest is not None:
            from_version, arrays = latest
            self._install_snapshot(table, shard, arrays)
        replayed = 0
        for op in self.wl.replay(table, shard, from_version):
            # Replay is total: an op that fails application (it failed
            # identically for its original client) must not wedge the
            # shard on every future owner — skip it loudly. Any other
            # error (a failed launch, a CUDA error, device memory) fails
            # the directive unacked, and the controller pushes again.
            try:
                self._apply_op(table, op, shard)
            except _APPLY_ERRORS as exc:
                import logging

                logging.getLogger("pilosa_tpu_torch.dax").warning(
                    "writelog replay skipped bad op on %s/%d: %r",
                    table, shard, exc)
            replayed += 1
        if replayed:
            self.registry.count(obs_metrics.METRIC_DAX_REPLAY_OPS,
                                replayed)
        self.registry.observe_bucketed(
            obs_metrics.METRIC_DAX_REPLAY_SECONDS,
            time.perf_counter() - t0, obs_metrics.DAX_REPLAY_BUCKETS)

    def _export_shard(self, table: str, shard: int) -> Dict[str, np.ndarray]:
        from pilosa_tpu_torch.storage.store import export_shard_arrays

        return export_shard_arrays(self.api.holder.index(table), shard)

    def _install_snapshot(self, table: str, shard: int,
                          arrays: Dict[str, np.ndarray]) -> None:
        from pilosa_tpu_torch.storage.store import install_shard_arrays

        install_shard_arrays(self.api.holder.index(table), shard, arrays)

    def _apply_op(self, table: str, op: dict, shard: int) -> None:
        k = op["k"]
        if k == "pql":
            # restricted to the log's own shard: multi-shard write calls
            # (Delete/ClearRow/Store) are logged into EVERY owned shard's
            # log, and replay order across shards must not matter
            self._exec.execute(table, parse(op["q"]), shards=[shard])
        elif k == "bits":
            self.api.import_bits(table, op["f"], rows=op["r"], cols=op["c"],
                                 clear=bool(op.get("x")))
        elif k == "vals":
            self.api.import_values(table, op["f"], cols=op["c"],
                                   values=op["v"])
        elif k == "roaring":
            views = {v: base64.b64decode(b) for v, b in op["views"].items()}
            self.api.import_roaring(table, op["f"], op["s"], views,
                                    clear=bool(op.get("x")))
        else:
            raise ValueError(f"unknown writelog op kind {k!r}")

    def maybe_snapshot(self, table: str, shard: int) -> None:
        """Compaction trigger: snapshot once the log has grown
        snapshot_every ops past the last snapshot (an exact-multiple
        check would skip forever when multi-op requests stride past the
        boundary). A successful snapshot prunes the log segments it
        covers — the snapshot now protects those ops."""
        n = self.wl.length(table, shard)
        key = (table, shard)
        last = self._last_snap.get(key)
        if last is None:
            last = self.snap.latest_version(table, shard)
            self._last_snap[key] = last
        if n - last >= self.snapshot_every:
            if self.snap.write(table, shard, n,
                               self._export_shard(table, shard)):
                self.wl.prune(table, shard, n)
                self._last_snap[key] = n

    # -- internal serving surface (same shape as ClusterNode) --------------

    def query_remote(self, index: str, pql: str,
                     shards: Sequence[int]) -> List[dict]:
        q = parse(pql)
        touched: Set[int] = set()
        if has_write_calls(q):
            for call in q.calls:
                inner = call
                while inner.name == "Options":
                    inner = inner.children[0]
                if inner.name in ("Set", "Clear"):
                    ws = [int(inner.arg("_col")) // SHARD_WIDTH]
                else:  # Store / ClearRow / Delete: every local shard
                    ws = sorted(shards) or sorted(
                        self.api.holder.index(index).shards())
                for s in ws:
                    self.wl.append(index, s, {"k": "pql",
                                              "q": inner.to_pql()})
                    touched.add(s)
            # group commit: ONE fsync per touched shard for the whole
            # request, before any op applies or the client is acked
            for s in sorted(touched):
                self.wl.commit(index, s)
        results = self._exec.execute(index, q, shards=shards)
        for s in sorted(touched):
            self.maybe_snapshot(index, s)
        return [result_to_wire(r) for r in results]

    def import_bits(self, index: str, field: str, rows=None, cols=None,
                    row_keys=None, col_keys=None, clear: bool = False,
                    remote: bool = False) -> int:
        if row_keys or col_keys:
            # globally-consistent key translation needs the translate
            # service role (reference: dax translate workers) — refusing
            # beats silently writing nothing
            raise NotImplementedError(
                "DAX compute nodes take pre-translated IDs; keyed imports "
                "need the translate service")
        by_shard: Dict[int, Tuple[list, list]] = {}
        for r, c in zip(rows or [], cols or []):
            ent = by_shard.setdefault(int(c) // SHARD_WIDTH, ([], []))
            ent[0].append(int(r))
            ent[1].append(int(c))
        for shard, (rs, cs) in sorted(by_shard.items()):
            self.wl.append(index, shard,
                           {"k": "bits", "f": field, "r": rs, "c": cs,
                            "x": int(clear)})
        for shard in sorted(by_shard):
            self.wl.commit(index, shard)
        total = 0
        for shard, (rs, cs) in sorted(by_shard.items()):
            total += self.api.import_bits(index, field, rows=rs, cols=cs,
                                          clear=clear)
            self.maybe_snapshot(index, shard)
        return total

    def import_values(self, index: str, field: str, cols=None, values=None,
                      col_keys=None, remote: bool = False) -> int:
        if col_keys:
            raise NotImplementedError(
                "DAX compute nodes take pre-translated IDs; keyed imports "
                "need the translate service")
        # validate BEFORE logging — a rejected write must never poison
        # the shared writelog (core/field.py gives the local WAL the
        # same guarantee)
        fld = self.api.holder.index(index).field(field)
        for v in values or []:
            fld.to_stored(v)
        by_shard: Dict[int, Tuple[list, list]] = {}
        for c, v in zip(cols or [], values or []):
            ent = by_shard.setdefault(int(c) // SHARD_WIDTH, ([], []))
            ent[0].append(int(c))
            ent[1].append(v)
        for shard, (cs, vs) in sorted(by_shard.items()):
            self.wl.append(index, shard,
                           {"k": "vals", "f": field, "c": cs, "v": vs})
        for shard in sorted(by_shard):
            self.wl.commit(index, shard)
        total = 0
        for shard, (cs, vs) in sorted(by_shard.items()):
            total += self.api.import_values(index, field, cols=cs, values=vs)
            self.maybe_snapshot(index, shard)
        return total

    def import_roaring(self, index: str, field: str, shard: int,
                       views: Dict[str, bytes], clear: bool = False,
                       remote: bool = False) -> None:
        self.wl.append(index, shard, {
            "k": "roaring", "f": field, "s": shard, "x": int(clear),
            "views": {v: base64.b64encode(b).decode()
                      for v, b in views.items()}})
        self.wl.commit(index, shard)
        self.api.import_roaring(index, field, shard, views, clear=clear)
        self.maybe_snapshot(index, shard)

    # -- membership surface (gossip/membership.py probes us like any node) -

    def membership_ping(self, body: dict) -> dict:
        target = body.get("target")
        if target:
            # indirect probe relay: ping the target on the requester's
            # behalf and report what WE saw (SWIM's ping-req leg)
            if self._relay_client is None:
                from pilosa_tpu_torch.cluster.client import InternalClient

                self._relay_client = InternalClient()
            node = Node(id=target["id"], uri=target.get("uri", ""))
            try:
                return self._relay_client.membership_ping(node, {})
            except Exception:
                return {"ok": False, "node": self.node.id}
        return {"ok": True, "node": self.node.id,
                "inc": int(body.get("inc", 0))}

    def membership_json(self) -> dict:
        return {"node": self.node.id, "view": {}}

    # -- passthroughs so the stock HTTP handler can serve a computer -------

    @property
    def holder(self):
        return self.api.holder

    @property
    def transactions(self):
        return self.api.transactions

    @property
    def history(self):
        return self.api.history

    @property
    def idalloc(self):
        return self.api.idalloc

    @property
    def query_logger(self):
        return self.api.query_logger

    def query(self, index: str, pql: str, shards=None):
        # direct (non-wire) queries, e.g. health checks against one node
        return self.api.query(index, pql, shards=shards)

    def schema(self) -> List[dict]:
        return self.api.schema()

    def status(self) -> dict:
        age = (self.clock.now() - self.directive_at
               if self.directive_at is not None else -1.0)
        return {"nodeID": self.node.id,
                "directiveVersion": self.directive_version,
                "directiveAgeS": age,
                "ready": self.directive_version >= 0,
                "assigned": sorted([t, s] for t, s in self.assigned)}

    def close(self) -> None:
        self.wl.close()
