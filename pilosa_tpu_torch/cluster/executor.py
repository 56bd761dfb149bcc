"""ClusterExecutor: coordinator-side distributed PQL execution.

Port of ``pilosa_tpu/cluster/executor.py`` (reference: executor.go:6449
mapReduce): shards are grouped by their primary owner (jump hash), the
local group runs on this node's engine (``Executor(holder,
remote=True)``), remote groups ship the pre-translated call tree over
the internal RPC (:6392 remoteExec) and come back as
``result_from_wire`` partials, and the partials merge under the same
monoids the single-node executor uses per shard. Replica failover on
transport errors mirrors :6500-6515. Key translation brackets the whole
thing: preTranslate (:6814) rewrites string keys to IDs before the
fan-out, translateResults (:7519) maps IDs back after the merge — remote
nodes never see a string. Writes go to every replica of their shards.

Each node of the port is one process with its own card (or, in
``LocalCluster``, one card shared by every node): the node's local
kernels run on its stacks, and this layer is the host-to-host axis.
``sql_subtree`` fans a SQL plan subtree out over the same loop
(sql/fanout.py). With a ``Resilience`` attached (``cluster/resilience.py``)
the remote legs of a read hedge onto replicas, open breakers route
around a failing node and each leg has an adaptive timeout; with a
``NodeBatcher`` (``cluster/batch.py``) concurrent read legs to one peer
ship as one RPC. With a gossip agent attached, a remote leg's cached
partial is keyed on the gossiped version fingerprint of its shards, so a
write anywhere invalidates it exactly.
"""
from __future__ import annotations

import contextvars
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

from pilosa_tpu_torch.cluster.client import InternalClient, NodeDownError
from pilosa_tpu_torch.obs.tracing import active_span, get_tracer
from pilosa_tpu_torch.cluster.topology import ClusterSnapshot, Node
from pilosa_tpu_torch.cluster.translator import ClusterTranslator
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.pql.ast import Call, Condition, Query, ROW_OPTIONS
from pilosa_tpu_torch.pql.executor import Executor, PQLError, _WRITE_CALLS
from pilosa_tpu_torch.pql.parser import parse
from pilosa_tpu_torch.pql import result as R
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

# Sentinel ID for read-path keys that don't exist: lives in a shard no
# index will ever populate, so every lookup comes back empty (the
# reference returns empty rows for unknown keys the same way).
MISSING_ID = 1 << 62


class ClusterExecutor:
    def __init__(self, node_id: str, holder: Holder, client: InternalClient,
                 snapshot_fn: Callable[[], ClusterSnapshot],
                 shards_fn: Callable[[str], Set[int]],
                 on_node_down: Optional[Callable[[str], None]] = None,
                 live_fn: Optional[Callable[[], Set[str]]] = None):
        self.node_id = node_id
        self.holder = holder
        self.client = client
        self._snapshot_fn = snapshot_fn
        self._shards_fn = shards_fn  # index -> all known shards cluster-wide
        self._on_node_down = on_node_down or (lambda _id: None)
        self._live_fn = live_fn
        self.local = Executor(holder, remote=True)
        # optional micro-batching scheduler over the LOCAL engine (sched/):
        # set by ClusterNode.enable_scheduler; coordinator fan-out then
        # coalesces its local shard groups with concurrent coordinators'
        self.scheduler = None
        # optional result cache (cache/), set by ClusterNode.enable_cache.
        # The local fan-out leg caches inside self.local with exact
        # fragment-version keys; the REMOTE leg has no local versions to
        # key on, so its per-shard-leg partials are cached only when a
        # TTL bounds staleness (ttl_ms > 0), keyed additionally on this
        # coordinator's per-index write epoch (self-coordinated writes
        # invalidate immediately; other writers are TTL-bounded), or
        # when gossip keys them (below).
        self.cache = None
        self._write_epoch: Dict[str, int] = {}
        # optional gossip agent (gossip/), set by ClusterNode.enable_gossip.
        # When present, remote-leg partials are keyed on the gossiped
        # version fingerprint instead of TTL+epoch: a write anywhere in
        # the cluster changes some origin's seq, so entries invalidate
        # exactly, with no reliance on a TTL.
        self.gossip = None
        # optional fan-out resilience manager (cluster/resilience.py), set
        # by ClusterNode.enable_resilience: hedged remote legs, per-node
        # circuit breakers, adaptive per-leg timeouts. READ fan-outs only;
        # the write path mirrors to every replica and never hedges.
        self.resilience = None
        # optional per-node remote-leg coalescer (cluster/batch.py), set
        # by ClusterNode.enable_cluster_batch: concurrent read legs to
        # the same peer ship as one multi-query RPC. It sits BELOW the
        # remote-leg cache (each query's partials stay keyed on its own
        # shard set) and ABOVE the wire client (hedging and failover see
        # the error surface of solo legs).
        self.batcher = None
        self.translator = ClusterTranslator(node_id, holder, client,
                                            snapshot_fn, live_fn=live_fn)
        # the node API that runs SQL subtrees on this node's shards, set
        # by ClusterNode (sql/fanout.py); None on a bare executor
        self._node_api = None

    # -- public entry ------------------------------------------------------

    def execute(self, index: str, query,
                shards: Optional[Sequence[int]] = None) -> List[Any]:
        idx = self.holder.index(index)
        if isinstance(query, str):
            query = parse(query)
        if isinstance(query, Call):
            query = Query([query])
        out = []
        for call in query.calls:
            if shards is not None and call.name not in _WRITE_CALLS:
                call = Call("Options", {"shards": list(shards)}, [call])
            inner = call
            while inner.name == "Options":
                inner = inner.children[0]
            call = self._pre_translate(idx, call,
                                       create=inner.name in _WRITE_CALLS)
            if inner.name in _WRITE_CALLS:
                out.append(self._execute_write(idx, call))
            else:
                out.append(self._post_translate(
                    idx, inner, self._execute_read(idx, call)))
        return out

    # -- fan-out machinery -------------------------------------------------

    def _assign(self, snap: ClusterSnapshot, index: str,
                shards: Sequence[int], dead: Set[str],
                replica_rank: int = 0,
                on_exhausted: str = "raise") -> Dict[str, List[int]]:
        """shard -> owning node at the given replica rank, skipping dead
        nodes (reference: executor.go:6416 shardsByNode). A rank beyond
        the live owner list is EXPLICIT: ``on_exhausted="raise"`` surfaces
        NodeDownError (never silently re-target the last owner — a hedge
        would race the very node it's hedging against),
        ``on_exhausted="skip"`` drops the shard from the assignment (the
        write mirror pass has nothing left to mirror to)."""
        by_node: Dict[str, List[int]] = {}
        for s in shards:
            owners = [n for n in snap.shard_nodes(index, s) if n.id not in dead]
            if replica_rank >= len(owners):
                if on_exhausted == "skip":
                    continue
                raise NodeDownError(
                    f"no live replica for shard {s} of index {index!r} "
                    f"at rank {replica_rank} ({len(owners)} live owner(s))")
            n = owners[replica_rank]
            by_node.setdefault(n.id, []).append(s)
        return by_node

    def _fan_shards(self, index: str, shards: Sequence[int],
                    run_local, run_remote,
                    hedgeable: bool = True) -> List[Any]:
        """The fan-out + replica-failover loop: group shards by primary
        owner, run the local group on this thread while the remote groups
        run concurrently (latency = max, not sum — the reference's mapper
        goroutines, executor.go:6579), and re-target a failed node's
        shards at the next replica rank (executor.go:6500).
        ``run_local(shards)`` / ``run_remote(node, shards, token)``
        produce one partial each; the PQL map/reduce and the SQL subtree
        fan-out share it. With a resilience manager attached the remote
        wave also gets hedging, breaker routing and adaptive timeouts
        (cluster/resilience.py)."""
        snap = self._snapshot_fn()
        nodes = {n.id: n for n in snap.nodes}
        # Seed with membership's view of dead peers (etcd heartbeats in
        # the reference); transport errors below add stragglers.
        dead: Set[str] = (set(nodes) - self._live_fn()
                          if self._live_fn is not None else set())
        res = self.resilience
        pending = list(shards)
        parts: List[Any] = []
        for _attempt in range(max(1, snap.replica_n)):
            by_node = self._assign(snap, index, pending, dead)
            if res is not None:
                # Breaker routing: open-breaker nodes lose their legs to
                # replicas up front (no timeout paid); when only vetoed
                # owners remain, probe through the breaker rather than
                # fail a query that could still succeed.
                veto = res.vetoed(
                    [nid for nid in by_node if nid != self.node_id])
                if veto:
                    active_span().set_tag("breaker_vetoed", sorted(veto))
                    try:
                        by_node = self._assign(snap, index, pending,
                                               dead | veto)
                    except NodeDownError:
                        pass
            remote = {nid: s for nid, s in by_node.items()
                      if nid != self.node_id}
            local_shards = by_node.get(self.node_id)
            if not remote:
                # all-local fan-out: no thread pool, no tokens
                if local_shards:
                    parts.append(run_local(local_shards))
                return parts
            local_fn = ((lambda s=local_shards: run_local(s))
                        if local_shards else None)
            failed: List[int] = []
            if res is not None:
                def mark_failed(nid: str, transport: bool) -> None:
                    dead.add(nid)
                    if transport:
                        self._on_node_down(nid)

                def next_owners(s, racing):
                    return self._assign(snap, index, s, dead | {racing})

                got, failed = res.run_legs(
                    remote, nodes, run_remote, next_owners,
                    hedgeable=hedgeable, local_fn=local_fn,
                    mark_failed=mark_failed)
                parts.extend(got)
            else:
                def traced_leg(nid, s):
                    with get_tracer().start_span("cluster.leg", node=nid,
                                                 hedge=False,
                                                 shards=len(s)):
                        return run_remote(nodes[nid], s, None)

                with ThreadPoolExecutor(max_workers=len(remote)) as pool:
                    # per-leg context copies re-enter the coordinator's
                    # span scope on the pool workers (a shared Context
                    # object cannot be entered concurrently)
                    futs = {nid: pool.submit(contextvars.copy_context().run,
                                             traced_leg, nid, s)
                            for nid, s in remote.items()}
                    if local_fn is not None:
                        parts.append(local_fn())
                    for nid, fut in futs.items():
                        try:
                            parts.append(fut.result())
                        except NodeDownError:
                            dead.add(nid)
                            self._on_node_down(nid)
                            failed.extend(remote[nid])
            if not failed:
                return parts
            pending = failed
        raise NodeDownError(
            f"shards {pending} unreachable on all replicas")

    def _map_shards(self, idx, call: Call,
                    shards: Sequence[int]) -> List[Any]:
        """Run `call` over the shards wherever they live; returns per-node
        partial results (untranslated, untruncated)."""
        pql = call.to_pql()

        def run_remote(node, s, token=None):
            batcher = self.batcher
            if batcher is not None:
                return R.result_from_wire(
                    batcher.run(node, idx.name, pql, s, token=token)[0])
            return R.result_from_wire(
                self.client.query_node(node, idx.name, pql, s,
                                       token=token)[0])

        cache = self.cache
        # stale serves happen on fan-out pool threads; the leg wrappers
        # pop their thread's flag into this request-scoped box and it is
        # re-raised on the request thread after the fan
        leg_stale = [False]
        gossip = self.gossip
        if cache is not None and (gossip is not None or cache.ttl_ms > 0):
            from pilosa_tpu_torch.cache.keys import shard_key

            def leg_key(s):
                # per-shard-leg partials: a later query overlapping only
                # some of these shards still hits on the shared legs.
                # With gossip the key holds the gossiped fingerprint of
                # every known origin's version slots for these shards, so
                # a write anywhere (once spread) changes the key: exact
                # invalidation. Without it, this coordinator's write
                # epoch, and the TTL bounds other writers.
                if gossip is not None:
                    return ("rlegg", idx.name, pql, shard_key(s),
                            gossip.remote_fingerprint(idx.name, s))
                return ("rleg", idx.name, pql, shard_key(s),
                        self._write_epoch.get(idx.name, 0))

            def run_remote_cached(node, s, token=None, _raw=run_remote):
                out = cache.run(leg_key(s), lambda: _raw(node, s, token))
                if cache.take_stale_flag():
                    leg_stale[0] = True
                return out

            run_remote = run_remote_cached
        out = self._fan_shards(
            idx.name, shards,
            lambda s: self._run_local_read(idx.name, call, s),
            run_remote, hedgeable=call.name not in _WRITE_CALLS)
        if leg_stale[0] and cache is not None:
            cache.mark_stale()
        return out

    def _run_local_read(self, index: str, call: Call,
                        shards: Sequence[int]) -> Any:
        """Local half of a read fan-out; rides the micro-batcher when one
        is attached so concurrent coordinators share a dispatch."""
        sched = self.scheduler
        if sched is not None and call.name not in _WRITE_CALLS:
            return sched.execute(index, Query([call]), shards=shards)[0]
        return self.local.execute(index, Query([call]), shards=shards)[0]

    # -- SQL subtree fan-out (reference: executionplanner.go:212-338) ------

    def sql_subtree(self, spec: dict) -> List[dict]:
        """Fan a serialized SQL subtree out to the shard owners: one
        node-partial ``{"rows": [...]}`` per owner group, with the PQL
        map/reduce's primary-to-replica failover (the shared
        ``_fan_shards`` loop). Each owner runs the subtree on its own
        shards only, through the node API that ``ClusterNode`` sets as
        ``_node_api``; rows received from peers count under
        ``sql_fanout_rows_total``."""
        from pilosa_tpu_torch.obs import metrics as M
        from pilosa_tpu_torch.sql.fanout import execute_subtree

        index = spec["index"]
        shards = sorted(self._shards_fn(index)) or [0]
        api = self._node_api

        def run_local(node_shards):
            if api is None:
                raise PQLError("sql_subtree needs the node API wrapper")
            return execute_subtree(api, spec, node_shards)

        def run_remote(node, node_shards, token=None):
            out = self.client.sql_subtree(node, spec, node_shards,
                                          token=token)
            M.REGISTRY.count(M.METRIC_SQL_FANOUT_ROWS,
                             len(out.get("rows", [])))
            return out

        return self._fan_shards(index, shards, run_local, run_remote)

    # -- reads -------------------------------------------------------------

    def _execute_read(self, idx, call: Call) -> Any:
        name = call.name
        if name == "Options":
            shards = call.arg("shards")
            inner = call.children[0]
            if shards is not None:
                parts = self._map_shards(idx, inner, [int(s) for s in shards])
                return self._reduce(idx, inner, parts)
            return self._execute_read(idx, inner)
        if name == "Percentile":
            return self._execute_percentile(idx, call)
        if name == "Count" and call.children and \
                call.children[0].name == "Distinct":
            merged = self._execute_read(idx, call.children[0])
            if isinstance(merged, R.RowResult):
                return len(merged.columns or merged.keys or [])
            return len(merged)
        if name == "IncludesColumn":
            col = call.arg("column")
            if col is None:
                raise PQLError("IncludesColumn requires column=")
            shard = int(col) // SHARD_WIDTH
            parts = self._map_shards(idx, call, [shard])
            return any(parts)
        shards = sorted(self._shards_fn(idx.name))
        if not shards:
            shards = [0]
        parts = self._map_shards(idx, call, shards)
        return self._reduce(idx, call, parts)

    # -- reduce monoids (reference: the reduceFn of each execute*) ---------

    def _reduce(self, idx, call: Call, parts: List[Any]) -> Any:
        name = call.name
        if name == "Count":
            return sum(parts)
        if name == "Sum":
            total, cnt = 0, 0
            for p in parts:
                if p.val is not None:
                    total += p.val
                    cnt += p.count
            return R.ValCount(val=total if cnt else None, count=cnt)
        if name in ("Min", "Max"):
            want_max = name == "Max"
            best: Optional[R.ValCount] = None
            for p in parts:
                if p.val is None:
                    continue
                if best is None or (p.val > best.val if want_max
                                    else p.val < best.val):
                    best = R.ValCount(val=p.val, count=p.count)
                elif p.val == best.val:
                    best.count += p.count
            return best or R.ValCount(val=None, count=0)
        if name in ("TopN", "TopK"):
            counts: Dict[int, int] = {}
            field = None
            for p in parts:
                field = p.field
                for pair in p.pairs:
                    counts[pair.id] = counts.get(pair.id, 0) + pair.count
            ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
            n = call.arg("n") or call.arg("k")
            if n is not None:
                ranked = ranked[: int(n)]
            return R.PairsField(
                field=field or "", pairs=[
                    R.Pair(id=r, key=None, count=c) for r, c in ranked])
        if name == "Rows":
            rows = sorted({r for p in parts for r in p})
            limit = call.arg("limit")
            if limit is not None:
                rows = rows[: int(limit)]
            return rows
        if name == "GroupBy":
            acc: Dict[tuple, R.GroupCount] = {}
            for p in parts:
                for gc in p:
                    key = tuple((fr.field, fr.row_id, fr.value)
                                for fr in gc.group)
                    got = acc.get(key)
                    if got is None:
                        acc[key] = R.GroupCount(
                            group=gc.group, count=gc.count, agg=gc.agg)
                    else:
                        got.count += gc.count
                        if gc.agg is not None:
                            got.agg = (got.agg or 0) + gc.agg
            out = [acc[k] for k in sorted(acc, key=_group_sort_key)]
            limit = call.arg("limit")
            if limit is not None:
                out = out[: int(limit)]
            return out
        if name == "Distinct":
            if parts and isinstance(parts[0], R.RowResult):
                return R.RowResult(columns=sorted(
                    {c for p in parts for c in p.columns}))
            return sorted({v for p in parts for v in p})
        if name == "Extract":
            fields = next((p.fields for p in parts if p.fields), [])
            cols = [c for p in parts for c in p.columns]
            cols.sort(key=lambda c: c.column)
            return R.ExtractedTable(fields=fields, columns=cols)
        if name == "Limit":
            merged = sorted({c for p in parts for c in p.columns})
            offset = int(call.arg("offset", 0))
            if offset:
                merged = merged[offset:]
            limit = call.arg("limit")
            if limit is not None:
                merged = merged[: int(limit)]
            return R.RowResult(columns=merged)
        # bitmap calls -> RowResult union
        if parts and isinstance(parts[0], R.RowResult):
            return R.RowResult(columns=sorted(
                {c for p in parts for c in p.columns}))
        raise PQLError(f"no distributed reduce for call {name!r}")

    # -- Percentile (coordinator-driven binary search over cluster counts) -

    def _execute_percentile(self, idx, call: Call) -> R.ValCount:
        fname = call.arg("field") or call.arg("_field")
        field = idx.field(fname)
        nth = call.arg("nth")
        if nth is None:
            raise PQLError("Percentile requires nth=")
        nth = float(nth)
        filter_call = call.arg("filter")

        def count_le(stored: int) -> int:
            cond = Call("Row", {fname: Condition("<=", field.from_stored(stored))})
            child = (Call("Intersect", children=[cond, filter_call])
                     if filter_call is not None else cond)
            return self._execute_read(idx, Call("Count", children=[child]))

        mn = self._execute_read(idx, Call(
            "Min", {"field": fname},
            [filter_call] if filter_call is not None else []))
        mx = self._execute_read(idx, Call(
            "Max", {"field": fname},
            [filter_call] if filter_call is not None else []))
        if mn.val is None:
            return R.ValCount(val=None, count=0)
        lo, hi = field.to_stored(mn.val), field.to_stored(mx.val)
        total = count_le(hi)
        if total == 0:
            return R.ValCount(val=None, count=0)
        rank = max(1, int(-(-nth * total // 100))) if nth > 0 else 1
        floor = lo
        while lo < hi:
            mid = (lo + hi) // 2
            if count_le(mid) >= rank:
                hi = mid
            else:
                lo = mid + 1
        cnt = count_le(lo) - (count_le(lo - 1) if lo > floor else 0)
        return R.ValCount(val=field.from_stored(lo), count=cnt)

    # -- writes ------------------------------------------------------------

    def _execute_write(self, idx, call: Call) -> Any:
        while call.name == "Options":
            call = call.children[0]
        snap = self._snapshot_fn()
        nodes = {n.id: n for n in snap.nodes}
        if call.name in ("Set", "Clear"):
            col = call.arg("_col")
            shards = [int(col) // SHARD_WIDTH]
        else:  # Store / ClearRow / Delete touch every shard
            shards = sorted(self._shards_fn(idx.name)) or [0]
        # Primary pass carries the result; replica passes mirror the write
        # (reference: api.go Import forwarding with remote flag).
        result: Any = None
        for rank in range(snap.replica_n):
            # mirror pass: shards whose owner list is shorter than
            # replica_n simply have no mirror at this rank
            by_node = self._assign(snap, idx.name, shards, set(), rank,
                                   on_exhausted="skip")
            if set(by_node) == {self.node_id}:
                # all-local: no thread pool
                r = self._run_write_on(nodes[self.node_id], idx, call,
                                       by_node[self.node_id])
                if rank == 0:
                    result = _merge_write(result, r)
                continue
            # the remote legs on the pool, this node's leg on this thread:
            # a SQL write holds this holder's write lock here (its Qcx),
            # and a pool thread waiting for it would never get it (the
            # JAX package deadlocks there; ROADMAP C, departure 24)
            with ThreadPoolExecutor(max_workers=max(1, len(by_node))) as pool:
                futs = {nid: pool.submit(self._run_write_on, nodes[nid], idx,
                                         call, nshards)
                        for nid, nshards in by_node.items()
                        if nid != self.node_id}
                mine = by_node.get(self.node_id)
                local = None if mine is None else self._run_write_on(
                    nodes[self.node_id], idx, call, mine)
                for nid in by_node:
                    r = futs[nid].result() if nid in futs else local
                    if rank == 0:
                        result = _merge_write(result, r)
        # invalidate remote-leg cache entries for this index (local-leg
        # entries self-invalidate via fragment versions)
        self._write_epoch[idx.name] = self._write_epoch.get(idx.name, 0) + 1
        self._after_write(idx)
        return result

    def _run_write_on(self, node: Node, idx, call: Call,
                      shards: List[int]) -> Any:
        if node.id == self.node_id:
            return self.local.execute(idx.name, Query([call]), shards=shards)[0]
        wire = self.client.query_node(node, idx.name, call.to_pql(), shards)
        return R.result_from_wire(wire[0])

    def _after_write(self, idx) -> None:
        """Hook for the node wrapper to re-broadcast shard availability."""

    # -- pre-translation (reference: executor.go:6814 preTranslate) --------

    def _pre_translate(self, idx, call: Call, create: bool) -> Call:
        args: Dict[str, Any] = dict(call.args)
        # Column values (record keys).
        if isinstance(args.get("_col"), str):
            args["_col"] = self._index_key(idx, args["_col"], create)
        if isinstance(args.get("column"), str):
            args["column"] = self._index_key(idx, args["column"], False)
        if isinstance(args.get("columns"), (list, tuple)):
            args["columns"] = [
                self._index_key(idx, c, False) if isinstance(c, str) else c
                for c in args["columns"]]
        # Row value (field keys) on Row-style calls.
        if call.name in ("Row", "Set", "Clear", "ClearRow", "Store"):
            exclude = ROW_OPTIONS if call.name == "Row" else frozenset()
            fa = call.field_arg(exclude=exclude)
            if fa is not None:
                fname, value = fa
                field = idx.fields.get(fname)
                if (field is not None and isinstance(value, str)
                        and field.options.keys):
                    args[fname] = self._field_key(idx, fname, value, create)
        if call.name == "Rows" and isinstance(args.get("previous"), str):
            fname = args.get("_field") or args.get("field")
            args["previous"] = self._field_key(idx, fname, args["previous"],
                                               False)
        if call.name == "Rows" and isinstance(args.get("in"), (list, tuple)):
            # semi-join broadcast lists ship pre-translated ints from the
            # coordinator; stray string members resolve here so remote
            # legs never see untranslated keys
            fname = args.get("_field") or args.get("field")
            args["in"] = [
                self._field_key(idx, fname, v, False)
                if isinstance(v, str) else v
                for v in args["in"]]
        # Call-valued args (GroupBy filter=/aggregate=) recurse too.
        for k, v in args.items():
            if isinstance(v, Call):
                args[k] = self._pre_translate(idx, v, create)
        children = [self._pre_translate(idx, c, create)
                    for c in call.children]
        return Call(call.name, args, children)

    def _index_key(self, idx, key: str, create: bool) -> int:
        if not idx.options.keys:
            raise PQLError(f"index {idx.name!r} does not use string keys")
        got = self.translator.index_keys(idx.name, [key], create)
        return got.get(key, MISSING_ID)

    def _field_key(self, idx, fname: str, key: str, create: bool) -> int:
        got = self.translator.field_keys(idx.name, fname, [key], create)
        return got.get(key, MISSING_ID)

    # -- post-translation (reference: executor.go:7519 translateResults) ---

    def _post_translate(self, idx, call: Call, result: Any) -> Any:
        if call.name == "Distinct":
            # Set-like Distinct yields field ROW ids (not record ids);
            # BSI Distinct yields plain values. Neither goes through the
            # index key store.
            field = idx.fields.get(
                call.arg("_field") or call.arg("field") or "")
            if (isinstance(result, R.RowResult) and field is not None
                    and field.options.keys):
                m = self.translator.field_ids(
                    idx.name, field.name, result.columns)
                return R.RowResult(columns=[], keys=[
                    m.get(c, str(c)) for c in result.columns])
            return result
        if isinstance(result, R.RowResult) and idx.options.keys:
            m = self.translator.index_ids(idx.name, result.columns)
            return R.RowResult(columns=[], keys=[
                m.get(c, str(c)) for c in result.columns])
        if isinstance(result, R.PairsField):
            field = idx.fields.get(result.field)
            if field is not None and field.options.keys:
                m = self.translator.field_ids(
                    idx.name, result.field, [p.id for p in result.pairs])
                return R.PairsField(field=result.field, pairs=[
                    R.Pair(id=None, key=m.get(p.id, str(p.id)), count=p.count)
                    for p in result.pairs])
            return result
        if isinstance(result, list) and result and \
                isinstance(result[0], R.GroupCount):
            return [self._translate_group(idx, gc) for gc in result]
        if isinstance(result, list) and call.name == "Rows":
            field = idx.fields.get(
                call.arg("_field") or call.arg("field") or "")
            if field is not None and field.options.keys:
                m = self.translator.field_ids(idx.name, field.name, result)
                return [m.get(r, str(r)) for r in result]
            return result
        if isinstance(result, R.ExtractedTable):
            return self._translate_extract(idx, result)
        return result

    def _translate_group(self, idx, gc: R.GroupCount) -> R.GroupCount:
        group = []
        for fr in gc.group:
            field = idx.fields.get(fr.field)
            if (field is not None and field.options.keys
                    and fr.row_id is not None):
                m = self.translator.field_ids(idx.name, fr.field, [fr.row_id])
                group.append(R.FieldRow(field=fr.field,
                                        row_key=m.get(fr.row_id, str(fr.row_id))))
            else:
                group.append(fr)
        return R.GroupCount(group=group, count=gc.count, agg=gc.agg)

    def _translate_extract(self, idx, tbl: R.ExtractedTable) -> R.ExtractedTable:
        cols = tbl.columns
        if idx.options.keys:
            m = self.translator.index_ids(idx.name, [c.column for c in cols])
            cols = [R.ExtractedColumn(column=c.column,
                                      key=m.get(c.column, str(c.column)),
                                      rows=c.rows) for c in cols]
        for fi, ef in enumerate(tbl.fields):
            field = idx.fields.get(ef.name)
            if field is None or not field.options.keys:
                continue
            all_ids = {r for c in cols if isinstance(c.rows[fi], list)
                       for r in c.rows[fi]}
            m = self.translator.field_ids(idx.name, ef.name, all_ids)
            for c in cols:
                if isinstance(c.rows[fi], list):
                    c.rows[fi] = [m.get(r, str(r)) for r in c.rows[fi]]
        return R.ExtractedTable(fields=tbl.fields, columns=cols)


def _group_sort_key(key: tuple):
    # Sort None-free: (field, row_id-or-value) tuples may hold None slots.
    return tuple((f, -1 if r is None else r, -1 if v is None else v)
                 for f, r, v in key)


def _merge_write(acc, r):
    if acc is None:
        return r
    if isinstance(r, bool):
        return bool(acc) or r
    return acc + r  # Delete counts sum across shards
