"""Crash-consistent recovery: kill-point injection, fuzzy checkpoint
metadata, and replica catch-up by WAL log shipping.

Port of ``pilosa_tpu/storage/recovery.py``. Three subsystems share one
invariant: *any* crash, restart and re-delivery must converge to the
exact planes the committed write stream describes.

1. :class:`CrashPlan`: deterministic kill points at the five
   durability-critical sites (``wal.append``, ``wal.flush``,
   ``savez.pre_replace``, ``savez.post_replace``, ``checkpoint.mid``)
   and at the streaming pipeline's three stage boundaries
   (``STREAM_CRASH_SITES``, stream/pipeline.py) raise
   :class:`SimulatedCrash`; after the first fire the simulated
   process is *dead* and every hooked operation silently no-ops, so
   unwind paths (``Qcx.__exit__`` still calls ``finish()``) cannot
   persist post-crash state. The same seeds pick the same sites as in
   the JAX package.

2. Checkpoint LSN metadata: ``checkpoint.json`` next to each index's
   WAL segments records the LSN the last fuzzy checkpoint covers
   (core/holder.py writes it between the snapshot and the segment
   prune). Recovery replays only records above it; a crash between any
   two steps leaves either (old meta + full tail) or (new meta + not yet
   pruned tail), both of which replay to the same planes because every
   WAL op is idempotent at the plane level.

3. :class:`RecoveryManager`: replica catch-up. A restarted or lagging
   node compares its local fragment version slots against its peers'
   gossiped vectors (gossip/state.py), fetches shard snapshots and the
   WAL tail above each snapshot's LSN over
   ``/internal/recovery/{snapshot,wal}``, and replays them idempotently
   (the tail's ``import_bits`` records through ``scatter_merge``, as
   every import). Writes arriving during catch-up queue and apply
   after; the node gossips its own breaker open on start and closed on
   completion, so peers route reads elsewhere until it has caught up.

:func:`abandon_holder` simulates a process death in one process. Beyond
severing the WAL handles as the JAX package does, it drops every
field's device stacks and their ``DeviceBudget`` entries, as a real
process death frees the card.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.storage.wal import fsync_dir, iter_frames

log = logging.getLogger(__name__)

# the five kill sites, in write-path order
CRASH_SITES = (
    "wal.append",
    "wal.flush",
    "savez.pre_replace",
    "savez.post_replace",
    "checkpoint.mid",
)

# pipeline stage-boundary kill sites (stream/pipeline.py). A SEPARATE
# tuple: seeded() chooses over CRASH_SITES only, so the pinned crash-lane
# seeds keep selecting the same sites; the stream lane draws from
# stream_seeded() instead.
STREAM_CRASH_SITES = (
    "stream.handoff",
    "stream.apply",
    "stream.commit",
)

CHECKPOINT_META = "checkpoint.json"


class SimulatedCrash(RuntimeError):
    """Raised at an armed kill point; everything the 'process' did after
    its last flushed commit must be invisible after reopen."""


class CrashPlan:
    """Deterministic kill points for the storage write path (the
    FaultPlan idea applied to durability instead of RPCs).

        plan = CrashPlan().kill("wal.flush", at=3)
        plan = CrashPlan.seeded(7)          # seed-derived site + hit
        attach_crash_plan(holder, plan)

    ``fire(site)`` returns True to proceed; raises SimulatedCrash on the
    ``at``-th hit of an armed site; returns False once dead — callers
    must then silently no-op (a dead process performs no IO, but python
    unwind code still runs)."""

    def __init__(self):
        self._arms: Dict[str, int] = {}
        self._hits: Dict[str, int] = {}
        self.dead = False
        self.fired: Optional[Tuple[str, int]] = None
        self._lock = locktrace.tracked_lock("storage.recovery.crashplan")

    def kill(self, site: str, at: int = 1) -> "CrashPlan":
        if site not in CRASH_SITES and site not in STREAM_CRASH_SITES:
            raise ValueError(f"unknown crash site {site!r}")
        if at < 1:
            raise ValueError("at must be >= 1")
        self._arms[site] = at
        return self

    @classmethod
    def seeded(cls, seed) -> "CrashPlan":
        """Seed-derived plan: one site, one occurrence — same seed, same
        crash, forever (string-seeded like FaultPlan/GossipAgent)."""
        rng = random.Random(f"crash:{seed}")
        return cls().kill(rng.choice(CRASH_SITES), at=rng.randint(1, 4))

    @classmethod
    def stream_seeded(cls, seed) -> "CrashPlan":
        """Seed-derived plan over the pipeline stage boundaries — the
        stream lane's analog of :meth:`seeded` (its own keyspace so the
        storage lane's pinned seeds stay untouched)."""
        rng = random.Random(f"stream-crash:{seed}")
        return cls().kill(rng.choice(STREAM_CRASH_SITES),
                          at=rng.randint(1, 3))

    @classmethod
    def from_env(cls, var: str = "PILOSA_TPU_CRASH_SEED") -> Optional["CrashPlan"]:
        seed = os.environ.get(var)
        return cls.seeded(seed) if seed else None

    def fire(self, site: str) -> bool:
        with self._lock:
            if self.dead:
                return False
            hits = self._hits.get(site, 0) + 1
            self._hits[site] = hits
            if self._arms.get(site) == hits:
                self.dead = True
                self.fired = (site, hits)
                raise SimulatedCrash(f"kill point {site} hit {hits}")
        return True


# _atomic_savez can't take a plan kwarg (it would collide with array
# names), so the checkpoint passes it down thread-locally.
_SCOPE = threading.local()


class crash_scope:
    """``with crash_scope(plan): save_holder_data(...)`` — the savez
    kill sites see ``plan`` via :func:`scoped_plan`."""

    def __init__(self, plan: Optional[CrashPlan]):
        self.plan = plan

    def __enter__(self):
        self._prev = getattr(_SCOPE, "plan", None)
        _SCOPE.plan = self.plan
        return self.plan

    def __exit__(self, *exc):
        _SCOPE.plan = self._prev


def scoped_plan() -> Optional[CrashPlan]:
    return getattr(_SCOPE, "plan", None)


def attach_crash_plan(holder, plan: Optional[CrashPlan]) -> None:
    """Arm ``plan`` on a holder and every WAL it already opened (WALs
    created later inherit it via ``holder.crash_plan``)."""
    holder.crash_plan = plan
    for idx in holder.indexes.values():
        if getattr(idx, "wal", None) is not None:
            idx.wal.crash_plan = plan


def abandon_holder(holder) -> None:
    """Simulate process death for a crashed holder: sever its WAL file
    handles WITHOUT flushing, so python-buffered bytes are lost exactly
    like a real crash would lose them. (A plain reopen is not enough —
    CPython would flush the old BufferedWriter at GC time, resurrecting
    writes the 'dead' process never committed.) Then drop every field's
    device stacks and their budget entries: a dead process frees the
    card, and a holder abandoned in this process must not keep its
    stacks charged. Call this BEFORE opening a new holder on the same
    path."""
    from pilosa_tpu_torch.core.stacked import release_field_cache

    for idx in holder.indexes.values():
        for field in idx.fields.values():
            release_field_cache(field)
        idx.dataframe.release_device()
        w = getattr(idx, "wal", None)
        if w is None:
            continue
        old = getattr(w, "_f", None)
        if old is None:
            continue
        try:
            os.close(old.fileno())
        except (OSError, ValueError):
            pass
        try:
            old.close()  # flush now hits the closed fd; swallow it here,
        except (OSError, ValueError):  # synchronously, before fd reuse
            pass
        w._f = open(os.devnull, "ab")


# -- checkpoint LSN metadata -------------------------------------------------


def write_checkpoint_meta(index_path: str, lsn: int,
                          stream_offsets: Optional[Dict] = None) -> None:
    """Atomically persist the checkpoint LSN for one index: every WAL
    record <= ``lsn`` is subsumed by the on-disk snapshots. When the
    index carries stream consumer watermarks (written by the JAX
    package's stream pipeline; kept here so data directories cross
    packages), they are stamped alongside — the WAL ``stream_offsets``
    records that fed them may be pruned with the segments the
    checkpoint covers."""
    path = os.path.join(index_path, CHECKPOINT_META)
    tmp = path + ".tmp"
    doc: Dict[str, Any] = {"lsn": int(lsn)}
    if stream_offsets:
        doc["stream_offsets"] = {
            g: {k: int(v) for k, v in m.items()}
            for g, m in stream_offsets.items()}
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(index_path)


def read_checkpoint_meta(index_path: Optional[str]) -> int:
    if not index_path:
        return 0
    try:
        with open(os.path.join(index_path, CHECKPOINT_META)) as f:
            return int(json.load(f).get("lsn", 0))
    except (OSError, ValueError):
        return 0


def read_checkpoint_offsets(index_path: Optional[str]) -> Dict[str, Dict[str, int]]:
    """The stream watermark stamp from ``checkpoint.json``:
    ``{group: {"topic:partition": next_offset}}`` (empty on missing or
    pre-stream metadata). ``read_checkpoint_meta`` keeps its plain-int
    return for every existing caller."""
    if not index_path:
        return {}
    try:
        with open(os.path.join(index_path, CHECKPOINT_META)) as f:
            raw = json.load(f).get("stream_offsets") or {}
        return {str(g): {str(k): int(v) for k, v in m.items()}
                for g, m in raw.items()}
    except (OSError, ValueError, AttributeError):
        return {}


# -- record shard filtering (catch-up applies only owned shards) -------------


def record_shards(rec, shard_width: int) -> Optional[Set[int]]:
    """The shard(s) a WAL record touches, or None for index-wide records
    (tombstones / clear_row / clear_value) that must always apply."""
    op = rec[0]
    if op in ("set_bit", "clear_bit"):
        return {int(rec[3]) // shard_width}
    if op in ("set_values", "import_bits"):
        return {int(c) // shard_width for c in rec[3 if op == "import_bits" else 2]}
    if op in ("row_plane", "clear_row_bits"):
        return {int(rec[3])}
    if op in ("clear_cols", "delete_cols", "df_changeset"):
        return {int(rec[2])}
    if op == "clear_value":
        return {int(rec[2]) // shard_width}
    return None  # delete_view/delete_field/df_delete/clear_row/unknown


def filter_record(rec, shard_ok: Callable[[int], bool],
                  shard_width: int):
    """Restrict a shipped WAL record to the shards ``shard_ok`` accepts:
    returns the record (possibly with cols/values subset), or None when
    nothing in it is wanted. Index-wide records always pass."""
    op = rec[0]
    if op in ("set_values", "import_bits"):
        # pairwise subset: (op, field, a_list, b_list) where cols are
        # rec[2] for set_values and rec[3] for import_bits
        ci = 2 if op == "set_values" else 3
        oi = 3 if op == "set_values" else 2
        pairs = [(a, c) for a, c in zip(rec[oi], rec[ci])
                 if shard_ok(int(c) // shard_width)]
        if not pairs:
            return None
        a_l = [p[0] for p in pairs]
        c_l = [p[1] for p in pairs]
        out = list(rec)
        out[oi], out[ci] = a_l, c_l
        return tuple(out)
    shards = record_shards(rec, shard_width)
    if shards is None or any(shard_ok(s) for s in shards):
        return rec
    return None


# -- deterministic crash-replay harness --------------------------------------


def crash_workload(n_batches: int = 6, rows: int = 4, bits_per: int = 8,
                   seed: int = 0) -> List[Tuple[List[int], List[int]]]:
    """Small deterministic write batches (one import call == one commit
    == one WAL record, so every recovery point is a batch boundary).
    Batches stay far under the 8KB BufferedWriter spill threshold so an
    unflushed commit is lost whole, never partially."""
    rng = random.Random(f"crash-workload:{seed}")
    out = []
    for _ in range(n_batches):
        rs = [rng.randrange(rows) for _ in range(bits_per)]
        cs = [rng.randrange(2048) for _ in range(bits_per)]
        out.append((rs, cs))
    return out


def oracle_checksums(base_dir: str, batches, device=None) -> List[str]:
    """Uncrashed oracle: checksums[k] is the holder digest after k
    committed batches (checksums[0] = schema only). ``device`` is the
    API's (None: the card)."""
    from pilosa_tpu_torch.api import API

    api = API(os.path.join(base_dir, "oracle"), device=device)
    _harness_schema(api)
    out = [api.checksum()]
    for rs, cs in batches:
        api.import_bits("ci", "f", rows=rs, cols=cs)
        out.append(api.checksum())
    api.holder.flush_wals()
    return out


def _harness_schema(api) -> None:
    # trackExistence off keeps it at exactly one WAL record per import
    api.create_index("ci", {"trackExistence": False})
    api.create_field("ci", "f")


def run_crash_point(base_dir: str, plan: CrashPlan, batches,
                    checkpoint_bytes: Optional[int] = None,
                    segment_bytes: int = 1024,
                    device=None) -> Dict[str, Any]:
    """Run the workload under ``plan``; on SimulatedCrash abandon the
    holder (no flush!), reopen, recover. Returns {checksum, acked,
    crashed, fired}: the caller asserts ``checksum`` equals some oracle
    prefix >= ``acked`` (a crash may lose unacked work, never acked
    work, and never leaves a non-prefix state). Tiny ``segment_bytes``
    forces rotation so tails span segments; ``checkpoint_bytes`` (e.g.
    1) forces a fuzzy checkpoint per commit so the savez/checkpoint
    sites actually fire. ``device`` is the APIs' (None: the card)."""
    from pilosa_tpu_torch.api import API

    path = os.path.join(base_dir, "crash")
    api = API(path, segment_bytes=segment_bytes, device=device)
    _harness_schema(api)
    api.save()  # schema + empty checkpoint durable before arming
    if checkpoint_bytes is not None:
        api.holder.checkpoint_bytes = checkpoint_bytes
    attach_crash_plan(api.holder, plan)
    acked = 0
    crashed = False
    try:
        for rs, cs in batches:
            api.import_bits("ci", "f", rows=rs, cols=cs)
            acked += 1
    except SimulatedCrash:
        crashed = True
    abandon_holder(api.holder)
    reopened = API(path, segment_bytes=segment_bytes,
                   device=device)  # replays on open
    out = {
        "checksum": reopened.checksum(),
        "acked": acked,
        "crashed": crashed,
        "fired": plan.fired,
        "api": reopened,
    }
    return out


# -- replica catch-up by log shipping ----------------------------------------


class RecoveryManager:
    """Catch a lagging/restarted ClusterNode up to its replica peers.

    Lag detection compares the holder's local fragment version slots
    against gossiped vectors; repair fetches each lagging shard's
    snapshot (``export_shard_arrays`` npz) plus the peer's WAL tail
    above the snapshot LSN and replays it filtered to the lagging
    shards. Both steps are idempotent, so overlap with concurrent
    delivery or a second catch-up run is harmless. Writes forwarded to
    this node while catch-up is active queue and drain afterwards;
    the node's own breaker state rides gossip so peers only route reads
    back once ``catch_up`` completes."""

    def __init__(self, node, batch_bytes: int = 1 << 20, registry=None):
        from pilosa_tpu_torch.obs import metrics as M

        self.node = node
        self.batch_bytes = max(1, int(batch_bytes))
        self.registry = registry if registry is not None else M.REGISTRY
        self._lock = locktrace.tracked_lock("storage.recovery.manager")
        self._active: Set[str] = set()  # indexes mid-catch-up
        self._queued: Dict[str, List[Callable[[], Any]]] = {}

    @classmethod
    def from_config(cls, node, config=None, **overrides):
        kw = {}
        if config is not None:
            kw["batch_bytes"] = config.storage_recovery_catchup_batch_bytes
        kw.update(overrides)
        return cls(node, **kw)

    # -- write queueing ----------------------------------------------------

    def active(self, index: str) -> bool:
        with self._lock:
            return index in self._active

    def begin(self, index: str) -> None:
        """Mark an index as catching up so defer() queues its writes —
        catch_up does this itself; exposed for tests and manual runs."""
        with self._lock:
            self._active.add(index)

    def defer(self, index: str, fn: Callable[[], Any]) -> bool:
        """Queue a remote write arriving mid-catch-up; returns False when
        the index is not catching up (caller applies normally)."""
        from pilosa_tpu_torch.obs import metrics as M

        with self._lock:
            if index not in self._active:
                return False
            self._queued.setdefault(index, []).append(fn)
        self.registry.count(M.METRIC_RECOVERY_CATCHUP_QUEUED)
        return True

    def drain(self, indexes=None) -> int:
        """Un-mark ``indexes`` (all when None) as catching up and apply
        their queued writes. Per-index: a catch_up run drains only the
        indexes IT marked active, so two overlapping runs on different
        indexes can't release each other's queues mid-replay."""
        with self._lock:
            names = set(self._active) | set(self._queued) \
                if indexes is None else set(indexes)
            fns: List[Callable[[], Any]] = []
            for name in names:
                self._active.discard(name)
                fns.extend(self._queued.pop(name, []))
        for fn in fns:
            try:
                fn()
            except Exception:  # a queued write must not wedge the drain
                log.exception("queued catch-up write failed")
        return len(fns)

    # -- lag detection -----------------------------------------------------

    def lagging(self, index: str) -> Dict[str, Set[int]]:
        """{peer_node_id: lagging shards} — shards we own whose gossiped
        slot at some peer is strictly ahead of ours. Strictly-ahead only:
        fetching from a BEHIND peer would regress us."""
        from pilosa_tpu_torch.gossip.state import local_fragment_slots

        agent = self.node.gossip
        idx = self.node.api.holder.indexes.get(index)
        if agent is None or idx is None:
            return {}
        local = local_fragment_slots(idx)
        snap = self.node.snapshot()
        me = self.node.node.id
        out: Dict[str, Set[int]] = {}
        for origin, slots in agent.state.fragment_entries(index).items():
            for (fname, shard), val in slots.items():
                if not val:
                    continue
                mine = local.get((fname, shard), [0, 0])
                ahead = (int(val[0]) > int(mine[0])
                         or (int(val[0]) == int(mine[0])
                             and int(val[1]) > int(mine[1])))
                if not ahead:
                    continue
                owners = {n.id for n in snap.shard_nodes(index, shard)}
                if me in owners and origin in owners:
                    out.setdefault(origin, set()).add(int(shard))
        return out

    # -- the catch-up run --------------------------------------------------

    def catch_up(self, index: Optional[str] = None) -> Dict[str, Any]:
        """Detect lag and repair it. Returns a summary dict; a no-lag run
        returns ``{"shards": 0, ...}`` without touching gossip."""
        from pilosa_tpu_torch.obs import metrics as M

        holder = self.node.api.holder
        names = [index] if index else sorted(holder.indexes)
        plans = {n: self.lagging(n) for n in names}
        plans = {n: p for n, p in plans.items() if p}
        summary: Dict[str, Any] = {
            "shards": 0, "records": 0, "bytes": 0, "queued": 0,
            "indexes": sorted(plans),
        }
        if not plans:
            return summary
        t0 = time.perf_counter()
        agent = self.node.gossip
        with self._lock:
            self._active.update(plans)
        if agent is not None:
            # not queryable until caught up: peers' breakers veto reads
            # toward us (local evidence still outranks — see
            # CircuitBreaker.apply_remote)
            agent.record_breaker(self.node.node.id, "open")
        ok = False
        try:
            for name, by_origin in plans.items():
                # each lagging shard repairs from exactly one peer (first
                # ahead origin by id) — several peers being ahead of us
                # does not mean several fetches
                seen: Set[int] = set()
                for origin in sorted(by_origin):
                    fresh = sorted(by_origin[origin] - seen)
                    if not fresh:
                        continue
                    seen.update(fresh)
                    st = self._repair_from(name, origin, fresh)
                    summary["shards"] += st["shards"]
                    summary["records"] += st["records"]
                    summary["bytes"] += st["bytes"]
            holder.checkpoint()  # make the repaired planes durable
            ok = True
        finally:
            # queued writes always apply (they were accepted; replay
            # idempotence makes re-shipping them on a retry harmless),
            # but only a COMPLETED repair may advertise us queryable —
            # a failed run stays open so peers keep routing reads away,
            # and the error propagates so the caller retries catch_up
            summary["queued"] = self.drain(plans)
            if agent is not None:
                agent.record_breaker(
                    self.node.node.id, "closed" if ok else "open")
                agent.refresh_local()
        lag_ms = (time.perf_counter() - t0) * 1e3
        self.registry.observe_bucketed(
            M.METRIC_RECOVERY_CATCHUP_LAG_MS, lag_ms,
            M.RECOVERY_CATCHUP_LAG_BUCKETS_MS)
        self.registry.count(M.METRIC_RECOVERY_CATCHUP_SHARDS,
                            summary["shards"])
        summary["lag_ms"] = lag_ms
        if hasattr(self.node, "_announce_shards"):
            self.node._announce_shards(index) if index else \
                self.node._announce_shards_all()
        return summary

    def _peer(self, origin: str):
        for n in self.node.disco.nodes():
            if n.id == origin:
                return n
        raise KeyError(f"peer {origin!r} not in membership")

    def _repair_from(self, index: str, origin: str,
                     shards: List[int]) -> Dict[str, int]:
        """Snapshot + WAL-tail repair of ``shards`` from one peer. All
        snapshots come from the same peer so their LSNs share one
        counter; the tail replays from the minimum."""
        import numpy as np

        from pilosa_tpu_torch.obs import metrics as M
        from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
        from pilosa_tpu_torch.storage.store import install_shard_arrays

        holder = self.node.api.holder
        idx = holder.index(index)
        peer = self._peer(origin)
        client = self.node.client
        lagging = set(shards)
        since = None
        for shard in shards:
            resp = client.recovery_snapshot(peer, index, shard)
            raw = base64.b64decode(resp.get("npz", ""))
            if raw:
                with np.load(io.BytesIO(raw)) as z:
                    arrays = {k: z[k] for k in z.files}
            else:
                arrays = {}
            with holder.write_lock:
                if arrays:
                    install_shard_arrays(idx, shard, arrays)
            lsn = int(resp.get("lsn", 0))
            since = lsn if since is None else min(since, lsn)
        records = nbytes = 0
        since = since or 0
        while True:
            resp = client.recovery_wal(peer, index, since, self.batch_bytes)
            floor = int(resp.get("floor_lsn", 0))
            if since < floor:
                # the peer checkpointed + pruned between our snapshot and
                # this tail fetch: the gap is inside its new snapshots, so
                # re-snapshot and restart the tail from there
                since = None
                for shard in shards:
                    r2 = client.recovery_snapshot(peer, index, shard)
                    raw = base64.b64decode(r2.get("npz", ""))
                    if raw:
                        with np.load(io.BytesIO(raw)) as z:
                            arrays = {k: z[k] for k in z.files}
                        with holder.write_lock:
                            install_shard_arrays(idx, shard, arrays)
                    since_s = int(r2.get("lsn", 0))
                    since = since_s if since is None else min(since, since_s)
                since = since or 0
                continue
            frames = base64.b64decode(resp.get("frames", ""))
            recs = []
            for _lsn, rec in iter_frames(frames):
                sub = filter_record(rec, lambda s: s in lagging, SHARD_WIDTH)
                if sub is not None:
                    recs.append(sub)
            if recs:
                with holder.write_lock:
                    records += holder.replay_records(idx, recs)
            nbytes += len(frames)
            since = max(since, int(resp.get("last_lsn", since)))
            if not resp.get("more"):
                break
        self.registry.count(M.METRIC_RECOVERY_REPLAY_RECORDS, records)
        self.registry.count(M.METRIC_RECOVERY_REPLAY_BYTES, nbytes)
        return {"shards": len(shards), "records": records, "bytes": nbytes}
