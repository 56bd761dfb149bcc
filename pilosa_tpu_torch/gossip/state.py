"""Gossip state table: per-origin sequence-numbered cluster metadata.

Port of ``pilosa_tpu/gossip/state.py``; the entries, digests, delta
windows and fingerprints are the JAX package's, value for value.

Every node keeps one :class:`GossipState` holding, per ORIGIN node, a
set of (key, value, seq, stamp) entries:

- ``("f", index, field, shard)`` — the origin's fragment version vector
  slot for one (index, field, shard): value is ``[fragment_count,
  version_sum]`` over that field's views (plus the BSI fragment), so
  both a write bumping an existing fragment's version and a brand-new
  fragment appearing change the value. ``field`` is ``"@dataframe"``
  for dataframe frames (mirroring cache/keys.py's sentinel).
- ``("b", target)`` — the origin's circuit-breaker state for ``target``
  (cluster/resilience.py), so one coordinator's open/half-open
  observation pre-warms its peers' breakers.
- ``("h", node)`` — node-health marker (the origin asserting itself up).

Seqs are per-origin monotone counters assigned when the ORIGIN bumps a
key; a re-bumped key gets a fresh seq and the old one simply ceases to
exist ("live" seqs are sparse). A node's ``digest()`` maps origin ->
max live seq it holds, and ``deltas_since(peer_digest)`` returns every
live entry above the peer's watermark, ascending per origin — so any
transfer is a complete window over (watermark, cutoff] and the
receiver's digest never advances past an entry it missed, even when
``max_deltas`` truncates the batch. Entries relay transitively (a delta
batch carries ALL origins the sender knows), so A learns about C
through B; per-key seq comparison makes application idempotent and
newest-wins.

Iteration is sorted everywhere (origins, keys) so digests, delta order
and fingerprints are byte-identical across interpreter runs —
PYTHONHASHSEED must not matter, same rule as cache/keys.py.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from pilosa_tpu_torch.obs import metrics as M
from pilosa_tpu_torch.sched.clock import MonotonicClock

# key-kind tags (first tuple slot)
KIND_FRAGMENT = "f"
KIND_BREAKER = "b"
KIND_HEALTH = "h"
# SWIM membership observation: ("m", target) -> [status, incarnation]
# published under each OBSERVER's origin (gossip/membership.py)
KIND_MEMBER = "m"
# control-plane broadcast: ("c", n) -> message dict, n a per-origin
# counter so every message gets its own seq and applies exactly once
# per receiver in origin order (cluster/broadcast.GossipBroadcaster)
KIND_CONTROL = "c"
# translate replication: ("t", index, field-or-"", batch) -> entry list
# (cluster/translator.py; grow-only key->id maps, primary-only
# allocation makes cross-origin application conflict-free)
KIND_TRANSLATE = "t"

# mirrors cache/keys.py sentinel: dataframe frames version under a field
# name no real field can use
DF_FIELD = "@dataframe"


def local_fragment_slots(idx) -> Dict[Tuple[str, int], List[int]]:
    """(field, shard) -> ``[fragment_count, version_sum]`` for one holder
    index — the raw material of :meth:`GossipState.refresh_index` and the
    LOCAL side of replica catch-up lag detection (storage/recovery.py
    compares these against peers' gossiped slots)."""
    slots: Dict[Tuple[str, int], List[int]] = {}
    # list() snapshots: concurrent imports mutate these dicts (same
    # pattern as server/http.py get_mem_usage)
    for fname in sorted(list(idx.fields)):
        field = idx.fields.get(fname)
        if field is None:
            continue
        for view in sorted(list(field.views)):
            frags = field.views.get(view) or {}
            for shard, frag in sorted(list(frags.items())):
                s = slots.setdefault((fname, int(shard)), [0, 0])
                s[0] += 1
                s[1] += int(frag.version)
        for shard, frag in sorted(list(field.bsi.items())):
            s = slots.setdefault((fname, int(shard)), [0, 0])
            s[0] += 1
            s[1] += int(frag.version)
    for shard, frame in sorted(list(idx.dataframe.frames.items())):
        s = slots.setdefault((DF_FIELD, int(shard)), [0, 0])
        s[0] += 1
        s[1] += int(frame.version)
    return slots


class _Entry:
    __slots__ = ("value", "seq", "stamp")

    def __init__(self, value: Any, seq: int, stamp: float):
        self.value = value
        self.seq = seq
        self.stamp = stamp


class GossipState:
    """Thread-safe per-origin entry table + the local version-vector
    scanner. ``on_breaker(origin, target, state)`` fires for every
    breaker entry APPLIED from a remote origin (never for local bumps,
    never for stale/duplicate deltas) — the resilience wiring point."""

    def __init__(self, node_id: str, clock=None, registry=None,
                 on_breaker: Optional[Callable[[str, str, str], None]] = None):
        self.node_id = node_id
        self.clock = clock if clock is not None else MonotonicClock()
        self.registry = registry if registry is not None else M.REGISTRY
        self.on_breaker = on_breaker
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict[Tuple, _Entry]] = {node_id: {}}
        self._max_seq: Dict[str, int] = {node_id: 0}
        # generic per-kind apply listeners: fn(origin, key, value) fires
        # for every entry of that kind APPLIED from a remote origin (the
        # same contract as on_breaker, which predates this registry) —
        # membership records, control broadcasts and translate batches
        # all hook here
        self._kind_listeners: Dict[
            str, List[Callable[[str, Tuple, Any], None]]] = {}

    def add_kind_listener(self, kind: str,
                          fn: Callable[[str, Tuple, Any], None]) -> None:
        self._kind_listeners.setdefault(kind, []).append(fn)

    def remove_kind_listener(self, kind: str, fn) -> None:
        try:
            self._kind_listeners.get(kind, []).remove(fn)
        except ValueError:
            pass

    # -- local bumps -------------------------------------------------------

    def bump_local(self, key: Tuple, value: Any) -> bool:
        """Publish ``key=value`` under this node's origin with a fresh
        seq — no-op (and no traffic) when the value is unchanged."""
        with self._lock:
            own = self._entries[self.node_id]
            cur = own.get(key)
            if cur is not None and cur.value == value:
                return False
            seq = self._max_seq[self.node_id] + 1
            self._max_seq[self.node_id] = seq
            own[key] = _Entry(value, seq, self.clock.now())
            self._update_gauges_locked()
        return True

    def record_health(self) -> None:
        self.bump_local((KIND_HEALTH, self.node_id), "up")

    def record_breaker(self, target: str, state: str) -> None:
        self.bump_local((KIND_BREAKER, target), state)

    # -- local fragment-version scan ---------------------------------------

    def refresh_index(self, idx) -> int:
        """Scan one holder index and bump every (field, shard) slot whose
        combined fragment versions changed since the last scan. The
        value is ``[fragment_count, version_sum]`` per slot — a write
        bumps the sum, a new fragment bumps the count, so either changes
        the published value (and hence every covering fingerprint).
        Returns how many slots were bumped."""
        slots = {(KIND_FRAGMENT, idx.name, fname, shard): v
                 for (fname, shard), v in local_fragment_slots(idx).items()}
        bumped = 0
        for key in sorted(slots):
            if self.bump_local(key, slots[key]):
                bumped += 1
        return bumped

    # -- digests + deltas --------------------------------------------------

    def digest(self) -> Dict[str, int]:
        """origin -> max live seq held (the SWIM-style summary that rides
        every envelope)."""
        with self._lock:
            return {o: s for o, s in sorted(self._max_seq.items()) if s > 0}

    def origin_ages(self, now: Optional[float] = None) -> Dict[str, float]:
        """Seconds since each NON-SELF origin's newest entry landed here
        — the health-plane staleness read: a partitioned or silent peer's
        age keeps growing while healthy peers stay near the gossip
        interval."""
        if now is None:
            now = self.clock.now()
        out: Dict[str, float] = {}
        with self._lock:
            for origin, table in self._entries.items():
                if origin == self.node_id or not table:
                    continue
                newest = max(e.stamp for e in table.values())
                out[origin] = max(0.0, now - newest)
        return out

    def deltas_since(self, peer_digest: Dict[str, int],
                     cap: int = 512) -> List[dict]:
        """Every live entry above the peer's per-origin watermark,
        ascending (origin, seq), truncated at ``cap``. Ascending order
        keeps truncated batches complete windows: the receiver's digest
        only ever advances to a seq it holds everything below."""
        out: List[dict] = []
        with self._lock:
            for origin in sorted(self._entries):
                since = int(peer_digest.get(origin, 0))
                if self._max_seq.get(origin, 0) <= since:
                    continue
                ent = [(e.seq, key, e) for key, e in
                       self._entries[origin].items() if e.seq > since]
                for seq, key, e in sorted(ent, key=lambda t: t[0]):
                    if len(out) >= cap:
                        return out
                    out.append({"o": origin, "k": list(key), "v": e.value,
                                "s": seq, "t": e.stamp})
        return out

    def apply(self, deltas) -> int:
        """Merge a delta batch: per-key newest-seq-wins, own-origin
        entries skipped (we are authoritative for ourselves). Fires
        ``on_breaker`` for applied remote breaker entries and observes
        apply staleness. Returns entries applied."""
        applied = 0
        breaker_cbs: List[Tuple[str, str, str]] = []
        kind_cbs: List[Tuple[Callable, str, Tuple, Any]] = []
        now = self.clock.now()
        with self._lock:
            for d in deltas:
                origin = d.get("o")
                if not origin or origin == self.node_id:
                    continue
                key = tuple(d["k"])
                seq = int(d["s"])
                table = self._entries.setdefault(origin, {})
                cur = table.get(key)
                if cur is not None and cur.seq >= seq:
                    continue
                stamp = float(d.get("t", now))
                table[key] = _Entry(d.get("v"), seq, stamp)
                if seq > self._max_seq.get(origin, 0):
                    self._max_seq[origin] = seq
                applied += 1
                age_ms = (now - stamp) * 1e3
                if age_ms >= 0:
                    self.registry.observe_bucketed(
                        M.METRIC_GOSSIP_STALENESS_MS, age_ms,
                        M.GOSSIP_STALENESS_BUCKETS_MS)
                if key[0] == KIND_BREAKER and self.on_breaker is not None:
                    breaker_cbs.append((origin, key[1], d.get("v")))
                for fn in self._kind_listeners.get(key[0], ()):
                    kind_cbs.append((fn, origin, key, d.get("v")))
            if applied:
                self._update_gauges_locked()
        for origin, target, state in breaker_cbs:
            self.on_breaker(origin, target, state)
        for fn, origin, key, value in kind_cbs:
            fn(origin, key, value)
        return applied

    def entries_of_kind(self, kind: str) -> List[Tuple[str, Tuple, Any]]:
        """Every held (origin, key, value) whose key is of ``kind``,
        sorted (origin, key) — the membership layer's merged-view scan.
        Includes this node's own entries (our observations count)."""
        out: List[Tuple[str, Tuple, Any]] = []
        with self._lock:
            for origin in sorted(self._entries):
                ent = [(key, e.value) for key, e in
                       self._entries[origin].items() if key[0] == kind]
                for key, value in sorted(ent, key=lambda kv: kv[0]):
                    out.append((origin, key, value))
        return out

    # -- cache fingerprints ------------------------------------------------

    def remote_fingerprint(self, index: str, shards) -> Tuple:
        """Sorted tuple of (origin, field, shard, seq) over every known
        origin's fragment slots covering ``index`` x ``shards`` — the
        gossiped analog of cache/keys.version_fingerprint. Any holder's
        write to a covered shard (once gossiped, or immediately via a
        piggybacked envelope) changes some slot's seq, so the remote-leg
        cache entry keyed on this fingerprint simply never matches
        again: exact invalidation, zero TTL reliance."""
        shard_set = frozenset(int(s) for s in shards)
        parts = []
        with self._lock:
            for origin in sorted(self._entries):
                for key, e in self._entries[origin].items():
                    if (key[0] == KIND_FRAGMENT and key[1] == index
                            and key[3] in shard_set):
                        parts.append((origin, key[2], key[3], e.seq))
        parts.sort()
        return tuple(parts)

    def fragment_entries(self, index: str) -> Dict[str, Dict[Tuple, Any]]:
        """{origin: {(field, shard): [count, version_sum]}} for every
        NON-SELF origin's fragment slots covering ``index`` — the remote
        side of replica catch-up lag detection (storage/recovery.py)."""
        out: Dict[str, Dict[Tuple, Any]] = {}
        with self._lock:
            for origin in sorted(self._entries):
                if origin == self.node_id:
                    continue
                for key, e in self._entries[origin].items():
                    if key[0] == KIND_FRAGMENT and key[1] == index:
                        out.setdefault(origin, {})[
                            (key[2], int(key[3]))] = e.value
        return out

    # -- introspection -----------------------------------------------------

    def entries_json(self) -> Dict[str, Dict[str, dict]]:
        """{origin: {"kind/part/...": {"v", "s", "t"}}} — the
        /internal/gossip/state payload (sorted, JSON-safe)."""
        with self._lock:
            return {
                origin: {
                    "/".join(str(p) for p in key): {
                        "v": e.value, "s": e.seq, "t": round(e.stamp, 6)}
                    for key, e in sorted(self._entries[origin].items(),
                                         key=lambda kv: kv[1].seq)
                }
                for origin in sorted(self._entries)
            }

    def __len__(self) -> int:
        with self._lock:
            return sum(len(t) for t in self._entries.values())

    def _update_gauges_locked(self) -> None:
        self.registry.gauge(
            M.METRIC_GOSSIP_ENTRIES,
            sum(len(t) for t in self._entries.values()), node=self.node_id)
        self.registry.gauge(M.METRIC_GOSSIP_ORIGINS, len(self._entries),
                            node=self.node_id)
