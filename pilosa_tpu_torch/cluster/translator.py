"""ClusterTranslator: routes key<->ID traffic to the owning nodes and
replicates new entries to their replicas.

Port of ``pilosa_tpu/cluster/translator.py`` (reference: cluster.go:233-887
— the coordinator batches keys per key partition, sends each batch to
the partition's primary, and retries on ownership races). Row (field)
keys all live on one stable node, the partition-0 primary
(disco/snapshot.go:137). Locally owned partitions hit the holder's
stores directly, so a one-node cluster never pays an RPC.

Replication (reference: translate.go EntryReader + TranslationSyncer,
http_translator.go): every create on an owner pushes the new (key, id)
entries to the partition's replicas over /internal/translate/replicate.
A push that fails waits in an outbox and goes out ahead of the next
push to the same replica. A promoted replica serves (and extends, with
ids that do not conflict) the translation namespace without the dead
primary. Reads skip dead nodes, by the liveness signal the query
fan-out uses; creates go to the true primary only. With membership on
(``ClusterNode.enable_membership``) new entries also ride the gossip
plane (``gossip_publish``), and every gossip round drains the outbox
(``flush_outbox``).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.cluster.client import NodeDownError, RemoteError
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


class ClusterTranslator:
    def __init__(self, node_id: str, holder, client, snapshot_fn,
                 live_fn=None):
        self.node_id = node_id
        self.holder = holder
        self.client = client
        self._snapshot_fn = snapshot_fn  # () -> ClusterSnapshot
        self._live_fn = live_fn          # () -> set of live node ids
        # (node, index, field) -> entries a down replica hasn't seen yet.
        # Every pop/requeue holds _outbox_lock and requeues EXTEND rather
        # than overwrite: two concurrent creates whose sends both fail
        # used to race pop-then-assign and one batch's entries could
        # vanish — a promoted replica then re-allocated those ids to
        # different keys.
        self._outbox: Dict[tuple, List] = {}
        self._outbox_lock = locktrace.tracked_lock("cluster.translator.outbox")
        # gossip hook (ClusterNode.enable_membership): fn(index, field,
        # entries, batch_no) publishes new entries on the gossip plane, so
        # replicas a partition hides from us still converge through peers
        self.gossip_publish = None
        self._gossip_batch = 0

    def _first_live(self, owners, live=None):
        """READ failover: first live owner (reference: reads fail over
        the owner list, executor.go:6500). CREATES never fail over — new
        ids are allocated only on the true primary (owners[0]), exactly
        like the reference's createIndexKeys primary loops
        (cluster.go:233): a promoted replica allocating ids that the
        recovered primary never saw would hand one id to two keys.
        ``live`` lets bulk callers hoist the liveness scan."""
        if self._live_fn is None:
            return owners[0] if owners else None
        if live is None:
            live = set(self._live_fn())
        for n in owners:
            if n.id in live:
                return n
        return owners[0] if owners else None

    # -- local create + replica push ---------------------------------------

    def _store(self, index: str, field: Optional[str]):
        idx = self.holder.index(index)
        return idx.translate if field is None else idx.field(field).translate

    def create_local(self, index: str, field: Optional[str],
                     keys: List[str]) -> Dict[str, int]:
        """Create on this node (as owner) and stream the new entries to
        the replicas (reference: TranslationSyncer push)."""
        store = self._store(index, field)
        out, new = store.create_entries(keys)
        if new:
            self._push_entries(index, field, new)
        return out

    def apply_replicated(self, index: str, field: Optional[str],
                         entries: Iterable) -> None:
        self._store(index, field).apply_entries(entries)

    def _push_entries(self, index: str, field: Optional[str],
                      new: List) -> None:
        if self.gossip_publish is not None:
            with self._outbox_lock:
                self._gossip_batch += 1
                batch_no = self._gossip_batch
            try:
                self.gossip_publish(index, field,
                                    [[k, int(i)] for k, i in new], batch_no)
            except Exception:
                pass  # gossip is a second channel; the direct push runs
        snap = self._snapshot_fn()
        by_node: Dict[str, List] = {}
        nodes = {}
        if field is None:
            for k, id_ in new:
                for n in snap.key_nodes(index, k)[1:]:
                    nodes[n.id] = n
                    by_node.setdefault(n.id, []).append([k, id_])
        else:
            for n in snap.partition_nodes(0)[1:]:
                nodes[n.id] = n
                by_node[n.id] = [[k, id_] for k, id_ in new]
        for nid, entries in by_node.items():
            if nid == self.node_id:
                continue
            self._send_with_outbox(nodes[nid], index, field, entries)

    def _send_with_outbox(self, node, index: str, field: Optional[str],
                          entries: List) -> bool:
        """Send ``entries`` (plus any outbox backlog for this replica)
        to one replica; a failed send requeues by APPEND under the lock,
        so a concurrent create's requeue can never be overwritten."""
        key = (node.id, index, field)
        with self._outbox_lock:
            pending = self._outbox.pop(key, [])
        payload = pending + entries
        try:
            self.client.replicate_translate(node, index, field, payload)
            return True
        except (NodeDownError, RemoteError):
            with self._outbox_lock:
                # prepend: keep this batch ahead of entries queued while
                # the send was in flight (apply is idempotent either way,
                # but ordered replay keeps replica stores append-shaped)
                self._outbox.setdefault(key, [])[:0] = payload
            return False

    def flush_outbox(self) -> int:
        """Retry every queued replica push. The gossip round hooks call
        it, so a recovered replica drains within one round instead of
        waiting for the next create on the same (replica, index, field).
        Returns the entries drained."""
        with self._outbox_lock:
            keys = sorted(self._outbox.keys(),
                          key=lambda t: (t[0], t[1], t[2] or ""))
        if not keys:
            return 0
        nodes = {n.id: n for n in self._snapshot_fn().nodes}
        live = set(self._live_fn()) if self._live_fn is not None else None
        drained = 0
        for key in keys:
            nid, index, field = key
            node = nodes.get(nid)
            if node is None or (live is not None and nid not in live):
                continue  # keep queued until the replica is back
            with self._outbox_lock:
                payload = self._outbox.pop(key, None)
            if not payload:
                continue
            if self._send_with_outbox(node, index, field, payload):
                drained += len(payload)
        return drained

    def outbox_depth(self) -> int:
        with self._outbox_lock:
            return sum(len(v) for v in self._outbox.values())

    # -- index (record) keys ----------------------------------------------

    def _group_keys_by_node(self, snap, index: str, keys: Iterable[str],
                            create: bool):
        by_node: Dict[str, List[str]] = {}
        nodes = {}
        live = set(self._live_fn()) if self._live_fn is not None else None
        for k in keys:
            owners = snap.key_nodes(index, k)
            # creates pin to the true primary; reads fail over
            owner = owners[0] if create else self._first_live(owners, live)
            nodes[owner.id] = owner
            by_node.setdefault(owner.id, []).append(k)
        return by_node, nodes

    def index_keys(self, index: str, keys: List[str],
                   create: bool) -> Dict[str, int]:
        snap = self._snapshot_fn()
        by_node, nodes = self._group_keys_by_node(snap, index, keys, create)
        out: Dict[str, int] = {}
        for node_id, batch in by_node.items():
            if node_id == self.node_id:
                if create:
                    out.update(self.create_local(index, None, batch))
                else:
                    out.update(self._store(index, None).find_keys(batch))
            elif create:
                out.update(self.client.create_index_keys(
                    nodes[node_id], index, batch))
            else:
                out.update(self.client.find_index_keys(
                    nodes[node_id], index, batch))
        return out

    def index_ids(self, index: str, ids: Iterable[int]) -> Dict[int, str]:
        """ID->key: an ID's shard hashes to the partition that owns the
        key (translate.go:103 invariant), so route by shard."""
        snap = self._snapshot_fn()
        by_node: Dict[str, List[int]] = {}
        nodes = {}
        live = set(self._live_fn()) if self._live_fn is not None else None
        for i in ids:
            p = snap.shard_to_partition(index, i // SHARD_WIDTH)
            owner = self._first_live(snap.partition_nodes(p), live)
            nodes[owner.id] = owner
            by_node.setdefault(owner.id, []).append(i)
        out: Dict[int, str] = {}
        for node_id, batch in by_node.items():
            if node_id == self.node_id:
                out.update(self.holder.index(index).translate.translate_ids(batch))
            else:
                out.update(self.client.translate_index_ids(
                    nodes[node_id], index, batch))
        return out

    # -- field (row) keys --------------------------------------------------

    def _field_primary(self):
        snap = self._snapshot_fn()
        return self._first_live(snap.partition_nodes(0))

    def field_keys(self, index: str, field: str, keys: List[str],
                   create: bool) -> Dict[str, int]:
        if create:
            # creates pin to the true primary (no promotion — see
            # _first_live); fail loudly if it is down
            owners = self._snapshot_fn().partition_nodes(0)
            primary = owners[0] if owners else None
        else:
            primary = self._field_primary()
        if primary is None or primary.id == self.node_id:
            if create:
                return self.create_local(index, field, keys)
            return self._store(index, field).find_keys(keys)
        if create:
            return self.client.create_field_keys(primary, index, field, keys)
        return self.client.find_field_keys(primary, index, field, keys)

    def field_ids(self, index: str, field: str,
                  ids: Iterable[int]) -> Dict[int, str]:
        primary = self._field_primary()
        ids = list(ids)
        if primary is None or primary.id == self.node_id:
            return self.holder.index(index).field(field).translate.translate_ids(ids)
        return self.client.translate_field_ids(primary, index, field, ids)
