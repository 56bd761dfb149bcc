"""DisCo — distributed consensus facade: membership + shared schema.

Port of ``pilosa_tpu/cluster/disco.py`` (reference: disco/disco.go:35,
the DisCo interface; :92 Schemator; the production implementation on
embedded etcd, etcd/embed.go:190, and the in-memory fakes of
disco/disco.go:161-281). ``StaticDisCo`` (a peer list from the config,
liveness probed over HTTP) and ``LeaseDisCo`` (TTL leases over a shared
directory) cover several hosts; ``InMemDisCo`` backs the in-process
harness, the analog of the reference's test.MustRunCluster
(test/cluster.go:748). ``GossipDisCo`` comes with the gossip plane.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.cluster.topology import (
    Node, ClusterSnapshot, STATE_NORMAL,
)


class DisCo:
    """Membership + schema-broadcast interface."""

    def nodes(self) -> List[Node]:
        raise NotImplementedError

    def live_ids(self) -> List[str]:
        raise NotImplementedError

    def snapshot(self, replica_n: int = 1) -> ClusterSnapshot:
        return ClusterSnapshot(self.nodes(), replica_n=replica_n)

    def cluster_state(self, replica_n: int = 1) -> str:
        return self.snapshot(replica_n).cluster_state(self.live_ids())

    # Transport-level liveness hints from the executor/resilience layer
    # (connection refused / breaker closed again). No-ops by default so
    # every implementation exposes the surface; backends with real state
    # (InMemDisCo, StaticDisCo, LeaseDisCo) override.

    def mark_down(self, node_id: str) -> None:
        pass

    def mark_up(self, node_id: str) -> None:
        pass


class InMemDisCo(DisCo):
    """Shared-memory membership for in-process clusters (reference:
    disco.NewInMemDisCo, disco/disco.go:161). One instance is shared by
    every node in the process; ``down()``/``up()`` simulate failures the
    way clustertests pause containers."""

    def __init__(self):
        self._lock = locktrace.tracked_lock("cluster.disco.inmem")
        self._nodes: Dict[str, Node] = {}
        self._live: Dict[str, bool] = {}

    def register(self, node: Node) -> None:
        with self._lock:
            self._nodes[node.id] = node
            self._live[node.id] = True

    def unregister(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)
            self._live.pop(node_id, None)

    def down(self, node_id: str) -> None:
        with self._lock:
            self._live[node_id] = False

    def up(self, node_id: str) -> None:
        with self._lock:
            self._live[node_id] = True

    def nodes(self) -> List[Node]:
        with self._lock:
            return sorted(self._nodes.values(), key=lambda n: n.id)

    def live_ids(self) -> List[str]:
        with self._lock:
            return [i for i, ok in self._live.items() if ok]

    def is_live(self, node_id: str) -> bool:
        with self._lock:
            return self._live.get(node_id, False)

    # the executor/resilience hints use the mark_* spelling
    mark_down = down
    mark_up = up


class StaticDisCo(DisCo):
    """Config-listed peers with cached HTTP liveness probes — the
    multi-host mode when no consensus service is wanted. Liveness is
    learned lazily: a probe function (typically InternalClient.status)
    is consulted at most every ``probe_interval`` seconds per node, and
    the executor also marks nodes down on connection errors (the same
    signal the reference uses, executor.go:6500)."""

    def __init__(self, nodes: List[Node],
                 probe: Optional[Callable[[Node], bool]] = None,
                 probe_interval: float = 5.0):
        self._nodes = sorted(nodes, key=lambda n: n.id)
        self._probe = probe
        self._interval = probe_interval
        self._lock = locktrace.tracked_lock("cluster.disco.static")
        self._state: Dict[str, bool] = {n.id: True for n in self._nodes}
        self._checked: Dict[str, float] = {}

    def nodes(self) -> List[Node]:
        return list(self._nodes)

    def live_ids(self) -> List[str]:
        now = time.monotonic()
        out = []
        for n in self._nodes:
            with self._lock:
                last = self._checked.get(n.id, 0.0)
                live = self._state.get(n.id, True)
            if self._probe is not None and now - last > self._interval:
                live = bool(self._probe(n))
                with self._lock:
                    self._state[n.id] = live
                    self._checked[n.id] = now
            if live:
                out.append(n.id)
        return out

    def mark_down(self, node_id: str) -> None:
        with self._lock:
            self._state[node_id] = False
            self._checked[node_id] = time.monotonic()

    def mark_up(self, node_id: str) -> None:
        with self._lock:
            self._state[node_id] = True
            self._checked[node_id] = time.monotonic()


class LeaseDisCo(DisCo):
    """Consensus-backed membership over a shared directory: TTL leases +
    member registry, the minimal analog of the reference's embedded-etcd
    heartbeats (etcd/embed.go:458 startHeartbeatAndWatcher, lease TTL
    keepalive) with cluster state derived exactly like disco/disco.go:53
    (via ClusterSnapshot.cluster_state).

    Layout under ``root`` (a shared filesystem in multi-host deployments,
    the same substrate the DAX writelogger/snapshotter use):

        members/<id>.json   — {"id", "uri"}; written atomically on join,
                              removed on leave() — the etcd member registry
        leases/<id>         — heartbeat file, rewritten every
                              ``heartbeat_interval`` with the holder's
                              wall-clock; a node is live iff its lease
                              timestamp is within ``ttl`` seconds

    Joining nodes appear to every peer on its next nodes() read and
    leaving/expired nodes disappear — dynamic membership without restart,
    unlike StaticDisCo's fixed list. Atomicity is per-file
    (tmp + os.replace); there is no multi-key transaction, which matches
    what membership needs (each node only writes its own two files).
    Timestamps compare across hosts, so shared-FS deployments need NTP at
    ttl/2 accuracy — the same assumption etcd's lease TTLs make of its
    own server clock.
    """

    def __init__(self, root: str, ttl: float = 10.0,
                 heartbeat_interval: Optional[float] = None,
                 clock: Callable[[], float] = time.time):
        import os

        self.root = root
        self.ttl = ttl
        self.heartbeat_interval = heartbeat_interval or max(0.5, ttl / 3)
        self._clock = clock
        self._os = os
        self._members_dir = os.path.join(root, "members")
        self._leases_dir = os.path.join(root, "leases")
        os.makedirs(self._members_dir, exist_ok=True)
        os.makedirs(self._leases_dir, exist_ok=True)
        self._self_id: Optional[str] = None
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        # executor-observed failures (connection refused) force a node
        # dead until its NEXT heartbeat, like the reference's down-node
        # confirmation loop (cluster.go:23)
        self._forced_down: Dict[str, float] = {}
        self._lock = locktrace.tracked_lock("cluster.disco.lease")

    # -- join / leave / heartbeat -----------------------------------------

    def _write_atomic(self, path: str, data: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(data)
        self._os.replace(tmp, path)

    def register(self, node: Node) -> None:
        """Join: publish the member record, take the lease, start the
        keepalive thread (reference: etcd member add + lease grant)."""
        import json

        self._self_id = node.id
        self._write_atomic(
            self._os.path.join(self._members_dir, f"{node.id}.json"),
            json.dumps({"id": node.id, "uri": node.uri}))
        self.heartbeat()
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return  # re-register (e.g. uri update): keepalive already runs
        self._hb_stop.clear()
        self._hb_thread = threading.Thread(
            target=self._keepalive, name=f"lease-hb-{node.id}", daemon=True)
        self._hb_thread.start()

    def leave(self) -> None:
        """Graceful departure: stop the keepalive, drop lease + member
        record so peers see the change immediately (etcd member remove)."""
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
            self._hb_thread = None
        if self._self_id:
            for p in (self._os.path.join(self._leases_dir, self._self_id),
                      self._os.path.join(self._members_dir,
                                         f"{self._self_id}.json")):
                try:
                    self._os.remove(p)
                except FileNotFoundError:
                    pass

    def suspend(self) -> None:
        """Simulate a crash (tests/harness): stop the keepalive and drop
        the lease so peers see the node dead immediately; the member
        record stays (lease expired != member removed). register()
        resumes."""
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
            self._hb_thread = None
        if self._self_id:
            try:
                self._os.remove(
                    self._os.path.join(self._leases_dir, self._self_id))
            except FileNotFoundError:
                pass

    def heartbeat(self) -> None:
        if self._self_id:
            self._write_atomic(
                self._os.path.join(self._leases_dir, self._self_id),
                repr(self._clock()))

    def _keepalive(self) -> None:
        while not self._hb_stop.wait(self.heartbeat_interval):
            try:
                self.heartbeat()
            except OSError:
                pass  # shared FS hiccup: retry next tick; lease expires
                # naturally if it persists

    # -- membership reads ---------------------------------------------------

    def nodes(self) -> List[Node]:
        import json

        out = []
        for name in sorted(self._os.listdir(self._members_dir)):
            if not name.endswith(".json"):
                continue
            try:
                with open(self._os.path.join(self._members_dir, name)) as f:
                    d = json.load(f)
                out.append(Node(id=d["id"], uri=d.get("uri", "")))
            except (OSError, ValueError, KeyError):
                continue  # torn write of a concurrent join: next read
        return out

    def _lease_time(self, node_id: str) -> float:
        try:
            with open(self._os.path.join(self._leases_dir, node_id)) as f:
                return float(f.read().strip() or 0.0)
        except (OSError, ValueError):
            return 0.0

    def live_ids(self) -> List[str]:
        now = self._clock()
        out = []
        with self._lock:
            forced = dict(self._forced_down)
        for n in self.nodes():
            t = self._lease_time(n.id)
            if now - t > self.ttl:
                continue  # lease expired
            if n.id in forced and t <= forced[n.id]:
                continue  # transport said dead; needs a FRESH heartbeat
            out.append(n.id)
        return out

    def is_live(self, node_id: str) -> bool:
        return node_id in self.live_ids()

    # -- executor failure signals ------------------------------------------

    def mark_down(self, node_id: str) -> None:
        """Transport-level failure: disbelieve the current lease until
        the node heartbeats again (a live-but-unreachable peer should not
        keep receiving fan-out)."""
        with self._lock:
            self._forced_down[node_id] = self._lease_time(node_id)

    def mark_up(self, node_id: str) -> None:
        with self._lock:
            self._forced_down.pop(node_id, None)


class SingleNodeDisCo(DisCo):
    """The degenerate one-node cluster (default for embedded use)."""

    def __init__(self, node: Optional[Node] = None):
        self._node = node or Node(id="local", uri="")

    def nodes(self) -> List[Node]:
        return [self._node]

    def live_ids(self) -> List[str]:
        return [self._node.id]

    def cluster_state(self, replica_n: int = 1) -> str:
        return STATE_NORMAL
