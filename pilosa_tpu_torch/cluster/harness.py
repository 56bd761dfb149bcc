"""In-process multi-node cluster harness.

Port of ``pilosa_tpu/cluster/harness.py`` (reference: test/cluster.go:748
MustRunCluster — N real servers in one process on ephemeral ports,
sharing an in-memory membership fake, disco.NewInMemDisCo). Traffic
between the nodes goes over real HTTP loopback sockets, so the whole
RPC, broadcast and translation path runs. ``pause`` / ``unpause`` mirror
the cluster tests' container pause
(internal/clustertests/pause_node_test.go).

Every node runs its engine on ``device``: ``cuda:0`` unless the caller
asks for the CPU, so the nodes of one process share one card (and one
``DeviceBudget``). A ``FaultPlan`` injects seeded faults into every
node's client, ``client_factory`` builds each node's client, and
``cluster_batch`` attaches the leg coalescer on every node. The gossip,
membership, tenant and degradation helpers come with their planes.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

from pilosa_tpu_torch import platform
from pilosa_tpu_torch.cluster.client import InternalClient
from pilosa_tpu_torch.cluster.disco import InMemDisCo
from pilosa_tpu_torch.cluster.node import ClusterNode
from pilosa_tpu_torch.server.http import serve


class LocalCluster:
    def __init__(self, n: int, replica_n: int = 1,
                 base_path: Optional[str] = None, disco_factory=None,
                 fault_plan=None, client_factory=None,
                 cluster_batch: Optional[dict] = None,
                 device: platform.DeviceLike = None):
        """``disco_factory()`` builds one DisCo per node (e.g. LeaseDisCo
        instances over a shared root — each node holds its own lease);
        the default is one InMemDisCo shared by every node.

        ``fault_plan`` (cluster/resilience.FaultPlan) injects seeded
        drops, delays and flaps into every node's client.
        ``client_factory(i)`` builds node i's client instead (it sees the
        plan only if it wires one itself). ``cluster_batch`` attaches the
        remote-leg coalescer on every node with the given NodeBatcher
        keyword arguments ({} for the defaults), as
        PILOSA_TPU_CLUSTER_BATCH=1 does."""
        device = platform.resolve_device(device)
        self.disco = InMemDisCo() if disco_factory is None else None
        self.fault_plan = fault_plan
        self.nodes: List[ClusterNode] = []
        self._servers = []
        try:
            for i in range(n):
                path = os.path.join(base_path, f"node{i}") \
                    if base_path else None
                if path:
                    os.makedirs(path, exist_ok=True)
                disco = self.disco if disco_factory is None \
                    else disco_factory()
                if client_factory is not None:
                    client = client_factory(i)
                elif fault_plan is not None:
                    client = InternalClient(fault_plan=fault_plan)
                else:
                    client = None
                node = ClusterNode(f"node{i}", "", disco, path=path,
                                   replica_n=replica_n, client=client,
                                   device=device)
                self.nodes.append(node)
                if cluster_batch is not None and node.batcher is None:
                    node.enable_cluster_batch(**cluster_batch)
                srv, _ = serve(node, port=0, background=True)
                self._servers.append(srv)
                host, port = srv.server_address[:2]
                node.node.uri = f"http://{host}:{port}"
                if disco_factory is not None and hasattr(disco, "register"):
                    disco.register(node.node)  # re-publish with the uri
        except BaseException:
            self.close()
            raise

    def __getitem__(self, i: int) -> ClusterNode:
        return self.nodes[i]

    def __len__(self) -> int:
        return len(self.nodes)

    @property
    def coordinator(self) -> ClusterNode:
        return self.nodes[0]

    def pause(self, i: int) -> None:
        """Make node i unreachable (keeps its data, like SIGSTOP on a
        container). The listener closes so peers get connection-refused
        rather than hangs."""
        self._servers[i].shutdown()
        self._servers[i].server_close()
        # closing the listener refuses NEW connections, but peers'
        # keep-alive pools still hold live sockets the paused server's
        # handler threads keep serving — evict them so the node is
        # really unreachable
        for node in self.nodes:
            evict = getattr(node.client, "evict_node", None)
            if evict is not None:  # a client_factory's double may lack it
                evict(f"node{i}")
        if self.disco is not None:
            self.disco.down(f"node{i}")
        else:  # per-node disco (LeaseDisCo): stop heartbeating
            d = self.nodes[i].disco
            if hasattr(d, "suspend"):
                d.suspend()

    def unpause(self, i: int) -> None:
        node = self.nodes[i]
        srv, _ = serve(node, port=0, background=True)
        host, port = srv.server_address[:2]
        node.node.uri = f"http://{host}:{port}"
        self._servers[i] = srv
        if self.disco is not None:
            self.disco.up(f"node{i}")
        elif hasattr(node.disco, "register"):
            node.disco.register(node.node)  # resume lease + publish uri

    def __enter__(self) -> "LocalCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        # each shutdown waits out its server's poll interval: wait for
        # them all at once, not one after another
        stops = [threading.Thread(target=srv.shutdown, daemon=True)
                 for srv in self._servers]
        for t in stops:
            t.start()
        for t in stops:
            t.join()
        for srv in self._servers:
            try:
                srv.server_close()
            except Exception:
                pass
        for node in self.nodes:
            node.disable_scheduler()
            close = getattr(node.client, "close", None)
            if close is not None:
                close()
            # stop per-node lease heartbeat threads (LeaseDisCo) so a
            # closed cluster leaves no writers behind
            leave = getattr(node.disco, "leave", None)
            if leave is not None:
                try:
                    leave()
                except Exception:
                    pass
