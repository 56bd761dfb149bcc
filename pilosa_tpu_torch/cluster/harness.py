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
``cluster_batch`` attaches the leg coalescer on every node.
``enable_gossip``, ``enable_membership``, ``enable_health``,
``enable_tenants`` and ``enable_degrade`` attach those planes on every
node, and ``run_gossip_rounds`` / ``run_membership_ticks`` drive them by
hand.
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

    def enable_gossip(self, **kw) -> list:
        """Enable gossip on every node (gossip/agent.py keyword
        arguments pass through). Returns the agents in node order. Tests
        usually keep ``start=False`` (the default) and drive rounds by
        hand."""
        return [node.enable_gossip(**kw) for node in self.nodes]

    def enable_health(self, **kw) -> list:
        """Enable the health plane on every node
        (ClusterNode.enable_health keyword arguments pass through; tests
        usually share one ManualClock through ``clock=``). Returns the
        planes in node order."""
        return [node.enable_health(**kw) for node in self.nodes]

    def enable_tenants(self, **kw) -> list:
        """Enable the tenant attribution plane on every node
        (ClusterNode.enable_tenants keyword arguments pass through; tests
        usually share one ManualClock through ``clock=``). Returns the
        registries in node order."""
        return [node.enable_tenants(**kw) for node in self.nodes]

    def enable_degrade(self, **kw) -> list:
        """Enable the graceful-degradation ladder on every node
        (ClusterNode.enable_degrade keyword arguments pass through).
        Returns the controllers in node order."""
        return [node.enable_degrade(**kw) for node in self.nodes]

    def enable_membership(self, **kw) -> list:
        """Enable SWIM membership on every node
        (ClusterNode.enable_membership keyword arguments pass through;
        gossip is enabled first where it is off). Tests usually share one
        ManualClock through ``clock=`` and drive protocol rounds with
        run_gossip_rounds (the tick rides the round hooks) or
        run_membership_ticks. Returns the Membership objects."""
        return [node.enable_membership(**kw) for node in self.nodes]

    def run_membership_ticks(self, rounds: int = 1) -> list:
        """Drive ``rounds`` protocol ticks on every node WITHOUT an
        anti-entropy exchange (probe, suspect, confirm only; use
        run_gossip_rounds for ticks and dissemination). Returns the last
        round's tick results in node order."""
        out = []
        for _ in range(rounds):
            out = [node.membership.tick() for node in self.nodes
                   if node.membership is not None]
        return out

    def run_gossip_rounds(self, rounds: int = 1) -> int:
        """Drive ``rounds`` synchronous anti-entropy rounds across every
        node (round-robin, in node order), the deterministic stand-in
        for the background threads. Returns the entries applied."""
        applied = 0
        for _ in range(rounds):
            for node in self.nodes:
                agent = node.gossip
                if agent is not None:
                    applied += agent.run_round()
        return applied

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
        for node in self.nodes:
            try:
                node.disable_gossip()  # stops the round threads first
            except Exception:
                pass
        # uninstall in reverse enable order: each registry's process-wide
        # WAL and fold hooks restore the previous link in the chain
        for node in reversed(self.nodes):
            try:
                if node.tenants is not None:
                    node.disable_tenants()
            except Exception:
                pass
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
