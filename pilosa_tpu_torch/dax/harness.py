"""In-process DAX cluster for tests (reference: dax/test/dax.go).

Boots a Controller, N HTTP-served Computers, and a Queryer sharing one
filesystem directory. Kill a computer with :meth:`kill` — the poller (or
the next failed push) reassigns its shards and the new owners rebuild
from the shared writelog/snapshots.

Optional planes, each off by default (the plain harness stays the seed's
shape):

- ``membership=True`` runs a controller-side SWIM view over the
  computers (gossip/membership.py) — :meth:`step` ticks it, and
  ``controller.poll()`` then buries exactly the members the protocol
  confirmed down (a silenced node is detected by failed probes, not by
  a wall-clock checkin sweep);
- ``serving=True`` routes queryer reads through scheduler admission and
  a directive-versioned result cache;
- ``autoscale=True`` attaches an Autoscaler whose up/down callbacks are
  :meth:`scale_up` / :meth:`scale_down` (spawn + rebalance / retire).

Port of ``pilosa_tpu/dax/harness.py``. ``device`` (``cuda:0`` unless the
caller asks for the CPU) goes to every ``Computer`` — those that
:meth:`spawn` and :meth:`scale_up` add, and the fresh ``API`` a RESET
builds — and to the ``Queryer``, so the whole fleet shares one card.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional

from pilosa_tpu_torch import platform
from pilosa_tpu_torch.cluster.client import InternalClient
from pilosa_tpu_torch.cluster.topology import Node
from pilosa_tpu_torch.dax.computer import Computer
from pilosa_tpu_torch.dax.controller import Controller
from pilosa_tpu_torch.dax.queryer import Queryer
from pilosa_tpu_torch.dax.storage import DEFAULT_SEGMENT_BYTES
from pilosa_tpu_torch.server.http import serve


class DaxCluster:
    def __init__(self, n: int, shared_dir: Optional[str] = None,
                 dead_after_s: float = 5.0, snapshot_every: int = 256,
                 http: bool = True, *, membership: bool = False,
                 serving: bool = False, autoscale: bool = False,
                 warm_handoff: bool = True, sync: str = "batch",
                 clock=None, crash_plan=None, fault_plan=None,
                 autoscale_kw: Optional[dict] = None, device=None,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 directive_retries: int = 2,
                 directive_backoff_s: float = 0.05):
        self.device = platform.resolve_device(device)
        self.dir = shared_dir or tempfile.mkdtemp(prefix="dax_")
        os.makedirs(self.dir, exist_ok=True)
        self.http = http
        self.sync = sync
        self.segment_bytes = segment_bytes
        self.clock = clock
        self.snapshot_every = snapshot_every
        self.warm_handoff = warm_handoff
        self.crash_plan = crash_plan
        client = None
        if fault_plan is not None:
            client = InternalClient(fault_plan=fault_plan)
        self.controller = Controller(
            self.dir, client=client, dead_after_s=dead_after_s,
            clock=clock, directive_retries=directive_retries,
            directive_backoff_s=directive_backoff_s,
            # a manual clock means a deterministic test — retry backoff
            # must not really sleep
            sleep=(lambda s: None) if clock is not None else None)
        self.computers: List[Computer] = []
        self._servers = []
        self._next_id = 0
        self.membership = None
        if membership:
            from pilosa_tpu_torch.core.holder import Holder
            from pilosa_tpu_torch.gossip.agent import GossipAgent
            from pilosa_tpu_torch.gossip.membership import Membership

            peers_fn = self.controller.live_nodes
            agent = GossipAgent("dax-controller", self.controller.client,
                                peers_fn, Holder(self.device), seed=7,
                                clock=clock)
            self.membership = Membership(
                "dax-controller", agent, self.controller.client, peers_fn,
                ping_timeout_ms=100.0, seed=7, clock=clock)
            self.controller.attach_membership(self.membership)
        for _ in range(n):
            self.spawn()
        self.queryer = Queryer(self.controller, device=self.device)
        if serving:
            self.queryer.enable_serving(window_ms=0.2)
        self.autoscaler = None
        if autoscale:
            from pilosa_tpu_torch.dax.autoscale import Autoscaler

            self.autoscaler = Autoscaler(
                probes_fn=self.queryer.probe,
                scale_up=self.scale_up,
                scale_down=self.scale_down,
                pool_size=lambda: len(self.controller.live_ids()),
                clock=clock, **(autoscale_kw or {}))

    @classmethod
    def from_config(cls, n: int, config=None, **overrides) -> "DaxCluster":
        """A fleet of ``n`` computers with the ``[dax]`` section's
        settings (``Config()``'s when ``config`` is None): the writelog's
        segment size and fsync mode, the snapshot cadence, the checkin
        deadline, the directive retries and backoff, the warm handoff,
        and the autoscaler's bounds and triggers (used when
        ``autoscale=True``). Keyword ``overrides`` win; an
        ``autoscale_kw`` override merges over the section's bounds."""
        from pilosa_tpu_torch.config import Config

        cfg = config or Config()
        scale = dict(min_nodes=cfg.dax_autoscale_min,
                     max_nodes=cfg.dax_autoscale_max,
                     cooldown_s=cfg.dax_autoscale_cooldown_s,
                     queue_high=cfg.dax_autoscale_queue_high,
                     p99_high_ms=cfg.dax_autoscale_p99_high_ms)
        scale.update(overrides.pop("autoscale_kw", None) or {})
        kw = dict(dead_after_s=cfg.dax_dead_after_s,
                  snapshot_every=cfg.dax_snapshot_every,
                  sync=cfg.dax_sync, warm_handoff=cfg.dax_warm_handoff,
                  segment_bytes=cfg.dax_segment_bytes,
                  directive_retries=cfg.dax_directive_retries,
                  directive_backoff_s=cfg.dax_directive_backoff_ms / 1e3)
        kw.update(overrides)
        return cls(n, autoscale_kw=scale, **kw)

    # -- elasticity --------------------------------------------------------

    def spawn(self) -> Computer:
        """Add one Computer to the pool (register only — call
        :meth:`scale_up` to also move shards onto it)."""
        i = self._next_id
        self._next_id += 1
        comp = Computer(f"compute{i}", self.dir,
                        snapshot_every=self.snapshot_every,
                        sync=self.sync, warm_handoff=self.warm_handoff,
                        crash_plan=self.crash_plan, clock=self.clock,
                        device=self.device,
                        segment_bytes=self.segment_bytes)
        if self.http:
            srv, _ = serve(comp, port=0, background=True)
            host, port = srv.server_address[:2]
            comp.node = Node(id=comp.node.id,
                             uri=f"http://{host}:{port}")
            self._servers.append(srv)
        else:
            self._servers.append(None)
        self.computers.append(comp)
        # register with the in-process object so directive delivery
        # works even without HTTP; queries go over HTTP regardless
        self.controller.register(comp.node, computer=comp)
        return comp

    def scale_up(self) -> int:
        """Spawn a node and rebalance ~1/n of the shards onto it (the
        warm handoff happens inside directive application: the new
        owner replays + prewarms before acking)."""
        self.spawn()
        self.controller.rebalance()
        return len(self.controller.live_ids())

    def scale_down(self) -> int:
        """Retire the newest live computer — kill semantics: its shards
        reassign from shared storage (any computer is disposable)."""
        for i in range(len(self.computers) - 1, -1, -1):
            nid = self.computers[i].node.id
            if nid in self.controller.live_ids():
                self.kill(i)
                break
        return len(self.controller.live_ids())

    def step(self) -> None:
        """One control-plane beat: a membership protocol tick (when
        enabled) then the liveness sweep, then an autoscaler decision
        (when enabled)."""
        if self.membership is not None:
            self.membership.tick()
        self.controller.poll()
        if self.autoscaler is not None:
            self.autoscaler.tick()

    # -- chaos -------------------------------------------------------------

    def _sever(self, i: int) -> None:
        """Close the node's listener AND evict the shared client's
        pooled keep-alive sockets to it. Without the eviction a
        \"dead\" node keeps serving established connections (shutdown
        only closes the *listening* socket; handler threads live on),
        so legs to it would quietly keep succeeding and the chaos would
        exercise nothing — the next fresh connect is what delivers the
        real ECONNREFUSED a crashed process gives its peers."""
        srv = self._servers[i]
        if srv is not None:
            srv.shutdown()
            srv.server_close()
            self._servers[i] = None
        node = self.computers[i].node
        self.controller._local.pop(node.id, None)
        self.controller.client.evict_node(node.id)
        if "://" in node.uri:  # legs pooled under netloc when id absent
            self.controller.client.pool.evict(node.uri.split("://", 1)[1])

    def kill(self, i: int) -> None:
        """SIGKILL analog: sever the node AND mark dead (the poller
        path is exercised separately via controller.poll)."""
        self._sever(i)
        self.controller.mark_dead(self.computers[i].node.id)

    def silence(self, i: int) -> None:
        """Stop serving WITHOUT telling the controller — death must be
        detected by the poller (missed checkins) or the membership
        protocol (failed probes → suspect → confirm)."""
        self._sever(i)

    def close(self) -> None:
        for srv in self._servers:
            if srv is not None:
                srv.shutdown()
                srv.server_close()
        self.queryer.close()
        for comp in self.computers:
            comp.close()
        self.controller.wl.close()
