"""Gossip agent: the dissemination half of the cluster-metadata plane.

Port of ``pilosa_tpu/gossip/agent.py``: the same envelopes, rounds and
seeded peer choice.

Two channels, both carrying the same envelope shape
``{"from": node_id, "digest": {origin: max_seq}, "deltas": [...]}``:

- **Piggyback** — InternalClient attaches an envelope to every query /
  import / broadcast request it sends and applies the envelope the
  server puts on the response, so active clusters converge at RPC
  speed with zero extra round-trips (SWIM's "infection on existing
  traffic" idea).
- **Anti-entropy rounds** — a periodic push/pull exchange with
  ``fanout`` seeded-randomly chosen peers over
  ``/internal/gossip/exchange``, so idle clusters (and nodes that
  missed piggybacks) still converge in O(log n) rounds.

The agent remembers the last digest each peer SENT it
(``_peer_digest``) and ships only entries above that watermark —
delta encoding without acks: a peer's digest reflects what it holds,
so underestimating (stale watermark, dropped response) only causes an
idempotent resend, never a gap.

Determinism: peer choice comes from ``random.Random(f"{seed}:{node_id}")``
(seed from config / ``PILOSA_TPU_GOSSIP_SEED``, same convention as
FaultPlan's fault seed) and the clock is injectable (ManualClock in
tests), so a fixed seed reproduces the exact exchange sequence.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Callable, Dict, List, Optional

from pilosa_tpu_torch.obs import metrics as M
from pilosa_tpu_torch.sched.clock import MonotonicClock
from pilosa_tpu_torch.gossip.state import GossipState


def _env_seed() -> int:
    try:
        return int(os.environ.get("PILOSA_TPU_GOSSIP_SEED", "0"))
    except ValueError:
        return 0


class GossipAgent:
    """One per node. ``peers_fn()`` returns the current peer Node list
    (self excluded); ``holder`` is the node's data holder for the
    version-vector scan."""

    def __init__(self, node_id: str, client, peers_fn, holder, *,
                 interval_ms: float = 100.0, fanout: int = 1,
                 seed: Optional[int] = None, max_deltas: int = 512,
                 piggyback: bool = True, clock=None, registry=None):
        self.node_id = node_id
        self.client = client
        self.peers_fn = peers_fn
        self.holder = holder
        self.interval_ms = float(interval_ms)
        self.fanout = max(1, int(fanout))
        self.seed = _env_seed() if seed is None else int(seed)
        self.max_deltas = int(max_deltas)
        self.piggyback = bool(piggyback)
        self.clock = clock if clock is not None else MonotonicClock()
        self.registry = registry if registry is not None else M.REGISTRY
        self.state = GossipState(node_id, clock=self.clock,
                                 registry=self.registry)
        # seed:node_id so every node in a seeded cluster draws a distinct
        # but reproducible peer sequence (FaultPlan's _hit_rng convention)
        self._rng = random.Random(f"{self.seed}:{node_id}")
        # called once per anti-entropy round, before the exchange — the
        # membership tick and translate-outbox flush ride here so cluster
        # liveness and replication drain at gossip cadence with no extra
        # threads (ClusterNode.enable_membership registers them)
        self.round_hooks: List[Callable[[], None]] = []
        self._peer_digest: Dict[str, Dict[str, int]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- envelopes ---------------------------------------------------------

    def envelope(self, peer_id: Optional[str] = None) -> dict:
        """Build the wire envelope for ``peer_id`` — deltas above the
        digest that peer last sent us (everything, for an unknown peer)."""
        with self._lock:
            known = dict(self._peer_digest.get(peer_id, {})) if peer_id else {}
        deltas = self.state.deltas_since(known, self.max_deltas)
        if deltas:
            self.registry.count(M.METRIC_GOSSIP_DELTAS_SENT, len(deltas))
        return {"from": self.node_id, "digest": self.state.digest(),
                "deltas": deltas}

    def receive(self, env) -> int:
        """Apply a peer's envelope: remember its digest (what it holds),
        merge its deltas. Returns entries applied."""
        if not isinstance(env, dict):
            return 0
        peer = env.get("from")
        if peer and peer != self.node_id:
            with self._lock:
                self._peer_digest[peer] = dict(env.get("digest") or {})
        applied = self.state.apply(env.get("deltas") or [])
        if applied:
            self.registry.count(M.METRIC_GOSSIP_DELTAS_APPLIED, applied)
        return applied

    # -- local-state delegates --------------------------------------------

    def refresh_index(self, name: str) -> None:
        idx = self.holder.indexes.get(name)
        if idx is not None:
            self.state.refresh_index(idx)

    def refresh_local(self) -> None:
        for name in sorted(list(self.holder.indexes)):
            self.refresh_index(name)

    def record_breaker(self, target: str, state: str) -> None:
        self.state.record_breaker(target, state)

    def remote_fingerprint(self, index: str, shards):
        return self.state.remote_fingerprint(index, shards)

    # -- anti-entropy rounds ----------------------------------------------

    def run_round(self) -> int:
        """One synchronous push/pull round: refresh local versions, pick
        ``fanout`` seeded-random peers, exchange envelopes. Returns
        entries applied from responses. Safe to call directly in tests
        (no thread needed)."""
        t0 = self.clock.now()
        self.refresh_local()
        self.state.record_health()
        for hook in list(self.round_hooks):
            try:
                hook()
            except Exception:
                pass  # hooks are best-effort; the round must still run
        peers = sorted((p for p in self.peers_fn()
                        if p.id != self.node_id), key=lambda p: p.id)
        if not peers:
            self.registry.count(M.METRIC_GOSSIP_ROUNDS, outcome="idle")
            return 0
        picks = (peers if len(peers) <= self.fanout
                 else self._rng.sample(peers, self.fanout))
        applied = 0
        errs = 0
        for peer in picks:
            try:
                out = self.client.gossip_exchange(
                    peer, {"gossip": self.envelope(peer.id)})
            except Exception:
                errs += 1
                continue
            env = (out or {}).get("gossip")
            if isinstance(env, dict):
                applied += self.receive(env)
        self.registry.observe_bucketed(
            M.METRIC_GOSSIP_ROUND_MS, (self.clock.now() - t0) * 1e3,
            M.GOSSIP_ROUND_BUCKETS_MS)
        self.registry.count(M.METRIC_GOSSIP_ROUNDS,
                            outcome="err" if errs else "ok")
        return applied

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_ms / 1e3):
                try:
                    self.run_round()
                except Exception:
                    pass  # background best-effort; next round retries

        self._thread = threading.Thread(
            target=loop, name=f"gossip-{self.node_id}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=5.0)
        self._thread = None

    # -- introspection -----------------------------------------------------

    def state_json(self) -> dict:
        with self._lock:
            peer_digest = {p: dict(d) for p, d in
                           sorted(self._peer_digest.items())}
        return {
            "node": self.node_id,
            "seed": self.seed,
            "interval_ms": self.interval_ms,
            "fanout": self.fanout,
            "digest": self.state.digest(),
            "peer_digests": peer_digest,
            "entries": self.state.entries_json(),
        }

    # -- config ------------------------------------------------------------

    @classmethod
    def from_config(cls, node_id: str, client, peers_fn, holder,
                    config=None, **overrides) -> "GossipAgent":
        kw = {}
        if config is not None:
            kw.update(
                interval_ms=config.gossip_interval_ms,
                fanout=config.gossip_fanout,
                seed=config.gossip_seed,
                max_deltas=config.gossip_max_deltas,
                piggyback=config.gossip_piggyback,
            )
        kw.update(overrides)
        return cls(node_id, client, peers_fn, holder, **kw)
