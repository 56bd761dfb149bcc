"""SWIM-style gossip-native membership: failure detection + liveness.

Port of ``pilosa_tpu/gossip/membership.py``: the same records, merged
view, probe sequence and timeouts.

Reference: the SWIM protocol (indirect probing + incarnation-numbered
dissemination) as production systems run it (memberlist/Serf), mapped
onto this repo's existing gossip plane instead of a dedicated UDP
stack. ROADMAP's control-plane item: liveness previously came from
status probes and lease heartbeats even though a gossip plane already
disseminated health — this module makes the gossip plane itself the
source of truth for ``live_ids()`` (cluster/disco.GossipDisCo).

Every node publishes, under ITS OWN gossip origin, one observation per
target: ``("m", target) -> [status, incarnation]``. The merged view of
a target is the max over all origins' observations ordered by
``(incarnation, rank)`` with rank alive(0) < suspect(1) < down(2):

- at the SAME incarnation, suspicion and confirmation override alive
  (an observer's failed probe outranks the target's old assertion);
- an alive record at a HIGHER incarnation refutes any suspicion or
  confirmation below it — only the target bumps its own incarnation,
  so only the target can refute (SWIM's central invariant), and a
  healed node rejoins by gossiping ``alive@inc+1``.

Protocol tick (one per gossip anti-entropy round, or driven directly
in tests):

1. self-refutation — if the merged view says WE are suspect/down at an
   incarnation >= ours, bump past it and publish alive (also fired
   immediately from the gossip apply path, so the response envelope of
   the very exchange that delivered the suspicion carries the refutal);
2. suspect expiry — a target continuously suspect for
   ``suspect_timeout_s`` (tick interval x ``suspect_mult`` x
   log2(cluster size), the SWIM bound) is confirmed down;
3. probe — one seeded-random non-down peer gets a direct ping
   (``POST /internal/membership/ping``, op="ping" so FaultPlan rules
   can partition it); on transport failure, ``indirect_k`` other peers
   relay a ping-req, each probing the target over ITS OWN link — an
   asymmetric partition (we can't reach X, the relay can) therefore
   never produces a false confirmation. Only when the direct ping and
   every relay fail do we publish suspect at the target's current
   incarnation.

Dissemination is the existing plane: records ride piggybacked
envelopes and anti-entropy rounds like every other kind, so membership
converges exactly as fast as breaker state does, and a partitioned
minority's records merge back deterministically on heal.
"""

from __future__ import annotations

import math
import random
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from pilosa_tpu_torch.gossip.state import KIND_MEMBER
from pilosa_tpu_torch.obs import metrics as M

MEMBER_ALIVE = "alive"
MEMBER_SUSPECT = "suspect"
MEMBER_DOWN = "down"

# precedence rank within one incarnation; the merged view maximizes
# (incarnation, rank) so alive@i+1 beats suspect@i beats alive@i
_RANK = {MEMBER_ALIVE: 0, MEMBER_SUSPECT: 1, MEMBER_DOWN: 2}


class PingToken:
    """Minimal CancellationToken stand-in for probe RPCs: carries the
    transport timeout, never cancels (a ping IS the timeout probe).
    Duck-typed against InternalClient._request's token contract."""

    __slots__ = ("timeout_s",)
    cancelled = False

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s

    def wait(self, timeout: float) -> bool:
        time.sleep(max(0.0, timeout))
        return False


class Membership:
    """One per node; rides a GossipAgent's state table. ``peers_fn()``
    returns the bootstrap peer Node list (self excluded) — typically
    the seed DisCo's registry (LeaseDisCo / InMemDisCo), which stays
    the discovery path while this protocol owns liveness."""

    def __init__(self, node_id: str, agent, client, peers_fn, *,
                 interval_ms: float = 500.0,
                 ping_timeout_ms: float = 200.0,
                 indirect_k: int = 2,
                 suspect_mult: float = 3.0,
                 flap_window_s: float = 30.0,
                 seed: Optional[int] = None,
                 clock=None, registry=None):
        self.node_id = node_id
        self.agent = agent
        self.state = agent.state
        self.client = client
        self.peers_fn = peers_fn
        self.interval_ms = float(interval_ms)
        self.ping_timeout_s = max(1e-3, float(ping_timeout_ms) / 1e3)
        self.indirect_k = max(0, int(indirect_k))
        self.suspect_mult = max(1.0, float(suspect_mult))
        self.flap_window_s = float(flap_window_s)
        self.seed = agent.seed if seed is None else int(seed)
        self.clock = clock if clock is not None else agent.clock
        self.registry = registry if registry is not None else agent.registry
        self.incarnation = 1
        self._lock = threading.Lock()
        # target -> clock time we FIRST saw the merged view say suspect
        self._suspect_since: Dict[str, float] = {}
        # last merged status per target (transition detection)
        self._last_view: Dict[str, str] = {}
        # (t, node, frm, to) — the flap window the flight recorder reads
        self._transitions: deque = deque(maxlen=256)
        self._rng = random.Random(f"{self.seed}:{node_id}:membership")
        self.state.add_kind_listener(KIND_MEMBER, self._on_member_entry)
        self._publish_alive()

    @classmethod
    def from_config(cls, node_id: str, agent, client, peers_fn,
                    config=None, **overrides) -> "Membership":
        kw: Dict[str, Any] = {}
        if config is not None:
            kw.update(
                interval_ms=config.membership_interval_ms,
                ping_timeout_ms=config.membership_ping_timeout_ms,
                indirect_k=config.membership_indirect_k,
                suspect_mult=config.membership_suspect_mult,
                flap_window_s=config.membership_flap_window_s,
            )
        kw.update(overrides)
        return cls(node_id, agent, client, peers_fn, **kw)

    # -- record publication ------------------------------------------------

    def _publish_alive(self) -> None:
        self.state.bump_local((KIND_MEMBER, self.node_id),
                              [MEMBER_ALIVE, self.incarnation])

    def _publish(self, target: str, status: str, inc: int) -> None:
        if self.state.bump_local((KIND_MEMBER, target), [status, int(inc)]):
            self._note_transition(target)

    def refute(self, observed_inc: int) -> None:
        """We were suspected/confirmed at ``observed_inc``: bump past it
        and assert alive — the only legal refutation in SWIM (nobody
        else may touch our incarnation)."""
        with self._lock:
            if observed_inc < self.incarnation:
                return  # stale suspicion; our newer assertion wins already
            self.incarnation = int(observed_inc) + 1
        self._publish_alive()
        self._note_transition(self.node_id)
        self.registry.count(M.METRIC_MEMBERSHIP_REFUTATIONS,
                            node=self.node_id)

    def _on_member_entry(self, origin: str, key: Tuple, value: Any) -> None:
        """Gossip apply hook: immediate refutation + transition/flap
        accounting without waiting for the next tick."""
        target = key[1]
        status, inc = _parse(value)
        if status is None:
            return
        if target == self.node_id and status != MEMBER_ALIVE \
                and inc >= self.incarnation:
            self.refute(inc)
            return
        self._note_transition(target)

    # -- merged view --------------------------------------------------------

    def view(self) -> Dict[str, Dict[str, Any]]:
        """target -> {"status", "incarnation"}: the (incarnation, rank)
        max over every origin's observation. Bootstrap peers nobody has
        an observation for yet default to alive@0 (the cluster starts
        NORMAL; the first failed probe introduces real records)."""
        best: Dict[str, Tuple[int, int]] = {}
        for origin, key, value in self.state.entries_of_kind(KIND_MEMBER):
            status, inc = _parse(value)
            if status is None:
                continue
            cand = (inc, _RANK[status])
            if cand > best.get(key[1], (-1, -1)):
                best[key[1]] = cand
        out = {t: {"status": _status_of_rank(r), "incarnation": i}
               for t, (i, r) in best.items()}
        for p in self.peers_fn():
            out.setdefault(p.id, {"status": MEMBER_ALIVE, "incarnation": 0})
        out.setdefault(self.node_id,
                       {"status": MEMBER_ALIVE,
                        "incarnation": self.incarnation})
        return out

    def status_of(self, target: str) -> str:
        return self.view().get(
            target, {"status": MEMBER_ALIVE}).get("status", MEMBER_ALIVE)

    def live_ids(self, node_ids) -> List[str]:
        """Liveness for routing: only CONFIRMED-down members leave the
        assignment; suspects stay routed (hedging and breakers absorb a
        true failure, and a false suspicion costs nothing)."""
        view = self.view()
        return [nid for nid in node_ids
                if view.get(nid, {}).get("status") != MEMBER_DOWN]

    def suspect_timeout_s(self, n: int) -> float:
        """SWIM's dissemination-bounded confirm delay: tick interval x
        ``suspect_mult`` x log2(cluster size) — large clusters get more
        rounds for the refutation to propagate before a confirm."""
        scale = max(1.0, math.log2(max(2, int(n))))
        return (self.interval_ms / 1e3) * self.suspect_mult * scale

    # -- external evidence (GossipDisCo mark_down/mark_up) ------------------

    def evidence_down(self, target: str) -> None:
        """Transport-level failure from the executor/breaker layer:
        publish suspicion at the target's current incarnation (refutable
        — a live-but-briefly-unreachable peer clears itself)."""
        if target == self.node_id:
            return
        rec = self.view().get(target)
        inc = rec["incarnation"] if rec else 0
        if rec and rec["status"] == MEMBER_DOWN:
            return  # already confirmed; rejoin needs the target's refutal
        self._publish(target, MEMBER_SUSPECT, inc)

    def evidence_alive(self, target: str) -> None:
        """Positive transport evidence (breaker closed again): withdraw
        OUR suspicion by re-asserting alive at the same incarnation.
        This cannot refute another observer's suspicion (rank), and a
        confirmed-down target still needs its own incarnation bump."""
        if target == self.node_id:
            return
        rec = self.view().get(target)
        inc = rec["incarnation"] if rec else 0
        self._publish(target, MEMBER_ALIVE, inc)

    # -- the protocol tick ---------------------------------------------------

    def tick(self) -> Dict[str, Any]:
        """One protocol round: refute/assert, expire suspects, probe one
        peer. Synchronous and deterministic under a seeded rng + manual
        clock; GossipAgent.run_round drives it as a round hook in
        production."""
        now = self.clock.now()
        view = self.view()
        mine = view.get(self.node_id)
        if mine is not None and mine["status"] != MEMBER_ALIVE \
                and mine["incarnation"] >= self.incarnation:
            self.refute(mine["incarnation"])
        else:
            self._publish_alive()
        peers = sorted((p for p in self.peers_fn()
                        if p.id != self.node_id), key=lambda p: p.id)
        timeout = self.suspect_timeout_s(len(peers) + 1)
        confirmed: List[str] = []
        for nid in sorted(view):
            if nid == self.node_id:
                continue
            rec = view[nid]
            if rec["status"] == MEMBER_SUSPECT:
                since = self._suspect_since.setdefault(nid, now)
                if now - since >= timeout:
                    self._publish(nid, MEMBER_DOWN, rec["incarnation"])
                    self._suspect_since.pop(nid, None)
                    confirmed.append(nid)
            else:
                self._suspect_since.pop(nid, None)
        probed = None
        candidates = [p for p in peers
                      if view.get(p.id, {}).get("status") != MEMBER_DOWN]
        if candidates:
            target = candidates[self._rng.randrange(len(candidates))]
            probed = target.id
            ok = self._probe(target, peers)
            self.registry.count(M.METRIC_MEMBERSHIP_PINGS,
                                outcome="ok" if ok else "fail")
            if not ok:
                self.evidence_down(target.id)
        self._refresh_gauges()
        return {"probed": probed, "confirmed": confirmed,
                "suspect_timeout_s": timeout}

    def _probe(self, target, peers) -> bool:
        """Direct ping, then up to ``indirect_k`` ping-req relays, each
        probing the target over its own network path."""
        from pilosa_tpu_torch.cluster.client import NodeDownError, RemoteError

        try:
            out = self.client.membership_ping(
                target, {"from": self.node_id, "inc": self.incarnation},
                token=PingToken(self.ping_timeout_s))
            if out.get("ok"):
                return True
        except (NodeDownError, RemoteError):
            pass
        relays = [p for p in peers if p.id != target.id]
        if len(relays) > self.indirect_k:
            relays = self._rng.sample(relays, self.indirect_k)
        for relay in relays:
            try:
                out = self.client.membership_ping(
                    relay, {"from": self.node_id,
                            "target": target.to_json()},
                    token=PingToken(self.ping_timeout_s))
                if out.get("ok"):
                    return True
            except (NodeDownError, RemoteError):
                continue
        return False

    # -- transition / flap accounting ---------------------------------------

    def _note_transition(self, target: str) -> None:
        rec = self.view().get(target)
        if rec is None:
            return
        st = rec["status"]
        with self._lock:
            # a never-observed target was bootstrap-default alive, so its
            # first suspicion still counts as a transition (flap input)
            prev = self._last_view.get(target, MEMBER_ALIVE)
            self._last_view[target] = st
        if prev != st:
            self._transitions.append((self.clock.now(), target, prev, st))
            self.registry.count(M.METRIC_MEMBERSHIP_TRANSITIONS,
                                node=target, to=st)
        self.registry.gauge(M.METRIC_MEMBERSHIP_STATUS, float(_RANK[st]),
                            node=target)

    def recent_transitions(self, window_s: Optional[float] = None) -> int:
        """Transitions inside the flap window — the flight recorder's
        ``membership_flap`` trigger input."""
        if window_s is None:
            window_s = self.flap_window_s
        cutoff = self.clock.now() - window_s
        return sum(1 for t, *_ in list(self._transitions) if t >= cutoff)

    def _refresh_gauges(self) -> None:
        for nid, rec in self.view().items():
            self.registry.gauge(M.METRIC_MEMBERSHIP_STATUS,
                                float(_RANK[rec["status"]]), node=nid)

    # -- introspection -------------------------------------------------------

    def probe(self) -> Dict[str, Any]:
        """Timeline-probe payload (obs/health.py attach_node)."""
        view = self.view()
        counts = {MEMBER_ALIVE: 0, MEMBER_SUSPECT: 0, MEMBER_DOWN: 0}
        for rec in view.values():
            counts[rec["status"]] += 1
        return {"enabled": True, "incarnation": self.incarnation,
                "alive": counts[MEMBER_ALIVE],
                "suspect": counts[MEMBER_SUSPECT],
                "down": counts[MEMBER_DOWN],
                "recent_transitions": self.recent_transitions()}

    def members_json(self) -> Dict[str, Any]:
        """GET /internal/membership payload."""
        now = self.clock.now()
        view = self.view()
        members = {}
        for nid in sorted(view):
            rec = dict(view[nid])
            since = self._suspect_since.get(nid)
            if since is not None:
                rec["suspect_for_s"] = round(max(0.0, now - since), 6)
            members[nid] = rec
        n = sum(1 for _ in self.peers_fn()) + 1
        return {"enabled": True, "node": self.node_id,
                "incarnation": self.incarnation,
                "suspect_timeout_s": self.suspect_timeout_s(n),
                "members": members}


def _parse(value) -> Tuple[Optional[str], int]:
    if (isinstance(value, (list, tuple)) and len(value) == 2
            and value[0] in _RANK):
        try:
            return value[0], int(value[1])
        except (TypeError, ValueError):
            return None, 0
    return None, 0


def _status_of_rank(rank: int) -> str:
    for status, r in _RANK.items():
        if r == rank:
            return status
    return MEMBER_ALIVE
