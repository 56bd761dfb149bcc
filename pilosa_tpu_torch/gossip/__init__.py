"""Cluster metadata gossip: fragment version vectors, breaker-state
sharing, and exact remote-leg cache invalidation.

Port of ``pilosa_tpu/gossip/``, module for module, with the JAX
package's wire format, seeds and metric names: the two packages' nodes
exchange envelopes byte for byte alike.

See state.GossipState (the per-origin entry table + version-vector
scan) and agent.GossipAgent (piggyback envelopes + seeded anti-entropy
rounds). ClusterNode.enable_gossip() wires both into the client, the
executor's remote-leg cache keying, and resilience's circuit breakers.
"""

from __future__ import annotations

import warnings

from pilosa_tpu_torch.gossip.state import (
    GossipState,
    KIND_BREAKER,
    KIND_CONTROL,
    KIND_FRAGMENT,
    KIND_HEALTH,
    KIND_MEMBER,
    KIND_TRANSLATE,
)
from pilosa_tpu_torch.gossip.agent import GossipAgent
from pilosa_tpu_torch.gossip.membership import (
    MEMBER_ALIVE,
    MEMBER_DOWN,
    MEMBER_SUSPECT,
    Membership,
)

_warned_remote_ttl = False


def warn_remote_ttl_deprecated() -> None:
    """One-time DeprecationWarning: with gossip enabled the remote-leg
    cache self-invalidates on version fingerprints, so `cache.ttl-ms`
    no longer gates remote-leg entries (it still bounds memory via
    entry expiry). Warn instead of silently ignoring the knob."""
    global _warned_remote_ttl
    if _warned_remote_ttl:
        return
    _warned_remote_ttl = True
    warnings.warn(
        "cache.ttl-ms is deprecated for remote-leg caching when gossip is "
        "enabled: entries are keyed on gossiped version fingerprints and "
        "invalidate exactly; the TTL only bounds entry lifetime in memory",
        DeprecationWarning, stacklevel=3)


def _reset_ttl_warning() -> None:
    """Test hook: re-arm the one-time deprecation warning."""
    global _warned_remote_ttl
    _warned_remote_ttl = False


__all__ = [
    "GossipAgent",
    "GossipState",
    "KIND_BREAKER",
    "KIND_CONTROL",
    "KIND_FRAGMENT",
    "KIND_HEALTH",
    "KIND_MEMBER",
    "KIND_TRANSLATE",
    "MEMBER_ALIVE",
    "MEMBER_DOWN",
    "MEMBER_SUSPECT",
    "Membership",
    "warn_remote_ttl_deprecated",
]
