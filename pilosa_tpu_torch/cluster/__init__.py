"""Cluster layer: membership, placement, node-to-node RPC, distributed
execution (SURVEY.md §2.3).

Port of ``pilosa_tpu/cluster/``'s core: shards hash to partitions
(fnv64a), partitions jump-hash to nodes, queries fan out to the shard
primaries and reduce at the coordinator, writes replicate to every
owner. The resilience plane (hedges, breakers, seeded fault plans) and
the per-node leg batcher guard and coalesce the remote legs; the gossip
agent spreads cluster metadata, and SWIM membership over it decides
liveness."""

from pilosa_tpu_torch.cluster.broadcast import (  # noqa: F401
    Broadcaster, HTTPBroadcaster, NopBroadcaster,
)
from pilosa_tpu_torch.cluster.batch import NodeBatcher  # noqa: F401
from pilosa_tpu_torch.cluster.client import (  # noqa: F401
    InternalClient, LegCancelled, NodeDownError, RemoteError,
)
from pilosa_tpu_torch.cluster.disco import (  # noqa: F401
    DisCo, GossipDisCo, InMemDisCo, LeaseDisCo, SingleNodeDisCo,
    StaticDisCo,
)
from pilosa_tpu_torch.cluster.executor import ClusterExecutor  # noqa: F401
from pilosa_tpu_torch.cluster.harness import LocalCluster  # noqa: F401
from pilosa_tpu_torch.cluster.resilience import (  # noqa: F401
    CancellationToken, CircuitBreaker, FaultPlan, InjectedFault,
    LatencyTracker, Resilience,
)
from pilosa_tpu_torch.gossip import GossipAgent, GossipState  # noqa: F401
from pilosa_tpu_torch.hashing import (  # noqa: F401
    fnv64a, jump_hash, key_to_partition, shard_to_partition,
)
from pilosa_tpu_torch.cluster.node import ClusterNode  # noqa: F401
from pilosa_tpu_torch.errors import ClusterStateError  # noqa: F401
from pilosa_tpu_torch.cluster.topology import (  # noqa: F401
    ClusterSnapshot, Node, STATE_DEGRADED, STATE_DOWN, STATE_NORMAL,
)
from pilosa_tpu_torch.cluster.translator import ClusterTranslator  # noqa: F401
