"""Cluster topology: nodes, states, and the static placement snapshot.

Port of ``pilosa_tpu/cluster/topology.py``. Reference:
disco/disco.go:53-61 (cluster states), disco/noder.go (Node lists),
disco/snapshot.go:24 (ClusterSnapshot) — a pure function of
(node list, hasher, partitionN, replicaN) answering "who owns shard S /
partition P / key K". The placement math is the JAX package's, so both
packages put every shard on the same node.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from pilosa_tpu_torch.hashing import (
    DEFAULT_PARTITION_N, jump_hash, key_to_partition, shard_to_partition,
)

# Cluster states (reference: disco/disco.go:53-61).
STATE_UNKNOWN = "UNKNOWN"
STATE_STARTING = "STARTING"
STATE_DEGRADED = "DEGRADED"  # some nodes down, reads still possible
STATE_NORMAL = "NORMAL"
STATE_DOWN = "DOWN"          # too many nodes down to serve reads

# Node states (reference: disco/disco.go node states).
NODE_STATE_STARTED = "STARTED"
NODE_STATE_STARTING = "STARTING"
NODE_STATE_UNKNOWN = "UNKNOWN"


@dataclasses.dataclass
class Node:
    """Reference: disco/disco.go Node (ID + advertised URI)."""
    id: str
    uri: str  # e.g. "http://127.0.0.1:10101"
    grpc_uri: str = ""
    is_primary: bool = False
    state: str = NODE_STATE_STARTED

    def to_json(self) -> dict:
        return {"id": self.id, "uri": self.uri, "isPrimary": self.is_primary,
                "state": self.state}


class ClusterSnapshot:
    """Static placement calculator (reference: disco/snapshot.go:24).

    Node order must be stable across the cluster (sorted by node ID —
    the reference sorts etcd-discovered peers the same way).
    """

    def __init__(self, nodes: List[Node], replica_n: int = 1,
                 partition_n: int = DEFAULT_PARTITION_N):
        self.nodes = sorted(nodes, key=lambda n: n.id)
        n = len(self.nodes)
        self.replica_n = max(1, min(replica_n, n)) if n else max(1, replica_n)
        self.partition_n = partition_n

    # -- partition math ----------------------------------------------------

    def shard_to_partition(self, index: str, shard: int) -> int:
        return shard_to_partition(index, shard, self.partition_n)

    def key_to_partition(self, index: str, key: str) -> int:
        return key_to_partition(index, key, self.partition_n)

    def primary_node_index(self, partition: int) -> int:
        """Jump-hash the partition over the node list (reference:
        disco/snapshot.go PrimaryNodeIndex)."""
        return jump_hash(partition, len(self.nodes))

    def partition_nodes(self, partition: int) -> List[Node]:
        """Primary + next ReplicaN-1 nodes around the ring (reference:
        disco/snapshot.go:117 PartitionNodes)."""
        if not self.nodes:
            return []
        i = self.primary_node_index(partition)
        return [self.nodes[(i + r) % len(self.nodes)]
                for r in range(self.replica_n)]

    def shard_nodes(self, index: str, shard: int) -> List[Node]:
        return self.partition_nodes(self.shard_to_partition(index, shard))

    def key_nodes(self, index: str, key: str) -> List[Node]:
        return self.partition_nodes(self.key_to_partition(index, key))

    def primary_shard_node(self, index: str, shard: int) -> Optional[Node]:
        nodes = self.shard_nodes(index, shard)
        return nodes[0] if nodes else None

    def owns_shard(self, node_id: str, index: str, shard: int) -> bool:
        return any(n.id == node_id for n in self.shard_nodes(index, shard))

    def primary_field_translation_node(self) -> Optional[Node]:
        """Field (row) keys live on one arbitrary-but-stable node: the
        primary of partition 0 (reference: disco/snapshot.go:137)."""
        nodes = self.partition_nodes(0)
        return nodes[0] if nodes else None

    # -- state derivation --------------------------------------------------

    def cluster_state(self, live_ids) -> str:
        """NORMAL if all nodes live; DEGRADED while every partition still
        has a live replica; DOWN otherwise (reference: etcd/embed.go:493
        ClusterState semantics: DOWN when more than ReplicaN-1 missing)."""
        live = set(live_ids)
        down = [n for n in self.nodes if n.id not in live]
        if not self.nodes or len(live) == 0:
            return STATE_DOWN
        if not down:
            return STATE_NORMAL
        if len(down) < self.replica_n:
            return STATE_DEGRADED
        return STATE_DOWN
