"""Distribution: shard -> device placement and the mesh reduces.

Port of ``pilosa_tpu/parallel``: instead of jump-hashing shards to nodes
(disco/hasher.go:13) and scatter-gathering over HTTP
(internal_client.go), shards are pinned to mesh devices
(:mod:`.mesh`) and every cross-shard reduce is one kernel per block and
a sum of the partials. :mod:`.tape` holds the op-tape programs of one
device.
"""

from pilosa_tpu_torch.parallel.mesh import ShardPlacement, analytics_mesh

__all__ = ["ShardPlacement", "analytics_mesh"]
