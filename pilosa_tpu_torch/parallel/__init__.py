"""Distribution: shard -> device placement and the mesh reduces.

Port of ``pilosa_tpu/parallel``: instead of jump-hashing shards to nodes
(disco/hasher.go:13) and scatter-gathering over HTTP
(internal_client.go), shards are pinned to mesh devices
(:mod:`.mesh`) and every cross-shard reduce is one kernel per block and
a sum of the partials. :mod:`.split` is the tensor the engine mesh
splits, :mod:`.tape` the op-tape programs. The names below load
:mod:`.mesh` on first use, so that the kernel wrappers in ``ops/`` can
import :mod:`.split` without a cycle.
"""

__all__ = ["ShardPlacement", "analytics_mesh", "engine_mesh",
           "set_engine_mesh", "mesh_epoch", "engine_sharding",
           "engine_put"]


def __getattr__(name):
    if name in __all__:
        from pilosa_tpu_torch.parallel import mesh

        return getattr(mesh, name)
    raise AttributeError(name)
