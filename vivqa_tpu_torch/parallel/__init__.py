"""The ('data', 'model') mesh, its placement rules and collectives
(counterpart of vivqa_tpu/parallel).

The names below load ``parallel/mesh.py`` on first use: the model layers
import ``parallel/collectives.py``, and ``mesh.py`` imports the layers.
"""

__all__ = [
    "MeshConfig",
    "create_mesh",
    "batch_sharding",
    "replicated",
    "logical_to_mesh",
    "shard_pytree_by_rules",
    "DEFAULT_PARTITION_RULES",
]


def __getattr__(name):
    if name in __all__:
        from vivqa_tpu_torch.parallel import mesh
        return getattr(mesh, name)
    raise AttributeError(name)
