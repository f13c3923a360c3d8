"""Sharding of the port (``repro.sharding``): the named single-controller
mesh, the context the model lanes read, the parameter rules, blocks, and
the CoDR engine's output-tile mesh."""
from repro_torch.sharding.rules import (ENGINE_TILE_AXIS, Mesh,  # noqa: F401
                                        NamedSharding, P, ShardCtx,
                                        ShardedTensor, current_ctx,
                                        maybe_constrain, named_sharding_tree,
                                        pad_to_multiple, param_spec, place,
                                        set_ctx, shard_leading, tile_mesh,
                                        use_ctx)

__all__ = ["ENGINE_TILE_AXIS", "Mesh", "NamedSharding", "P", "ShardCtx",
           "ShardedTensor", "current_ctx", "maybe_constrain",
           "named_sharding_tree", "pad_to_multiple", "param_spec", "place",
           "set_ctx", "shard_leading", "tile_mesh", "use_ctx"]
