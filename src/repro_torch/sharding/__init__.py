"""Sharding of the port: the CoDR engine's output-tile mesh
(``repro.sharding`` without its model half, which waits for ROADMAP
"A10, model half")."""
from repro_torch.sharding.rules import (ENGINE_TILE_AXIS,  # noqa: F401
                                        pad_to_multiple, shard_leading,
                                        tile_mesh)

__all__ = ["ENGINE_TILE_AXIS", "pad_to_multiple", "shard_leading",
           "tile_mesh"]
