"""Checkpoints of the port: the packed artifact
(``repro.checkpoint.packed``).  ``CheckpointManager`` (training state)
waits for ROADMAP A11."""
from repro_torch.checkpoint.packed import (CODR_FORMAT_VERSION,  # noqa: F401
                                           PackedCheckpointError,
                                           load_packed, save_packed)

__all__ = ["CODR_FORMAT_VERSION", "PackedCheckpointError", "load_packed",
           "save_packed"]
