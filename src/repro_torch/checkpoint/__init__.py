"""Checkpoints of the port: training state (``repro.checkpoint.manager``,
the reference's directory format) and the packed artifact
(``repro.checkpoint.packed``)."""
from repro_torch.checkpoint.manager import (CheckpointManager,  # noqa: F401
                                            restore_latest)
from repro_torch.checkpoint.packed import (CODR_FORMAT_VERSION,  # noqa: F401
                                           PackedCheckpointError,
                                           load_packed, save_packed)

__all__ = ["CheckpointManager", "restore_latest", "CODR_FORMAT_VERSION",
           "PackedCheckpointError", "load_packed", "save_packed"]
