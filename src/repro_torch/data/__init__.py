"""Data pipeline of the port (``repro.data`` without
``make_batch_specs``)."""
from repro_torch.data.pipeline import (DataConfig,  # noqa: F401
                                       SyntheticTokenDataset,
                                       host_batch_iterator)

__all__ = ["DataConfig", "SyntheticTokenDataset", "host_batch_iterator"]
