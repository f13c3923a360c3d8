"""Data pipeline of the port (``repro.data``)."""
from repro_torch.data.pipeline import (DataConfig,  # noqa: F401
                                       SyntheticTokenDataset,
                                       host_batch_iterator, make_batch_specs)

__all__ = ["DataConfig", "SyntheticTokenDataset", "make_batch_specs",
           "host_batch_iterator"]
