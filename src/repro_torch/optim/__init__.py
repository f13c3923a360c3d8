"""Optimizer of the port (``repro.optim``): AdamW and the LR schedules
on trees of tensors."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: F401
                                     adamw_update, clip_by_global_norm)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup  # noqa: F401

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "cosine_schedule", "linear_warmup"]
