"""LR schedules (pure functions of the step counter) — the port's copy
of ``repro.optim.schedule``: a Python int or an integer tensor in, a
float32 0-d tensor out."""
from __future__ import annotations

import math

import torch

__all__ = ["linear_warmup", "cosine_schedule"]


def linear_warmup(step, *, peak_lr: float, warmup_steps: int):
    step = torch.as_tensor(step)
    return peak_lr * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, final_frac: float = 0.1):
    step = torch.as_tensor(step)
    warm = linear_warmup(step, peak_lr=peak_lr, warmup_steps=warmup_steps)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                              * prog))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)
