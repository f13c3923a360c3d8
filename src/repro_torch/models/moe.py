"""Dense MLP — the ``mlp_init`` / ``mlp_forward`` half of
``repro.models.moe``.  Mixture-of-Experts waits for ROADMAP A5."""
from __future__ import annotations

import torch

from repro_torch.models.common import act_fn, dense_init, linear

__all__ = ["mlp_init", "mlp_forward"]


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool = True, lead: tuple = ()) -> dict:
    """SwiGLU-style gate/up/down (or plain act(up)·down) params; ``lead``
    stacks them (the layer stack)."""
    p = {"up_proj": dense_init(gen, d_model, d_ff, lead=lead)}
    if gated:
        p["gate_proj"] = dense_init(gen, d_model, d_ff, lead=lead)
    p["down_proj"] = dense_init(gen, d_ff, d_model, lead=lead)
    return p


def mlp_forward(p, x, act: str = "silu"):
    up = linear(x, p["up_proj"])
    if "gate_proj" in p:
        up = act_fn(act)(linear(x, p["gate_proj"])) * up
    else:
        up = act_fn(act)(up)
    return linear(up, p["down_proj"])
