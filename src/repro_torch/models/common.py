"""Shared model building blocks (dict-tree params) — the torch
counterpart of ``repro.models.common``.

Activations run in bfloat16 (:data:`DEFAULT_DTYPE`) over float32 master
params, as in the reference.  ``repro.sharding.maybe_constrain`` /
``constrain_tokens`` are no-ops on one device and are left out here
(ROADMAP "A10, model half" ports them).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.codr_linear import (PackedEmbedding, PackedLinear,
                                         dense_weight)

__all__ = ["DEFAULT_DTYPE", "PARAM_DTYPE", "dense_init", "embed_init",
           "dense_weight", "linear", "embedding_lookup", "unembed",
           "rms_norm", "layer_norm", "norm_apply", "norm_init", "act_fn", "rope_freqs",
           "apply_rope", "softmax_xent"]

DEFAULT_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32    # master params; cast to compute dtype at use


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               scale: float | None = None, lead: tuple = (),
               dtype=PARAM_DTYPE) -> torch.Tensor:
    """Normal ``(*lead, d_in, d_out)`` weights on the generator's device;
    ``lead`` stacks independent matrices (the layer stack)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    # scaled in place: a full-width expert stack has no room for a copy
    return torch.randn(tuple(lead) + (d_in, d_out), generator=gen,
                       device=gen.device, dtype=dtype).mul_(scale)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=PARAM_DTYPE) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=gen.device,
                       dtype=dtype).mul_(0.02)


def linear(x: torch.Tensor, w, b: torch.Tensor | None = None
           ) -> torch.Tensor:
    """``x @ w (+ b)`` — the single matmul every model projection routes
    through.  A plain tensor is a dense product in ``x``'s dtype; a
    :class:`PackedLinear` leaf (a params tree after ``compile_params``)
    resolves through the backend registry and executes from the packed
    words."""
    if isinstance(w, PackedLinear):
        from repro_torch.core import backends
        y = backends.resolve(w.backend).matmul(x, w)
    else:
        y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def embedding_lookup(table, tokens: torch.Tensor,
                     dtype=DEFAULT_DTYPE) -> torch.Tensor:
    """``table[tokens]``: a plain ``(V, d)`` tensor is indexed; a
    :class:`PackedEmbedding` resolves through the backend registry and
    decodes only the requested rows."""
    if isinstance(table, PackedEmbedding):
        from repro_torch.core import backends
        return backends.resolve(table.backend).gather(tokens, table
                                                      ).to(dtype)
    return table[tokens].to(dtype)


def unembed(x: torch.Tensor, table) -> torch.Tensor:
    """``x @ table.T`` — the logit projection against the (possibly
    packed) output embedding."""
    if isinstance(table, PackedEmbedding):
        from repro_torch.core import backends
        return backends.resolve(table.backend).unembed(x, table)
    return torch.matmul(x, table.to(x.dtype).T)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             f32: bool = True) -> torch.Tensor:
    if f32:
        xf = x.to(torch.float32)
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * w.to(torch.float32)).to(x.dtype)
    # f32 only in the (…, 1) reduction accumulators
    var = torch.mean(torch.square(x), dim=-1, keepdim=True,
                     dtype=torch.float32)
    r = torch.rsqrt(var + eps).to(x.dtype)
    return x * r * w.to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5, f32: bool = True) -> torch.Tensor:
    if f32:
        xf = x.to(torch.float32)
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * w.to(torch.float32)
                + b.to(torch.float32)).to(x.dtype)
    mu = torch.mean(x, dim=-1, keepdim=True, dtype=torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True,
                     dtype=torch.float32) - torch.square(mu)
    r = torch.rsqrt(var + eps).to(x.dtype)
    return ((x - mu.to(x.dtype)) * r * w.to(x.dtype) + b.to(x.dtype))


def norm_apply(x, p, kind: str, f32: bool = True):
    if kind == "rmsnorm":
        return rms_norm(x, p["w"], f32=f32)
    return layer_norm(x, p["w"], p["b"], f32=f32)


def norm_init(d: int, kind: str, *, lead: tuple = (), device=None):
    shape = tuple(lead) + (d,)
    if kind == "rmsnorm":
        return {"w": torch.ones(shape, dtype=PARAM_DTYPE, device=device)}
    return {"w": torch.ones(shape, dtype=PARAM_DTYPE, device=device),
            "b": torch.zeros(shape, dtype=PARAM_DTYPE, device=device)}


def act_fn(name: str):
    """``jax.nn`` activations: its ``gelu`` is the tanh approximation."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device
                   ) -> torch.Tensor:
    """:func:`rope_freqs` as float32 on ``device``, copied there once: a
    host→device copy cannot be captured into a CUDA graph."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, D) — rotate the full head dim."""
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, theta, x.device)                  # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs     # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean cross entropy; logits (.., V) in float32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
