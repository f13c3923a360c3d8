"""Plain PyTorch version of flash attention — the counterpart of
``repro.kernels.flash_attention.ref``: naive softmax attention over
float32 scores, GQA by head grouping, a ``-1e30`` causal mask from a
top-left ``tril``, output in ``q``'s dtype.  The CPU path of :mod:`.ops`
and the yardstick the CUDA kernel is held to on the card."""
from __future__ import annotations

import math

import torch

__all__ = ["flash_attention_ref"]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """q (B,Sq,Hq,D), k (B,Sk,Hkv,D), v (B,Sk,Hkv,Dv) → (B,Sq,Hq,Dv)."""
    b, s, hq, d = q.shape
    _, sk, hkv, dv = v.shape
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(d)
    if causal:
        mask = torch.tril(torch.ones(s, sk, dtype=torch.bool,
                                     device=q.device))
        scores = torch.where(mask, scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(b, s, hq, dv).to(q.dtype)
