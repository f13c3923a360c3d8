"""Model zoo facade of the port — the decoder-only branch of
``repro.models.get_model``:

    api = get_model(cfg)
    params = api.init_params(gen, cfg)            # gen: torch.Generator
    logits, cache = api.prefill(params, batch, cfg)
    cache = api.init_cache(cfg, batch, seq, device=...)
    logits, cache = api.decode_step(params, cache, token, pos, cfg)

The encoder-decoder branch waits for ROADMAP A5.
"""
from __future__ import annotations

import types

import torch

from repro_torch.models import lm

__all__ = ["get_model"]


def get_model(cfg) -> types.SimpleNamespace:
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is not ported yet "
            f"(ROADMAP A5)")

    def prefill(params, batch, cfg):
        return lm.prefill(params, batch["tokens"], cfg,
                          prefix=batch.get("prefix"))

    def init_cache(cfg, batch, seq, dtype=torch.bfloat16, paged=None,
                   device=None):
        return lm.init_cache(cfg, batch, seq, dtype=dtype, paged=paged,
                             device=device)

    return types.SimpleNamespace(
        init_params=lm.init_params, prefill=prefill,
        decode_step=lm.decode_step, init_cache=init_cache)
