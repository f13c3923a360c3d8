"""Model zoo facade of the port — ``repro.models.get_model``: one API
over the decoder-only families (dense, MLA and MoE, SSM and hybrid,
frontend-fed) and the encoder-decoder family:

    api = get_model(cfg)
    params = api.init_params(gen, cfg)            # gen: torch.Generator
    loss = api.train_loss(params, batch, cfg)
    logits, cache = api.prefill(params, batch, cfg)
    cache = api.init_cache(cfg, batch, seq, device=...)
    logits, cache = api.decode_step(params, cache, token, pos, cfg)

``batch`` holds ``"tokens"`` and, for a frontend or an encoder-decoder
model, ``"prefix"``: the frontend stub's precomputed embeddings (the
encoder's frames for the encoder-decoder family).
"""
from __future__ import annotations

import types

import torch

from repro_torch.models import encdec, lm

__all__ = ["get_model"]


def get_model(cfg) -> types.SimpleNamespace:
    if cfg.family == "encdec":
        def prefill(params, batch, cfg):
            return encdec.prefill(params, batch["prefix"], batch["tokens"],
                                  cfg)

        def init_cache(cfg, batch, seq, dtype=torch.bfloat16, paged=None,
                       device=None):
            if paged is not None:
                raise NotImplementedError(
                    "paged KV cache is decoder-only for now "
                    "(enc-dec caches carry a cross-attention half)")
            return encdec.init_cache(cfg, batch, seq,
                                     enc_seq=cfg.frontend_seq or seq,
                                     dtype=dtype, device=device)

        return types.SimpleNamespace(
            init_params=encdec.init_params, train_loss=encdec.train_loss,
            prefill=prefill, decode_step=encdec.decode_step,
            init_cache=init_cache)

    def prefill(params, batch, cfg):
        return lm.prefill(params, batch["tokens"], cfg,
                          prefix=batch.get("prefix"))

    def init_cache(cfg, batch, seq, dtype=torch.bfloat16, paged=None,
                   device=None):
        return lm.init_cache(cfg, batch, seq, dtype=dtype, paged=paged,
                             device=device)

    return types.SimpleNamespace(
        init_params=lm.init_params, train_loss=lm.train_loss,
        prefill=prefill, decode_step=lm.decode_step, init_cache=init_cache)
