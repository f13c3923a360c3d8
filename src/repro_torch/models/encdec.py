"""Encoder–decoder transformer (the SeamlessM4T backbone) —
``repro.models.encdec`` on one device.

The audio frontend is a stub, as in the reference: precomputed frame
embeddings ``(B, S_frames, d)`` go straight into the encoder.  Encoder
layers are bidirectional GQA with an ungated MLP; decoder layers are
causal self-attention, then cross-attention into the encoder output,
then the MLP.  Layer stacks keep the reference's leading layer axis
(``enc_stack``, ``dec_stack``), looped over in Python as in
:mod:`repro_torch.models.lm`.

Cross-attention runs through the model's plain chunked
:func:`~repro_torch.models.attention.flash_attention` (prefill) and
:func:`~repro_torch.models.attention.decode_attention` (decode), as the
reference's does; the reference models never call the attention kernel.
The decoder cache is ``{"self": (k, v), "cross": (k, v)}``, each stacked
over the decoder layers; a decode step writes its self-attention row in
place and only reads the cross half.  ``mode="train"`` gives every
position's logits, each decoder layer checkpointed when ``cfg.remat`` is
set (the reference's ``jax.checkpoint`` on its scan body).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (DEFAULT_DTYPE, constrain_tokens,
                                       embed_init, embedding_lookup, linear,
                                       norm_apply, norm_init, softmax_xent,
                                       unembed)
from repro_torch.models.lm import _layer, _layers

__all__ = ["init_params", "encode", "decode_forward", "train_loss",
           "prefill", "decode_step", "init_cache"]


def _init_enc_layer(gen: torch.Generator, cfg, lead: tuple) -> dict:
    dev = gen.device
    return {"norm1": norm_init(cfg.d_model, cfg.norm_type, lead=lead,
                               device=dev),
            "mixer": attn.gqa_init(gen, cfg, lead=lead),
            "norm2": norm_init(cfg.d_model, cfg.norm_type, lead=lead,
                               device=dev),
            "mlp": moe_mod.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=False,
                                    lead=lead)}


def _init_dec_layer(gen: torch.Generator, cfg, lead: tuple) -> dict:
    dev = gen.device
    return {"norm1": norm_init(cfg.d_model, cfg.norm_type, lead=lead,
                               device=dev),
            "self_attn": attn.gqa_init(gen, cfg, lead=lead),
            "norm_x": norm_init(cfg.d_model, cfg.norm_type, lead=lead,
                                device=dev),
            "cross_attn": attn.gqa_init(gen, cfg, lead=lead),
            "norm2": norm_init(cfg.d_model, cfg.norm_type, lead=lead,
                               device=dev),
            "mlp": moe_mod.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=False,
                                    lead=lead)}


def init_params(gen: torch.Generator, cfg) -> dict:
    """Random params on ``gen``'s device, drawn from ``gen``."""
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model),
        "enc_stack": _init_enc_layer(gen, cfg, (cfg.n_encoder_layers,)),
        "dec_stack": _init_dec_layer(gen, cfg, (cfg.n_periods,)),
        "enc_norm": norm_init(cfg.d_model, cfg.norm_type, device=gen.device),
        "final_norm": norm_init(cfg.d_model, cfg.norm_type,
                                device=gen.device),
        "out_embed": embed_init(gen, cfg.vocab_size, cfg.d_model),
    }


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


def encode(params, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames (B, S_enc, d) precomputed embeddings → encoder output."""
    x = constrain_tokens(frames.to(DEFAULT_DTYPE))
    positions = _positions(*x.shape[:2], x.device)
    for lp in _layers(params["enc_stack"], cfg.n_encoder_layers):
        h = norm_apply(x, lp["norm1"], cfg.norm_type, f32=cfg.norm_f32)
        out, _ = attn.gqa_forward(lp["mixer"], h, cfg, positions,
                                  causal=False)
        x = x + out
        h = norm_apply(x, lp["norm2"], cfg.norm_type, f32=cfg.norm_f32)
        x = constrain_tokens(x + moe_mod.mlp_forward(lp["mlp"], h, cfg.act))
    return norm_apply(x, params["enc_norm"], cfg.norm_type, f32=cfg.norm_f32)


def _dec_block(lp, x, cfg, mode, cache, pos, positions, enc_out, enc_kv):
    # self attention
    h = norm_apply(x, lp["norm1"], cfg.norm_type, f32=cfg.norm_f32)
    if mode == "decode":
        out, new_self = attn.gqa_decode(lp["self_attn"], h, cfg, cache, pos)
    else:
        out, new_self = attn.gqa_forward(lp["self_attn"], h, cfg, positions)
    x = x + out
    # cross attention into the encoder output
    h = norm_apply(x, lp["norm_x"], cfg.norm_type, f32=cfg.norm_f32)
    b, s = h.shape[:2]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cross = lp["cross_attn"]
    q = linear(h, cross["q_proj"], cross.get("q_bias")).reshape(b, s, hq, hd)
    if enc_kv is None:
        se = enc_out.shape[1]
        k = linear(enc_out, cross["k_proj"]).reshape(b, se, hkv, hd)
        v = linear(enc_out, cross["v_proj"]).reshape(b, se, hkv, hd)
    else:
        k, v = enc_kv
    if mode == "decode":
        out = attn.decode_attention(q, k, v, k.shape[1] - 1)
    else:
        out = attn.flash_attention(q, k, v, causal=False,
                                   q_chunk=cfg.attn_q_chunk,
                                   kv_chunk=cfg.attn_kv_chunk)
    x = x + linear(out.reshape(b, s, -1), cross["o_proj"])
    h = norm_apply(x, lp["norm2"], cfg.norm_type, f32=cfg.norm_f32)
    x = x + moe_mod.mlp_forward(lp["mlp"], h, cfg.act)
    return constrain_tokens(x), new_self, (k, v)


def decode_forward(params, tokens: torch.Tensor, cfg, enc_out=None, *,
                   mode: str = "train", cache=None, pos=None):
    """tokens (B, S) int → (logits, cache).

    mode='train'  : causal decoder over ``enc_out``, logits for every
                    position, no cache (``None``).
    mode='prefill': causal decoder over ``enc_out``, logits for the LAST
                    position, the cache out (self KV and cross KV, each
                    stacked over the layers).
    mode='decode' : S == 1 against ``cache`` at ``pos``, the new self KV
                    row written into it in place; returns it.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    x = constrain_tokens(embedding_lookup(params["embed"], tokens,
                                          DEFAULT_DTYPE))
    positions = _positions(*x.shape[:2], x.device)
    self_kv, cross_kv = [], []

    def train_layer(xc, enc, lp):
        xc, _, _ = _dec_block(lp, xc, cfg, mode, None, pos, positions, enc,
                              None)
        return xc

    if mode == "train":
        for lp in _layers(params["dec_stack"], cfg.n_periods):
            x = (checkpoint(train_layer, x, enc_out, lp, use_reentrant=False)
                 if cfg.remat else train_layer(x, enc_out, lp))
    else:
        for li in range(cfg.n_periods):
            lp = _layer(params["dec_stack"], li)
            if mode == "prefill":
                x, skv, ckv = _dec_block(lp, x, cfg, mode, None, pos,
                                         positions, enc_out, None)
                self_kv.append(skv)
                cross_kv.append(ckv)
            else:
                x, _, _ = _dec_block(
                    lp, x, cfg, mode, tuple(t[li] for t in cache["self"]),
                    pos, positions, None,
                    tuple(t[li] for t in cache["cross"]))
    x = norm_apply(x, params["final_norm"], cfg.norm_type, f32=cfg.norm_f32)
    if mode == "prefill":
        x = x[:, -1:]
        cache = {half: tuple(torch.stack(parts) for parts in zip(*kvs))
                 for half, kvs in (("self", self_kv), ("cross", cross_kv))}
    return unembed(x, params["out_embed"]), cache


def train_loss(params, batch, cfg) -> torch.Tensor:
    """Next-token cross entropy of the decoder over ``batch["tokens"]``,
    encoding ``batch["prefix"]`` (the frames) first."""
    enc_out = encode(params, batch["prefix"], cfg)
    logits, _ = decode_forward(params, batch["tokens"], cfg, enc_out,
                               mode="train")
    mask = batch.get("mask")
    return softmax_xent(logits[:, :-1], batch["tokens"][:, 1:],
                        mask[:, 1:] if mask is not None else None)


def prefill(params, frames, tokens, cfg):
    """Encode ``frames``, run the decoder prefill over ``tokens``.
    Returns (last-token logits, cache with per-layer self KV + cross
    KV)."""
    enc_out = encode(params, frames, cfg)
    return decode_forward(params, tokens, cfg, enc_out, mode="prefill")


def decode_step(params, cache, token, pos, cfg):
    """token (B,) int, pos int or (B,) → (logits (B, V), cache)."""
    logits, cache = decode_forward(params, token[:, None], cfg, None,
                                   mode="decode", cache=cache, pos=pos)
    return logits[:, 0], cache


def init_cache(cfg, batch: int, seq: int, enc_seq: int,
               dtype=DEFAULT_DTYPE, device=None) -> dict:
    """Zeroed decoder cache on ``device`` (the card unless the caller
    names another): self KV ``(n_layers, batch, seq, n_kv_heads,
    head_dim)`` and cross KV ``(n_layers, batch, enc_seq, …)``."""
    dev = resolve_device(device)
    lead = (cfg.n_periods,)
    return {"self": attn.gqa_cache_init(cfg, batch, seq, dtype, lead=lead,
                                        device=dev),
            "cross": attn.gqa_cache_init(cfg, batch, enc_seq, dtype,
                                         lead=lead, device=dev)}
