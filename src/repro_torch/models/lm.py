"""Decoder-only language model, the dense family of ``repro.models.lm``.

Params keep the reference's tree layout: the layers of one period live
under ``params["stack"]`` with a leading ``n_periods`` axis, so the
'/'-joined paths ``compile_params`` matches on are the reference's.
Where the reference scans the stack with ``lax.scan``, the port loops
over layers in Python and slices layer ``i`` out of every stacked leaf
(``packed[i]``, ``table[i]``, ``scale[i]`` for a packed projection).
The same forward serves prefill (returns the KV cache) and decode
(single token against a preallocated cache, written in place).

Ported: GQA attention mixers with dense MLPs.  MLA, MoE, the SSM mixers
and prologue layers wait for ROADMAP A5; the paged KV cache for A6; the
training forward and loss for A11.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.tree import map_leaves
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (DEFAULT_DTYPE, embed_init,
                                       embedding_lookup, norm_apply,
                                       norm_init, unembed)

__all__ = ["init_params", "init_cache", "forward", "prefill", "decode_step"]


def _check_supported(cfg) -> list[tuple[str, str]]:
    """The period plan, or ``NotImplementedError`` naming the ROADMAP item
    for what the port does not run yet."""
    plan = cfg.layer_plan()
    for kind, ffn in plan:
        if kind != "attn" or cfg.use_mla:
            raise NotImplementedError(
                f"{cfg.name}: mixer {'mla' if cfg.use_mla else kind!r} is "
                f"not ported yet (ROADMAP A5: MLA and the SSM mixers)")
        if ffn == "moe":
            raise NotImplementedError(
                f"{cfg.name}: MoE layers are not ported yet (ROADMAP A5)")
    if cfg.n_dense_layers:
        raise NotImplementedError(
            f"{cfg.name}: prologue layers are not ported yet (ROADMAP A5)")
    return plan


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_period(gen: torch.Generator, cfg) -> dict:
    """One period's params for all ``n_periods`` at once (leading axis)."""
    lead = (cfg.n_periods,)
    out = {}
    for i, (_, ffn) in enumerate(_check_supported(cfg)):
        p = {"norm1": norm_init(cfg.d_model, cfg.norm_type, lead=lead,
                                device=gen.device),
             "mixer": attn.gqa_init(gen, cfg, lead=lead)}
        if ffn == "dense":
            p["norm2"] = norm_init(cfg.d_model, cfg.norm_type, lead=lead,
                                   device=gen.device)
            p["mlp"] = moe_mod.mlp_init(gen, cfg.d_model, cfg.d_ff,
                                        lead=lead)
        out[f"b{i}"] = p
    return out


def init_params(gen: torch.Generator, cfg) -> dict:
    """Random params on ``gen``'s device, drawn from ``gen``."""
    params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model),
        "final_norm": norm_init(cfg.d_model, cfg.norm_type,
                                device=gen.device),
        "stack": _init_period(gen, cfg),
    }
    if not cfg.tied_embeddings:
        params["out_embed"] = embed_init(gen, cfg.vocab_size, cfg.d_model)
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _mixer_cache(cfg, batch: int, seq: int, dtype, paged, device):
    """One GQA mixer's cache, stacked over ``n_periods`` (the only mixer
    ``_check_supported`` lets through: the MLA cache, paged or not, and
    the SSM states wait for ROADMAP A5)."""
    lead = (cfg.n_periods,)
    if paged is not None:
        return attn.gqa_cache_init_paged(cfg, paged, dtype, lead=lead,
                                         device=device)
    return attn.gqa_cache_init(cfg, batch, seq, dtype, lead=lead,
                               device=device)


def init_cache(cfg, batch: int, seq: int, dtype=DEFAULT_DTYPE, paged=None,
               device=None) -> dict:
    """Zeroed KV cache, ``{"stack": {"b<i>": (k, v)}}`` on ``device`` (the
    card unless the caller names another): k, v of shape ``(n_periods,
    batch, seq, n_kv_heads, head_dim)``, or, with ``paged`` (a
    :class:`repro_torch.models.cache.PagedSpec`), :class:`PagedKV` pools
    stacked over ``n_periods`` (``batch`` must equal ``paged.n_slots``,
    ``seq`` its ``max_len``)."""
    if paged is not None and (batch != paged.n_slots
                              or seq != paged.max_len):
        raise ValueError(
            f"paged cache geometry mismatch: batch={batch}/seq={seq} vs "
            f"spec n_slots={paged.n_slots}/max_len={paged.max_len}")
    plan = _check_supported(cfg)
    dev = resolve_device(device)
    return {"stack": {f"b{i}": _mixer_cache(cfg, batch, seq, dtype, paged,
                                            dev)
                      for i in range(len(plan))}}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer(tree, i: int):
    """Layer ``i`` of a stacked params tree: every leaf sliced on its
    leading axis (a packed projection slices its words, table and
    scale)."""
    return map_leaves(lambda leaf: leaf[i], tree)


def _block_apply(lp, x, cfg, mode, cache, pos, positions):
    """One GQA block (+ its dense MLP, if the plan gives it one)."""
    h = norm_apply(x, lp["norm1"], cfg.norm_type, f32=cfg.norm_f32)
    if mode == "decode":
        out, new_cache = attn.gqa_decode(lp["mixer"], h, cfg, cache, pos)
    else:
        out, new_cache = attn.gqa_forward(lp["mixer"], h, cfg, positions)
    x = x + out
    if "mlp" in lp:
        h = norm_apply(x, lp["norm2"], cfg.norm_type, f32=cfg.norm_f32)
        x = x + moe_mod.mlp_forward(lp["mlp"], h, cfg.act)
    return x, new_cache


def forward(params, tokens: torch.Tensor, cfg, *, mode: str, cache=None,
            pos=None, prefix=None):
    """tokens (B, S) int → (logits, new_cache).

    mode='prefill': causal forward, logits for the LAST position, cache
                    out (k, v stacked over the layers).
    mode='decode' : S == 1, attends into ``cache`` at ``pos``, writing the
                    new KV row into it in place; returns it.
    """
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"mode {mode!r}: the port runs prefill "
                                  f"and decode (training is ROADMAP A11)")
    plan = _check_supported(cfg)
    x = embedding_lookup(params["embed"], tokens, DEFAULT_DTYPE)
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)

    caches: dict[str, list] = {f"b{i}": [] for i in range(len(plan))}
    for li in range(cfg.n_periods):
        period = _layer(params["stack"], li)
        for i in range(len(plan)):
            name = f"b{i}"
            layer_cache = None
            if mode == "decode":
                k, v = cache["stack"][name]
                layer_cache = (k[li], v[li])
            x, nc = _block_apply(period[name], x, cfg, mode, layer_cache,
                                 pos, positions)
            if mode == "prefill":
                caches[name].append(nc)

    x = norm_apply(x, params["final_norm"], cfg.norm_type, f32=cfg.norm_f32)
    if mode == "prefill":
        x = x[:, -1:]
        new_cache = {"stack": {
            name: (torch.stack([k for k, _ in kv]),
                   torch.stack([v for _, v in kv]))
            for name, kv in caches.items()}}
    else:
        new_cache = cache             # the layers wrote into it in place
    logits = unembed(x, params.get("out_embed", params["embed"]))
    return logits, new_cache


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def prefill(params, tokens, cfg, prefix=None):
    return forward(params, tokens, cfg, mode="prefill", prefix=prefix)


def decode_step(params, cache, token, pos, cfg):
    """token (B,) int, pos int → (logits (B, V), cache)."""
    logits, cache = forward(params, token[:, None], cfg, mode="decode",
                            cache=cache, pos=pos)
    return logits[:, 0], cache

