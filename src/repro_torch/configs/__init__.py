"""Model configurations of the port: the paper's CNN shape tables
(:mod:`.paper_cnns`) and the transformer architecture registry —
``get_config(arch_id)`` + reduced smoke variants, as ``repro.configs``.

Only the configurations the port can run are registered: the dense
family (qwen2.5-3b).  The MLA, MoE, SSM and encoder-decoder
architectures of the reference registry wait for ROADMAP A5.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.qwen2_5_3b import CONFIG as _qwen25

REGISTRY: dict[str, ModelConfig] = {c.name: c for c in [_qwen25]}

ARCH_IDS = list(REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"arch {arch!r} is not in the port; it runs {ARCH_IDS} "
                       f"(the MLA, MoE, SSM and encoder-decoder families "
                       f"wait for ROADMAP A5)")
    return REGISTRY[arch]


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: few layers, narrow, tiny vocab/experts
    — the same reduction as ``repro.configs.smoke_variant``, so both
    packages build the same smoke model."""
    period = len(cfg.block_pattern)
    n_layers = period + cfg.n_dense_layers
    d_model = 64
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    changes = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=d_model // n_heads if cfg.head_dim == cfg.d_model // cfg.n_heads else 32,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        attn_q_chunk=16, attn_kv_chunk=16, mamba_chunk=16,
        remat=False,
    )
    if cfg.use_mla:
        changes.update(q_lora_rank=32, kv_lora_rank=16, nope_head_dim=16,
                       rope_head_dim=8, v_head_dim=16, head_dim=16)
    if cfg.n_experts:
        changes.update(n_experts=8, moe_top_k=min(cfg.moe_top_k, 4),
                       moe_d_ff=32)
    if cfg.n_encoder_layers:
        changes.update(n_encoder_layers=2)
    if cfg.frontend:
        changes.update(frontend_seq=16)
    return dataclasses.replace(cfg, **changes)


__all__ = ["REGISTRY", "ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig",
           "get_config", "smoke_variant"]
