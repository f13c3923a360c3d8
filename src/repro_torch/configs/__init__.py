"""Model configurations of the port: the paper's CNN shape tables
(:mod:`.paper_cnns`) and the transformer architecture registry —
``get_config(arch_id)`` + reduced smoke variants, as ``repro.configs``.

The registry holds the reference's ten architectures, in its order:
the dense family (qwen2.5-3b, qwen1.5-4b, command-r-plus-104b,
qwen3-32b), the encoder-decoder seamless-m4t-medium, the MLA / MoE
family (deepseek-v2-236b, granite-moe-1b-a400m), the vision-prefixed
internvl2-26b, and the SSM and hybrid xlstm-350m and jamba-v0.1-52b.
``applicable_shapes`` says which of ``SHAPES`` each one runs.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.command_r_plus_104b import CONFIG as _command_r
from repro_torch.configs.deepseek_v2_236b import CONFIG as _deepseek
from repro_torch.configs.granite_moe_1b import CONFIG as _granite
from repro_torch.configs.internvl2_26b import CONFIG as _internvl
from repro_torch.configs.jamba_v01_52b import CONFIG as _jamba
from repro_torch.configs.qwen1_5_4b import CONFIG as _qwen15
from repro_torch.configs.qwen2_5_3b import CONFIG as _qwen25
from repro_torch.configs.qwen3_32b import CONFIG as _qwen3
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless
from repro_torch.configs.xlstm_350m import CONFIG as _xlstm

REGISTRY: dict[str, ModelConfig] = {
    c.name: c for c in [
        _qwen25, _qwen15, _command_r, _qwen3, _seamless,
        _deepseek, _granite, _internvl, _xlstm, _jamba,
    ]
}

ARCH_IDS = list(REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    return REGISTRY[arch]


def applicable_shapes(cfg: ModelConfig) -> dict[str, str]:
    """shape_name → 'run' | reason-to-skip, as the reference's registry
    gives them (the dry-run records the reason)."""
    out = {}
    for name, shp in SHAPES.items():
        if name == "long_500k" and not cfg.sub_quadratic:
            out[name] = "SKIP: 512k dense-attention decode is the quadratic regime this shape excludes"
        else:
            out[name] = "run"
    return out


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
           "get_config", "applicable_shapes", "smoke_variant"]
