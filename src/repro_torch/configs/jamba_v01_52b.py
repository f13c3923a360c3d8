"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e
top-2 on every other layer. [arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ModelConfig

__all__ = ["CONFIG"]

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    n_experts=16, moe_top_k=2, moe_d_ff=14336, moe_every=2, moe_offset=1,
    block_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    ssm_d_state=16, ssm_d_conv=4, ssm_expand=2,
    sub_quadratic=True,
)
