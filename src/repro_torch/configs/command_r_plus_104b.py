"""command-r-plus-104b [dense] — GQA kv=8, no bias.
[hf:CohereForAI/c4ai-command-r-plus; unverified]"""
from repro_torch.configs.base import ModelConfig

__all__ = ["CONFIG"]

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000,
    qkv_bias=False, rope_theta=7.5e7, norm_type="layernorm",
)
