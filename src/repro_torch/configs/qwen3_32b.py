"""qwen3-32b [dense] — qk_norm, GQA kv=8. [hf:Qwen/Qwen3-32B; hf]"""
from repro_torch.configs.base import ModelConfig

__all__ = ["CONFIG"]

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab_size=151936,
    qk_norm=True, rope_theta=1e6,
)
