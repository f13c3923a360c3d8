"""qwen2.5-3b [dense] — GQA kv=2, QKV bias, tied embeddings.
[hf:Qwen/Qwen2.5-3B; hf]"""
from repro_torch.configs.base import ModelConfig

__all__ = ["CONFIG"]

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
    d_ff=11008, vocab_size=151936,
    qkv_bias=True, tied_embeddings=True, rope_theta=1e6,
)
