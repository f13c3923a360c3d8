"""internvl2-26b [vlm] — InternViT frontend (stub per spec) +
InternLM2-20B backbone. [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig

__all__ = ["CONFIG"]

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553,
    frontend="vision", frontend_seq=1024,
    rope_theta=1e6,
)
