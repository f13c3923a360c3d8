"""seamless-m4t-medium [audio] — enc-dec, multimodal; the audio
frontend is a stub (input_specs() feeds precomputed frame embeddings).
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig

__all__ = ["CONFIG"]

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206,
    n_encoder_layers=12, frontend="audio", frontend_seq=1024,
    act="relu", norm_type="layernorm",
)
