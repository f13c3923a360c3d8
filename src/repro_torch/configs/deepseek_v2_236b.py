"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed
experts top-6, first layer dense. [arXiv:2405.04434; hf]"""
from repro_torch.configs.base import ModelConfig

__all__ = ["CONFIG"]

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=12288,                       # dense prologue layer FFN
    vocab_size=102400,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    nope_head_dim=128, rope_head_dim=64, v_head_dim=128,
    n_experts=160, n_shared_experts=2, moe_top_k=6, moe_d_ff=1536,
    n_dense_layers=1, rope_theta=1e4,
)
