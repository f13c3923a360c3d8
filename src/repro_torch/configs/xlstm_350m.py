"""xlstm-350m [ssm] — alternating mLSTM/sLSTM blocks, d_ff=0 (the
blocks carry their own up/down projections). [arXiv:2405.04517;
unverified]"""
from repro_torch.configs.base import ModelConfig

__all__ = ["CONFIG"]

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    sub_quadratic=True,
)
