"""Model/run configuration schema shared by all architectures — the
port's own copy of ``repro.configs.base`` (pure Python; field for field
the same, so a config means the same model in both packages)."""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_type: str = "rmsnorm"
    act: str = "silu"
    tied_embeddings: bool = False
    # MLA (DeepSeek-V2)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    nope_head_dim: int = 0
    rope_head_dim: int = 0
    v_head_dim: int = 0
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1             # MoE on layers with idx % moe_every == moe_offset
    moe_offset: int = 0
    n_dense_layers: int = 0        # leading non-scanned dense layers
    # heterogeneous layer pattern — one period, scanned n_period times
    block_pattern: tuple = ("attn",)
    # SSM (Mamba)
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    # encoder-decoder
    n_encoder_layers: int = 0
    # modality frontend stub: embeddings come precomputed via input_specs()
    frontend: str | None = None    # "audio" | "vision"
    frontend_seq: int = 0
    # attention chunking (flash-style scan block sizes)
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    # numerics / scan
    remat: bool = True
    sub_quadratic: bool = False    # can run long_500k
    mamba_chunk: int = 256
    # ---- perf levers (baseline = defaults; measured via the roofline
    # ---- report, see benchmarks/roofline.py) ----
    decode_attn: str = "naive"     # "dist" = sequence-parallel softmax
    moe_decode_2d: bool = False    # 2-D expert sharding for decode
    attn_f32: bool = True          # False = bf16 score/accum buffers
    norm_f32: bool = True          # False = f32 stats, bf16 normalize

    @property
    def n_scanned_layers(self) -> int:
        return self.n_layers - self.n_dense_layers

    @property
    def n_periods(self) -> int:
        period = len(self.block_pattern)
        assert self.n_scanned_layers % period == 0, \
            (self.name, self.n_scanned_layers, period)
        return self.n_scanned_layers // period

    def layer_plan(self) -> list[tuple[str, str]]:
        """Per-period plan: [(mixer_kind, ffn_kind)] where ffn_kind is
        'dense' | 'moe' | 'none'."""
        plan = []
        period = len(self.block_pattern)
        for i, kind in enumerate(self.block_pattern):
            gidx = self.n_dense_layers + i         # same for every period
            if kind in ("mlstm", "slstm"):
                ffn = "none" if self.d_ff == 0 else "dense"
            elif self.n_experts and gidx % self.moe_every == self.moe_offset:
                ffn = "moe"
            else:
                ffn = "dense"
            plan.append((kind, ffn))
        # uniformity check: the plan must repeat identically every period
        if self.n_experts and self.n_periods > 1:
            assert period % self.moe_every == 0 or self.moe_every == 1, \
                f"{self.name}: moe_every must divide the pattern period"
        return plan

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks)."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tied_embeddings else 2)
        per_layer = 0.0
        plan = self.layer_plan()
        total = emb
        for kind, ffn in plan:
            per_layer = 0
            if kind == "attn":
                if self.use_mla:
                    per_layer += d * self.q_lora_rank \
                        + self.q_lora_rank * self.n_heads * (self.nope_head_dim + self.rope_head_dim) \
                        + d * (self.kv_lora_rank + self.rope_head_dim) \
                        + self.kv_lora_rank * self.n_heads * (self.nope_head_dim + self.v_head_dim) \
                        + self.n_heads * self.v_head_dim * d
                else:
                    per_layer += d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) \
                        + self.n_heads * self.head_dim * d
            elif kind == "mamba":
                d_in = self.ssm_expand * d
                per_layer += d * 2 * d_in + d_in * (d // 16 + 2 * self.ssm_d_state) \
                    + (d // 16) * d_in + d_in * d
            elif kind == "mlstm":
                d_up = 2 * d
                per_layer += d * 2 * d_up + 3 * d_up * d_up + d_up * d
            elif kind == "slstm":
                per_layer += d * 4 * d + d * 4 * (d // self.n_heads) + d * d
            if ffn == "dense":
                per_layer += 3 * d * self.d_ff
            elif ffn == "moe":
                per_layer += d * self.n_experts + 3 * self.n_experts * d * self.moe_d_ff
                per_layer += 3 * d * self.moe_d_ff * self.n_shared_experts
            total += per_layer * self.n_periods
        # prologue dense layers
        if self.n_dense_layers:
            att = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * self.head_dim * d
            if self.use_mla:
                att = d * self.q_lora_rank \
                    + self.q_lora_rank * self.n_heads * (self.nope_head_dim + self.rope_head_dim) \
                    + d * (self.kv_lora_rank + self.rope_head_dim) \
                    + self.kv_lora_rank * self.n_heads * (self.nope_head_dim + self.v_head_dim) \
                    + self.n_heads * self.v_head_dim * d
            total += self.n_dense_layers * (att + 3 * d * self.d_ff)
        if self.n_encoder_layers:
            att = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * self.head_dim * d
            total += self.n_encoder_layers * (att + 2 * d * self.d_ff)
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        plan = self.layer_plan()
        n_moe_layers = sum(1 for _, f in plan if f == "moe") * self.n_periods
        all_routed = 3 * self.n_experts * self.d_model * self.moe_d_ff
        active_routed = 3 * self.moe_top_k * self.d_model * self.moe_d_ff
        return int(full - n_moe_layers * (all_routed - active_routed))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
