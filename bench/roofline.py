"""The yardstick's frozen arithmetic: the card's peaks and the operations
and bytes a kernel's work needs, counted from shapes alone.

The peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity),
at the full 700 W power limit.  The counts are of the work, not of what a
kernel happens to read: each input once at the narrowest width the lane's
contract allows, each output once at the width the layer returns, so that
no kernel can read above 100% honestly.  Nothing here imports the program.
"""
from __future__ import annotations

import math

__all__ = ["PEAK_OPS", "HBM_BYTES_S", "bound_s", "conv_out_hw",
           "smm_conv_counts", "conv_nonzero_ops", "codr_matmul_counts",
           "mla_moe_step_matmuls", "mla_moe_params_per_token"]

# operations a second, by the arithmetic that performs them
PEAK_OPS = {
    "int8": 1979e12,     # tensor cores, dense int8
    "fp8": 1979e12,      # tensor cores, dense fp8
    "bf16": 989e12,      # tensor cores, dense bf16 / fp16
    "tf32": 495e12,      # tensor cores, dense tf32
    "fp32": 67e12,       # CUDA cores, float32
}
HBM_BYTES_S = 3.35e12    # HBM3, bytes a second


def bound_s(n_bytes: float, n_ops: float, arithmetic: str) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the arithmetic's peak."""
    return max(n_bytes / HBM_BYTES_S, n_ops / PEAK_OPS[arithmetic])


def conv_out_hw(ri: int, ci: int, rk: int, ck: int, stride: int
                ) -> tuple[int, int]:
    """Output rows and columns of a VALID convolution."""
    return (ri - rk) // stride + 1, (ci - ck) // stride + 1


def conv_nonzero_ops(nonzero: int, ro: int, co: int, batch: int) -> float:
    """The sparse convolution's arithmetic: a multiply and an add for
    every nonzero weight at every output position of every image."""
    return 2.0 * nonzero * ro * co * batch


def smm_conv_counts(*, batch: int, n_in: int, ri: int, ci: int, m: int,
                    rk: int, ck: int, stride: int, nonzero: int,
                    n_unique: int) -> tuple[float, float]:
    """``(operations, bytes)`` of one ``smm_conv`` call.

    Operations: 2 × nonzero weights × output positions × batch.  Bytes:
    the activations once at int8 (the lane's feature path), the weights
    once at ``log2(U)`` bits each (an index into the U unique levels),
    the output once in float32 (what the layer returns)."""
    ro, co = conv_out_hw(ri, ci, rk, ck, stride)
    weight_bits = max(1, math.ceil(math.log2(n_unique)))
    n_bytes = (batch * ri * ci * n_in
               + m * n_in * rk * ck * weight_bits / 8
               + batch * ro * co * m * 4)
    return conv_nonzero_ops(nonzero, ro, co, batch), float(n_bytes)


def codr_matmul_counts(*, m: int, k: int, n: int, bits: int,
                       out_bytes: int = 2) -> tuple[float, float]:
    """``(operations, bytes)`` of one ``codr_matmul`` call ``(m, k) @ (k,
    n)``: 2·m·k·n operations; the activations once in bf16, the pack at
    ``bits / 8`` bytes a weight plus its table of ``2 ** bits`` float32
    levels and one float32 scale, the output once at ``out_bytes`` a
    value (bf16: what the projection returns)."""
    n_bytes = (m * k * 2 + k * n * bits / 8 + 4 * 2 ** bits + 4
               + m * n * out_bytes)
    return 2.0 * m * k * n, float(n_bytes)


def _mla_moe_widths(c: dict) -> dict:
    h = c["num_attention_heads"]
    return {"d": c["hidden_size"], "qr": c["q_lora_rank"],
            "kr": c["kv_lora_rank"], "dr": c["qk_rope_head_dim"],
            "qk": h * (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]),
            "kv": h * (c["qk_nope_head_dim"] + c["v_head_dim"]),
            "o": h * c["v_head_dim"], "dff": c["intermediate_size"],
            "fs": c["moe_intermediate_size"] * c["n_shared_experts"],
            "n_dense": c["first_k_dense_replace"],
            "n_moe": c["num_hidden_layers"] - c["first_k_dense_replace"]}


def mla_moe_step_matmuls(c: dict) -> list[tuple[int, int]]:
    """``(K, N)`` of each packed projection a decode step of a
    DeepSeek-V2-style model multiplies on ``codr_matmul``, per layer:
    the MLA projections q_a, q_b, kv_a and o (``kv_b`` is absorbed into
    the latent attention as a weight), then the dense layer's SwiGLU or
    the MoE layer's shared SwiGLU (the router and the routed experts are
    weights, not products, on this path)."""
    w = _mla_moe_widths(c)
    d = w["d"]
    mla = [(d, w["qr"]), (w["qr"], w["qk"]), (d, w["kr"] + w["dr"]),
           (w["o"], d)]
    out = []
    for ff, n in ((w["dff"], w["n_dense"]), (w["fs"], w["n_moe"])):
        out += (mla + [(d, ff), (d, ff), (ff, d)]) * n
    return out


def mla_moe_params_per_token(c: dict) -> int:
    """Parameters one token multiplies by in a forward of a
    DeepSeek-V2-style model: every layer's MLA projections, the dense
    layers' SwiGLU, each MoE layer's router, its top-k routed experts
    and its shared experts, and the output table."""
    w = _mla_moe_widths(c)
    d = w["d"]
    mla = (d * w["qr"] + w["qr"] * w["qk"] + d * (w["kr"] + w["dr"])
           + w["kr"] * w["kv"] + w["o"] * d)
    dense = 3 * d * w["dff"]
    moe = (d * c["n_routed_experts"]
           + c["num_experts_per_tok"] * 3 * d * c["moe_intermediate_size"]
           + 3 * d * w["fs"])
    return (w["n_dense"] * (mla + dense) + w["n_moe"] * (mla + moe)
            + c["vocab_size"] * d)
