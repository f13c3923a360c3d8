"""Fused flash attention: CUDA kernel for sm_90a and its wrapper
(:mod:`.ops`), and its plain PyTorch version (:mod:`.ref`)."""
from repro_torch.kernels.flash_attention.ops import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention_kernel", "flash_attention_ref"]
