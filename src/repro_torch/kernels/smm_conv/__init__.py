"""The CoDR SMM convolution: CUDA kernel for sm_90a, its wrapper and
operand packer (:mod:`.ops`), and its plain PyTorch versions
(:mod:`.ref`)."""
from repro_torch.kernels.smm_conv.ops import (pack_smm_operands, smm_conv,
                                              smm_conv_batched)
from repro_torch.kernels.smm_conv.ref import smm_conv_ref

__all__ = ["smm_conv", "smm_conv_batched", "pack_smm_operands",
           "smm_conv_ref"]
