"""The CoDR unique-index compressed matmul: CUDA kernel for sm_90a and its
wrapper (:mod:`.ops`), and its plain PyTorch version (:mod:`.ref`)."""
from repro_torch.kernels.codr_matmul.ops import codr_matmul
from repro_torch.kernels.codr_matmul.ref import codr_matmul_ref

__all__ = ["codr_matmul", "codr_matmul_ref"]
