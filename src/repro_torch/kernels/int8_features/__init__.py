"""The ``smm_kernel`` lane's 8-bit feature path and epilogue: CUDA kernels
for sm_90a, their wrapper (:mod:`.ops`) and their plain PyTorch versions
(:mod:`.ref`)."""
from repro_torch.kernels.int8_features.ops import epilogue, int8_features
from repro_torch.kernels.int8_features.ref import (epilogue_plain,
                                                   int8_features_plain)

__all__ = ["int8_features", "epilogue", "int8_features_plain",
           "epilogue_plain"]
