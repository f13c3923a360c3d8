"""Public API of the port — spec → compile → run, and the transformer
lane's compile_params.

    import repro_torch.api as codr

    spec = codr.ModelSpec.from_params(params)      # any conv/dense tree
    compiled = codr.compile(spec, codr.EncodeConfig(n_unique=16),
                            backend="smm_kernel")  # on the card
    y = compiled.run(x)                            # from the RLE bitstreams

    cp = codr.compile_params(lm_params, codr.EncodeConfig(n_unique=16),
                             backend="codr_matmul")  # packed projections
    codr.save_packed(cp, "ckpt/qwen.codr")         # words + manifest
    cp = codr.load_packed("ckpt/qwen.codr")        # mapped, on the card

Re-exports :mod:`repro_torch.core.api` (the pipeline),
:mod:`repro_torch.core.backends` (the pluggable execution backends),
:mod:`repro_torch.core.codr_linear` (the packed projection leaves) and
:mod:`repro_torch.checkpoint.packed` (the packed artifact).
"""
from repro_torch.checkpoint.packed import (CODR_FORMAT_VERSION,  # noqa: F401
                                           PackedCheckpointError,
                                           load_packed, save_packed)
from repro_torch.core.api import (EMBED_INCLUDE,  # noqa: F401
                                  PACK_INCLUDE, CompiledModel,
                                  CompiledParams, EncodeConfig, LayerSpec,
                                  ModelSpec, ModuleSpec, PoolSpec, compile,
                                  compile_params)
from repro_torch.core.backends import (Backend, BackendCaps,  # noqa: F401
                                       available_backends, get_backend,
                                       register)
from repro_torch.core.codr_linear import (PackedEmbedding,  # noqa: F401
                                          PackedLinear, PackedWeight,
                                          dense_weight, pack_embedding,
                                          pack_projection)

__all__ = [
    "LayerSpec", "PoolSpec", "ModuleSpec", "ModelSpec", "EncodeConfig",
    "CompiledModel", "compile",
    "PACK_INCLUDE", "EMBED_INCLUDE", "CompiledParams", "compile_params",
    "PackedLinear", "PackedWeight", "PackedEmbedding", "dense_weight",
    "pack_projection", "pack_embedding",
    "Backend", "BackendCaps", "available_backends", "get_backend",
    "register",
    "CODR_FORMAT_VERSION", "PackedCheckpointError", "save_packed",
    "load_packed",
]
