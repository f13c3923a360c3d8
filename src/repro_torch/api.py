"""Public API of the port — spec → compile → run, and the transformer
lane's compile_params.

    import repro_torch.api as codr

    spec = codr.ModelSpec.from_params(params)      # any conv/dense tree
    compiled = codr.compile(spec, codr.EncodeConfig(n_unique=16),
                            backend="smm_kernel")  # on the card
    y = compiled.run(x)                            # from the RLE bitstreams

    cp = codr.compile_params(lm_params, codr.EncodeConfig(n_unique=16),
                             backend="codr_matmul")  # packed projections

Re-exports :mod:`repro_torch.core.api` (the pipeline) and
:mod:`repro_torch.core.backends` (the pluggable execution backends).
"""
from repro_torch.core.api import (EMBED_INCLUDE,  # noqa: F401
                                  PACK_INCLUDE, CompiledModel,
                                  CompiledParams, EncodeConfig, LayerSpec,
                                  ModelSpec, compile, compile_params)
from repro_torch.core.backends import (Backend, BackendCaps,  # noqa: F401
                                       available_backends, get_backend,
                                       register)

__all__ = [
    "LayerSpec", "ModelSpec", "EncodeConfig", "CompiledModel", "compile",
    "PACK_INCLUDE", "EMBED_INCLUDE", "CompiledParams", "compile_params",
    "Backend", "BackendCaps", "available_backends", "get_backend",
    "register",
]
