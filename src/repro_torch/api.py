"""Public API of the port's CNN lane — spec → compile → run.

    import repro_torch.api as codr

    spec = codr.ModelSpec.from_params(params)      # any conv/dense tree
    compiled = codr.compile(spec, codr.EncodeConfig(n_unique=16),
                            backend="smm_kernel")  # on the card
    y = compiled.run(x)                            # from the RLE bitstreams

Re-exports :mod:`repro_torch.core.api` (the pipeline) and
:mod:`repro_torch.core.backends` (the pluggable execution backends).
"""
from repro_torch.core.api import (CompiledModel, EncodeConfig,  # noqa: F401
                                  LayerSpec, ModelSpec, compile)
from repro_torch.core.backends import (Backend, BackendCaps,  # noqa: F401
                                       available_backends, get_backend,
                                       register)

__all__ = [
    "LayerSpec", "ModelSpec", "EncodeConfig", "CompiledModel", "compile",
    "Backend", "BackendCaps", "available_backends", "get_backend",
    "register",
]
