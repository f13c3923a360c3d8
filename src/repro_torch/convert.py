"""Carry compiled state from the JAX reference package into the port.

:func:`compiled_from_reference` takes a ``repro`` ``CompiledModel`` and
builds a port :class:`~repro_torch.core.api.CompiledModel` that executes
the very same bitstreams — no re-encoding.  The reference is read
duck-typed (``.model.layers``, and per layer ``.kind``, ``.name``,
``.stride``, ``.activation``, ``.bias`` and ``.code`` with its NumPy
streams), so nothing of the reference package is imported here.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import api, backends, engine, rle, ucr

__all__ = ["layer_code_from_reference", "compiled_from_reference"]


def _stream(s) -> rle.Stream:
    return rle.Stream(np.array(s.packed, dtype=np.uint8), int(s.nbits),
                      int(s.param), int(s.count), int(s.mode_bits))


def layer_code_from_reference(code) -> ucr.LayerCode:
    """A port :class:`~repro_torch.core.ucr.LayerCode` holding copies of a
    reference layer code's streams and UCR vectors."""
    vectors = [rle.EncodedVector(_stream(v.deltas), _stream(v.reps),
                                 _stream(v.indexes), int(v.vector_len),
                                 int(v.n_unique), int(v.n_weights))
               for v in code.vectors]
    ucrs = [ucr.UCRVector(np.array(u.unique_vals), np.array(u.reps),
                          np.array(u.indexes), int(u.vector_len))
            for u in code.ucr]
    return ucr.LayerCode(vectors, ucrs, tuple(int(d) for d in code.shape),
                         np.array(code.scale, dtype=np.float32),
                         int(code.t_m), int(code.t_n),
                         tuple(int(p) for p in code.params))


def compiled_from_reference(compiled, device=None, *,
                            backend: str | None = None
                            ) -> api.CompiledModel:
    """Port executable over a reference ``CompiledModel``'s bitstreams.

    ``device`` as for :func:`repro_torch.core.api.compile` (the card by
    default).  ``backend`` defaults to the reference's backend name,
    which must be registered in the port.  The result has no float
    weights, so its ``reference`` oracle raises; ``quantized_reference``
    and every backend run."""
    dev = engine.resolve_device(device)
    layers = []
    for layer in compiled.model.layers:
        common = dict(activation=layer.activation, name=layer.name,
                      decode_source=getattr(layer, "decode_source",
                                            "bitstream"),
                      n_unique=getattr(layer, "n_unique", 256), device=dev)
        code = layer_code_from_reference(layer.code)
        bias = None if layer.bias is None else np.asarray(layer.bias)
        if layer.kind == "conv":
            layers.append(engine.CodrConv2D.from_code(
                code, bias, stride=layer.stride, **common))
        elif layer.kind == "linear":
            layers.append(engine.CodrLinear.from_code(code, bias, **common))
        else:
            raise ValueError(f"unknown layer kind {layer.kind!r}")
    be = backends.resolve(backend or compiled.backend.name)
    ok, reason = be.supports_model(layers)
    if not ok:
        raise ValueError(f"cannot run the reference model: {reason}")
    cfg = compiled.config
    config = api.EncodeConfig(
        n_unique=cfg.n_unique, t_m=cfg.t_m, t_n=cfg.t_n,
        t_m_linear=cfg.t_m_linear, rle_params=cfg.rle_params,
        decode_source=cfg.decode_source)
    return api.CompiledModel(engine.CodrModel(layers), None, config, be)
