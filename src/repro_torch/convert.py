"""Carry params and compiled state from the JAX reference package into
the port.

* :func:`compiled_from_reference` takes a ``repro`` ``CompiledModel`` and
  builds a port :class:`~repro_torch.core.api.CompiledModel` that
  executes the very same bitstreams — no re-encoding.
* :func:`params_from_reference` turns a ``repro.models`` params tree,
  given as NumPy arrays, into the port's tree of tensors (same dict
  layout, same paths).
* :func:`compiled_params_from_reference` copies a ``repro``
  ``CompiledParams``' packed leaves (words, table, scale, bits, shape,
  out-features) into a port :class:`~repro_torch.core.api.CompiledParams`
  — no re-encoding.

The reference is read duck-typed (``.model.layers`` and per layer
``.kind``, ``.code``, ...; ``.weight.packed`` / ``.out_features`` /
``.d_model`` on a packed leaf), so nothing of the reference package is
imported here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import api, backends, codr_linear, engine, rle, ucr
from repro_torch.core.serving import TensorReport
from repro_torch.core.tree import map_leaves

__all__ = ["layer_code_from_reference", "compiled_from_reference",
           "params_from_reference", "compiled_params_from_reference"]


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
    return api.CompiledModel(engine.CodrModel(layers), None,
                             _config(compiled.config), be)


def _config(cfg) -> api.EncodeConfig:
    return api.EncodeConfig(
        n_unique=cfg.n_unique, t_m=cfg.t_m, t_n=cfg.t_n,
        t_m_linear=cfg.t_m_linear, rle_params=cfg.rle_params,
        decode_source=cfg.decode_source)


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A NumPy (or array-like) leaf as a tensor on ``device``; bfloat16
    arrays keep their bits."""
    a = np.asarray(a)
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_reference(tree, device=None):
    """The port's params tree for a reference params tree whose leaves
    are NumPy arrays (``jax.tree.map(np.asarray, params)``), on
    ``device`` (the card unless the caller names another)."""
    dev = engine.resolve_device(device)
    return map_leaves(lambda a: _tensor(a, dev), tree)


def compiled_params_from_reference(cp, device=None) -> api.CompiledParams:
    """A port :class:`~repro_torch.core.api.CompiledParams` holding copies
    of a reference ``CompiledParams``' leaves — packed words (as int32
    bit patterns), tables, scales, bits, shapes and out-features as the
    reference encoded them, every other leaf as a tensor — on
    ``device``."""
    dev = engine.resolve_device(device)

    def leaf(x):
        w = getattr(x, "weight", None)
        if w is None or not hasattr(w, "packed"):
            return _tensor(x, dev)
        pw = codr_linear.PackedWeight(
            packed=_tensor(np.asarray(w.packed).view(np.int32), dev),
            table=_tensor(w.table, dev), scale=_tensor(w.scale, dev),
            bits=int(w.bits), shape=tuple(int(d) for d in w.shape))
        if hasattr(x, "out_features"):
            return codr_linear.PackedLinear(pw, int(x.out_features),
                                            x.backend)
        return codr_linear.PackedEmbedding(pw, int(x.d_model), x.backend)

    fields = [f.name for f in dataclasses.fields(TensorReport)]
    return api.CompiledParams(
        map_leaves(leaf, cp.params),
        [TensorReport(**{f: getattr(r, f) for f in fields})
         for r in cp.reports],
        list(cp.packed_paths), list(cp.quantized_paths),
        _config(cp.config), cp.backend, None,
        embed_paths=list(cp.embed_paths))

