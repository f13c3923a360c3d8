"""The CoDR engine's output-tile mesh — the engine part of
``repro.sharding.rules``.

The ``sharded`` backend (:class:`repro_torch.core.backends.ShardedBackend`)
partitions each layer's decoded tile stack over one axis,
:data:`ENGINE_TILE_AXIS`, the output-tile axis of the CoDR loop nest.
The port's mesh is single-process, as JAX's single-controller mesh is: a
1-D tuple of :class:`torch.device`, position i holding shard i.

* :func:`tile_mesh` builds it: every card ``torch.cuda.device_count()``
  reports by default, or ``(cpu,)`` when the caller asks for the CPU.
* A mesh may name one device more than once.  That is the port's
  counterpart of ``XLA_FLAGS=--xla_force_host_platform_device_count=N``:
  the CPU tests and a single H100 run the partitioning at D = 2, 3 or 4
  over one physical device, each shard one more dispatch on it.
* :func:`shard_leading` zero-pads an array's leading axis to a multiple
  of D and places slice i on device i.

The model half of the reference module (``ShardCtx``, ``use_ctx``,
``maybe_constrain``, ``param_spec``, ``named_sharding_tree``) is not
here: it waits for ROADMAP "A10, model half".
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import resolve_device

__all__ = ["ENGINE_TILE_AXIS", "tile_mesh", "pad_to_multiple",
           "shard_leading"]

# the CoDR engine's output-tile model-parallel axis (sharded backend)
ENGINE_TILE_AXIS = "tile"


def tile_mesh(devices=None, *, device=None) -> tuple[torch.device, ...]:
    """1-D mesh over ``devices`` (repeats allowed).  With ``devices``
    ``None`` the mesh follows ``device``: every card for the card (the
    default; raises when there is none), ``(cpu,)`` for the CPU.  One
    device is a valid 1-element mesh, the single-device fallback."""
    if devices is not None:
        mesh = tuple(torch.device(d) for d in devices)
        if not mesh:
            raise ValueError("a tile mesh needs at least one device")
        return mesh
    dev = resolve_device(device)
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of ``k`` that is >= ``n`` (>= k for n == 0)."""
    return max(-(-n // k), 1) * k


def shard_leading(x, mesh) -> tuple[torch.Tensor, ...]:
    """``x`` (array or tensor) split over its leading axis, slice i on
    ``mesh[i]``.  The leading axis is zero-padded up to a multiple of
    the mesh size first (a ragged tile stack still shards; the pad rows
    compute zeros the caller crops away), so any ``n >= 1`` works on any
    device count.  Returns the D shards, each ``(n_pad / D, ...)``."""
    x = torch.as_tensor(x)
    d = len(mesh)
    pad = pad_to_multiple(x.shape[0], d) - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return tuple(part.to(dev).contiguous()
                 for part, dev in zip(torch.chunk(x, d), mesh))
