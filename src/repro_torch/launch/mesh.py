"""Meshes — the port's ``repro.launch.mesh``.

``make_production_mesh`` gives the reference's production shapes,
(16, 16) over ``("data", "model")`` and (2, 16, 16) over ``("pod",
"data", "model")``, as meta meshes (shape only): the dry-run's.  The
per-card roofline constants are the H100's datasheet peaks, in place of
the reference's TPU v5e figures.

``make_host_mesh`` is the small mesh of the tests and of the card: a
(data, model) mesh over the given devices, or else over the devices of
``device`` (every card; ``cpu`` when the caller asks for the CPU)
repeated until every position has one — so one H100 fills a (2, 2) mesh
with ``cuda:0`` four times.
"""
from __future__ import annotations

import itertools

import numpy as np

from repro_torch.sharding.rules import Mesh, tile_mesh

__all__ = ["make_production_mesh", "make_host_mesh", "PEAK_FLOPS_BF16",
           "HBM_BW", "ICI_BW"]

# NVIDIA H100 80GB HBM3 (SXM5, 700 W) constants used by the rooflines, per
# card.  Datasheet peaks, not measurements.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                # B/s, HBM3
# B/s per NVLink 4 link in one direction: 18 links carry 900 GB/s in both
# directions together, 50 GB/s a link, 25 GB/s each way
ICI_BW = 25e9


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh.meta(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, *, devices=None,
                   device=None) -> Mesh:
    """A (data, model) mesh over ``devices`` (cycled to fill it; repeats
    allowed), by default over the devices of ``device``."""
    pool = list(devices) if devices is not None else list(
        tile_mesh(device=device))
    if not pool:
        raise ValueError("a host mesh needs at least one device")
    fill = list(itertools.islice(itertools.cycle(pool), data * model))
    return Mesh(np.array(fill, dtype=object).reshape(data, model),
                ("data", "model"))
