"""Elastic mesh management — the port's copy of ``repro.runtime.elastic``:
rebuild the device mesh after host loss (or growth) and re-shard state
from the latest checkpoint.

Policy: the mesh data axis must divide the global batch; on host loss we
pick the largest feasible (data, model) grid from the surviving chip
count, preferring to shrink ``data`` (keeps TP intact — model-axis
collectives are latency-critical) and re-spliting the per-host batch.
State flows through :class:`repro_torch.checkpoint.CheckpointManager`:
host-side numpy leaves are re-placed on the new mesh's devices (no
resharding collectives needed — the filesystem is the exchange medium,
which is also the fault-tolerance path).

The grid arithmetic is the reference's line for line (NumPy).  Where the
reference builds a ``jax.sharding.Mesh`` with axes ``("data", "model")``,
:meth:`ElasticMeshManager.make_mesh` returns the ``(data, model)`` NumPy
object array of :class:`torch.device` it would be built over.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.sharding.rules import tile_mesh


@dataclasses.dataclass
class HostSet:
    """Logical fleet state (control-plane view)."""
    n_hosts: int
    chips_per_host: int
    healthy: np.ndarray          # bool mask

    @property
    def healthy_chips(self) -> int:
        return int(self.healthy.sum()) * self.chips_per_host


def feasible_grid(chips: int, *, model_parallel: int,
                  global_batch: int) -> tuple[int, int]:
    """Largest (data, model) grid with data·model ≤ chips, model fixed,
    data dividing global_batch."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, got "
                         f"{model_parallel}")
    if chips < model_parallel:
        raise ValueError(
            f"no feasible grid: {chips} surviving chip(s) cannot host "
            f"even one model-parallel group of {model_parallel} (the "
            f"model axis is fixed; recover hosts or lower "
            f"model_parallel)")
    data = chips // model_parallel
    while data > 0 and global_batch % data:
        data -= 1
    if data == 0:
        raise ValueError(
            f"no feasible grid: chips={chips} model={model_parallel} "
            f"batch={global_batch} — no data-axis size ≤ "
            f"{chips // model_parallel} divides the global batch")
    return data, model_parallel


class ElasticMeshManager:
    def __init__(self, hosts: HostSet, *, model_parallel: int,
                 global_batch: int):
        self.hosts = hosts
        self.model_parallel = model_parallel
        self.global_batch = global_batch

    def mark_failed(self, host_id: int) -> None:
        self.hosts.healthy[host_id] = False

    def mark_recovered(self, host_id: int) -> None:
        self.hosts.healthy[host_id] = True

    def current_grid(self) -> tuple[int, int]:
        return feasible_grid(self.hosts.healthy_chips,
                             model_parallel=self.model_parallel,
                             global_batch=self.global_batch)

    def make_mesh(self, devices=None) -> np.ndarray:
        """The current grid's devices as a ``(data, model)`` object array
        of :class:`torch.device`; ``devices`` defaults to every card
        (raises without one)."""
        data, model = self.current_grid()
        devices = list(devices if devices is not None else tile_mesh())
        need = data * model
        if len(devices) < need:
            raise ValueError(f"need {need} devices, have {len(devices)}")
        arr = np.empty(need, dtype=object)
        arr[:] = devices[:need]
        return arr.reshape(data, model)

    def resume_plan(self, step: int) -> dict:
        """What the control plane executes after a failure."""
        data, model = self.current_grid()
        return {
            "restore_step": step,
            "mesh": (data, model),
            "per_host_batch": self.global_batch // max(data, 1),
            "actions": ["drain-collectives", "rebuild-mesh",
                        "restore-checkpoint", "resume"],
        }
