"""Fault-tolerant training loop — ``repro.runtime.loop`` in PyTorch.

Composes: data pipeline (step-indexed, restart-exact) → train step (loss
and gradients by ``torch.autograd``, the optional bf16 gradient cast,
the cosine schedule and AdamW) → checkpoint manager (async, atomic) →
straggler monitor, with the simulated failure the tests use.  This is
the runtime the launcher (``repro_torch.launch.train``) drives.

The step is eager where the reference jits it.  It updates the params
and the optimizer state in place (``adamw_update(inplace=True)``) and
returns them: at qwen2.5-3b's widths the state does not fit twice on an
80 GB card.  The params' leaves become autograd leaves
(``requires_grad``) on the first step.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, restore_latest
from repro_torch.core.tree import leaves, unflatten_like
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.runtime.straggler import StragglerMonitor

__all__ = ["TrainLoopConfig", "make_train_step", "TrainLoop"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    # the reference's /tmp/repro_ckpt, under the process's temp directory
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    peak_lr: float = 3e-4
    warmup_steps: int = 10
    grad_compression: str | None = None   # None | "bf16"
    fail_at_step: int | None = None       # simulated host failure (tests)


def _batch_on(batch: dict, device: torch.device) -> dict:
    """A host batch (NumPy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(train_loss_fn: Callable, opt_cfg: AdamWConfig,
                    loop_cfg: TrainLoopConfig):
    """The ``(params, opt_state, batch) → (params, opt_state, metrics)``
    step; ``batch`` may be host arrays (moved to the params' device)."""

    def step_fn(params, opt_state, batch):
        p_leaves = leaves(params)
        for p in p_leaves:
            p.requires_grad_(True)
        batch = _batch_on(batch, p_leaves[0].device)
        loss = train_loss_fn(params, batch)
        grads = torch.autograd.grad(loss, p_leaves)
        if loop_cfg.grad_compression == "bf16":
            # the reference casts before the (cross-pod) all-reduce
            grads = [g.to(torch.bfloat16) for g in grads]
        lr = cosine_schedule(opt_state["step"], peak_lr=loop_cfg.peak_lr,
                             warmup_steps=loop_cfg.warmup_steps,
                             total_steps=loop_cfg.total_steps)
        params, opt_state, metrics = adamw_update(
            params, unflatten_like(params, grads), opt_state, opt_cfg,
            lr=lr, inplace=True)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return step_fn


def _world_size() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class TrainLoop:
    def __init__(self, *, train_loss_fn, params, batch_iter,
                 opt_cfg: AdamWConfig | None = None,
                 loop_cfg: TrainLoopConfig | None = None):
        self.loop_cfg = loop_cfg or TrainLoopConfig()
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.params = params
        self.opt_state = adamw_init(params, self.opt_cfg)
        self.batch_iter = batch_iter
        self.ckpt = CheckpointManager(self.loop_cfg.ckpt_dir)
        self.monitor = StragglerMonitor(n_hosts=_world_size())
        self.step_fn = make_train_step(train_loss_fn, self.opt_cfg,
                                       self.loop_cfg)
        self.start_step = 0
        self.history: list[dict] = []

    # -- fault tolerance ----------------------------------------------------
    def try_restore(self) -> int:
        state = {"params": self.params, "opt": self.opt_state}
        restored, extra, step = restore_latest(self.ckpt, state)
        if restored is not None:
            self.params = restored["params"]
            self.opt_state = restored["opt"]
            self.start_step = step + 1
        return self.start_step

    def _save(self, step: int) -> None:
        self.ckpt.save(step, {"params": self.params, "opt": self.opt_state},
                       extra={"data_cursor": step + 1}, async_=True)

    # -- main loop ------------------------------------------------------------
    def run(self, *, max_steps: int | None = None) -> list[dict]:
        cfg = self.loop_cfg
        end = min(cfg.total_steps,
                  self.start_step + (max_steps or cfg.total_steps))
        for step, batch in self.batch_iter:
            if step < self.start_step:
                continue
            if step >= end:
                break
            if cfg.fail_at_step is not None and step == cfg.fail_at_step:
                # the simulated failure kills the *process*, not I/O issued
                # steps ago: join the async writer so the last checkpoint
                # commit isn't racily lost with the in-memory state.
                self.ckpt.wait()
                raise RuntimeError(f"simulated host failure at step {step}")
            t0 = time.monotonic()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            self.monitor.observe(np.array([dt] * max(_world_size(), 1)))
            metrics["step_time_s"] = dt
            metrics["step"] = step
            self.history.append(metrics)
            if step % cfg.checkpoint_every == 0 and step > 0:
                self._save(step)
        self.ckpt.wait()
        return self.history
