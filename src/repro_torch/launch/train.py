"""End-to-end training entry point — the port's ``repro.launch.train``, with
the reference's flags word for word and its printed lines.

  PYTHONPATH=src python -m repro_torch.launch.train [--arch qwen2.5-3b]
      [--steps 200] [--batch 8] [--seq 128] [--ckpt-dir DIR] [--resume]
      [--fail-at STEP] [--lr 3e-3]

Trains on the card (without one :func:`run_train` raises; the CPU tests
call ``run_train(device="cpu")``).  As in the reference, ``--smoke`` is
``store_true`` with ``default=True``, so the CLI always trains the
arch's smoke variant (ROADMAP caveat C-ref4); :func:`run_train` with
``smoke=False`` trains the full config.

Fault tolerance: the loop checkpoints every ``steps // 4`` steps
(atomic, async) and ``--resume`` restores the latest checkpoint, the
data cursor included, so a killed run continues from its last
checkpoint on the same batches.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.engine import resolve_device
from repro_torch.core.tree import leaves
from repro_torch.data import DataConfig, host_batch_iterator
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import TrainLoop, TrainLoopConfig

__all__ = ["run_train", "main"]


def run_train(*, arch: str = "qwen2.5-3b", smoke: bool = True,
              steps: int = 200, batch: int = 8, seq: int = 128,
              ckpt_dir: str | None = None, resume: bool = False,
              fail_at: int | None = None, lr: float = 3e-3, seed: int = 0,
              device=None) -> dict:
    """One training run as the CLI makes it: params from ``seed`` on
    ``device`` (the card unless the caller names another), the synthetic
    data pipeline, AdamW without a master copy, checkpoints every
    ``steps // 4`` steps into ``ckpt_dir``.  Returns the loop's history
    and the two printed means."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_variant(cfg)
    api = get_model(cfg)
    params = api.init_params(torch.Generator(dev).manual_seed(seed), cfg)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M")

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch,
                      frontend=cfg.frontend
                      or ("audio" if cfg.family == "encdec" else None),
                      frontend_seq=cfg.frontend_seq or seq,
                      d_model=cfg.d_model)
    loop = TrainLoop(
        train_loss_fn=lambda p, b: api.train_loss(p, b, cfg),
        params=params,
        batch_iter=host_batch_iterator(dcfg),
        opt_cfg=AdamWConfig(lr=lr, use_master=False),
        loop_cfg=TrainLoopConfig(
            total_steps=steps, checkpoint_every=max(steps // 4, 1),
            ckpt_dir=ckpt_dir or os.path.join(tempfile.gettempdir(),
                                              "repro_ckpt"),
            peak_lr=lr, fail_at_step=fail_at))
    if resume:
        start = loop.try_restore()
        print(f"resumed from step {start}")
    hist = loop.run()
    first = np.mean([h["loss"] for h in hist[:10]])
    last = np.mean([h["loss"] for h in hist[-10:]])
    print(f"steps={len(hist)} loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return {"history": hist, "first": float(first), "last": float(last),
            "n_params": n_params, "loop": loop}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a failure at this step (FT demo)")
    ap.add_argument("--lr", type=float, default=3e-3)
    args = ap.parse_args(argv)
    run_train(arch=args.arch, smoke=args.smoke, steps=args.steps,
              batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
              resume=args.resume, fail_at=args.fail_at, lr=args.lr)


if __name__ == "__main__":
    main()
