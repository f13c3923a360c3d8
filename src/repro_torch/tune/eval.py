"""Compression-quality eval harness — the port's copy of
``repro.tune.eval``: every knob gets a measured number.

Quality here is *agreement with the dense oracle*, not task accuracy —
no pretrained checkpoints ship offline (docs/DESIGN.md §6), so the
reproduction target is how far the compressed execution drifts from the
uncompressed forward at each bits/weight point:

* **CNN lane** (:func:`cnn_quality`): top-1 logit agreement and mean
  absolute / relative logit error of ``CompiledModel.run`` vs
  ``CompiledModel.reference`` on a fixed input batch.
* **Transformer lane** (:func:`transformer_quality`): perplexity proxy —
  mean absolute logit error and argmax (next-token) agreement of the
  packed forward vs the dense forward over the ``configs/`` smoke zoo.
* **Pareto curves** (:func:`pareto_curve`): quality-vs-bits/weight for a
  sweep of global U budgets plus any tuned plans, the Fig. 6 U-sweep
  with a quality axis attached.

Models compile and run on the card unless the caller passes
``device="cpu"``; the agreement numbers are computed in NumPy on the
host from the outputs, as the reference computes them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.api import CompiledModel, EncodeConfig, ModelSpec, compile
from repro_torch.core.serving import _host

__all__ = ["eval_batch", "cnn_quality", "pareto_curve",
           "transformer_quality"]


def eval_batch(spec: ModelSpec, input_hw: tuple[int, int],
               batch: int = 8, seed: int = 0) -> np.ndarray:
    """A deterministic NHWC (or ``(B, N)`` for linear-first specs) eval
    batch shaped for the spec's first layer."""
    rng = np.random.default_rng(seed)
    first = spec.layers[0]
    if first.kind == "conv":
        ri, ci = input_hw
        shape = (batch, ri, ci, first.in_features)
    else:
        shape = (batch, first.in_features)
    return rng.normal(size=shape).astype(np.float32)


def cnn_quality(compiled: CompiledModel, x: np.ndarray) -> dict:
    """Logit agreement of the compressed forward vs the dense oracle."""
    y = _host(compiled.run(x))
    ref = _host(compiled.reference(x))
    y2 = y.reshape(y.shape[0], -1)
    ref2 = ref.reshape(ref.shape[0], -1)
    denom = float(np.linalg.norm(ref2)) or 1.0
    return {
        "top1_match": float(np.mean(np.argmax(y2, -1) == np.argmax(ref2, -1))),
        "mean_abs_logit_err": float(np.abs(y2 - ref2).mean()),
        "rel_logit_err": float(np.linalg.norm(y2 - ref2)) / denom,
    }


def _point(tag: str, compiled: CompiledModel,
           input_hw: tuple[int, int], x: np.ndarray) -> dict:
    sram = sum(acc.total_sram for _, acc in
               compiled.sram_report(input_hw, per_layer_tiling=True))
    return {"tag": tag,
            "bits_per_weight": compiled.bits_per_weight(),
            "sram_accesses": float(sram),
            "config": compiled.config.metadata(),
            **cnn_quality(compiled, x)}


def pareto_curve(spec: ModelSpec, input_hw: tuple[int, int], *,
                 n_uniques=(8, 16, 32, 64, 256),
                 base: EncodeConfig | None = None,
                 plans: dict | None = None,
                 batch: int = 8, seed: int = 0,
                 backend: str = "tiled", device=None) -> list[dict]:
    """Quality-vs-bits/weight curve: one point per global U budget, plus
    one per named tuned plan (``plans={tag: TunePlan}``).  Every point
    carries measured bits/weight, measured per-layer-tiling SRAM
    accesses, and the :func:`cnn_quality` agreement numbers."""
    base = EncodeConfig() if base is None else base
    x = eval_batch(spec, input_hw, batch=batch, seed=seed)
    points = []
    for u in n_uniques:
        cfg = dataclasses.replace(base, n_unique=int(u))
        compiled = compile(spec, cfg, backend=backend, device=device)
        points.append(_point(f"U{u}", compiled, input_hw, x))
    for tag, plan in (plans or {}).items():
        compiled = compile(spec, base, backend=backend, plan=plan,
                           device=device)
        points.append(_point(tag, compiled, input_hw, x))
    return points


def transformer_quality(arch: str, *, plan=None,
                        config: EncodeConfig | None = None,
                        backend: str = "tiled",
                        batch: int = 2, prompt_len: int = 8,
                        seed: int = 0, device=None) -> dict:
    """Perplexity proxy for one ``configs/`` zoo arch: mean absolute
    logit error + next-token argmax agreement of the packed prefill vs
    the dense prefill on the smoke variant, its weights, tokens and (for
    a frontend or encoder-decoder model) the stub prefix drawn from a
    ``torch.Generator`` seeded ``seed`` on ``device``.
    ``backend="tiled"`` is the bit-exact decode-then-matmul lane; pass
    ``"codr_matmul"`` to measure through the fused kernel instead."""
    import repro_torch.api as codr
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.engine import resolve_device
    from repro_torch.models import get_model

    cfg = smoke_variant(get_config(arch))
    dev = resolve_device(device)
    api = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = api.init_params(gen, cfg)
    config = EncodeConfig(n_unique=16) if config is None else config

    cp = codr.compile_params(params, config, backend=backend, plan=plan,
                             device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=dev)
    batch_in = {"tokens": tokens}
    if cfg.frontend or cfg.family == "encdec":
        batch_in["prefix"] = torch.randn(
            (batch, cfg.frontend_seq, cfg.d_model), generator=gen,
            device=dev)
    dense_logits, _ = api.prefill(params, batch_in, cfg)
    packed_logits, _ = api.prefill(cp.params, batch_in, cfg)
    d = _host(dense_logits)
    p = _host(packed_logits)
    return {
        "arch": arch,
        "bits_per_weight": cp.bits_per_weight(),
        "hbm_mb": cp.hbm_bytes() / 1e6,
        "mean_abs_logit_err": float(np.abs(d - p).mean()),
        "argmax_agreement": float(np.mean(
            np.argmax(d[:, -1], -1) == np.argmax(p[:, -1], -1))),
        "n_packed": len(cp.packed_paths),
    }
