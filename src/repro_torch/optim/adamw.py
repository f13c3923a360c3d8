"""AdamW with optional fp32 master weights — ``repro.optim.adamw`` on
trees of tensors (mixed-precision training: bf16 params in the forward,
fp32 master and moments in the optimizer state).

The state is ``{"m": tree, "v": tree, "step": int32 0-d tensor}`` plus
``"master"`` (float32 copies of the params) with ``use_master``; its
leaves live on the params' devices.  The arithmetic is the reference's,
element by element in float32: clip by the global norm, the moment
updates, bias correction and the decoupled weight decay.

:func:`adamw_update` returns new trees, as the reference's does.  With
``inplace=True`` it writes the new values into the given params and
state instead and returns those same objects: the train loop's step uses
that, because on the card a 3 B-parameter model's state does not fit
twice (``repro_torch.runtime.loop``).  Each leaf is updated
:data:`CHUNK` elements at a time, so the float32 temporaries stay small
however large a leaf is (a stacked MLP weight of qwen2.5-3b holds 811 M
elements); the update is elementwise, so the chunks change no bit.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tree import leaves, map_leaves

__all__ = ["AdamWConfig", "adamw_init", "clip_by_global_norm",
           "adamw_update", "CHUNK"]

CHUNK = 1 << 24           # elements of a leaf updated at a time


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    use_master: bool = True        # keep fp32 master copy of bf16 params


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments (float32, each on its param's device), step 0 and,
    with ``use_master``, float32 copies of the params."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    first = leaves(params)[0]
    state = {
        "m": map_leaves(zeros, params),
        "v": map_leaves(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }
    if cfg.use_master:
        state["master"] = map_leaves(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def _spans(n: int):
    return [slice(a, min(a + CHUNK, n)) for a in range(0, n, CHUNK)]


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in flatten order) of each leaf's
    float32 sum of squares (a leaf above :data:`CHUNK` elements summed
    chunk by chunk)."""
    total = 0
    for g in leaves(grads):
        flat = g.reshape(-1)
        for sl in _spans(flat.numel()):
            total = total + torch.sum(torch.square(
                flat[sl].to(torch.float32)))
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.minimum(torch.ones_like(gn),
                         max_norm / torch.clamp(gn, min=1e-12))


def clip_by_global_norm(grads, max_norm: float):
    """``(grads as float32 · min(1, max_norm / max(norm, 1e-12)), norm)``."""
    gn = _global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return map_leaves(lambda g: g.to(torch.float32) * scale, grads), gn


def _copy(tree, dtype=None):
    return map_leaves(lambda t: t.detach().to(dtype or t.dtype, copy=True),
                      tree)


def adamw_update(params, grads, state, cfg: AdamWConfig, lr=None, *,
                 inplace: bool = False):
    """Returns ``(new_params, new_state, metrics)``; ``metrics`` holds
    ``grad_norm`` (before clipping) and the new ``step``.  ``lr`` (a
    float or a 0-d tensor, e.g. :func:`~repro_torch.optim.schedule.
    cosine_schedule`'s) defaults to ``cfg.lr``.  ``inplace``: see the
    module docstring."""
    lr = cfg.lr if lr is None else lr
    gn = _global_norm(grads)
    scale = _clip_scale(gn, cfg.grad_clip)
    step = state["step"] + 1
    b1c = 1.0 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1.0 - torch.pow(cfg.b2, step.to(torch.float32))
    keep_master = "master" in state
    if not inplace:            # the same update, on copies
        new_state = {"m": _copy(state["m"]), "v": _copy(state["v"])}
        if cfg.use_master or "master" in state:
            new_state["master"] = _copy(state.get("master", params),
                                        torch.float32)
        params, state = _copy(params), new_state
        keep_master = cfg.use_master
    masters = leaves(state["master"]) if "master" in state else None
    with torch.no_grad():
        for i, (p, g, m, v) in enumerate(zip(
                leaves(params), leaves(grads), leaves(state["m"]),
                leaves(state["v"]))):
            pf, gf, mf, vf = (t.view(-1) for t in (p, g.reshape(-1), m, v))
            wf = masters[i].view(-1) if masters is not None else pf
            for sl in _spans(pf.numel()):
                gc = gf[sl].to(torch.float32) * scale
                new_m = cfg.b1 * mf[sl] + (1 - cfg.b1) * gc
                new_v = cfg.b2 * vf[sl] + (1 - cfg.b2) * gc * gc
                del gc
                p32 = wf[sl].to(torch.float32)
                new_w = p32 - lr * (
                    (new_m / b1c) / (torch.sqrt(new_v / b2c) + cfg.eps)
                    + cfg.weight_decay * p32)
                mf[sl].copy_(new_m)
                vf[sl].copy_(new_v)
                if masters is not None:
                    wf[sl].copy_(new_w)
                pf[sl].copy_(new_w)
    state["step"] = step
    if not keep_master:
        state.pop("master", None)
    return params, state, {"grad_norm": gn, "step": step}
