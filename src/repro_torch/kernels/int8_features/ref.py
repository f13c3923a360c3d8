"""Plain PyTorch versions of the ``smm_kernel`` lane's 8-bit feature path
and its epilogue: what the CUDA kernels of :mod:`.ops` compute, in
ordinary tensor ops.  The CPU path of :mod:`.ops` and the yardstick the
kernels are held to on the card.

* :func:`int8_features_plain` (:func:`feature_scale_plain`, then
  :func:`quantize_plain`) — symmetric int8 over the whole batch:
  ``scale`` = 1 where ``x`` is whole numbers within ±127, else ``amax /
  127`` correctly rounded to float32 (1 where ``amax`` is not > 0); ``q`` =
  ``clamp(round(x / scale), -127, 127)``, round half to even: the numbers
  of ``repro.core.backends._int_activations``; a ``pad`` puts the
  features on a zero border (SAME padding, which the JAX package's engine
  does not have).  Nothing reaches the host.
* :func:`max_pool_plain` — ``F.max_pool2d`` (no indices kept).
* :func:`epilogue_plain` — ``backends._finish(layer, y.permute(0, 2, 3, 1)
  * s)`` with ``s`` = float32(layer scale · scale), the product taken in
  double as the host takes it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["feature_scale_plain", "quantize_plain", "int8_features_plain",
           "max_pool_plain", "epilogue_plain"]


def feature_scale_plain(x: torch.Tensor) -> torch.Tensor:
    """The scale of NHWC float32 features ``x``, a one-element float32
    tensor on ``x``'s device: 1 where ``x`` is whole numbers within ±127,
    else ``amax / 127`` correctly rounded (1 where ``amax`` is not > 0)."""
    amax = x.abs().max()
    exact = (x == torch.round(x)).all() & (amax <= 127)
    # a divisor on the device: a host scalar would let CUDA multiply by
    # its reciprocal, one unit in the last place off amax / 127
    scale = torch.where(exact | ~(amax > 0), torch.ones_like(amax),
                        amax / torch.full_like(amax, 127.0))
    return scale.reshape(1)


def quantize_plain(x: torch.Tensor, scale: torch.Tensor, pad: int = 0
                   ) -> torch.Tensor:
    """``clamp(round(x / scale), -127, 127)`` of NHWC ``x`` as contiguous
    NCHW ``(B, C, H + 2 pad, W + 2 pad)``, on a zero border of ``pad``
    pixels."""
    q = torch.clamp(torch.round(x / scale), -127, 127).permute(0, 3, 1, 2)
    return (F.pad(q, (pad,) * 4) if pad else q).contiguous()


def int8_features_plain(x: torch.Tensor, pad: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` NHWC ``(B, H, W, C)`` → ``(q, scale)``: ``q`` the integer-
    valued float32 features as contiguous NCHW ``(B, C, H + 2 pad, W + 2
    pad)`` on a zero border, ``scale`` a one-element float32 tensor on
    ``x``'s device (``x ≈ q · scale``)."""
    x = x.to(torch.float32)
    scale = feature_scale_plain(x)
    return quantize_plain(x, scale, pad), scale


def max_pool_plain(x: torch.Tensor, window: int, stride: int, padding: int,
                   ceil_mode: bool) -> torch.Tensor:
    """``F.max_pool2d`` of NCHW ``x``, contiguous NCHW."""
    return F.max_pool2d(x, window, stride, padding,
                        ceil_mode=ceil_mode).contiguous()


def epilogue_plain(y: torch.Tensor, x_scale: torch.Tensor,
                   layer_scale: float, bias: torch.Tensor | None,
                   relu: bool) -> torch.Tensor:
    """``y`` NCHW ``(B, M, RO, CO)`` accumulators → NHWC ``(B, RO, CO, M)``
    (NCHW storage): ``y · s`` (+ ``bias``), ReLU if ``relu``."""
    s = (x_scale.to(torch.float64) * layer_scale).to(torch.float32)
    out = y.permute(0, 2, 3, 1) * s
    if bias is not None:
        out = out + bias
    return torch.relu(out) if relu else out
