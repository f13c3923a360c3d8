"""Plain reference of GoogLeNet's inception stages: Szegedy et al., "Going
Deeper with Convolutions", arXiv:1409.4842, Table 1.  Plain ``torch`` in
float64, on the CPU or the card; it imports no kernel, codec or engine of
the port, and no JAX.

A network is a list of steps (:class:`Conv`, :class:`Pool`,
:class:`Module`) on an NHWC float32 batch.  An inception module on ``x``::

    b1 = relu(conv1x1(x))                        # "#1x1"
    b2 = relu(conv3x3_pad1(relu(conv1x1(x))))    # "#3x3 reduce", "#3x3"
    b3 = relu(conv5x5_pad2(relu(conv1x1(x))))    # "#5x5 reduce", "#5x5"
    b4 = relu(conv1x1(maxpool3x3_s1_pad1(x)))    # "pool proj"
    y  = concat_channels(b1, b2, b3, b4)

Each convolution has a bias and a ReLU.  :func:`forward` repeats a lane's
stated arithmetic, not the port's code:

* weights: symmetric int8 per tensor (``scale = float32(amax / 127)``,
  round half to even, clip ±127), restricted to U levels including zero
  (:func:`quantize_weights`; CoDR's U knob);
* ``lane="smm_kernel"`` (and ``"smm"``): the 8-bit feature path.  Each
  convolution's input is quantized per tensor, symmetric int8 at ``amax /
  127`` correctly rounded to float32 (whole numbers within ±127 pass
  unchanged at scale 1) and put on its zero border (SAME padding: the
  border changes neither amax nor the whole-number test); the integer
  sums are exact (float64); the float32 epilogue multiplies the sums, cast
  to float32, by ``float32(weight scale · feature scale)``, adds the
  bias, then ReLU.  A module quantizes its input once: its 1×1
  convolutions take those features and its pool branch max-pools them
  (for ``x`` ≥ 0 this is quantizing the pooled tensor, since the pooling
  keeps amax and rounding is monotone);
* ``lane="tiled"``: the float path.  Each convolution is the float32
  input times the dequantized weights, summed in float64 (TF32 off),
  times the weight scale, cast to float32; then the bias and ReLU.

Poolings between modules pool the float32 tensor.  ``bits`` narrows the
feature path (4: the benchmark's control).

Departures from the paper: the weights are quantized and CoDR-coded
(U levels) where the paper's are float; the features are int8 on the
integer lanes; the pool branch pools int8 features there (above); the
3×3/2 max pooling between stages rounds its output size up (``ceil_mode``,
28 → 14, as the authors' Caffe model does: Table 1 gives the sizes only);
no LRN.  The 5×5 convolutions are kept as published (torchvision's
GoogLeNet has 3×3 there).  Which stages run, and the weights and inputs
(random, from a seed), are the caller's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Conv", "Pool", "Module", "inception_module", "quantize_weights",
           "int_features", "forward"]


class Conv(NamedTuple):
    """A convolution: float32 OIHW ``weight``, ``bias`` ``(M,)`` or
    ``None``, ``padding`` zero pixels each side, ``stride``, a ReLU after
    it where ``relu``."""

    weight: torch.Tensor
    bias: torch.Tensor | None = None
    padding: int = 0
    stride: int = 1
    relu: bool = True


class Pool(NamedTuple):
    """A max pooling, as ``F.max_pool2d``'s arguments."""

    window: int
    stride: int
    padding: int = 0
    ceil_mode: bool = False


class Module(NamedTuple):
    """Branches of :class:`Conv` / :class:`Pool` steps on one input, their
    outputs concatenated on channels in order."""

    branches: tuple


def inception_module(w1, w3r, w3, w5r, w5, wp) -> Module:
    """Table 1's module from its six convolutions (each a
    ``(weight, bias)`` pair): #1x1, #3x3 reduce, #3x3 (padding 1), #5x5
    reduce, #5x5 (padding 2), pool proj after a 3×3/1 max pooling of
    padding 1."""
    return Module((
        (Conv(*w1),),
        (Conv(*w3r), Conv(*w3, padding=1)),
        (Conv(*w5r), Conv(*w5, padding=2)),
        (Pool(3, 1, 1), Conv(*wp)),
    ))


def quantize_weights(w: torch.Tensor, n_unique: int):
    """``(q, scale)``: the int-valued float64 weights the codec keeps for
    float weights ``w`` under a U budget, and the float32 scale (a Python
    float)."""
    amax = np.float32(w.abs().max().item())
    scale = np.float32(amax / 127.0) if amax > 0 else np.float32(1.0)
    q = torch.clamp(torch.round(w / torch.tensor(scale, device=w.device)),
                    -127, 127)
    if n_unique < 256:
        step = -(-256 // (n_unique - 1))
        qi = q.to(torch.int32)
        r = torch.div(qi + 128, step, rounding_mode="floor") * step \
            - 128 + step // 2
        q = torch.where(qi == 0, 0, torch.clamp(r, -127, 127)).to(q.dtype)
    return q.to(torch.float64), float(scale)


def int_features(x: torch.Tensor, bits: int = 8):
    """The feature path's quantization of a float32 tensor: ``(q, scale)``
    with ``x ≈ q · scale``, ``|q| <= 2**(bits-1) - 1``, ``scale`` a Python
    float."""
    top = 2 ** (bits - 1) - 1
    amax = np.float32(x.abs().max().item())
    if bool((x == torch.round(x)).all()) and amax <= top:
        return x, 1.0
    scale = amax / np.float32(top) if amax > 0 else np.float32(1.0)
    q = torch.clamp(torch.round(x / torch.tensor(scale, device=x.device)),
                    -top, top)
    return q, float(scale)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _pool(p: Pool, x: torch.Tensor) -> torch.Tensor:
    """Max pooling of NCHW ``x``."""
    return F.max_pool2d(x, p.window, p.stride, p.padding,
                        ceil_mode=p.ceil_mode)


def _epilogue(c: Conv, y: torch.Tensor) -> torch.Tensor:
    """NCHW float32 ``y`` + bias, then ReLU."""
    if c.bias is not None:
        y = y + c.bias.to(y.device, torch.float32)[:, None, None]
    return torch.relu(y) if c.relu else y


def _conv_int(c: Conv, q: torch.Tensor, x_scale: float, n_unique: int):
    """``c`` on NCHW int features ``q`` (border included): exact sums, the
    float32 epilogue."""
    wq, w_scale = quantize_weights(c.weight, n_unique)
    acc = F.conv2d(q.double(), wq, stride=c.stride)
    s = torch.tensor(w_scale * x_scale, dtype=torch.float32,
                     device=acc.device)
    return _epilogue(c, acc.to(torch.float32) * s)


def _conv_float(c: Conv, x: torch.Tensor, n_unique: int):
    """``c`` on NCHW float32 ``x``: float64 sums of the dequantized
    weights' integers, times the scale, in float32."""
    wq, w_scale = quantize_weights(c.weight, n_unique)
    x = F.pad(x, (c.padding,) * 4).double()
    acc = F.conv2d(x, wq, stride=c.stride)
    return _epilogue(c, (acc * w_scale).to(torch.float32))


def _features(x: torch.Tensor, pad: int, bits: int):
    """NCHW float32 ``x`` → (NCHW int features on a ``pad`` border,
    scale)."""
    q, s = int_features(x, bits)
    return F.pad(q, (pad,) * 4), s


def _branch(steps, x, feats, lane, n_unique, bits):
    """One branch on NCHW float32 ``x``, whose int features (integer
    lanes) are ``feats``."""
    for st in steps:
        if isinstance(st, Pool):
            if feats is not None:
                feats = (_pool(st, feats[0]), feats[1])
            else:
                x = _pool(st, x)
        elif lane == "tiled":
            x = _conv_float(st, x, n_unique)
        else:
            q, s = (_features(x, st.padding, bits) if feats is None
                    else (F.pad(feats[0], (st.padding,) * 4), feats[1]))
            x, feats = _conv_int(st, q, s, n_unique), None
    return x


def forward(steps, x: torch.Tensor, *, lane: str = "smm_kernel",
            n_unique: int = 16, bits: int = 8) -> torch.Tensor:
    """The steps' output, float64 NHWC, for an NHWC float32 batch ``x``,
    in ``lane``'s stated arithmetic (``"smm_kernel"`` / ``"smm"``: the
    8-bit feature path; ``"tiled"``: the float path)."""
    if lane not in ("smm_kernel", "smm", "tiled"):
        raise ValueError(f"no reference for lane {lane!r}")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        h = _nchw(x.to(torch.float32))
        for st in steps:
            if isinstance(st, Pool):
                h = _pool(st, h)
            elif isinstance(st, Module):
                feats = (None if lane == "tiled"
                         else _features(h, 0, bits))
                h = torch.cat([_branch(b, h, feats, lane, n_unique, bits)
                               for b in st.branches], dim=1)
            else:
                h = _branch((st,), h, None, lane, n_unique, bits)
        return _nhwc(h).double()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
