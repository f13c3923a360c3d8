"""The plain reference of the inception cells: the configuration's
modules and poolings in float64, from the same float weights, biases and
inputs as the program, with the codec's quantization worked out again
here (``bench.reference.cnn``'s ``quantize_weights`` and
``_int_features``).

It follows the lane's stated arithmetic, not the program's code:

* ``smm_kernel``: the 8-bit feature path.  Each convolution's input is
  quantized symmetric int8 over the whole batch (``amax / 127``
  correctly rounded to float32, round half to even, clip ±127; whole
  numbers within ±127 pass at scale 1) and put on its zero border (SAME
  padding); exact integer sums (float64); the float32 epilogue: the sums
  in float32 times ``float32(weight scale · feature scale)``, plus the
  bias, then ReLU.  A module quantizes its input once: the 1×1
  convolutions take those features and the pool branch max-pools them
  (3×3/1, padding 1).  The pooling between modules pools float32;
* ``tiled``: the float path.  The float32 input times the dequantized
  weights, summed in float64, times the weight scale in float32, plus the
  bias, then ReLU.

A module's branches are concatenated on channels in order: #1x1, #3x3,
#5x5, pool proj.  ``bits`` sets the feature path's width (8 as stated;
4 is the control), ``tf32`` runs the float path's sums in TF32 on the
card.  Imports neither the program nor JAX.
"""
from __future__ import annotations

from bench.generators import inception as gen
from bench.reference.cnn import _int_features, quantize_weights

__all__ = ["nonzero_counts", "forward"]


def nonzero_counts(config: dict, seed: int, device) -> list[int]:
    """Nonzero weights of each convolution after quantization, in launch
    order: what the sparse convolution has to multiply."""
    out = []
    for i in range(len(gen.conv_layers(config))):
        q, _ = quantize_weights(gen.draw_layer(config, seed, i, device),
                                int(config["n_unique"]))
        out.append(int((q != 0).sum()))
    return out


def forward(config: dict, lane: str, seed: int, x, *, bits: int = 8,
            tf32: bool = False):
    """The network's output, float64 NHWC, for an NHWC float32 batch ``x``
    of module inputs; each convolution's weights and bias drawn again from
    ``seed`` as it comes (the whole model never sits beside the
    program's state)."""
    import torch
    import torch.nn.functional as F

    if lane not in ("smm_kernel", "tiled"):
        raise ValueError(f"no reference for lane {lane!r}")
    device = x.device
    layers = gen.conv_layers(config)
    n_unique = int(config["n_unique"])

    def pool(p, h):
        return F.max_pool2d(h, p["window"], p["stride"], p["padding"],
                            ceil_mode=p["ceil_mode"])

    def conv(i, h, feats):
        """Convolution ``i`` on NCHW float32 ``h`` or, on the integer
        lane, on the given features ``(q, scale)``."""
        pad = layers[i]["pad"]
        q_w, w_scale = quantize_weights(
            gen.draw_layer(config, seed, i, device), n_unique)
        bias = gen.draw_bias(config, seed, i, device)
        if lane == "smm_kernel":
            q, x_scale = feats if feats is not None else _int_features(h,
                                                                      bits)
            acc = F.conv2d(F.pad(q, (pad,) * 4).double(), q_w)
            y = acc.to(torch.float32) * torch.tensor(
                w_scale * x_scale, dtype=torch.float32, device=device)
        else:
            hp = F.pad(h, (pad,) * 4)
            acc = (F.conv2d(hp, q_w.float()).double() if tf32 else
                   F.conv2d(hp.double(), q_w))
            y = (acc * w_scale).to(torch.float32)
        y = y + bias[:, None, None]
        return torch.relu(y) if config["activation"] == "relu" else y

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        h = x.to(torch.float32).permute(0, 3, 1, 2)
        for step in gen.plan(config):
            if step[0] == "pool":
                h = pool(step[1], h)
                continue
            shared = _int_features(h, bits) if lane == "smm_kernel" else None
            outs = []
            for branch in step[2]:
                b, feats = h, shared
                for kind, arg in branch:
                    if kind == "pool":
                        if feats is not None:
                            feats = (pool(arg, feats[0]), feats[1])
                        else:
                            b = pool(arg, b)
                    else:
                        b, feats = conv(arg, b, feats), None
                outs.append(b)
            h = torch.cat(outs, dim=1)
        return h.permute(0, 2, 3, 1).double()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
