"""The plain reference of the CNN cells: the configuration's conv chain in
float64, from the same float weights and images as the program, with the
codec's quantization worked out again here.

It follows the lane's stated arithmetic, not the program's code:

* weights: symmetric int8 per tensor (``scale = float32(amax / 127)``,
  round half to even, clip to ±127), then restricted to U levels
  including zero (the paper's U knob: a uniform re-quantization of the
  int8 grid that keeps 0 exactly 0);
* ``smm_kernel``: the 8-bit feature path.  Each layer's input is
  quantized symmetric int8 over the whole batch (``scale = amax / 127``
  correctly rounded to float32, round half to even, clip ±127), unless
  it is whole numbers within ±127 already; integer products summed
  exactly (in float64); the float32 epilogue: the sums times the product
  of the two scales, in float32; then bias-free ReLU.  The next layer
  quantizes that float32 output again, so a scale that another rounding
  moves by one unit in the last place moves int8 features and cascades
  through the later layers: the cell's limit leaves room for that;
* ``tiled``: the float path.  The float32 input times the dequantized
  weights, summed in float64, then ReLU.

The chain runs block by block (``bench.generators.cnn.blocks``): each
block's input on its zero border, VALID convolutions inside it, and the
2x2 max pooling after it.

``bits`` sets the feature path's width (8 as stated; 4 is the control),
``tf32`` runs the float path in TF32 on the card (the control).  Imports
neither the program nor JAX.
"""
from __future__ import annotations

__all__ = ["quantize_weights", "nonzero_counts", "forward"]


def quantize_weights(w, n_unique: int):
    """``(q, scale)``: the int-valued float64 weights the codec keeps for
    float weights ``w`` under a U budget, and the float32 scale (a
    Python float)."""
    import numpy as np
    import torch
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


def nonzero_counts(config: dict, seed: int, device) -> list[int]:
    """Nonzero weights of each layer after quantization: what the
    sparse convolution has to multiply."""
    from bench.generators.cnn import draw_layer
    out = []
    for i in range(len(config["conv_layers"])):
        q, _ = quantize_weights(draw_layer(config, seed, i, device),
                                int(config["n_unique"]))
        out.append(int((q != 0).sum()))
    return out


def _int_features(x, bits: int):
    """The feature path's quantization of a float32 batch: ``(q, scale)``
    with ``x ≈ q · scale``, ``|q| <= 2**(bits-1) - 1``."""
    import numpy as np
    import torch
    top = 2 ** (bits - 1) - 1
    amax = np.float32(x.abs().max().item())
    if bool((x == torch.round(x)).all()) and amax <= top:
        return x, 1.0
    scale = amax / np.float32(top) if amax > 0 else np.float32(1.0)
    q = torch.clamp(torch.round(x / torch.tensor(scale, device=x.device)),
                    -top, top)
    return q, float(scale)


def forward(config: dict, lane: str, weights, x, *, bits: int = 8,
            tf32: bool = False):
    """The chain's output, float64 NHWC, for an NHWC float32 batch ``x``
    on the first block's border.  ``weights`` yields each layer's float32 weights in order (drawn again
    layer by layer, so that the whole model never has to sit beside the
    program's state)."""
    import torch
    import torch.nn.functional as F

    from bench.generators.cnn import blocks
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = bool(tf32)
    weights = iter(weights)
    try:
        h = x.to(torch.float32)           # the first block's border included
        for k, blk in enumerate(blocks(config)):
            if k and blk["border"]:
                p = blk["border"]
                h = F.pad(h, (0, 0, p, p, p, p))
            h = _block(config, lane, blk, weights, h, bits, tf32)
            if blk["pool"]:
                h = F.max_pool2d(h.permute(0, 3, 1, 2), blk["pool"]
                                 ).permute(0, 2, 3, 1)
        return h.double()
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _block(config, lane, blk, weights, h, bits, tf32):
    """One block's VALID convolutions on a float32 NHWC batch."""
    import torch
    import torch.nn.functional as F
    for i in blk["layers"]:
        stride = config["conv_layers"][i][4]
        q, w_scale = quantize_weights(next(weights), int(config["n_unique"]))
        if lane == "smm_kernel":
            xi, x_scale = _int_features(h, bits)
            acc = F.conv2d(xi.permute(0, 3, 1, 2).double(), q, stride=stride)
            # the float32 epilogue the lane states: the integer sums,
            # exact, times the two scales' product in float32
            y = acc.to(torch.float32) * torch.tensor(
                w_scale * x_scale, dtype=torch.float32, device=acc.device)
        elif lane == "tiled":
            if tf32:
                acc = F.conv2d(h.permute(0, 3, 1, 2), q.float(),
                               stride=stride).double()
            else:
                acc = F.conv2d(h.permute(0, 3, 1, 2).double(), q,
                               stride=stride)
            y = (acc * w_scale).to(torch.float32)
        else:
            raise ValueError(f"no reference for lane {lane!r}")
        if config["activation"] == "relu":
            y = torch.relu(y)
        h = y.permute(0, 2, 3, 1)
        del acc, q
    return h
