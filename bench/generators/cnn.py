"""The CNN cells' inputs, drawn from the seed on the run's device: the
float weights of every layer and a pool of distinct image batches; and
the chain's geometry, block by block.

Both the program and the plain reference take these; neither makes its
own.  Every draw has a generator of its own, seeded from ``(seed, what,
index)``, so one layer's weights can be drawn again without the others.
Nothing here imports the program.
"""
from __future__ import annotations

__all__ = ["derive", "blocks", "layer_shapes", "draw_layer", "draw_images"]


def derive(seed: int, *keys: int) -> int:
    """A 63-bit generator seed for ``(seed, *keys)``, the same on every
    machine."""
    import numpy as np
    ss = np.random.SeedSequence([int(seed), *[int(k) for k in keys]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def blocks(config: dict) -> list[dict]:
    """The chain's blocks, each run as one model of VALID convolutions:
    ``layers`` (indices into ``conv_layers``), ``plane`` the block's
    input plane, ``border`` the zero pixels around it on each side (one a
    3x3 layer, so the block gives back its plane, as SAME padding would),
    and ``pool`` the max pooling's window and stride after it (0: none,
    the last block).  ``config["blocks"]`` holds the blocks' layer
    counts, ``config["input_hw"]`` the first block's plane."""
    layers, sizes = config["conv_layers"], config["blocks"]
    if sum(sizes) != len(layers):
        raise ValueError(f"blocks {sizes} do not cover {len(layers)} layers")
    plane, first, out = int(config["input_hw"]), 0, []
    for b, n in enumerate(sizes):
        idx = list(range(first, first + n))
        border = sum((layers[i][2] - 1) // 2 for i in idx)
        pool = 2 if b < len(sizes) - 1 else 0
        out.append({"layers": idx, "plane": plane, "border": border,
                    "pool": pool})
        hw = plane + 2 * border
        for i in idx:
            _, _, rk, _, stride = layers[i]
            hw = (hw - rk) // stride + 1
        plane, first = (hw // pool if pool else hw), first + n
    return out


def layer_shapes(config: dict) -> list[dict]:
    """Each conv layer's geometry along the chain: ``m, n, rk, ck,
    stride`` from the configuration, ``ri, ci`` its input plane (its
    block's border included)."""
    out = []
    for blk in blocks(config):
        ri = ci = blk["plane"] + 2 * blk["border"]
        for i in blk["layers"]:
            m, n, rk, ck, stride = config["conv_layers"][i]
            out.append({"m": m, "n": n, "rk": rk, "ck": ck,
                        "stride": stride, "ri": ri, "ci": ci})
            ri, ci = (ri - rk) // stride + 1, (ci - ck) // stride + 1
    return out


def draw_layer(config: dict, seed: int, index: int, device):
    """Layer ``index``'s float32 weights ``(M, N, RK, CK)`` on ``device``:
    Gaussian times ``weight_scale``, each weight kept with probability
    ``density`` (the paper's sparse random weights)."""
    import torch
    m, n, rk, ck, _ = config["conv_layers"][index]
    g = torch.Generator(device=device).manual_seed(derive(seed, 1, index))
    w = torch.randn((m, n, rk, ck), generator=g, device=device)
    w.mul_(float(config["weight_scale"]))
    drop = torch.rand((m, n, rk, ck), generator=g, device=device) \
        > float(config["density"])
    return w.masked_fill_(drop, 0.0)


def draw_images(config: dict, traffic: dict, seed: int, device) -> list:
    """``traffic["distinct_batches"]`` batches of
    ``traffic["images_per_request"]`` NHWC float32 images whose pixels
    are whole numbers 0 … 255, each on the first block's zero border."""
    import torch
    import torch.nn.functional as F
    hw = int(config["input_hw"])
    p = blocks(config)[0]["border"]
    shape = (int(traffic["images_per_request"]), hw, hw,
             int(config["conv_layers"][0][1]))
    out = []
    for i in range(int(traffic["distinct_batches"])):
        g = torch.Generator(device=device).manual_seed(derive(seed, 2, i))
        x = torch.randint(0, 256, shape, generator=g, device=device
                          ).to(torch.float32)
        out.append(F.pad(x, (0, 0, p, p, p, p)) if p else x)
    return out
