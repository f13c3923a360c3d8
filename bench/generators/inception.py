"""The inception cells' inputs, drawn from the seed on the run's device:
every convolution's float weights and bias, and a pool of distinct
module-input batches; and the network's geometry, step by step.

Both the program and the plain reference take these; neither makes its
own.  Every draw has a generator of its own, seeded from ``(seed, what,
index)`` (``bench.generators.cnn.derive``), so one layer can be drawn
again without the others.  Nothing here imports the program.
"""
from __future__ import annotations

from bench.generators.cnn import derive

__all__ = ["plan", "conv_layers", "layer_shapes", "pool_shapes",
           "draw_layer", "draw_bias", "draw_images"]

# a module's six convolutions in launch order: (width field, kernel,
# padding, input: the module's or the reduce before it)
_MODULE = (("#1x1", 1, 0, None), ("#3x3 reduce", 1, 0, None),
           ("#3x3", 3, 1, "#3x3 reduce"), ("#5x5 reduce", 1, 0, None),
           ("#5x5", 5, 2, "#5x5 reduce"), ("pool proj", 1, 0, None))


def _pool_hw(n: int, p: dict) -> int:
    """Output size of ``F.max_pool2d`` over ``n`` pixels."""
    span = n + 2 * p["padding"] - p["window"]
    o = (-(-span // p["stride"]) if p["ceil_mode"]
         else span // p["stride"]) + 1
    return o - 1 if (o - 1) * p["stride"] >= n + p["padding"] else o


def _modules(config: dict) -> dict:
    """``{module name: {width field: width}}``."""
    fields = config["module_fields"]
    return {row[0]: dict(zip(fields, row)) for row in config["modules"]}


def _out_channels(widths: dict) -> int:
    return sum(int(widths[f]) for f in ("#1x1", "#3x3", "#5x5", "pool proj"))


def conv_layers(config: dict) -> list[dict]:
    """Every convolution in launch order (module by module, branch by
    branch): ``name``, ``module``, ``m``, ``n``, ``k`` (square kernel),
    ``pad`` (zero pixels each side) and ``plane``, its input's side
    before the border."""
    mods = _modules(config)
    hw, c_in, out = int(config["input_hw"]), int(config["input_channels"]), []
    for step in config["steps"]:
        if step == "pool":
            hw = _pool_hw(hw, config["pool"])
            continue
        w = mods[step]
        for field, k, pad, src in _MODULE:
            out.append({"name": f"{step}/{field}", "module": step,
                        "m": int(w[field]), "n": c_in if src is None
                        else int(w[src]), "k": k, "pad": pad, "plane": hw})
        c_in = _out_channels(w)
    return out


def plan(config: dict) -> list:
    """The network as steps: ``("pool", params)`` or ``("module", name,
    branches)``, a branch a list of ``("conv", index into
    conv_layers)`` and ``("pool", params)``: #1x1; #3x3 reduce, #3x3;
    #5x5 reduce, #5x5; the branch pool, pool proj."""
    out, k = [], 0
    for step in config["steps"]:
        if step == "pool":
            out.append(("pool", config["pool"]))
            continue
        i = list(range(k, k + 6))
        out.append(("module", step, [
            [("conv", i[0])], [("conv", i[1]), ("conv", i[2])],
            [("conv", i[3]), ("conv", i[4])],
            [("pool", config["branch_pool"]), ("conv", i[5])]]))
        k += 6
    return out


def layer_shapes(config: dict) -> list[dict]:
    """Each convolution's geometry in launch order, as the CNN readers
    take it: ``m, n, rk, ck, stride`` and ``ri, ci`` its input plane with
    its zero border, and ``pad`` the border."""
    return [{"m": c["m"], "n": c["n"], "rk": c["k"], "ck": c["k"],
             "stride": 1, "ri": c["plane"] + 2 * c["pad"],
             "ci": c["plane"] + 2 * c["pad"], "pad": c["pad"]}
            for c in conv_layers(config)]


def pool_shapes(config: dict) -> list[dict]:
    """Each max pooling's geometry in launch order, one a step (a
    module's pool branch on its input, a pooling between modules): ``c``
    channels, ``hw`` its input plane's side, ``out_hw`` its output's."""
    mods = _modules(config)
    hw, c, out = int(config["input_hw"]), int(config["input_channels"]), []
    for step in config["steps"]:
        p = config["pool"] if step == "pool" else config["branch_pool"]
        out.append({"c": c, "hw": hw, "out_hw": _pool_hw(hw, p)})
        if step == "pool":
            hw = out[-1]["out_hw"]
        else:
            c = _out_channels(mods[step])
    return out


def draw_layer(config: dict, seed: int, index: int, device):
    """Convolution ``index``'s float32 weights ``(M, N, K, K)`` on
    ``device``: Gaussian times ``weight_scale``, each weight kept with
    probability ``density`` (the paper's sparse random weights)."""
    import torch
    c = conv_layers(config)[index]
    shape = (c["m"], c["n"], c["k"], c["k"])
    g = torch.Generator(device=device).manual_seed(derive(seed, 1, index))
    w = torch.randn(shape, generator=g, device=device)
    w.mul_(float(config["weight_scale"]))
    drop = torch.rand(shape, generator=g, device=device) \
        > float(config["density"])
    return w.masked_fill_(drop, 0.0)


def draw_bias(config: dict, seed: int, index: int, device):
    """Convolution ``index``'s float32 bias ``(M,)``: Gaussian times
    ``bias_scale``."""
    import torch
    m = conv_layers(config)[index]["m"]
    g = torch.Generator(device=device).manual_seed(derive(seed, 4, index))
    return torch.randn((m,), generator=g, device=device).mul_(
        float(config["bias_scale"]))


def draw_images(config: dict, traffic: dict, seed: int, device) -> list:
    """``traffic["distinct_batches"]`` batches of
    ``traffic["images_per_request"]`` NHWC float32 module inputs (3a's
    plane and channels): a ReLU of a standard Gaussian."""
    import torch
    hw = int(config["input_hw"])
    shape = (int(traffic["images_per_request"]), hw, hw,
             int(config["input_channels"]))
    out = []
    for i in range(int(traffic["distinct_batches"])):
        g = torch.Generator(device=device).manual_seed(derive(seed, 2, i))
        out.append(torch.randn(shape, generator=g, device=device).relu_())
    return out
