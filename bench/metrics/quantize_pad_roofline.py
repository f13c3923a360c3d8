"""quantize_pad_roofline: percent of its roofline that the
``int8_features`` kernel ``quantize_pad`` reached: Σ bound ÷ Σ measured
device time over the launches the trace recorded.

A request launches one ``quantize_pad`` for each convolution whose input
has a zero border (``pad`` in ``run.shapes["layers"]``), in layer order;
a request whose trace lost any of them drops from both sums.  The bound
of a launch is its bytes over the memory rate (it does a handful of
operations an element): the float32 input once, ``B · N · (RI - 2 pad)
· (CI - 2 pad)`` values, and the float32 features on their border once,
``B · N · RI · CI`` values (what ``smm_conv`` takes)."""
import re

from bench.roofline import bound_s

QUANTIZE_PAD = re.compile(r"int8_features_quantize_pad_kernel")


def request_bound_s(shapes) -> float:
    total = 0.0
    for layer in shapes["layers"]:
        pad = layer.get("pad", 0)
        if pad:
            values = shapes["batch"] * layer["n"] * (
                (layer["ri"] - 2 * pad) * (layer["ci"] - 2 * pad)
                + layer["ri"] * layer["ci"])
            total += bound_s(4.0 * values, 0.0, "int8")
    return total


def read(run):
    if run.trace is None or not run.shapes.get("layers"):
        return None
    n_padded = sum(1 for layer in run.shapes["layers"] if layer.get("pad"))
    if not n_padded:
        return None
    per_req = request_bound_s(run.shapes)
    groups = run.trace.by_group()
    bound = measured = 0.0
    for g in run.trace.in_groups("request"):
        launches = [o for o in groups.get(g, [])
                    if QUANTIZE_PAD.search(o.name)]
        if len(launches) != n_padded:
            continue
        bound += per_req
        measured += sum(o.end - o.start for o in launches) / 1e6
    return 100.0 * bound / measured if measured > 0 else None
