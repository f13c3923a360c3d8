"""cnn_elementwise_ms: device ms a request of every operation that is not
a convolution kernel: the int8 feature quantization
(``backends._int_activations``), the epilogue (``backends._finish``),
layout copies; from the trace, over the window's request marks.  The
harness's own max pooling between blocks is left out; its copy into the
next block's bordered input (one a block) stays in."""
from bench.kernel_names import CONV, POOL


def read(run):
    if run.trace is None:
        return None
    reqs = set(run.trace.in_groups("request"))
    if not reqs:
        return None
    us = sum(o.end - o.start for o in run.trace.ops
             if o.group in reqs and not CONV.search(o.name)
             and not POOL.search(o.name))
    return us / 1e3 / len(reqs) if us > 0 else None
