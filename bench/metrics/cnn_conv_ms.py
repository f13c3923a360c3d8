"""cnn_conv_ms: device ms a request of the convolution kernels:
``smm_conv`` (``sm90`` / ``simt``) on ``smm_kernel``, cuDNN's on
``tiled``; from the trace, over the window's request marks."""
from bench.kernel_names import CONV


def read(run):
    if run.trace is None:
        return None
    reqs = set(run.trace.in_groups("request"))
    if not reqs:
        return None
    us = sum(o.end - o.start for o in run.trace.ops
             if o.group in reqs and CONV.search(o.name))
    return us / 1e3 / len(reqs) if us > 0 else None
