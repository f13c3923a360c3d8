"""cnn_features_ms: device ms a request of the operations launched on the
host inside a ``codr.features`` span: the int8 feature path of
``backends._int_activations`` alone (the abs, the reductions, the integer
test, the scale, round and clamp, the two scalar reads).  Each operation
is placed by its launch's host time, never by its device time."""
import bisect

from bench import harness


def read(run):
    sp = harness.load_module("metrics", "cnn_host_reads")
    items = sp.window_spans(run)
    if items is None:
        return None
    items, n = sp.in_requests(run, items)
    feats = sp.named(items, "codr.features")
    if not n or not feats:
        return None
    starts = [s for s, _, _ in feats]
    reqs = set(run.trace.in_groups("request"))
    us = 0.0
    for o in run.trace.ops:
        t = run.trace.launch_ts.get(o.corr)
        if o.group not in reqs or t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= feats[i][1]:
            us += o.end - o.start
    return us / 1e3 / n
