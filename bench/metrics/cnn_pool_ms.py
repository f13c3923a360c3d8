"""cnn_pool_ms: device ms a request of the operations launched on the host
inside a ``codr.pool`` span: the program's own max poolings (a module's
pool branch, the poolings between modules).  Each operation is placed by
its launch's host time, never by its device time, as ``cnn_features_ms``
places it.

Here too :func:`launched_in`, which ``cnn_branch_launches`` reads as
well."""
import bisect

from bench import harness


def launched_in(run, name: str):
    """``(the device operations of the window's requests launched inside
    a span named name, the number of request marks)``; ``None`` where the
    run holds no such span inside a request.  The spans of one name do
    not overlap."""
    sp = harness.load_module("metrics", "cnn_host_reads")
    items = sp.window_spans(run)
    if items is None:
        return None
    items, n = sp.in_requests(run, items)
    spans = sp.named(items, name)
    if not n or not spans:
        return None
    starts = [s for s, _, _ in spans]
    reqs = set(run.trace.in_groups("request"))
    ops = []
    for o in run.trace.ops:
        t = run.trace.launch_ts.get(o.corr)
        if o.group not in reqs or t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            ops.append(o)
    return ops, n


def read(run):
    got = launched_in(run, "codr.pool")
    if got is None:
        return None
    ops, n = got
    return sum(o.end - o.start for o in ops) / 1e3 / n
