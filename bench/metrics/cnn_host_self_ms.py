"""cnn_host_self_ms: host ms a request inside the program's ``codr.run``
spans, less the part inside its ``codr.host_read`` spans: the entry and
the engine chain's own Python and launch work, not its waiting on the
device (host clock, spans inside the window's request marks)."""
from bench import harness


def read(run):
    sp = harness.load_module("metrics", "cnn_host_reads")
    items = sp.window_spans(run)
    if items is None:
        return None
    items, n = sp.in_requests(run, items)
    runs = sp.named(items, "codr.run")
    if not n or not runs:
        return None
    ids = {s.id for _, _, s in runs}
    us = sum(e - s for s, e, _ in runs) - sum(
        e - s for s, e, span in sp.named(items, "codr.host_read")
        if span.request in ids)
    return us / 1e3 / n
