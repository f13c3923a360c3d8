"""cnn_host_reads: ``codr.host_read`` spans a request: the times the
engine chain's host waited for a scalar read back from the device (two a
layer on the int8 feature path).

Here too the span helpers the other span readers share.  The spans are
the program's own (``repro_torch.core.spans``), stamped on the host
clock of the profiler's host events: they are taken from the module the
run already loaded, never imported, and compared with host times only
(span stamps, the harness's marks, the launches' host times).  A run
whose process holds no span module reads nothing."""
import bisect
import sys

SPANS = "repro_torch.core.spans"


def window_spans(run):
    """The program's spans inside the traced window as ``(start µs, end
    µs, Span)``, sorted by start; ``None`` where the run holds no trace,
    no span module or no span in the window."""
    mod = sys.modules.get(SPANS)
    if run.trace is None or mod is None:
        return None
    lo, hi = run.trace.window
    out = sorted(((s.start_ns / 1e3, s.end_ns / 1e3, s) for s in mod.spans()
                  if lo <= s.start_ns / 1e3 and s.end_ns / 1e3 <= hi),
                 key=lambda it: (it[0], it[1]))
    return out or None


def in_requests(run, items):
    """``(the items that start inside a request mark, the number of
    request marks)``; ``items`` are ``(start µs, ...)`` tuples."""
    marks = sorted((g[1], g[2]) for g in run.trace.groups
                   if g[0] == "request")
    starts = [m[0] for m in marks]
    kept = []
    for it in items:
        i = bisect.bisect_right(starts, it[0]) - 1
        if i >= 0 and it[0] <= marks[i][1]:
            kept.append(it)
    return kept, len(marks)


def named(items, name):
    return [it for it in items if it[2].name == name]


def read(run):
    items = window_spans(run)
    if items is None:
        return None
    items, n = in_requests(run, items)
    if not n or not named(items, "codr.run"):
        return None
    return len(named(items, "codr.host_read")) / n
