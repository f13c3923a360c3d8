"""cnn_idle_read_ms: device-idle ms a request in which the device ran dry
because the host waited on a read: gaps between two consecutive device
operations A and B of one request mark where a ``codr.host_read`` span
ended on the host after A's launch and at or before B's.

Here too the split of every such gap (:func:`idle_split`), which
``cnn_idle_launch_ms`` reads as well.  Gaps are device time; which class
a gap falls in is decided on the host clock alone (span stamps and the
launches' host times)."""
import bisect

from bench import harness


def union(intervals):
    """Sorted, disjoint ``[start, end]`` covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_split(run):
    """``{"read", "launch", "other", "idle": µs, "requests": n}``: the
    requests' device-idle time between consecutive operations of one
    request mark, by what held the device: a read (as above), the host's
    launching (B launched inside a ``codr.*`` span) or neither (B
    launched outside every span, or with no launch record: the harness's
    pooling and copies).  ``None`` where the run holds no spans."""
    sp = harness.load_module("metrics", "cnn_host_reads")
    items = sp.window_spans(run)
    if items is None:
        return None
    items, n = sp.in_requests(run, items)
    if not n:
        return None
    ends = sorted(e for _, e, _ in sp.named(items, "codr.host_read"))
    inside = union((s, e) for s, e, _ in items)
    starts = [s for s, _ in inside]
    launch_ts = run.trace.launch_ts
    reqs = set(run.trace.in_groups("request"))
    lo, hi = run.trace.window
    out = {"read": 0.0, "launch": 0.0, "other": 0.0}
    cur, last = lo, None
    for o in run.trace.ops:                # sorted by start
        s = max(o.start, lo)
        if (last is not None and s > cur and o.group == last.group
                and o.group in reqs):
            ta, tb = launch_ts.get(last.corr), launch_ts.get(o.corr)
            i = -1 if tb is None else bisect.bisect_right(starts, tb) - 1
            if (ta is not None and tb is not None and
                    bisect.bisect_right(ends, tb) >
                    bisect.bisect_right(ends, ta)):
                out["read"] += s - cur
            elif i >= 0 and tb <= inside[i][1]:
                out["launch"] += s - cur
            else:
                out["other"] += s - cur
        if min(o.end, hi) >= cur:
            cur, last = min(o.end, hi), o
    out["idle"] = out["read"] + out["launch"] + out["other"]
    out["requests"] = n
    return out


def read(run):
    split = idle_split(run)
    if split is None:
        return None
    return split["read"] / 1e3 / split["requests"]
