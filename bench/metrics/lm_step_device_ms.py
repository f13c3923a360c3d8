"""lm_step_device_ms: device-busy ms of one replay of the captured pooled
step (``models.lm.CapturedDecode``): the union of its kernels' times,
averaged over the replays the trace recorded whole.  A replay launches
its kernels under one correlation id; the number a whole replay holds is
the count most replays show, and a replay with fewer lost records and
is left out."""
from collections import Counter

from bench.stats import union_s


def whole_replays(trace) -> list:
    reps = trace.replays()
    if not reps:
        return []
    n = Counter(len(r) for r in reps).most_common(1)[0][0]
    return [r for r in reps if len(r) == n]


def read(run):
    if run.trace is None:
        return None
    reps = whole_replays(run.trace)
    if not reps:
        return None
    us = sum(union_s(((o.start, o.end) for o in r), r[0].start,
                     max(o.end for o in r)) for r in reps)
    return us / 1e3 / len(reps)
