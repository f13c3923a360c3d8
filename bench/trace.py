"""Reading the device: one window under ``torch.profiler``, reduced to
device operations, the harness's own marks and the host's operations.

The harness marks its own calls into the program (``mark``: a
``record_function`` range named ``bench.<label>``) and the whole window
(``bench.window``).  A device operation belongs to the mark in which the
host launched it (by the launch's correlation id), or, where the trace
holds no launch record for it, to the mark in which it started.  The
profiler can lose a few kernel records of a window; readers count what
was recorded and say so.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

__all__ = ["Op", "Trace", "mark", "record", "rows", "parse"]

WINDOW = "bench.window"
PREFIX = "bench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclasses.dataclass(frozen=True)
class Op:
    """One device operation: name, start and end in µs, the index of the
    mark it belongs to (-1: none), and the host call that launched it
    (``launch``: its name, ``corr``: its correlation id; a CUDA graph's
    replay launches all of its kernels under one)."""

    name: str
    start: float
    end: float
    group: int
    launch: str = ""
    corr: int = -1


@dataclasses.dataclass
class Trace:
    """A parsed window: ``ops`` on the device, ``groups`` the marks
    ``(label, start, end)`` in µs, ``host`` the host's operations
    ``(name, start, end)``, ``launch_ts`` each launch's host time by
    correlation id."""

    window: tuple[float, float]
    ops: list
    groups: list
    host: list
    launch_ts: dict = dataclasses.field(default_factory=dict)
    read_s: float = 0.0            # seconds spent reading the profiler

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which a device operation ran."""
        from bench.stats import union_s
        return union_s(((o.start, o.end) for o in self.ops),
                       *self.window) / 1e6

    def in_groups(self, label: str) -> list[int]:
        """Indices of the marks with this label."""
        return [i for i, g in enumerate(self.groups) if g[0] == label]

    def replays(self) -> list[list]:
        """The operations of each CUDA-graph replay in the window, one list
        a replay, in launch order."""
        out: dict = {}
        for o in self.ops:
            if "GraphLaunch" in o.launch:
                out.setdefault(o.corr, []).append(o)
        return [out[k] for k in sorted(out)]

    def by_group(self) -> dict:
        """``{mark index: [Op, ...]}`` over the window's operations."""
        out: dict = {}
        for o in self.ops:
            out.setdefault(o.group, []).append(o)
        return out

    def device_ops(self, top: int = 10) -> list:
        """``[[name, seconds], ...]``: the operations that took most device
        time, summed by name."""
        tot: dict = {}
        for o in self.ops:
            tot[o.name] = tot.get(o.name, 0.0) + (o.end - o.start) / 1e6
        return [[n[:120], s] for n, s in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10, examined: int = 2000) -> list:
        """``[[host call, seconds], ...]``: the device's idle time in the
        window, by what ended each gap: the host operation inside which
        the next device operation was launched, for the ``examined``
        longest gaps, and the launch call's name for the rest."""
        lo, hi = self.window
        gaps, cur = [], lo                 # (length, next op or None)
        for o in self.ops:                 # sorted by start
            s = max(o.start, lo)
            if s > cur:
                gaps.append((s - cur, o))
            cur = max(cur, min(o.end, hi))
        if hi > cur:
            gaps.append((hi - cur, None))
        gaps.sort(key=lambda g: -g[0])
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        tot: dict = {}
        for k, (length, o) in enumerate(gaps):
            if o is None:
                name = "window end"
            else:
                name = f"launch {o.launch}" if o.launch else "unknown"
                t = self.launch_ts.get(o.corr)
                if k < examined and t is not None:
                    i = bisect.bisect_right(starts, t)
                    inner = min((h for h in host[max(0, i - 500):i]
                                 if h[2] >= t), key=lambda h: h[2] - h[1],
                                default=None)
                    if inner is not None:
                        name = inner[0]
            tot[name[:120]] = tot.get(name[:120], 0.0) + length / 1e6
        return [[n, v] for n, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def mark(label: str, enabled: bool):
    """A ``bench.<label>`` range around a call of the harness into the
    program, when tracing; nothing otherwise."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(PREFIX + label)


def record(fn, *, sync, after=None):
    """Run ``fn`` (the measured window) under ``torch.profiler`` and
    return ``(fn's result, Trace)``.  ``sync`` waits for the device;
    ``after`` runs after the window, before the profiler stops: stopping
    it while another thread launches work on the device can hang (seen
    with a CUDA graph's replay).  The events are read from the profiler
    in memory, not through a file."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            sync()
        if after is not None:
            after()
    t0 = time.perf_counter()
    trace = parse(rows(prof.profiler.kineto_results.events()))
    trace.read_s = time.perf_counter() - t0
    return out, trace


def rows(events):
    """The profiler's events as ``(category, name, start µs, end µs,
    correlation ids)`` rows; a device operation carries its own id and
    the id of the call it is linked to, either of which may be the
    launch's.  Where the events do not name their category (older
    torch), it follows from the device and the name: a device event is a
    kernel unless it is a ``bench.…`` mark's shadow, a host event named
    ``cu…`` a launch, ``bench.…`` a mark."""
    from torch.autograd import DeviceType
    for e in events:
        name = e.name()
        if e.device_type() != DeviceType.CPU:
            # a mark is also drawn on the device's timeline: not an op
            cat = ("gpu_user_annotation" if name.startswith(PREFIX)
                   else "kernel")
            ids = (e.correlation_id(), e.linked_correlation_id())
        else:
            cat = (e.activity_type() if hasattr(e, "activity_type") else
                   "user_annotation" if name.startswith(PREFIX) else
                   "cuda_runtime" if name.startswith("cu") else "cpu_op")
            ids = (e.correlation_id(),)
        start = e.start_ns() / 1e3
        yield cat, name, start, start + e.duration_ns() / 1e3, ids


def parse(events) -> Trace:
    """:func:`rows` as a :class:`Trace`."""
    window, groups, host, launches, dev = None, [], [], {}, []
    for cat, name, ts, end, ids in events:
        if cat in DEVICE_CATS:
            dev.append((name, ts, end, ids))
        elif cat in LAUNCH_CATS:
            if ids and ids[0]:
                launches[ids[0]] = (ts, name)
        elif cat in HOST_CATS:
            if name == WINDOW:
                window = (ts, end)
            elif cat == "user_annotation" and name.startswith(PREFIX):
                groups.append((name[len(PREFIX):], ts, end))
            else:
                host.append((name, ts, end))
    if window is None:
        raise ValueError("the trace holds no bench.window mark")
    groups.sort(key=lambda g: g[1])
    starts = [g[1] for g in groups]

    def group_of(t: float) -> int:
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and t <= groups[i][2] else -1

    lo, hi = window
    ops = []
    for n, s, e, ids in dev:
        if e > lo and s < hi:
            c = next((i for i in ids if i in launches), -1)
            t, launch = launches.get(c, (s, ""))
            ops.append(Op(n, s, e, group_of(t), launch, c))
    ops.sort(key=lambda o: o.start)
    return Trace(window, ops, groups, host,
                 {c: t for c, (t, _) in launches.items()})
