"""The yardstick's frozen statistics: percentiles, rates, busy time.
Nothing here imports the program."""
from __future__ import annotations

import math

__all__ = ["percentile", "median", "rate", "union_s"]


def percentile(xs, q: float) -> float:
    """The ``q``-th percentile of ``xs``, by linear interpolation between
    the closest ranks (NumPy's default): taken over every sample."""
    v = sorted(float(x) for x in xs)
    if not v:
        raise ValueError("percentile of no samples")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def median(xs) -> float:
    return percentile(xs, 50.0)


def rate(work: float, seconds: float) -> float:
    """All the work of a window over all of its time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return work / seconds


def union_s(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to
    ``[lo, hi]``: the time in which at least one of them ran."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total

