"""Statistics of a run: percentiles of latencies and the union of device
intervals."""

from __future__ import annotations

import math


def p95(values):
    """The 95th percentile by nearest rank: the smallest value with at least
    95 % of the values at or below it."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def mean(values):
    v = list(values)
    return sum(v) / len(v) if v else None


def merge(intervals, lo=None, hi=None):
    """The ``(start, end)`` intervals, each clipped to ``[lo, hi]`` when
    given, merged into sorted disjoint ones."""
    iv = sorted((max(s, lo) if lo is not None else s,
                 min(e, hi) if hi is not None else e) for s, e in intervals)
    out = []
    for s, e in iv:
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals, lo=None, hi=None):
    """Total length covered by ``(start, end)`` intervals, each clipped to
    ``[lo, hi]`` when given: overlapping intervals count once."""
    return sum(e - s for s, e in merge(intervals, lo, hi))


def intersect(a, b):
    """The stretches that two lists of sorted disjoint intervals share."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def gaps(intervals, lo, hi):
    """The idle ``(start, end)`` stretches of ``[lo, hi]`` that no interval
    covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out
