"""The benchmark's arithmetic: rates, percentiles, spreads and unions of time intervals."""

from __future__ import annotations

import statistics


def rate(work: float, seconds: float) -> float:
    """All the work of a window over all of its time."""
    if seconds <= 0:
        raise ValueError("a window has positive length")
    return work / seconds


def percentile(values: list[float], q: int) -> float:
    """The q-th percentile (1..99) of every sample: ``statistics.quantiles(n=100)``, the exclusive method."""
    if len(values) < 2:
        raise ValueError("a percentile needs at least two samples")
    return statistics.quantiles(values, n=100)[q - 1]


def spread(values: list[float]) -> float:
    """Interquartile distance over the median (``statistics.quantiles(n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def union(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The disjoint, sorted union of [start, end) intervals, clipped to [lo, hi)."""
    out: list[list[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: list[tuple[float, float]], lo: float, hi: float) -> float:
    """Length of [lo, hi) that any interval covers."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi) that no interval covers."""
    out, at = [], lo
    for s, e in union(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = e
    if hi > at:
        out.append((at, hi))
    return out
