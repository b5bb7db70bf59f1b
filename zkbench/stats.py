"""The benchmark's arithmetic: window rates, percentiles, interval unions,
spreads.  Plain Python, shared by the metric readers and by spread.py."""

from __future__ import annotations

import statistics


def per_item(total: float, count: int) -> float | None:
    return total / count if count else None


def percentile(values, q: int) -> float | None:
    """The q-th percentile by Python's statistics.quantiles (exclusive
    method) over all values; None under two values."""
    values = list(values)
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100)[q - 1]


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(intervals, start: float, end: float) -> list[tuple[float, float]]:
    """The stretches of [start, end] that no interval covers."""
    out, at = [], start
    for s, e in merged(intervals):
        s, e = max(s, start), min(e, end)
        if e <= s:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if end > at:
        out.append((at, end))
    return out


def spread(values) -> float | None:
    """The distance between the first and third quartiles
    (statistics.quantiles, n=4) as a share of the median."""
    values = list(values)
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def without_farthest(values) -> list:
    """The values without the one farthest from their median."""
    values = list(values)
    med = statistics.median(values)
    values.remove(max(values, key=lambda v: abs(v - med)))
    return values
