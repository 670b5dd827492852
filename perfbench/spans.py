"""The program's own host spans in a traced window: the union of the
spans of one layer (by name prefix), and how much of it another set of
intervals covers. Spans and kernels are ``(name, start_us, end_us)``, as
``trace.profiled`` gives them; intervals are sorted disjoint
``(start_us, end_us)``, as ``trace.busy_intervals`` gives them."""
from __future__ import annotations

from perfbench import trace


def union(spans, prefixes: tuple[str, ...]) -> list[tuple[float, float]]:
    """The union of the spans whose name starts with one of
    ``prefixes``."""
    return trace.busy_intervals([s for s in spans
                                 if s[0].startswith(prefixes)])


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def covered(intervals, others) -> float:
    """The length of ``intervals`` that ``others`` cover."""
    total, j = 0.0, 0
    for s, e in intervals:
        while j < len(others) and others[j][1] <= s:
            j += 1
        k = j
        while k < len(others) and others[k][0] < e:
            total += min(e, others[k][1]) - max(s, others[k][0])
            k += 1
    return total
