"""The program's own spans in a traced segment.

The port opens ``fct.*`` ranges (``utils/profiling.span``) while a profiler
records, so the traced segment of a ``--trace 1`` run holds them beside the
benchmark's own ranges (``tracing.py``).  A program without them leaves
them out of the trace: every function here then returns None, and the
metric that reads it is left out of the result line.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Iterable, List, Optional, Tuple

from portbench.tracing import _union


def spans(trace, name: str) -> List[Tuple[float, float]]:
    """(start, end) in us of each range named ``name``, in order."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in trace.ranges if e["name"] == name)


def host_ms(trace, name: str) -> Optional[float]:
    """Host ms a call inside ranges named ``name``."""
    s = spans(trace, name)
    return sum(b - a for a, b in s) / 1e3 / trace.calls if s else None


def host_ms_less(trace, name: str, child: str) -> Optional[float]:
    """Host ms a call inside ranges named ``name`` and outside the ranges
    named ``child`` that lie within them."""
    outer = spans(trace, name)
    if not outer:
        return None
    inner = [(a, b) for a, b in spans(trace, child) if _within(outer, a) and _within(outer, b)]
    return (sum(b - a for a, b in outer) - sum(b - a for a, b in inner)) / 1e3 / trace.calls


def runtime_calls(trace, piece: str, names: Iterable[str]) -> Optional[float]:
    """CUDA runtime or driver calls a call whose name holds ``piece``,
    issued inside a range of one of ``names``."""
    inside = _union([s for n in names for s in spans(trace, n)])
    if not inside:
        return None
    n = sum(1 for e in trace.launches if piece in e["name"] and _within(inside, e["ts"]))
    return n / trace.calls


def _within(intervals: List[Tuple[float, float]], t: float) -> bool:
    """``t`` inside one of ``intervals`` (sorted, not overlapping)."""
    k = bisect_right(intervals, (t, float("inf"))) - 1
    return k >= 0 and t <= intervals[k][1]
