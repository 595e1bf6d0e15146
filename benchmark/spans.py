"""The program's own spans in a traced device window, reduced to what the
``program_span`` readers (``benchmark/metrics/*.py``) read.

The program keeps a span (``bmcnet_esr_torch/utils/timers.py``) while a
profiler runs, stamped on the profiler's clock (``time.time_ns()``): so the
spans of a ``--trace 1`` run are those the program opened while the mode's
``devtrace.Span`` recorded.  The buffer is the process's and may hold the
spans of other traced windows too; a reader takes only the spans that lie
wholly inside this run's: from its first device record's start to its last
one's end, widened on each side by :data:`SLACK_S`.  The slack keeps the
outer span that closes just after the last copy, and, being under
``devtrace.EDGE_S``, drops any span that holds one of the trace's edges (a
drained device, then ``EDGE_S`` of sleep).  The window opens no later than
the host time between the edges (the trace's ``window_s``) before the last
record's end: the first launch under a fresh profiler can lag the span that
makes it by tens of milliseconds on a loaded host, and that lag lies inside
the host window but before the first record.

A span counts only where its outer span (``rollout``, ``train.iteration``)
is kept: the iteration in which the profiler starts has its step inside the
window but not its whole iteration, and leaves it out.  Times are
milliseconds.  A program without ``timers.spans()`` (one older than the
spans) and a window with no outer span read nothing (``None``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from benchmark import devtrace

SLACK_S = 0.05
assert SLACK_S < devtrace.EDGE_S

Interval = Tuple[float, float]  # microseconds, the device records' unit


def program_spans() -> Optional[list]:
    """The program's kept spans, or ``None`` where it keeps none."""
    from bmcnet_esr_torch.utils import timers

    fn = getattr(timers, "spans", None)
    return None if fn is None else fn()


def window(records, window_s: Optional[float] = None) -> Interval:
    """The records' extent, opened back to ``window_s`` (the host time
    between the trace's edges) before its end where that is earlier, and
    widened by :data:`SLACK_S` on each side."""
    slack = SLACK_S * 1e6
    lo, hi = min(r[1] for r in records), max(r[2] for r in records)
    if window_s:
        lo = min(lo, hi - window_s * 1e6)
    return lo - slack, hi + slack


def union(intervals) -> List[Interval]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_us(intervals, records) -> float:
    """Time inside ``intervals`` in which no device record ran."""
    spans, busy = union(intervals), union((s, e) for _, s, e in records)
    covered, j = 0.0, 0
    for s, e in spans:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return sum(e - s for s, e in spans) - covered


class Kept:
    """The spans of one run's window under kept outer spans, by name."""

    def __init__(self, by_name: Dict[str, List[Tuple[float, float, dict]]], records):
        self.by_name, self.records = by_name, records

    def has(self, *names: str) -> bool:
        return any(self.by_name.get(n) for n in names)

    def count(self, name: str) -> int:
        return len(self.by_name.get(name, ()))

    def ms(self, *names: str) -> float:
        return sum(e - s for n in names for s, e, _ in self.by_name.get(n, ())) * 1e-3

    def attr(self, name: str, key: str) -> int:
        return sum(a.get(key, 0) for _, _, a in self.by_name.get(name, ()))

    def idle_ms(self, name: str) -> float:
        """Time inside the ``name`` spans with no device record running."""
        return idle_us([(s, e) for s, e, _ in self.by_name.get(name, ())], self.records) * 1e-3


def kept(run: Dict, outer: str) -> Optional[Kept]:
    """The spans of ``run``'s traced window whose nearest ``outer`` ancestor
    (the span itself, for ``outer``) lies in the window too."""
    trace = run.get("trace") or {}
    records = trace.get("records")
    every = program_spans() if records else None
    if not every:
        return None
    lo, hi = window(records, trace.get("window_s"))
    inside = {s.id: s for s in every if lo <= s.start_ns * 1e-3 and s.end_ns * 1e-3 <= hi}
    by_name: Dict[str, List[Tuple[float, float, dict]]] = {}
    for s in inside.values():
        top = s
        while top is not None and top.name != outer:
            top = inside.get(top.parent)
        if top is not None:
            by_name.setdefault(s.name, []).append((s.start_ns * 1e-3, s.end_ns * 1e-3, s.attrs))
    return Kept(by_name, records) if by_name.get(outer) else None
