"""Device time an iteration of the kernels launched inside the LPIPS term's
calls (``train.loss.lpips``, first pass and recompute) (``device_trace``).

A device record is matched to the host runtime call that launched it by
their correlation id; a call belongs to the term where it starts inside one
of its spans.  A trace without the runtime calls reads nothing."""

import bisect

from benchmark import spans
from benchmark.metrics._by_time import placed


def read(run):
    trace = run.get("trace") or {}
    if not trace.get("launches") or not trace.get("kernels"):
        return None
    p = placed(run)
    lpips = [] if p is None else spans.union((s, e) for s, e, _ in p.named("train.loss.lpips"))
    if not lpips:
        return None
    starts = [s for s, _ in lpips]
    mine = set()
    for corr, t in trace["launches"]:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= lpips[i][1]:
            mine.add(corr)
    us = sum(e - s for corr, s, e in trace["kernels"] if corr in mine)
    return us * 1e-3 / len(p.iterations)
