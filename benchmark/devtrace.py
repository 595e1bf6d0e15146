"""Device records of a ``torch.profiler`` trace, reduced to what the metrics read.

The profiler records device activity only (``ProfilerActivity.CUDA``): host
records slow the port's launch-bound loops severalfold.  A trace is reduced
to its device intervals (kernels, copies, fills) on the profiler's clock, in
microseconds.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

# drained device and idle host time at each edge of a trace: the profiler
# drops device records that lie close inside a trace's edges
EDGE_S = 0.1


def edge() -> None:
    torch.cuda.synchronize()
    time.sleep(EDGE_S)


class Span:
    """A traced span of device activity.  :meth:`stop` ends the profiler
    without reading its records; :meth:`records` reads them (seconds of
    host time for a long span), so a caller reads them once its measured
    window has closed.  With ``drain``, each edge drains the device and
    keeps ``EDGE_S`` of host time; ``window_s`` is the host time between
    the edges, that idle time left out."""

    def __init__(self, drain: bool = True):
        from torch.profiler import ProfilerActivity, profile

        self.drain = drain
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.window_s = None
        self.stop_s = None

    def start(self) -> "Span":
        self.prof.start()
        if self.drain:
            edge()
        self.t0 = time.perf_counter()
        return self

    def stop(self) -> None:
        if self.drain:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        if self.drain:
            time.sleep(EDGE_S)
        t = time.perf_counter()
        self.prof.stop()
        self.stop_s = time.perf_counter() - t

    def records(self) -> List[Tuple[str, float, float]]:
        return device_records(self.prof)


def warm() -> None:
    """Start and stop the profiler once: its first start in a process takes
    tens of seconds (CUPTI's set-up), which belongs in set-up, not in a
    traced span or the window around it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def device_records(prof) -> List[Tuple[str, float, float]]:
    """``[(name, start_us, end_us)]`` of the device records, from the raw
    results (building the profiler's Python event tree of a span of some
    100,000 kernels takes tens of seconds)."""
    from torch.autograd import DeviceType

    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None:
        recs = [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
                for e in raw.events() if e.device_type() == DeviceType.CUDA]
    else:
        recs = [(e.name, float(e.time_range.start), float(e.time_range.end))
                for e in prof.events() if e.device_type == DeviceType.CUDA]
    recs.sort(key=lambda r: r[1])
    return recs


def busy_us(records) -> float:
    """Time in which at least one device record ran (the union of intervals)."""
    total, end = 0.0, float("-inf")
    for _, s, e in records:
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def short(name: str) -> str:
    """A kernel's name without its namespaces, template arguments and signature."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0]
    for token in ("void ", "at::native::", "cutlass::"):
        base = base.replace(token, "")
    return base.split("<")[0].strip()[:80]


def top_ops(records, n: int = 10) -> List[List]:
    """The ``n`` device operations (by short name) that took most time, seconds."""
    acc: Dict[str, float] = {}
    for name, s, e in records:
        k = short(name)
        acc[k] = acc.get(k, 0.0) + (e - s) * 1e-6
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(records, n: int = 10) -> List[List]:
    """The ``n`` longest gaps with no device record, named by the records on
    either side (what the host launched last and next), seconds."""
    gaps, end, last = [], None, None
    for name, s, e in records:
        if end is not None and s > end:
            gaps.append([f"{short(last)} -> {short(name)}", (s - end) * 1e-6])
        if end is None or e > end:
            end, last = e, name
    return sorted(gaps, key=lambda g: -g[1])[:n]


def kernel_time_s(records, pattern: str) -> Tuple[float, int]:
    """Summed duration (s) and count of the records whose name holds ``pattern``."""
    hits = [(e - s) for name, s, e in records if pattern in name]
    return sum(hits) * 1e-6, len(hits)
