"""Wall-clock and device timers (counterpart of
``bmcnet_esr_tpu/utils/timers.py``).

``DeviceTimer`` brackets its span with CUDA events on the current stream and
synchronizes on exit, so the span is the device time of the work enqueued
inside it; on a CPU device it is the wall time.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List

import torch

_TIMERS: Dict[str, List[float]] = defaultdict(list)


class Timer:
    """Context manager appending elapsed ms to a global stats dict."""

    def __init__(self, name: str, logger=None):
        self.name = name
        self.logger = logger

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def _record(self, ms: float) -> None:
        self.interval_ms = ms
        _TIMERS[self.name].append(ms)
        if self.logger is not None:
            self.logger.info(f"{self.name}: {ms:.2f} ms")

    def __exit__(self, *exc):
        self._record((time.perf_counter() - self.start) * 1000.0)


class DeviceTimer(Timer):
    """Times device work with CUDA events (wall time on a CPU device)."""

    def __init__(self, name: str, device="cuda", logger=None):
        super().__init__(name, logger)
        self.device = torch.device(device)

    def __enter__(self):
        if self.device.type == "cuda":
            self._events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self._events[0].record(torch.cuda.current_stream(self.device))
            return self
        return super().__enter__()

    def __exit__(self, *exc):
        if self.device.type != "cuda":
            return super().__exit__(*exc)
        self._events[1].record(torch.cuda.current_stream(self.device))
        self._events[1].synchronize()
        self._record(self._events[0].elapsed_time(self._events[1]))


def timing_stats() -> Dict[str, Dict[str, float]]:
    out = {}
    for name, values in _TIMERS.items():
        out[name] = {
            "count": len(values),
            "mean_ms": sum(values) / len(values),
            "min_ms": min(values),
            "max_ms": max(values),
        }
    return out


def print_timing_info(logger=None) -> None:
    for name, s in timing_stats().items():
        msg = (
            f"== Timing [{name}]: n={s['count']} mean={s['mean_ms']:.2f}ms "
            f"min={s['min_ms']:.2f}ms max={s['max_ms']:.2f}ms"
        )
        (logger.info if logger else print)(msg)


def reset_timers() -> None:
    _TIMERS.clear()
