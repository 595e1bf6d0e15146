"""Host spans and a device timer (counterpart of
``bmcnet_esr_tpu/utils/timers.py``).

``Timer(name, **attrs)`` is a span: a context manager that, while recording
is on, keeps its name, its start and end on ``time.time_ns()`` (CLOCK_REALTIME,
the clock ``torch.profiler`` stamps its records with, so spans and a trace's
kernels share one time axis), the id of the span it opened inside (the
innermost open span of the same thread, ``None`` at the top) and its integer
attributes (``windows=``, ``rows=``).  Recording is on while a
``torch.profiler`` session runs in the process, and inside a :func:`record`
block.  Off, entering and leaving a span is one flag check: nothing is kept
and no device is touched.  On or off, a span never synchronizes.  Under a
profiler that records this thread's host activity, a span also opens a
``record_function`` of its name, so the trace shows it over the kernels.

Kept spans go to a bounded buffer (the newest :data:`MAX_SPANS`):
:func:`spans` returns them in the order they ended, :func:`clear` empties it,
:func:`summary` gives the count, total and self milliseconds per name.

``DeviceTimer`` brackets its block with CUDA events on the current stream and
synchronizes on exit, so ``interval_ms`` is the device time of the work
enqueued inside it; on a CPU device it is the wall time.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List

import torch
from torch.autograd import profiler as _profiler

MAX_SPANS = 100_000

_SPANS: collections.deque = collections.deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
_LOCAL = threading.local()
_LOCK = threading.Lock()
_forced = 0  # open record() blocks, in any thread


@contextlib.contextmanager
def record():
    """Keep spans inside the block, in every thread, with no profiler."""
    global _forced
    with _LOCK:
        _forced += 1
    try:
        yield
    finally:
        with _LOCK:
            _forced -= 1


def _stack() -> List["Timer"]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class Timer:
    """A named span of host time: ``with Timer("rollout.dispatch", windows=32): ...``."""

    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "end_ns", "_annotation", "_keep")

    def __init__(self, name: str, **attrs: int):
        self.name = name
        self.attrs = attrs
        self.start_ns = None

    def __enter__(self) -> "Timer":
        if not (_forced or _profiler._is_profiler_enabled):
            return self
        stack = _stack()
        self.id, self.parent = next(_IDS), (stack[-1].id if stack else None)
        self._keep, self._annotation = True, None
        stack.append(self)
        self.start_ns = time.time_ns()
        if torch._C._autograd._profiler_enabled():  # this thread is profiled
            self._annotation = _profiler.record_function(self.name)
            self._annotation.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.start_ns is None:
            return
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        self.end_ns = time.time_ns()
        _stack().pop()
        if self._keep:
            _SPANS.append(self)

    def cancel(self) -> None:
        """Keep no record of this span (a loop's last turn that found no work)."""
        self._keep = False

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


def spans() -> List[Timer]:
    """The kept spans, in the order they ended."""
    return list(_SPANS)


def clear() -> None:
    _SPANS.clear()


def summary() -> Dict[str, Dict[str, float]]:
    """``{name: {"count", "total_ms", "self_ms"}}`` of the kept spans: a
    span's self time is its time less what its child spans cover."""
    kept = spans()
    children: Dict[int, float] = collections.defaultdict(float)
    for s in kept:
        if s.parent is not None:
            children[s.parent] += s.ms
    out: Dict[str, Dict[str, float]] = {}
    for s in kept:
        row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += s.ms
        row["self_ms"] += s.ms - children.get(s.id, 0.0)
    return out


class DeviceTimer:
    """Times device work with CUDA events (wall time on a CPU device); the
    milliseconds are ``interval_ms`` once the block has closed."""

    def __init__(self, name: str, device="cuda", logger=None):
        self.name = name
        self.logger = logger
        self.device = torch.device(device)
        self.interval_ms = None

    def __enter__(self):
        if self.device.type == "cuda":
            self._events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self._events[0].record(torch.cuda.current_stream(self.device))
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self._events[1].record(torch.cuda.current_stream(self.device))
            self._events[1].synchronize()
            self.interval_ms = self._events[0].elapsed_time(self._events[1])
        else:
            self.interval_ms = (time.perf_counter() - self._t0) * 1000.0
        if self.logger is not None:
            self.logger.info(f"{self.name}: {self.interval_ms:.2f} ms")
