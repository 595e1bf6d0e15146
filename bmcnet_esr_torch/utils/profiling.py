"""Device profiling helpers (counterpart of
``bmcnet_esr_tpu/utils/profiling.py``, the reference's CUDA-event timing).

``trace(log_dir)`` records the CPU and CUDA activity of a block with
``torch.profiler`` and writes a trace TensorBoard loads;
``device_time`` times a callable with the device drained after each call;
``annotate(name)`` is a span of ``utils/timers.py``: kept while a profiler
runs, and shown in the trace as a ``record_function`` of its name.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

from bmcnet_esr_torch.utils.timers import Timer


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('logs/profile'): ...`` -> a TensorBoard trace
    (``<log_dir>/*.pt.trace.json``) of the block's CPU and CUDA activity.
    The profiler is yielded, for ``key_averages()`` and ``events()``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def device_time(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> Tuple[float, float]:
    """``(median seconds, calls per second)`` of ``fn(*args)``, the device
    drained after every call."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    return med, 1.0 / med


def annotate(name: str) -> Timer:
    """A named span in the trace: ``with annotate('train_step'): ...``."""
    return Timer(name)
