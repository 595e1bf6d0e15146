"""Native host event ops (C++, loaded with ctypes).

Counterpart of ``bmcnet_esr_tpu/native/__init__.py``.  ``csrc/eventops.cpp``
is built at first use by :func:`bmcnet_esr_torch.kernels._build.
load_host_library` into the package's ``_build/`` and checked on a tiny
known answer before it is trusted.  Exposes:

* :func:`redistribute_stack`, the stack -> event-cloud redistribution (the
  C++ form of :func:`bmcnet_esr_torch.ops.encodings.event_redistribute_stack`);
* :func:`rasterize_counts`, a host ``[2, H, W]`` count image.

There is no quiet fallback: a failed build or self-test raises.  The numpy
``event_redistribute_stack`` runs only where a caller names it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from bmcnet_esr_torch.kernels import _build

SOURCE = "eventops.cpp"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _self_test(lib: ctypes.CDLL) -> None:
    """A known-answer call before the library is trusted (a corrupted or
    foreign binary fails here, not at its first real use)."""
    img = np.zeros((2, 2, 2), np.float32)
    xs = np.array([0.0, 1.0, 1.0], np.float32)
    ys = np.array([0.0, 0.0, 0.0], np.float32)
    ps = np.array([1.0, -1.0, -1.0], np.float32)
    lib.rasterize_counts(xs, ys, ps, 3, 2, 2, img)
    # y flipped, polarity squared into positive counts
    expect = np.array([[[0, 0], [1, 0]], [[0, 0], [0, 2]]], np.float32)
    if not np.array_equal(img, expect):
        raise RuntimeError("native eventops self-test failed")


def _prepare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry points' argument types, then run the self-test."""
    i64 = ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.redistribute_count.argtypes = [f32p, i64, i64, i64, i64, i64, i64p]
    lib.redistribute_fill.argtypes = [
        f32p, i64, i64, i64, i64, i64, ctypes.c_int, ctypes.c_uint64, i64, f32p,
    ]
    lib.rasterize_counts.argtypes = [f32p, f32p, f32p, i64, i64, i64, f32p]
    _self_test(lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = _prepare(_build.load_host_library(SOURCE))
    return _lib


def redistribute_stack(event_stack: np.ndarray, mode: str = "linear", seed: int = 0) -> np.ndarray:
    """Stack ``[B, C, Y, X]`` or ``[B, P, C, Y, X]`` -> padded event cloud
    ``[B, N_max, 4]`` (x, y, t, p), as ``event_redistribute_stack`` gives
    it; ``random`` draws from the library's own generator seeded by ``seed``
    (the same bins as numpy, not the same draws)."""
    if mode not in ("linear", "random"):
        raise ValueError(f"unsupported mode {mode!r}")
    stack = np.ascontiguousarray(event_stack, np.float32)
    if stack.ndim == 4:
        b, c, y, x = stack.shape
        p = 1
    elif stack.ndim == 5:
        b, p, c, y, x = stack.shape
    else:
        raise ValueError(f"unsupported stack rank {stack.ndim}")
    lib = _load()
    counts = np.zeros(b, np.int64)
    lib.redistribute_count(stack, b, p, c, y, x, counts)
    maxlen = int(counts.max())
    out = np.zeros((b, maxlen, 4), np.float32)
    lib.redistribute_fill(stack, b, p, c, y, x, 0 if mode == "linear" else 1, seed, maxlen, out)
    return out


def rasterize_counts(xs: np.ndarray, ys: np.ndarray, ps: np.ndarray, sensor_size) -> np.ndarray:
    """Host ``[2, H, W]`` count image: y flipped, out-of-range events
    dropped, polarity squared into positive counts."""
    h, w = int(sensor_size[0]), int(sensor_size[1])
    img = np.zeros((2, h, w), np.float32)
    _load().rasterize_counts(
        np.ascontiguousarray(xs, np.float32), np.ascontiguousarray(ys, np.float32),
        np.ascontiguousarray(ps, np.float32), len(xs), h, w, img,
    )
    return img
