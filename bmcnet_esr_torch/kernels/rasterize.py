"""Count-image rasterizer: the hand-written CUDA kernel and its plain version.

Counterpart of ``bmcnet_esr_tpu/ops/pallas/rasterize.py::pallas_events_to_counts``
(kernel body ``_kernel``) and of the XLA scatter in
``bmcnet_esr_tpu/ops/encodings.py::events_to_channels``: ``G`` windows of
``N`` zero-padded events -> ``[G, H, W, 2]`` float32 count images, pixel
``(H-1-y, x)``, channel ``p < 0``, value ``p**2``; out-of-range events and
``p == 0`` padding are dropped.  The kernel is ``csrc/rasterize.cu``.

Routing is by the device of the input: a CPU tensor goes through
:func:`counts_plain`, a CUDA tensor through the kernel (or an exception;
there is no fallback).  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from bmcnet_esr_torch.kernels._build import load_library

SOURCE = "rasterize.cu"

# kernel launches in this process (plain-version calls are not counted)
launches = 0


def counts_plain(
    xs: torch.Tensor, ys: torch.Tensor, ps: torch.Tensor, sensor_size: Tuple[int, int]
) -> torch.Tensor:
    """Plain PyTorch rasterizer: ``[G, N]`` coordinates and polarities of any
    real dtype -> ``[G, H, W, 2]`` float32 counts (one ``index_put_``)."""
    h, w = int(sensor_size[0]), int(sensor_size[1])
    g, n = xs.shape
    valid = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h) & (ps != 0)
    x = torch.where(valid, xs, 0).long()  # truncation toward zero
    y = (h - 1) - torch.where(valid, ys, 0).long()
    v = torch.where(valid, ps, 0).float()
    gi = torch.arange(g, device=xs.device).unsqueeze(1)
    idx = ((gi * h + y) * w + x) * 2 + (v < 0).long()
    out = torch.zeros(g * h * w * 2, dtype=torch.float32, device=xs.device)
    out.index_put_((idx.reshape(-1),), (v * v).reshape(-1), accumulate=True)
    return out.reshape(g, h, w, 2)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.rasterize_counts_compact.argtypes = [p, p, p, ll, i, i, i, p]
    lib.rasterize_counts_compact.restype = i
    lib.rasterize_counts_f32.argtypes = [p, p, ll, i, i, i, p]
    lib.rasterize_counts_f32.restype = i
    lib.rasterize_error_string.argtypes = [i]
    lib.rasterize_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name}: expected {ndim}-D {dtype}, got {t.dim()}-D {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_kind(*ts: torch.Tensor) -> str:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devs))}")
    kind = ts[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"rasterizer runs on cpu or cuda tensors, not {kind}")
    return kind


def _launch(fn, args, out: torch.Tensor) -> torch.Tensor:
    global launches
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        msg = _lib().rasterize_error_string(rc).decode()
        raise RuntimeError(f"rasterize kernel launch failed: {msg} ({rc})")
    launches += 1
    return out


def counts_from_compact(
    xy: torch.Tensor, p: torch.Tensor, sensor_size: Tuple[int, int]
) -> torch.Tensor:
    """``xy int16 [G, 2, N]`` + ``p int8 [G, N]`` -> ``[G, H, W, 2]`` counts."""
    _check(xy, "xy", torch.int16, 3)
    _check(p, "p", torch.int8, 2)
    if xy.shape[1] != 2 or p.shape != (xy.shape[0], xy.shape[2]):
        raise ValueError(f"shape mismatch: xy {tuple(xy.shape)}, p {tuple(p.shape)}")
    h, w = int(sensor_size[0]), int(sensor_size[1])
    if _device_kind(xy, p) == "cpu":
        return counts_plain(xy[:, 0], xy[:, 1], p, (h, w))
    g, _, n = xy.shape
    out = torch.zeros((g, h, w, 2), dtype=torch.float32, device=xy.device)
    args = (xy.data_ptr(), p.data_ptr(), out.data_ptr(), g, n, h, w)
    return _launch(_lib().rasterize_counts_compact, args, out)


def counts_from_events(events: torch.Tensor, sensor_size: Tuple[int, int]) -> torch.Tensor:
    """Raw ``float32 [G, 4, N]`` events (rows x, y, t, p) -> ``[G, H, W, 2]``."""
    _check(events, "events", torch.float32, 3)
    if events.shape[1] != 4:
        raise ValueError(f"events must be [G, 4, N], got {tuple(events.shape)}")
    h, w = int(sensor_size[0]), int(sensor_size[1])
    if _device_kind(events) == "cpu":
        return counts_plain(events[:, 0], events[:, 1], events[:, 3], (h, w))
    g, _, n = events.shape
    out = torch.zeros((g, h, w, 2), dtype=torch.float32, device=events.device)
    args = (events.data_ptr(), out.data_ptr(), g, n, h, w)
    return _launch(_lib().rasterize_counts_f32, args, out)
