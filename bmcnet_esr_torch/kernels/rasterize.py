"""Count-image rasterizer: the hand-written CUDA kernels and their plain version.

Counterpart of ``bmcnet_esr_tpu/ops/pallas/rasterize.py::pallas_events_to_counts``
(kernel body ``_kernel``) and of the XLA scatter in
``bmcnet_esr_tpu/ops/encodings.py::events_to_channels``: ``G`` windows of
``N`` zero-padded events -> ``[G, H, W, 2]`` float32 count images, pixel
``(H-1-y, x)``, channel ``p < 0``, value ``p**2``; out-of-range events and
``p == 0`` padding are dropped.  The kernels are in ``csrc/rasterize.cu``:
one that builds each band of rows of an image in shared memory and writes it
once (the output is never zero-filled), and one thread-per-event kernel for
the shapes no band fits.  :func:`raster_plan` chooses between them by shape
and sizes the launch.

The kernels are the operators ``bmcnet::rasterize_counts_compact`` and
``bmcnet::rasterize_counts_f32`` (each with an ``.into`` overload that
writes a caller's buffer): the dispatcher routes by the device of the
input, a CPU tensor through :func:`counts_plain`, a CUDA tensor through a
kernel (or an exception; there is no fallback), and a fake tensor, while
``torch.export`` traces, to the output's shape alone.  ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from bmcnet_esr_torch.kernels._build import (
    H100_SMS,
    SMEM_LIMIT,
    define_op,
    device_kind,
    launch,
    load_library,
)

SOURCE = "rasterize.cu"

# kernel launches in this process (plain-version calls are not counted)
launches = 0

# csrc/rasterize.cu's constants: the most threads of a band block, bytes of
# one counter, and the largest value one compact event adds (p = -128)
MAX_THREADS, COUNTER_BYTES, MAX_P2 = 1024, 4, 128 * 128


def raster_plan(g: int, n: int, h: int, w: int, compact: bool, sms: int = H100_SMS,
                smem_limit: int = SMEM_LIMIT) -> dict:
    """The launch of ``csrc/rasterize.cu`` for ``g`` windows of ``n`` events
    and ``h x w`` images (all at least 1 but ``n``).

    ``route == "band"``: a block owns ``rows`` consecutive rows of one image
    (block ``i`` is band ``i % bands`` of window ``i // bands``), keeps their
    ``rows * w * 2`` four-byte counters in ``smem_bytes`` of shared memory,
    walks all ``n`` events of its window and writes its rows once.  There are
    at least as many bands as shared memory forces and, while the windows
    alone leave multiprocessors idle, as many as fill the card's ``sms`` in
    one wave.  ``vector`` is the events a thread loads at once (16 bytes of
    each coordinate row).

    ``route == "event"`` (``rows == 0``): one thread per event adds itself to
    the cleared output with an atomic on device memory.  Taken where one row
    of counters exceeds shared memory, and for compact windows so long that
    an int32 counter could overflow (``n * 128**2 >= 2**31``; the raw form
    counts in float32)."""
    vector = 8 if compact else 4
    max_rows = smem_limit // (w * 2 * COUNTER_BYTES)
    if max_rows == 0 or (compact and n * MAX_P2 >= 2**31):
        return {"route": "event", "rows": 0, "bands": 0, "grid": -(-g * n // 256),
                "threads": 256, "smem_bytes": 0, "vector": 1}
    bands = min(h, max(-(-h // max_rows), sms // g))
    rows = -(-h // bands)
    bands = -(-h // rows)
    work = max(-(-n // vector), -(-rows * w * 2 // 4))  # vector loads, vector stores
    return {
        "route": "band",
        "rows": rows,
        "bands": bands,
        "grid": g * bands,
        "threads": min(MAX_THREADS, max(128, -(-work // 32) * 32)),
        "smem_bytes": -(-rows * w * 2 * COUNTER_BYTES // 16) * 16,
        "vector": vector,
    }


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
    lib.rasterize_counts_compact.argtypes = [p, p, p, ll, *[i] * 6, p]
    lib.rasterize_counts_compact.restype = i
    lib.rasterize_counts_f32.argtypes = [p, p, ll, *[i] * 6, p]
    lib.rasterize_counts_f32.restype = i
    lib.rasterize_error_string.argtypes = [i]
    lib.rasterize_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name}: expected {ndim}-D {dtype}, got {t.dim()}-D {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(fn, srcs: Tuple[torch.Tensor, ...], h: int, w: int, compact: bool,
            out: torch.Tensor) -> None:
    """Plan and launch on the windows ``srcs[0] [G, _, N]`` (and the rest of
    ``srcs``) into ``out [G, h, w, 2]``: every element is written, whatever
    it held."""
    global launches
    if device_kind(*srcs, out) != "cuda":
        raise ValueError("the kernel takes CUDA tensors only")
    src = srcs[0]
    g, n = src.shape[0], src.shape[2]
    if out.numel() == 0:
        return
    if max(n, h, w) >= 2**31:
        raise ValueError(f"N={n}, H={h}, W={w} do not fit the kernel's int indexing")
    sms = torch.cuda.get_device_properties(src.device).multi_processor_count
    plan = raster_plan(g, n, h, w, compact, sms=sms)
    if plan["grid"] >= 2**31:
        raise ValueError(f"{plan['grid']} blocks exceed the grid's first axis")
    args = (*(t.data_ptr() for t in srcs), out.data_ptr(), g, n, h, w, plan["rows"],
            plan["threads"], plan["smem_bytes"])
    launch(fn, args, out.device, _lib().rasterize_error_string)
    launches += 1


# the operators: the plain version for the CPU key, the kernel for the CUDA
# key; each ``.into`` overload writes a caller's buffer


def _new(src: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return torch.empty((src.shape[0], h, w, 2), dtype=torch.float32, device=src.device)


def _compact_plain(xy, p, h, w):
    return counts_plain(xy[:, 0], xy[:, 1], p, (h, w))


def _compact_plain_into(xy, p, h, w, out):
    out.copy_(_compact_plain(xy, p, h, w))


def _compact_cuda_into(xy, p, h, w, out):
    _launch(_lib().rasterize_counts_compact, (xy, p), h, w, True, out)


def _compact_cuda(xy, p, h, w):
    out = _new(xy, h, w)
    _compact_cuda_into(xy, p, h, w, out)
    return out


def _events_plain(events, h, w):
    return counts_plain(events[:, 0], events[:, 1], events[:, 3], (h, w))


def _events_plain_into(events, h, w, out):
    out.copy_(_events_plain(events, h, w))


def _events_cuda_into(events, h, w, out):
    _launch(_lib().rasterize_counts_f32, (events,), h, w, False, out)


def _events_cuda(events, h, w):
    out = _new(events, h, w)
    _events_cuda_into(events, h, w, out)
    return out


def _no_output(*args) -> None:
    return None


compact_op = define_op(
    "rasterize_counts_compact(Tensor xy, Tensor p, int h, int w) -> Tensor",
    _compact_plain, _compact_cuda, lambda xy, p, h, w: _new(xy, h, w))
compact_into_op = define_op(
    "rasterize_counts_compact.into(Tensor xy, Tensor p, int h, int w, Tensor(a!) out) -> ()",
    _compact_plain_into, _compact_cuda_into, _no_output)
events_op = define_op(
    "rasterize_counts_f32(Tensor events, int h, int w) -> Tensor",
    _events_plain, _events_cuda, lambda events, h, w: _new(events, h, w))
events_into_op = define_op(
    "rasterize_counts_f32.into(Tensor events, int h, int w, Tensor(a!) out) -> ()",
    _events_plain_into, _events_cuda_into, _no_output)


def _check_out(out: torch.Tensor, src: torch.Tensor, h: int, w: int) -> None:
    _check(out, "out", torch.float32, 4)
    want = (src.shape[0], h, w, 2)
    if tuple(out.shape) != want or out.device != src.device:
        raise ValueError(f"out: expected {want} on {src.device}, got "
                         f"{tuple(out.shape)} on {out.device}")


def counts_from_compact(
    xy: torch.Tensor, p: torch.Tensor, sensor_size: Tuple[int, int],
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``xy int16 [G, 2, N]`` + ``p int8 [G, N]`` -> ``[G, H, W, 2]`` counts
    (into ``out`` when given: the kernel writes every element of it)."""
    _check(xy, "xy", torch.int16, 3)
    _check(p, "p", torch.int8, 2)
    if xy.shape[1] != 2 or p.shape != (xy.shape[0], xy.shape[2]):
        raise ValueError(f"shape mismatch: xy {tuple(xy.shape)}, p {tuple(p.shape)}")
    device_kind(xy, p)
    h, w = int(sensor_size[0]), int(sensor_size[1])
    if out is None:
        return compact_op(xy, p, h, w)
    _check_out(out, xy, h, w)
    compact_into_op(xy, p, h, w, out)
    return out


def counts_from_events(
    events: torch.Tensor, sensor_size: Tuple[int, int], out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Raw ``float32 [G, 4, N]`` events (rows x, y, t, p) -> ``[G, H, W, 2]``."""
    _check(events, "events", torch.float32, 3)
    if events.shape[1] != 4:
        raise ValueError(f"events must be [G, 4, N], got {tuple(events.shape)}")
    device_kind(events)
    h, w = int(sensor_size[0]), int(sensor_size[1])
    if out is None:
        return events_op(events, h, w)
    _check_out(out, events, h, w)
    events_into_op(events, h, w, out)
    return out
