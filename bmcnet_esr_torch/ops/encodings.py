"""Single-window event rasterizers (plain PyTorch).

Counterpart of ``bmcnet_esr_tpu/ops/encodings.py:53-111`` (``events_to_image``
and ``events_to_channels``) and of its loss helpers
``normalize_event_times`` and ``events_polarity_mask`` (``:270-294``).  The
rasterizers keep the reference quirks:

* the y axis is flipped (``y -> H - 1 - y``) unless ``flip_y=False``;
* out-of-range events are redirected to pixel ``(0, 0)`` with value 0, i.e.
  dropped; coordinates truncate toward zero;
* ``events_to_channels`` squares the polarity into positive counts and picks
  the channel by ``p < 0`` (padding with ``p == 0`` adds nothing).

The range test is written as "inside" tests, so a NaN coordinate is dropped
too (the JAX version leaves NaN undefined).  Batched count images of the
inference path go through :mod:`bmcnet_esr_torch.kernels.rasterize`.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _pixels(xs, ys, ps, h: int, w: int, flip_y: bool, dtype):
    valid = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    x = torch.where(valid, xs, 0).long()
    y = torch.where(valid, ys, 0).long()
    v = torch.where(valid, ps, 0).to(dtype)
    if flip_y:
        y = (h - 1) - y
    return y * w + x, v


def events_to_image(
    xs: torch.Tensor,
    ys: torch.Tensor,
    ps: torch.Tensor,
    sensor_size: Tuple[int, int],
    *,
    flip_y: bool = True,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Scatter-add an event list into an ``[H, W]`` image of signed ``ps``."""
    h, w = int(sensor_size[0]), int(sensor_size[1])
    idx, v = _pixels(xs, ys, ps, h, w, flip_y, dtype)
    flat = torch.zeros(h * w, dtype=dtype, device=xs.device)
    flat.index_put_((idx,), v, accumulate=True)
    return flat.reshape(h, w)


def events_to_channels(
    xs: torch.Tensor,
    ys: torch.Tensor,
    ps: torch.Tensor,
    sensor_size: Tuple[int, int],
    *,
    flip_y: bool = True,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Two-channel (positive, negative) count image ``[2, H, W]``."""
    h, w = int(sensor_size[0]), int(sensor_size[1])
    idx, v = _pixels(xs, ys, ps, h, w, flip_y, dtype)
    idx = (v < 0).long() * (h * w) + idx
    flat = torch.zeros(2 * h * w, dtype=dtype, device=xs.device)
    flat.index_put_((idx,), v * v, accumulate=True)
    return flat.reshape(2, h, w)


def normalize_event_times(ts: torch.Tensor, n_valid=None) -> torch.Tensor:
    """Window timestamps ``[..., N]`` to ``[0, 1]``:
    ``(ts - ts[0]) / (ts[last] - ts[0] + 1e-6)`` (``base_dataset.py:24-31``).

    ``last`` is ``N - 1``, or ``n_valid - 1`` (``[...]``, clamped into the
    window) for zero-padded windows, so the last valid event anchors the end."""
    n = ts.shape[-1]
    t0 = ts[..., :1]
    if n_valid is None:
        t_last = ts[..., -1:]
    else:
        last = torch.clamp(torch.as_tensor(n_valid, device=ts.device).long() - 1, 0, n - 1)
        t_last = torch.gather(ts, -1, last.reshape(tuple(ts.shape[:-1]) + (1,)))
    return (ts - t0) / (t_last - t0 + 1e-6)


def events_polarity_mask(ps: torch.Tensor) -> torch.Tensor:
    """``[..., N]`` polarities -> ``[..., N, 2]``: ``max(p, 0)`` and
    ``-min(p, 0)`` (``encodings.py:335-346``)."""
    return torch.stack([torch.clamp(ps, min=0), -torch.clamp(ps, max=0)], dim=-1)
