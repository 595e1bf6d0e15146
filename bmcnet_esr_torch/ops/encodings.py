"""Single-window event rasterizers (plain PyTorch).

Counterpart of ``bmcnet_esr_tpu/ops/encodings.py:53-111`` (``events_to_image``
and ``events_to_channels``), with the same reference quirks:

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
