"""Pixel shuffle / unshuffle on NHWC tensors with torch's channel order.

Counterpart of ``bmcnet_esr_tpu/ops/shuffle.py``: channel ``c * r**2 + i * r + j``
maps to spatial offset ``(i, j)``, the order of ``F.pixel_shuffle`` on NCHW,
so these equal ``F.pixel_shuffle`` applied to the NCHW view.  The models
work on NCHW inside and call ``F.pixel_shuffle`` directly.
"""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """``[..., H, W, C*r*r] -> [..., H*r, W*r, C]``."""
    *lead, h, w, crr = x.shape
    c = crr // (r * r)
    if c * r * r != crr:
        raise ValueError(f"channels {crr} not divisible by r^2={r * r}")
    k = len(lead)
    x = x.reshape(*lead, h, w, c, r, r)
    # (..., h, w, c, i, j) -> (..., h, i, w, j, c)
    x = x.permute(*range(k), k, k + 3, k + 1, k + 4, k + 2)
    return x.reshape(*lead, h * r, w * r, c)


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """``[..., H*r, W*r, C] -> [..., H, W, C*r*r]``."""
    *lead, hr, wr, c = x.shape
    h, w = hr // r, wr // r
    if h * r != hr or w * r != wr:
        raise ValueError(f"spatial dims {(hr, wr)} not divisible by r={r}")
    k = len(lead)
    x = x.reshape(*lead, h, r, w, r, c)
    # (..., h, i, w, j, c) -> (..., h, w, c, i, j)
    x = x.permute(*range(k), k, k + 2, k + 4, k + 1, k + 3)
    return x.reshape(*lead, h, w, c * r * r)
