"""Sobel spatial gradients (``bmcnet_esr_tpu/losses/gradients.py``, reference
``myutils/gradients.py:7-33``): replication pad 1, 3x3 Sobel kernels, /8."""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_KX = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_KY = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def sobel(x: Tensor):
    """:param x: ``[B, C, H, W]``  :return: (gradx, grady), each ``[B*C, 1, H, W]``."""
    b, c, h, w = x.shape
    x = F.pad(x.reshape(b * c, 1, h, w), (1, 1, 1, 1), mode="replicate")

    def conv(k):
        return F.conv2d(x, torch.tensor(k, dtype=x.dtype, device=x.device)[None, None])

    return conv(_KX) / 8.0, conv(_KY) / 8.0
