"""Count images of event windows, in plain PyTorch.

``[..., 4, N]`` windows ``[x, y, t, p]`` -> ``[..., H, W, 2]`` float32: an
event adds ``p ** 2`` at pixel ``(H - 1 - y, x)`` in channel 0 for ``p > 0``
and 1 for ``p < 0``; events outside the sensor and ``p == 0`` add nothing
(the reference's ``events_to_channels``)."""

from __future__ import annotations

from typing import Sequence

import torch


def counts(windows: torch.Tensor, hw: Sequence[int]) -> torch.Tensor:
    h, w = int(hw[0]), int(hw[1])
    lead = windows.shape[:-2]
    ev = windows.reshape(-1, windows.shape[-2], windows.shape[-1])
    g, n = ev.shape[0], ev.shape[-1]
    x, y, p = ev[:, 0], ev[:, 1], ev[:, 3]
    valid = (x >= 0) & (x < w) & (y >= 0) & (y < h) & (p != 0)
    xi = torch.where(valid, x, 0).long()
    yi = (h - 1) - torch.where(valid, y, 0).long()
    v = torch.where(valid, p, 0).float()
    gi = torch.arange(g, device=ev.device)[:, None]
    idx = ((gi * h + yi) * w + xi) * 2 + (v < 0).long()
    out = torch.zeros(g * h * w * 2, dtype=torch.float32, device=ev.device)
    out.index_add_(0, idx.reshape(-1), (v * v).reshape(-1))
    return out.reshape(*lead, h, w, 2)
