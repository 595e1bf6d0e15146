"""Bilinear grid sampling with ``F.grid_sample``'s semantics.

Counterpart of ``bmcnet_esr_tpu/ops/warp.py``: ``mode='bilinear',
padding_mode='zeros'``, ``align_corners=False`` by default.  Written, as
there, as four gathers of the corner pixels: an indexing gather's backward
accumulates through ``index_put_``, which is deterministic on the GPU, where
``F.grid_sample``'s backward adds with atomics.  A resumed training run with
a warping term then repeats an uninterrupted one bit for bit.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def grid_sample_bilinear(img: Tensor, grid: Tensor, *, align_corners: bool = False) -> Tensor:
    """:param img: ``[B, C, H, W]``
    :param grid: ``[B, Hg, Wg, 2]`` with (x, y) in [-1, 1]
    :return: ``[B, C, Hg, Wg]`` (zeros outside the frame)
    """
    b, c, h, w = img.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        ix = (gx + 1.0) * 0.5 * (w - 1)
        iy = (gy + 1.0) * 0.5 * (h - 1)
    else:
        ix = ((gx + 1.0) * w - 1.0) * 0.5
        iy = ((gy + 1.0) * h - 1.0) * 0.5
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = ix - x0
    wy1 = iy - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    flat = img.reshape(b, c, h * w)
    rows = torch.arange(b, device=img.device)[:, None]

    def gather(yc, xc):
        valid = (yc >= 0) & (yc < h) & (xc >= 0) & (xc < w)
        yi = torch.clamp(yc, 0, h - 1).long()
        xi = torch.clamp(xc, 0, w - 1).long()
        idx = (yi * w + xi).reshape(b, -1)
        vals = flat.permute(0, 2, 1)[rows, idx]  # [B, Hg*Wg, C]
        vals = vals.permute(0, 2, 1).reshape((b, c) + tuple(yc.shape[1:]))
        return vals * valid[:, None].to(img.dtype)

    return (
        gather(y0, x0) * (wy0 * wx0)[:, None]
        + gather(y0, x1) * (wy0 * wx1)[:, None]
        + gather(y1, x0) * (wy1 * wx0)[:, None]
        + gather(y1, x1) * (wy1 * wx1)[:, None]
    )
