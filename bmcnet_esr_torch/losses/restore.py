"""Restoration metrics: MSE, PSNR, SSIM.

Counterpart of ``bmcnet_esr_tpu/losses/restore.py`` (skimage semantics):

* ``psnr``: ``10 * log10(data_range**2 / mse)``;
* ``ssim``: 7x7 uniform window over the valid region, K1=0.01, K2=0.03,
  sample covariance (N/(N-1));
* ``psnr_metric`` / ``ssim_metric``: per-channel averages on ``[C, H, W]``
  with the reference's data ranges (PSNR: ``target[c].max() - target.min()``,
  max per channel, min global).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def mse_loss(pred: Tensor, target: Tensor) -> Tensor:
    """Mean squared error (``nn.MSELoss`` default reduction)."""
    return torch.mean(torch.square(pred - target))


def psnr(pred: Tensor, target: Tensor, data_range) -> Tensor:
    err = torch.mean(torch.square(pred - target))
    return 10.0 * torch.log10(torch.square(torch.as_tensor(data_range, dtype=err.dtype)) / err)


def _uniform_filter_2d(x: Tensor, size: int) -> Tensor:
    """Mean filter over the trailing two axes, valid region only."""
    k = torch.full((1, 1, size, size), 1.0 / (size * size), dtype=x.dtype, device=x.device)
    lead = x.shape[:-2]
    out = F.conv2d(x.reshape((-1, 1) + tuple(x.shape[-2:])), k)
    return out.reshape(tuple(lead) + tuple(out.shape[-2:]))


def ssim(pred: Tensor, target: Tensor, data_range, *, win_size: int = 7,
         k1: float = 0.01, k2: float = 0.03) -> Tensor:
    """Mean SSIM over the trailing ``[H, W]`` axes (and any leading ones)."""
    np_ = win_size**2
    cov_norm = np_ / (np_ - 1)
    ux = _uniform_filter_2d(pred, win_size)
    uy = _uniform_filter_2d(target, win_size)
    uxx = _uniform_filter_2d(pred * pred, win_size)
    uyy = _uniform_filter_2d(target * target, win_size)
    uxy = _uniform_filter_2d(pred * target, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    dr = torch.as_tensor(data_range, dtype=pred.dtype, device=pred.device)
    c1 = torch.square(k1 * dr)
    c2 = torch.square(k2 * dr)
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    return torch.mean((a1 * a2) / (b1 * b2))


def psnr_metric(pred: Tensor, target: Tensor) -> Tensor:
    """Reference ``psnr_loss`` on ``[C, H, W]`` (``[H, W]`` is clipped to
    [0, 1] with data_range 1)."""
    if pred.dim() == 2:
        return psnr(pred.clamp(0, 1), target.clamp(0, 1), 1.0)
    ranges = target.amax(dim=(-2, -1)) - target.min()
    err = torch.mean(torch.square(pred - target), dim=(-2, -1))
    return torch.mean(10.0 * torch.log10(torch.square(ranges) / err))


def ssim_metric(pred: Tensor, target: Tensor, data_range=None) -> Tensor:
    """Reference ``ssim_loss`` on ``[C, H, W]``: per-channel SSIM averaged;
    ``data_range`` defaults to the joint max - min."""
    if data_range is None:
        both = torch.stack([pred, target])
        data_range = torch.clamp(both.max() - both.min(), min=1e-6)
    if pred.dim() == 2:
        return ssim(pred, target, data_range)
    return torch.stack([ssim(p, t, data_range) for p, t in zip(pred, target)]).mean()
