"""Brightness-constancy self-supervised reconstruction loss.

Counterpart of ``bmcnet_esr_tpu/losses/reconstruction.py`` (reference
``loss/reconstruction.py``, Paredes-Valles et al. CVPR'21): the generative
model's brightness-increment error, the warped temporal consistency and the
total-variation regularizer.  Flow ``[B, 2, H, W]`` (channel 0 = x), images
``[B, 1, H, W]``, event lists ``[B, N, 4]`` (ts, y, x, p).  The grid is
normalized as for ``align_corners=True`` and sampled with
``align_corners=False``, as in the reference (``reconstruction.py:64-68``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from bmcnet_esr_torch.losses.flow import averaged_iwe
from bmcnet_esr_torch.losses.gradients import sobel
from bmcnet_esr_torch.ops.warp import grid_sample_bilinear

Tensor = torch.Tensor


def _warp_grid(flow: Tensor, res: Tuple[int, int], flow_scaling: float) -> Tensor:
    """Backward-sampling grid in [-1, 1] (x, y), ``[B, H, W, 2]``
    (``reconstruction.py:64-68,108-112``)."""
    h, w = res
    my, mx = torch.meshgrid(torch.arange(h, dtype=flow.dtype, device=flow.device),
                            torch.arange(w, dtype=flow.dtype, device=flow.device),
                            indexing="ij")
    warped_y = my[None] - flow[:, 1] * flow_scaling
    warped_x = mx[None] - flow[:, 0] * flow_scaling
    gy = 2.0 * warped_y / (h - 1) - 1.0
    gx = 2.0 * warped_x / (w - 1) - 1.0
    return torch.stack([gx, gy], dim=-1)


def generative_model_loss(
    flow: Tensor,
    img: Tensor,
    event_cnt: Tensor,
    event_list: Tensor,
    pol_mask: Tensor,
    resolution: Tuple[int, int],
) -> Tensor:
    """Brightness-increment L2 error (``reconstruction.py:46-97``);
    ``event_cnt`` ``[B, 2, H, W]`` masks the flow where no event fell."""
    res = resolution
    flow_scaling = max(res)
    flow_mask = (torch.sum(event_cnt, dim=1, keepdim=True) > 0).to(flow.dtype)
    flow = flow * flow_mask

    grid = _warp_grid(flow, res, flow_scaling)
    img_gradx, img_grady = sobel(img)
    warped_grady = grid_sample_bilinear(img_grady, grid)
    warped_gradx = grid_sample_bilinear(img_gradx, grid)
    pred_delta_l = (warped_gradx * flow[:, 0:1] + warped_grady * flow[:, 1:2]) * flow_scaling

    avg_iwe = averaged_iwe(flow, event_list, pol_mask, res)
    event_delta_l = avg_iwe[:, 0:1] - avg_iwe[:, 1:2]

    bc_error = event_delta_l + pred_delta_l
    per_batch = torch.sum(torch.square(bc_error.reshape(bc_error.shape[0], -1)), dim=1)
    return torch.sum(per_batch)


def temporal_consistency_loss(
    flow: Tensor,
    prev_img: Tensor,
    img: Tensor,
    resolution: Tuple[int, int],
    weight: float,
) -> Tensor:
    """L1 warping error between consecutive reconstructions
    (``reconstruction.py:99-132``)."""
    grid = _warp_grid(flow, resolution, max(resolution))
    warped_prev = grid_sample_bilinear(prev_img, grid)
    return weight * torch.sum(torch.abs(img - warped_prev))


def total_variation_loss(img: Tensor, weight: float) -> Tensor:
    """Forward-difference TV (``reconstruction.py:134-145``)."""
    dx = torch.abs(img[:, :, :-1, :] - img[:, :, 1:, :])
    dy = torch.abs(img[:, :, :, :-1] - img[:, :, :, 1:])
    return weight * (torch.sum(dx) + torch.sum(dy))


class BrightnessConstancy:
    """The three components behind the reference's class interface."""

    def __init__(self, resolution: Tuple[int, int], regul_weights: Sequence[float] = (0.1, 0.1)):
        self.res = tuple(resolution)
        self.weights = tuple(regul_weights)

    def generative_model(self, flow, img, inputs: Dict) -> Tensor:
        return generative_model_loss(
            flow, img, inputs["inp_cnt"], inputs["inp_list"], inputs["inp_pol_mask"], self.res
        )

    def temporal_consistency(self, flow, prev_img, img) -> Tensor:
        return temporal_consistency_loss(flow, prev_img, img, self.res, self.weights[1])

    def regularization(self, img) -> Tensor:
        return total_variation_loss(img, self.weights[0])
