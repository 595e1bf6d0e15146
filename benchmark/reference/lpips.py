"""LPIPS net-lin, version 0.1, AlexNet backbone, in plain PyTorch.

Follows Zhang et al., "The Unreasonable Effectiveness of Deep Features as a
Perceptual Metric" (CVPR 2018), github.com/richzhang/PerceptualSimilarity
(``PNetLin``, ``networks_basic.py``), with the backbone in torchvision's
``alexnet.features`` layout (parameters ``{0,3,6,8,10}.{weight,bias}``):

* inputs in [-1, 1]; the scaling layer ``x' = (x - shift) / scale``;
* taps after each ReLU of conv 3->64 11x11/4 pad 2, maxpool 3/2,
  conv 64->192 5x5 pad 2, maxpool 3/2, conv 192->384 3x3, conv 384->256
  3x3, conv 256->256 3x3 (pad 1 for the three 3x3);
* each tap unit-normalised over the channels, ``f / (sqrt(sum_c f^2) +
  1e-10)``;
* ``d = sum_l mean_hw(w_l . (f0_l - f1_l)^2)`` with the 1x1 heads ``w_l``
  (``lin{l}``, ``[1, C_l]``).

:func:`perceptual` is the count-image loss of BMCNet's RGB recipe
(``loss/restore.py``'s wrapper): ``2 * counts - 1``, each of the channels
repeated to three and its distance averaged over the channels, then over the
batch.  Departures from the published description: none in the arithmetic;
the heads' dropout (training of the heads only) is left out, as in
evaluation.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
TAPS = (64, 192, 384, 256, 256)
# (features index, in, out, kernel, stride, padding) of each convolution
CONVS = ((0, 3, 64, 11, 4, 2), (3, 64, 192, 5, 1, 2), (6, 192, 384, 3, 1, 1),
         (8, 384, 256, 3, 1, 1), (10, 256, 256, 3, 1, 1))


def param_shapes() -> Dict[str, Tuple[int, ...]]:
    """The backbone's parameters under torchvision's names, then the heads."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    for i, cin, cout, k, _, _ in CONVS:
        shapes[f"{i}.weight"] = (cout, cin, k, k)
        shapes[f"{i}.bias"] = (cout,)
    for l, c in enumerate(TAPS):
        shapes[f"lin{l}"] = (1, c)
    return shapes


def features(p: Dict[str, Tensor], x: Tensor) -> List[Tensor]:
    """The five taps of ``x [B, 3, H, W]``."""
    taps = []
    for n, (i, _, _, _, stride, pad) in enumerate(CONVS):
        if n in (1, 2):
            x = F.max_pool2d(x, 3, 2)
        x = F.relu(F.conv2d(x, p[f"{i}.weight"], p[f"{i}.bias"], stride=stride, padding=pad))
        taps.append(x)
    return taps


def distance(p: Dict[str, Tensor], x0: Tensor, x1: Tensor) -> Tensor:
    """``[B]`` distances of ``[B, 3, H, W]`` images in [-1, 1]."""
    shift = torch.tensor(SHIFT, dtype=x0.dtype, device=x0.device)[None, :, None, None]
    scale = torch.tensor(SCALE, dtype=x0.dtype, device=x0.device)[None, :, None, None]
    d = x0.new_zeros(x0.shape[0])
    for l, (f0, f1) in enumerate(zip(features(p, (x0 - shift) / scale),
                                     features(p, (x1 - shift) / scale))):
        n0 = f0 / (torch.sqrt(torch.sum(f0 * f0, dim=1, keepdim=True)) + 1e-10)
        n1 = f1 / (torch.sqrt(torch.sum(f1 * f1, dim=1, keepdim=True)) + 1e-10)
        head = torch.sum(p[f"lin{l}"].reshape(1, -1, 1, 1) * (n0 - n1) ** 2, dim=1)
        d = d + head.mean(dim=(1, 2))
    return d


def perceptual(p: Dict[str, Tensor], pred: Tensor, gt: Tensor) -> Tensor:
    """The recipe's LPIPS term of NHWC count images ``[B, H, W, C]``."""
    a, b = 2.0 * pred - 1.0, 2.0 * gt - 1.0
    c = pred.shape[-1]
    d = sum(distance(p, a[..., k, None].permute(0, 3, 1, 2).repeat(1, 3, 1, 1),
                     b[..., k, None].permute(0, 3, 1, 2).repeat(1, 3, 1, 1)) for k in range(c))
    return torch.mean(d / c)
