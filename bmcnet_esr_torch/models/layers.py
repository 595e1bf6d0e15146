"""Building blocks of the BMCNet family (fp32 / bf16 path).

Counterpart of ``bmcnet_esr_tpu/models/layers.py``:

* ``Conv`` <- ``_conv`` (``layers.py:107-145``): float32 parameters cast to the
  compute dtype on every call, like flax's ``param_dtype`` / ``dtype``;
* ``ChannelLayerNorm`` (``layers.py:368-397``): eps 1e-6 inside the rsqrt; the
  float32 path subtracts the mean before squaring, the bf16 path takes
  ``E[x^2] - E[x]^2``;
* ``ResidualBlock`` (``layers.py:400-434``), ``BIE`` (``layers.py:437-492``),
  ``ParallelBlk`` (``layers.py:495-524``).

Activations are NCHW here (the JAX package is NHWC); the models feed
channels-last views, so no copy is made at the boundary.  Tied weights are
one module called at every site, as in the JAX package.  The int8 modes
(``QuantConv``) are not ported yet; the models refuse a ``quant`` mode.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

class Conv(nn.Conv2d):
    """SAME-padded conv with float32 parameters and a compute ``dtype``."""

    def __init__(self, cin: int, cout: int, kernel: int, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, kernel, padding=kernel // 2)
        self.compute_dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        # Kaiming-normal fan-in scaled by 0.1 (the reference's
        # initialize_weights; flax variance_scaling(0.02, fan_in, normal))
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        nn.init.normal_(self.weight, 0.0, math.sqrt(0.02 / fan_in), generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), padding=self.padding)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of NCHW (biased variance, eps in the
    rsqrt, per-channel ``weight`` and ``bias``)."""

    def __init__(self, features: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(1, keepdim=True)
        if self.dtype == torch.float32:
            var = (x32 - mu).square().mean(1, keepdim=True)
        else:
            var = torch.clamp(x32.square().mean(1, keepdim=True) - mu.square(), min=0.0)
        y = (x32 - mu) * torch.rsqrt(var + self.eps)
        return (y * self.weight[:, None, None] + self.bias[:, None, None]).to(self.dtype)


class ResidualBlock(nn.Module):
    """conv-relu-conv with identity skip."""

    def __init__(self, nf: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(nf, nf, 3, dtype)
        self.conv2 = Conv(nf, nf, 3, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(x)))


def init_weights(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Draw every conv of ``module`` afresh from ``generator`` (norms keep
    their ones / zeros)."""
    for m in module.modules():
        if isinstance(m, Conv):
            m.reset_parameters(generator)


def _as_tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> ``[B, H*W, C]`` (a view for channels-last tensors)."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


class BIE(nn.Module):
    """Bilateral information exchange block.  ``conv2``/``convf2`` of the
    reference are the tied ``conv1``/``convf1``."""

    def __init__(self, nf: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = ResidualBlock(nf, dtype)      # tied: also "conv2"
        self.convf1 = Conv(2 * nf, nf, 1, dtype)   # tied: also "convf2"
        self.norm_s = ChannelLayerNorm(nf, dtype=dtype)
        self.clustering = Conv(nf, nf, 1, dtype)
        self.unclustering = Conv(2 * nf, nf, 1, dtype)
        self.v1 = Conv(nf, nf, 1, dtype)
        self.v2 = Conv(nf, nf, 1, dtype)
        # c**-0.5 rounded in float32, as the JAX package computes it
        self.att_scale = float(np.float32(nf) ** np.float32(-0.5))

    def _attend(self, center: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        b, c, h, w = v.shape
        ct, vt = _as_tokens(center), _as_tokens(v)  # [B, HW, C]
        # logits and softmax in float32 even on the bf16 path
        att = torch.bmm(ct.transpose(1, 2).float(), vt.float())  # [B, C, C]
        att = torch.softmax(att * self.att_scale, dim=-1).to(self.dtype)
        out = torch.bmm(vt, att.transpose(1, 2))  # [B, HW, C]
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2)

    def forward(
        self, x_1: torch.Tensor, x_2: torch.Tensor, x_s: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x_1_ = self.conv1(x_1)
        x_2_ = self.conv1(x_2)  # tied conv2

        center1 = self.clustering(self.norm_s(self.convf1(torch.cat([x_s, x_2], 1))))
        center2 = self.clustering(self.norm_s(self.convf1(torch.cat([x_s, x_1], 1))))

        out_1 = self._attend(center1, self.v1(x_1))
        out_2 = self._attend(center2, self.v2(x_2))

        x_s_ = self.unclustering(torch.cat([center1, center2], 1)) + x_s
        return out_1 + x_2_, out_2 + x_1_, x_s_


class ParallelBlk(nn.Module):
    """Per-polarity residual convs + local/global BIE.  ``conv2 = conv1`` and
    ``conv2_st = conv1_st`` are tied; ``lBIE`` is shared by both polarities."""

    def __init__(self, nf: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ResidualBlock(nf, dtype)     # tied: also conv2
        self.conv1_st = ResidualBlock(nf, dtype)  # tied: also conv2_st
        self.lBIE = BIE(nf, dtype)
        self.gBIE = BIE(nf, dtype)

    def forward(self, x_1, x_2, x_s, x_1_st, x_2_st, x_1_s_st, x_2_s_st):
        x_1 = self.conv1(x_1)
        x_2 = self.conv1(x_2)
        x_1_st = self.conv1_st(x_1_st)
        x_2_st = self.conv1_st(x_2_st)

        x_1, x_1_st, x_1_s_st = self.lBIE(x_1, x_1_st, x_1_s_st)
        x_2, x_2_st, x_2_s_st = self.lBIE(x_2, x_2_st, x_2_s_st)

        x_1, x_2, x_s = self.gBIE(x_1, x_2, x_s)
        return x_1, x_2, x_s, x_1_st, x_2_st, x_1_s_st, x_2_s_st
