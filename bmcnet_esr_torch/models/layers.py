"""Building blocks of the BMCNet family (fp32 / bf16 path).

Counterpart of ``bmcnet_esr_tpu/models/layers.py``:

* ``Conv`` <- ``_conv`` (``layers.py:107-145``): float32 parameters cast to the
  compute dtype on every call, like flax's ``param_dtype`` / ``dtype``;
* ``ChannelLayerNorm`` (``layers.py:368-397``): eps 1e-6 inside the rsqrt; the
  float32 path subtracts the mean before squaring, the bf16 path takes
  ``E[x^2] - E[x]^2``;
* ``QuantConv`` (``layers.py:148-365``) and the ``quant`` mode routing of
  ``_conv`` (``layers.py:97-145``): the W8A8 int8 serving modes;
* ``ResidualBlock`` (``layers.py:400-434``, with the chain modes' int8
  hand-off), ``BIE`` (``layers.py:437-492``), ``ParallelBlk``
  (``layers.py:495-524``).

Activations are NCHW here (the JAX package is NHWC); the models feed
channels-last views, so no copy is made at the boundary.  Tied weights are
one module called at every site, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bmcnet_esr_torch.kernels.qconv import (
    pack_weights3x3,
    quant_conv3x3,
    quantize_weights3x3,
)
from bmcnet_esr_torch.kernels.qmm import pack_weights, quant_matmul, quantize_weights
from bmcnet_esr_torch.kernels.quantize import (
    lane_scales,
    quantize_act,
    round_clip_s8,
    symmetric_scale,
)

# The ``quant`` argument of every model module is a MODE (the JAX package's
# ``layers.py:62-96``):
#   False          plain float convolutions
#   True / "xla"   W8A8 3x3 convs; the activation quantize is a separate
#                  elementwise pass in front of the int8 conv kernel
#   "p1x1"         additionally the 1x1 convs, through the fused quantize +
#                  int8 matmul kernel (kernels/qmm.py) on static scales
#   "pconv"        the 3x3 convs through the fused quantize + int8 conv
#                  kernel (kernels/qconv.py) on static scales
#   "pall"         both fused routes
#   "pquant"       the quantize pass in front of each 3x3 conv runs as the
#                  standalone kernel (kernels/quantize.py) on static scales
#   "chain"        a ResidualBlock's conv1 emits int8 at conv2's static
#                  scale from its own epilogue (no bf16 intermediate, no
#                  quantize pass for conv2)
#   "chainq"       chain + pquant
#   "qat"          quantization-aware training: the 3x3 convs fake-quantize
#                  activations and weights onto the int8 grid, in float with
#                  straight-through gradients
# The parameters are the same in every mode, so checkpoints load unchanged.
QUANT_MODES = (True, "xla", "p1x1", "pconv", "pall", "pquant", "chain", "chainq", "qat")

# modes whose ResidualBlocks chain conv1 -> conv2 through an int8 epilogue
CHAIN_MODES = ("chain", "chainq")

# |x| quantile grid recorded during int8 calibration (models/quant.py picks
# one for percentile calibration; the per-lane max is the default)
_CALIB_QUANTILES = (0.995, 0.999, 0.9999)


def quant_mode(quant: Any) -> str:
    """The mode string of a model's ``quant`` argument ("" when off); an
    unknown mode raises rather than silently running another route."""
    mode = quant if isinstance(quant, str) else ("xla" if quant else "")
    if mode and mode not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r}; expected one of {QUANT_MODES}")
    return mode


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


def _conv(cin: int, cout: int, kernel: int, dtype: torch.dtype, quant: Any = False) -> Conv:
    """A :class:`Conv`, or a :class:`QuantConv` where the mode quantizes this
    kernel size: every 3x3 conv, and the 1x1 convs in "p1x1" / "pall"."""
    mode = quant_mode(quant)
    if mode and (kernel == 3 or mode in ("p1x1", "pall")):
        return QuantConv(cin, cout, kernel, dtype, mode)
    return Conv(cin, cout, kernel, dtype)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW view -> NHWC-contiguous tensor for the int8 kernels: free for the
    channels-last views the models pass, an explicit copy otherwise."""
    return x.permute(0, 2, 3, 1).contiguous()


class QuantConv(Conv):
    """W8A8 convolution of the int8 serving modes (``layers.py:148-365``).

    Same parameters as :class:`Conv` (``weight`` OIHW float32, ``bias``), so
    the state dict is identical to the float model's.  Weights are quantized
    symmetrically per output channel (``max|W| / 127``) and cached until the
    weight changes.  Activations are quantized per LANE (batch entry), so a
    stream batched with others computes exactly what it computes alone:

    * dynamic (no ``act_scale``): ``max|x| / 127`` of the lane, every call;
    * static: the per-lane ``act_scale`` buffer (scalar, ``[1]`` or ``[B]``)
      that ``models/quant.calibrate_act_scales`` installs.  It is not part of
      the state dict.  Only on this path do the fused kernels ("pconv",
      "p1x1", "pall") and the standalone quantize kernel ("pquant",
      "chainq") take over.

    While ``calib`` is a dict (calibration), each call records the lane's
    running ``max|x|`` there, and its |x| quantiles when ``calib`` has an
    ``act_q`` entry.
    """

    def __init__(self, cin: int, cout: int, kernel: int, dtype: torch.dtype, mode: str):
        super().__init__(cin, cout, kernel, dtype)
        self.fused = mode == "pall" or mode == ("pconv" if kernel == 3 else "p1x1")
        self.quantize_kernel = mode in ("pquant", "chainq")
        self.qat = mode == "qat"
        self.register_buffer("act_scale", None, persistent=False)
        self.calib: Optional[dict] = None
        self._wcache = None

    def _quantized_weights(self):
        """``(wq, sw, packed)`` in the kernels' layouts, recomputed when the
        weight is replaced, moved or written in place (``load_state_dict``
        copies into it, which bumps its version)."""
        w = self.weight
        key = (w.data_ptr(), w.device, w._version)
        if self._wcache is None or self._wcache[0] != key:
            hwio = w.detach().permute(2, 3, 1, 0)
            if self.kernel_size[0] == 3:
                wq, sw = quantize_weights3x3(hwio)
                packed = pack_weights3x3(wq) if w.is_cuda else None
            else:
                wq, sw = quantize_weights(hwio.reshape(self.in_channels, self.out_channels))
                packed = pack_weights(wq) if w.is_cuda else None
            self._wcache = (key, wq, sw, packed)
        return self._wcache[1:]

    def _record(self, x: torch.Tensor) -> None:
        """Fold this call's per-lane stats into ``calib``: ``act_max`` [B],
        and ``act_q`` [Q, B] (a sort per call) only where ``calib`` asks."""
        absx = x.detach().float().abs().reshape(x.shape[0], -1)
        for k, old in self.calib.items():
            if k == "act_max":
                v = absx.amax(1)
            else:
                q = torch.tensor(_CALIB_QUANTILES, dtype=torch.float32, device=x.device)
                v = torch.quantile(absx, q, dim=1)
            self.calib[k] = v if old is None else torch.maximum(old, v)

    def forward(
        self, x: torch.Tensor, *, in_scale: Optional[torch.Tensor] = None,
        emit_scale: Optional[torch.Tensor] = None, emit_relu: bool = False,
    ) -> torch.Tensor:
        """``in_scale``: ``x`` is already int8 at that per-lane scale (a
        chained producer emitted it).  ``emit_scale``: return int8 at that
        per-lane scale (after a ReLU when ``emit_relu``) instead of
        ``compute_dtype``.  Both serve the chain modes."""
        if self.qat:
            return self._fake_quant(x)
        if in_scale is not None:
            return self._convolve(x, in_scale, emit_scale, emit_relu)
        if self.calib is not None:
            self._record(x)
        if self.act_scale is None:  # dynamic, per lane
            sx = symmetric_scale(x.detach().abs().amax((1, 2, 3)))
            xin = round_clip_s8(x.float(), sx.view(-1, 1, 1, 1))
        else:
            sx = self.act_scale.reshape(-1)
            if self.fused:
                xin = x  # quantized inside the conv kernel
            elif self.quantize_kernel:
                xin = quantize_act(_nhwc(x), sx).permute(0, 3, 1, 2)
            else:
                s = lane_scales(sx, x.shape[0], x.device)
                xin = round_clip_s8(x.float(), s.view(-1, 1, 1, 1))
        return self._convolve(xin, sx, emit_scale, emit_relu)

    def _convolve(self, xin, sx, emit_scale, emit_relu) -> torch.Tensor:
        """Convolution + float32 epilogue of NCHW ``xin`` at the per-lane
        scale ``sx``: int8 ``xin`` is already quantized at ``sx``, a float
        ``xin`` is quantized inside the kernel (the fused form)."""
        wq, sw, packed = self._quantized_weights()
        dt = self.compute_dtype
        if self.kernel_size[0] == 3:
            y = quant_conv3x3(_nhwc(xin), wq, sw, sx, self.bias, out_dtype=dt,
                              emit_scale=emit_scale, emit_relu=emit_relu, packed=packed)
        else:
            b, c, h, w = xin.shape
            y = quant_matmul(_nhwc(xin).view(b, h * w, c), wq, sw, sx, self.bias,
                             out_dtype=dt, packed=packed).view(b, h, w, -1)
        return y.permute(0, 3, 1, 2)

    def _fake_quant(self, x: torch.Tensor) -> torch.Tensor:
        """QAT forward (``layers.py:305-341``): activations (per lane) and
        weights (per output channel) projected onto the int8 grid, the conv
        in ``compute_dtype``, straight-through gradients, scales without
        gradient."""
        xf = x.float()
        sx = symmetric_scale(xf.detach().abs().amax((1, 2, 3))).view(-1, 1, 1, 1)
        sw = symmetric_scale(self.weight.detach().abs().amax((1, 2, 3))).view(-1, 1, 1, 1)

        def ste(v, s):
            q = torch.clamp(torch.round(v / s), -127, 127) * s
            return v + (q - v).detach()

        dt = self.compute_dtype
        y = F.conv2d(ste(xf, sx).to(dt), ste(self.weight, sw).to(dt), padding=self.padding)
        return (y.float() + self.bias[:, None, None]).to(dt)


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

    def __init__(self, nf: int, dtype: torch.dtype = torch.float32, quant: Any = False):
        super().__init__()
        self.chain = quant_mode(quant) in CHAIN_MODES
        self.conv1 = _conv(nf, nf, 3, dtype, quant)
        self.conv2 = _conv(nf, nf, 3, dtype, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s2 = self.conv2.act_scale if self.chain else None
        if s2 is not None:
            # chained epilogue: conv1 emits int8 at conv2's static scale
            # (rescale + bias + relu + quantize in one kernel), so neither the
            # bf16 intermediate nor conv2's quantize pass exists.  conv2's
            # input skips one bf16 rounding against the unchained path.
            h = self.conv1(x, emit_scale=s2.reshape(-1), emit_relu=True)
            return x + self.conv2(h, in_scale=s2.reshape(-1))
        return x + self.conv2(F.relu(self.conv1(x)))


def init_weights(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Draw every conv (float or int8) of ``module`` afresh from
    ``generator`` (norms keep their ones / zeros)."""
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

    def __init__(self, nf: int, dtype: torch.dtype = torch.float32, quant: Any = False):
        super().__init__()
        self.dtype = dtype
        q = quant
        self.conv1 = ResidualBlock(nf, dtype, q)         # tied: also "conv2"
        self.convf1 = _conv(2 * nf, nf, 1, dtype, q)     # tied: also "convf2"
        self.norm_s = ChannelLayerNorm(nf, dtype=dtype)
        self.clustering = _conv(nf, nf, 1, dtype, q)
        self.unclustering = _conv(2 * nf, nf, 1, dtype, q)
        self.v1 = _conv(nf, nf, 1, dtype, q)
        self.v2 = _conv(nf, nf, 1, dtype, q)
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

    def __init__(self, nf: int, dtype: torch.dtype = torch.float32, quant: Any = False):
        super().__init__()
        self.conv1 = ResidualBlock(nf, dtype, quant)     # tied: also conv2
        self.conv1_st = ResidualBlock(nf, dtype, quant)  # tied: also conv2_st
        self.lBIE = BIE(nf, dtype, quant)
        self.gBIE = BIE(nf, dtype, quant)

    def forward(self, x_1, x_2, x_s, x_1_st, x_2_st, x_1_s_st, x_2_s_st):
        x_1 = self.conv1(x_1)
        x_2 = self.conv1(x_2)
        x_1_st = self.conv1_st(x_1_st)
        x_2_st = self.conv1_st(x_2_st)

        x_1, x_1_st, x_1_s_st = self.lBIE(x_1, x_1_st, x_1_s_st)
        x_2, x_2_st, x_2_s_st = self.lBIE(x_2, x_2_st, x_2_s_st)

        x_1, x_2, x_s = self.gBIE(x_1, x_2, x_s)
        return x_1, x_2, x_s, x_1_st, x_2_st, x_1_s_st, x_2_s_st
