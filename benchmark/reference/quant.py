"""Fake-quantized convolutions for the lower-precision controls.

The W8A8 scheme of the program's int8 modes, at any bit width: weights
symmetric per output channel (``max|W| / qmax``), activations symmetric per
lane at a static scale calibrated as ``max|x| / qmax`` over the first (up to
16) recurrent steps of a stream, the maximum over every call site of a tied
convolution; values rounded half to even and clipped to ``[-qmax, qmax]``,
the convolution itself in float32.  At 4 bits this is the int4 control of a
cell that serves in int8."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _q(v: Tensor, s: Tensor, qmax: int) -> Tensor:
    return torch.clamp(torch.round(v / s), -qmax, qmax) * s


class FakeQuantConv:
    """``conv(name, x, w, b)`` for :class:`reference.model.Net`."""

    def __init__(self, bits: int):
        self.qmax = 2 ** (bits - 1) - 1
        self.scales: Optional[Dict[str, Tensor]] = None  # static, per lane
        self.record: Optional[Dict[str, Tensor]] = None  # calibration maxima

    def __call__(self, name: str, x: Tensor, w: Tensor, b: Tensor) -> Tensor:
        sw = torch.clamp(w.abs().amax((1, 2, 3), keepdim=True), min=1e-12) / self.qmax
        lane_max = x.abs().amax((1, 2, 3))
        if self.scales is not None:
            sx = self.scales[name]
        else:  # dynamic, while calibrating
            sx = torch.clamp(lane_max, min=1e-12) / self.qmax
            if self.record is not None:
                old = self.record.get(name)
                self.record[name] = lane_max if old is None else torch.maximum(old, lane_max)
        xq = _q(x, sx.view(-1, 1, 1, 1), self.qmax)
        return F.conv2d(xq, _q(w, sw, self.qmax), b, padding=w.shape[-1] // 2)

    def calibrate(self, net, pairs: Sequence[Tensor], carry, steps: int = 16) -> None:
        """Static scales from up to ``steps`` recurrent steps over ``pairs``."""
        self.scales, self.record = None, {}
        for pair in list(pairs)[:steps]:
            carry = net(pair, *carry)
        self.scales = {k: torch.clamp(v, min=1e-12) / self.qmax for k, v in self.record.items()}
        self.record = None
