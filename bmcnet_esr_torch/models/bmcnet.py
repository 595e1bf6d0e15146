"""BMCNet (full, two-stream) and BMCNet_plain as PyTorch modules.

Counterpart of ``bmcnet_esr_tpu/models/bmcnet.py``, with the same call
signature and layouts at ``forward``: windows ``x [B, 2, H, W, 2]``, states
``[B, H, W, n_c]`` and the previous HR prediction ``o_hr [B, kH, kW, 2]``, all
NHWC.  Inside, activations are NCHW views of those channels-last tensors, so
cuDNN gets channels-last convolutions and no layout copy is made.  Kept from
the JAX package (and the reference):

* ONE shared block applied ``n_b`` times;
* tied aliases ``conv_f2 = conv_f1``, ``conv_fnst = conv_fpst`` and
  ``conv_fns = conv_fps`` (one module called at both sites);
* the full model's state-slot rotation into the backbone (``bmcnet.py:135-140``);
* zeros-HR as the initial ``o_hr`` (``init_state``);
* ``pred`` cast back to the model dtype after the float32 bilinear skip;
* the ``quant`` mode of the int8 serving path (``models/layers.py``),
  threaded into every convolution.

Module and parameter names are the reference state dict's canonical keys
(``models/convert.py``), e.g. ``neuro.para_reschunk.norm_s.weight``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bmcnet_esr_torch.models.layers import BIE, ParallelBlk, _conv, init_weights, quant_mode
from bmcnet_esr_torch.ops.resize import upsample_bilinear

Tensor = torch.Tensor


def _nchw(t: Tensor) -> Tensor:
    return t.permute(0, 3, 1, 2)


def _nhwc(t: Tensor) -> Tensor:
    return t.permute(0, 2, 3, 1)


class Backbone(nn.Module):
    """Two-stream fusion backbone (reference ``models/BMCNet.py:35-84``)."""

    def __init__(self, n_c: int, n_b: int, scale: int, repeat: int = 3,
                 dtype: torch.dtype = torch.float32, quant: Any = False):
        super().__init__()
        s2, r, q = scale**2, repeat, quant
        self.n_b = n_b
        self.conv_fpst = _conv(2 * r + n_c + s2, n_c, 3, dtype, q)  # tied: also conv_fnst
        self.conv_fps = _conv(r + n_c, n_c, 3, dtype, q)            # tied: also conv_fns
        self.conv_fs = _conv(3 * n_c + 2 * s2, n_c, 3, dtype, q)
        self.para_reschunk = ParallelBlk(n_c, dtype, q)              # shared n_b times
        self.conv_hs = _conv(n_c, n_c, 3, dtype, q)
        self.conv_hp = _conv(n_c, n_c, 3, dtype, q)
        self.conv_hn = _conv(n_c, n_c, 3, dtype, q)
        self.conv_o = _conv(2 * n_c, 2 * s2, 3, dtype, q)
        self.s2 = s2

    def forward(self, xs: Sequence[Tensor], hp: Tensor, hn: Tensor, hs: Tensor, o: Tensor):
        x1p, x1n, x2p, x2n = xs
        xp = torch.cat([x1p, x2p], 1)
        xn = torch.cat([x1n, x2n], 1)

        op, on = o[:, : self.s2], o[:, self.s2 :]
        xp_st = F.relu(self.conv_fpst(torch.cat([xp, hp, op], 1)))
        xn_st = F.relu(self.conv_fpst(torch.cat([xn, hn, on], 1)))  # tied
        xp_s = F.relu(self.conv_fps(torch.cat([x2p, hp], 1)))
        xn_s = F.relu(self.conv_fps(torch.cat([x2n, hn], 1)))  # tied

        xs_ = torch.cat([xp_st, xn_st], 1)
        x_s = F.relu(self.conv_fs(torch.cat([xs_, hs, o], 1)))
        xs_p_st = F.relu(self.conv_fs(torch.cat([xs_, hp, o], 1)))
        xs_n_st = F.relu(self.conv_fs(torch.cat([xs_, hn, o], 1)))

        for _ in range(self.n_b):  # ONE shared block applied n_b times
            xp_s, xn_s, x_s, xp_st, xn_st, xs_p_st, xs_n_st = self.para_reschunk(
                xp_s, xn_s, x_s, xp_st, xn_st, xs_p_st, xs_n_st
            )

        x_h = F.relu(self.conv_hs(x_s))
        x_h_p = F.relu(self.conv_hp(xs_p_st))
        x_h_n = F.relu(self.conv_hn(xs_n_st))
        x_o = self.conv_o(torch.cat([xp_s, xn_s], 1))
        return x_h, x_h_p, x_h_n, x_o


class PlainBackbone(nn.Module):
    """Single-stream backbone (reference ``models/BMCNet_plain.py:3-33``)."""

    def __init__(self, n_c: int, n_b: int, scale: int, repeat: int = 3,
                 dtype: torch.dtype = torch.float32, quant: Any = False):
        super().__init__()
        s2, r, q = scale**2, repeat, quant
        self.n_b = n_b
        self.conv_f1 = _conv(2 * r + n_c + s2, n_c, 3, dtype, q)  # tied: also conv_f2
        self.conv_fs = _conv(4 * r + n_c + 2 * s2, n_c, 3, dtype, q)
        self.para_reschunk = BIE(n_c, dtype, q)                    # shared n_b times
        self.conv_h = _conv(n_c, n_c, 3, dtype, q)
        self.conv_o = _conv(2 * n_c, 2 * s2, 3, dtype, q)
        self.s2 = s2

    def forward(self, x1: Tensor, x2: Tensor, h: Tensor, o: Tensor):
        xs = torch.cat([x1, x2], 1)
        o1, o2 = o[:, : self.s2], o[:, self.s2 :]
        x1 = F.relu(self.conv_f1(torch.cat([x1, h, o1], 1)))
        x2 = F.relu(self.conv_f1(torch.cat([x2, h, o2], 1)))  # tied
        xs = F.relu(self.conv_fs(torch.cat([xs, h, o], 1)))

        for _ in range(self.n_b):
            x1, x2, xs = self.para_reschunk(x1, x2, xs)

        x_h = F.relu(self.conv_h(xs))
        x_o = self.conv_o(torch.cat([x1, x2], 1))
        return x_h, x_o


class _Model(nn.Module):
    """Shared shell: dtype, quant mode, input split and the HR head."""

    n_states: int

    def __init__(self, scale: int, n_c: int, n_b: int, repeat: int, dtype, quant):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        quant_mode(quant)  # an unknown mode raises here
        self.scale, self.n_c, self.n_b, self.repeat, self.dtype = scale, n_c, n_b, repeat, dtype
        self.quant = quant

    def _split(self, x: Tensor):
        """``[B, 2, H, W, 2]`` -> float windows and per-polarity NCHW inputs."""
        x = x.to(self.dtype)
        f1, f2 = x[:, 0], x[:, 1]
        r = self.repeat
        pol = [_nchw(f[..., c : c + 1]).repeat(1, r, 1, 1) for f in (f1, f2) for c in (0, 1)]
        return f2, pol  # pol = [f1 pos, f1 neg, f2 pos, f2 neg]

    def _head(self, x_o: Tensor, f2: Tensor) -> Tensor:
        pred = _nhwc(F.pixel_shuffle(x_o, self.scale)) + upsample_bilinear(f2, self.scale)
        return pred.to(self.dtype)

    def init_state(self, batch: int, h: int, w: int, device=None) -> Tuple[Tensor, ...]:
        """Zero recurrent state and zeros-HR prediction for a stream start."""
        device = device if device is not None else next(self.parameters()).device
        z = torch.zeros((batch, h, w, self.n_c), dtype=self.dtype, device=device)
        o = torch.zeros((batch, h * self.scale, w * self.scale, 2), dtype=self.dtype, device=device)
        return (z,) * self.n_states + (o,)


class BMCNet(_Model):
    """Full two-stream BMCNet (reference ``models/BMCNet.py:87-121``).

    ``h, hp, hn, pred = model(x, h, hp, hn, o_hr)``.
    """

    n_states = 3

    def __init__(self, scale: int, n_c: int = 128, n_b: int = 5, repeat: int = 3,
                 dtype: torch.dtype = torch.float32, quant=False,
                 generator: Optional[torch.Generator] = None):
        super().__init__(scale, n_c, n_b, repeat, dtype, quant)
        self.neuro = Backbone(n_c, n_b, scale, repeat, dtype, quant)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, x: Tensor, x_h: Tensor, x_h_p: Tensor, x_h_n: Tensor, o_hr: Tensor):
        f2, (x1p, x1n, x2p, x2n) = self._split(x)
        o_lr = F.pixel_unshuffle(_nchw(o_hr.to(self.dtype)), self.scale)
        # Quirk kept on purpose: the reference passes (x_h, x_h_p, x_h_n)
        # positionally into Backbone.forward(xs, hp, hn, hs, o), so the shared
        # state feeds the hp slot, x_h_p feeds hn and x_h_n feeds hs.  The
        # released checkpoints were trained with this rotation.
        x_h, x_h_p, x_h_n, x_o = self.neuro(
            [x1p, x1n, x2p, x2n],
            _nchw(x_h.to(self.dtype)), _nchw(x_h_p.to(self.dtype)), _nchw(x_h_n.to(self.dtype)),
            o_lr,
        )
        return _nhwc(x_h), _nhwc(x_h_p), _nhwc(x_h_n), self._head(x_o, f2)


class BMCNetPlain(_Model):
    """Single-stream BMCNet_plain (reference ``models/BMCNet_plain.py:36-68``).

    ``h, pred = model(x, h, o_hr)``.
    """

    n_states = 1

    def __init__(self, scale: int, n_c: int = 128, n_b: int = 5, repeat: int = 3,
                 dtype: torch.dtype = torch.float32, quant=False,
                 generator: Optional[torch.Generator] = None):
        super().__init__(scale, n_c, n_b, repeat, dtype, quant)
        self.neuro = PlainBackbone(n_c, n_b, scale, repeat, dtype, quant)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, x: Tensor, x_h: Tensor, o_hr: Tensor):
        f2, (x1p, x1n, x2p, x2n) = self._split(x)
        # branch inputs concat both windows per polarity
        x1 = torch.cat([x1p, x2p], 1)
        x2 = torch.cat([x1n, x2n], 1)
        o_lr = F.pixel_unshuffle(_nchw(o_hr.to(self.dtype)), self.scale)
        x_h, x_o = self.neuro(x1, x2, _nchw(x_h.to(self.dtype)), o_lr)
        return _nhwc(x_h), self._head(x_o, f2)
