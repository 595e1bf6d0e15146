"""The full BMCNet forward in plain PyTorch (a frozen copy of its arithmetic).

Follows BMCNet (CVPR 2024, Lqm26/BMCNet-ESR ``models/BMCNet.py``) as the
port lays it out: windows ``x [B, 2, H, W, 2]``, states ``[B, H, W, n_c]``
and the previous HR prediction ``o_hr [B, kH, kW, 2]``, NHWC at the call;
one shared ``ParallelBlk`` applied ``n_b`` times; tied convolutions
(``conv_fnst = conv_fpst``, ``conv_fns = conv_fps``, each block's ``conv2 =
conv1``); the reference's state rotation into the backbone (``x_h`` feeds
``hp``, ``x_h_p`` feeds ``hn``, ``x_h_n`` feeds ``hs``); channel LayerNorm
with eps 1e-6 inside the rsqrt; the BIE attention's logits summed over the
pixels, softmax at ``n_c ** -0.5``; the HR head ``pixel_shuffle(x_o) +
bilinear(x2)``.  Parameters are a flat dict under the reference state dict's
names (``neuro.conv_fpst.weight``, ...).

``conv`` is the one hook: every convolution goes through it, so a caller
can compute the convolutions otherwise (``reference/quant.py`` fake-quantizes
them for the lower-precision control).  Everything else runs in the dtype
of the inputs, float32 for the checks.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def param_shapes(n_c: int, n_b: int, scale: int, repeat: int) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, in the state dict's order."""
    s2, r = scale * scale, repeat
    shapes: Dict[str, Tuple[int, ...]] = {}

    def conv(name, cin, cout, k):
        shapes[f"{name}.weight"] = (cout, cin, k, k)
        shapes[f"{name}.bias"] = (cout,)

    conv("neuro.conv_fpst", 2 * r + n_c + s2, n_c, 3)
    conv("neuro.conv_fps", r + n_c, n_c, 3)
    conv("neuro.conv_fs", 3 * n_c + 2 * s2, n_c, 3)
    blk = "neuro.para_reschunk"
    for res in ("conv1", "conv1_st"):
        conv(f"{blk}.{res}.conv1", n_c, n_c, 3)
        conv(f"{blk}.{res}.conv2", n_c, n_c, 3)
    for bie in ("lBIE", "gBIE"):
        p = f"{blk}.{bie}"
        conv(f"{p}.conv1.conv1", n_c, n_c, 3)
        conv(f"{p}.conv1.conv2", n_c, n_c, 3)
        conv(f"{p}.convf1", 2 * n_c, n_c, 1)
        shapes[f"{p}.norm_s.weight"] = (n_c,)
        shapes[f"{p}.norm_s.bias"] = (n_c,)
        conv(f"{p}.clustering", n_c, n_c, 1)
        conv(f"{p}.unclustering", 2 * n_c, n_c, 1)
        conv(f"{p}.v1", n_c, n_c, 1)
        conv(f"{p}.v2", n_c, n_c, 1)
    for name in ("conv_hs", "conv_hp", "conv_hn"):
        conv(f"neuro.{name}", n_c, n_c, 3)
    conv("neuro.conv_o", 2 * n_c, 2 * s2, 3)
    return shapes


def plain_conv(name: str, x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    x = x.contiguous(memory_format=torch.channels_last)
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2)


@lru_cache(maxsize=16)
def _bilinear_np(n_in: int, n_out: int) -> np.ndarray:
    """``[n_out, n_in]`` weights of ``F.interpolate(mode='bilinear',
    align_corners=False)`` along one axis (source ``(dst + 0.5) * in / out -
    0.5`` clamped at 0, taps ``floor`` and ``floor + 1`` clamped at the
    border)."""
    src = np.maximum((np.arange(n_out, dtype=np.float64) + 0.5) * n_in / n_out - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w1 = np.clip(src - i0, 0.0, 1.0)
    m = np.zeros((n_out, n_in))
    np.add.at(m, (np.arange(n_out), i0), 1.0 - w1)
    np.add.at(m, (np.arange(n_out), i1), w1)
    return m


def bilinear_up(x: Tensor, scale: int) -> Tensor:
    """``[B, H, W, C]`` -> ``[B, sH, sW, C]``, bilinear, in float32 at least."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    h, w = x.shape[1], x.shape[2]
    my = torch.as_tensor(_bilinear_np(h, h * scale), dtype=x.dtype, device=x.device)
    mx = torch.as_tensor(_bilinear_np(w, w * scale), dtype=x.dtype, device=x.device)
    return torch.einsum("ph,bhwc,qw->bpqc", my, x, mx)


class Net:
    """``h, hp, hn, pred = Net(params, ...)(x, h, hp, hn, o_hr)``."""

    def __init__(self, params: Params, n_c: int, n_b: int, scale: int, repeat: int,
                 conv: Callable[[str, Tensor, Tensor, Tensor], Tensor] = plain_conv):
        self.p, self.n_c, self.n_b, self.scale, self.repeat = params, n_c, n_b, scale, repeat
        self.s2 = scale * scale
        self._conv = conv
        self.att_scale = float(np.float32(n_c) ** np.float32(-0.5))

    def c(self, name: str, x: Tensor) -> Tensor:
        return self._conv(name, x, self.p[f"{name}.weight"].to(x.dtype),
                          self.p[f"{name}.bias"].to(x.dtype))

    def init_state(self, b: int, h: int, w: int, dtype=torch.float32, device=None):
        z = torch.zeros((b, h, w, self.n_c), dtype=dtype, device=device)
        o = torch.zeros((b, h * self.scale, w * self.scale, 2), dtype=dtype, device=device)
        return z, z.clone(), z.clone(), o

    def _norm(self, name: str, x: Tensor) -> Tensor:
        mu = x.mean(1, keepdim=True)
        var = (x - mu).square().mean(1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + 1e-6)
        return y * self.p[f"{name}.weight"].to(x.dtype)[:, None, None] \
            + self.p[f"{name}.bias"].to(x.dtype)[:, None, None]

    def _res(self, name: str, x: Tensor) -> Tensor:
        return x + self.c(f"{name}.conv2", F.relu(self.c(f"{name}.conv1", x)))

    def _attend(self, center: Tensor, v: Tensor) -> Tensor:
        b, c, h, w = v.shape
        tc = center.reshape(b, c, h * w)
        tv = v.reshape(b, c, h * w)
        logits = torch.bmm(tc, tv.transpose(1, 2))  # [B, C, C], summed over the pixels
        att = torch.softmax(logits * self.att_scale, dim=-1)
        return torch.bmm(att, tv).reshape(b, c, h, w)

    def _bie(self, name: str, x_1: Tensor, x_2: Tensor, x_s: Tensor):
        x_1_ = self._res(f"{name}.conv1", x_1)
        x_2_ = self._res(f"{name}.conv1", x_2)
        center1 = self.c(f"{name}.clustering",
                         self._norm(f"{name}.norm_s", self.c(f"{name}.convf1",
                                                             torch.cat([x_s, x_2], 1))))
        center2 = self.c(f"{name}.clustering",
                         self._norm(f"{name}.norm_s", self.c(f"{name}.convf1",
                                                             torch.cat([x_s, x_1], 1))))
        out_1 = self._attend(center1, self.c(f"{name}.v1", x_1))
        out_2 = self._attend(center2, self.c(f"{name}.v2", x_2))
        x_s_ = self.c(f"{name}.unclustering", torch.cat([center1, center2], 1)) + x_s
        return out_1 + x_2_, out_2 + x_1_, x_s_

    def _blk(self, x_1, x_2, x_s, x_1_st, x_2_st, x_1_s_st, x_2_s_st):
        b = "neuro.para_reschunk"
        x_1 = self._res(f"{b}.conv1", x_1)
        x_2 = self._res(f"{b}.conv1", x_2)
        x_1_st = self._res(f"{b}.conv1_st", x_1_st)
        x_2_st = self._res(f"{b}.conv1_st", x_2_st)
        x_1, x_1_st, x_1_s_st = self._bie(f"{b}.lBIE", x_1, x_1_st, x_1_s_st)
        x_2, x_2_st, x_2_s_st = self._bie(f"{b}.lBIE", x_2, x_2_st, x_2_s_st)
        x_1, x_2, x_s = self._bie(f"{b}.gBIE", x_1, x_2, x_s)
        return x_1, x_2, x_s, x_1_st, x_2_st, x_1_s_st, x_2_s_st

    def __call__(self, x: Tensor, x_h: Tensor, x_h_p: Tensor, x_h_n: Tensor, o_hr: Tensor):
        dt = x_h.dtype
        x = x.to(dt)
        r = self.repeat
        nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
        f1, f2 = x[:, 0], x[:, 1]
        x1p, x1n, x2p, x2n = [nchw(f[..., c:c + 1]).repeat(1, r, 1, 1)
                              for f in (f1, f2) for c in (0, 1)]
        o = F.pixel_unshuffle(nchw(o_hr.to(dt)), self.scale)
        hp, hn, hs = nchw(x_h), nchw(x_h_p), nchw(x_h_n)  # the reference's rotation
        n = "neuro"
        xp, xn = torch.cat([x1p, x2p], 1), torch.cat([x1n, x2n], 1)
        op, on = o[:, :self.s2], o[:, self.s2:]
        xp_st = F.relu(self.c(f"{n}.conv_fpst", torch.cat([xp, hp, op], 1)))
        xn_st = F.relu(self.c(f"{n}.conv_fpst", torch.cat([xn, hn, on], 1)))
        xp_s = F.relu(self.c(f"{n}.conv_fps", torch.cat([x2p, hp], 1)))
        xn_s = F.relu(self.c(f"{n}.conv_fps", torch.cat([x2n, hn], 1)))
        xs_ = torch.cat([xp_st, xn_st], 1)
        x_s = F.relu(self.c(f"{n}.conv_fs", torch.cat([xs_, hs, o], 1)))
        xs_p_st = F.relu(self.c(f"{n}.conv_fs", torch.cat([xs_, hp, o], 1)))
        xs_n_st = F.relu(self.c(f"{n}.conv_fs", torch.cat([xs_, hn, o], 1)))
        state = (xp_s, xn_s, x_s, xp_st, xn_st, xs_p_st, xs_n_st)
        for _ in range(self.n_b):
            state = self._blk(*state)
        xp_s, xn_s, x_s, xp_st, xn_st, xs_p_st, xs_n_st = state
        x_h = F.relu(self.c(f"{n}.conv_hs", x_s))
        x_h_p = F.relu(self.c(f"{n}.conv_hp", xs_p_st))
        x_h_n = F.relu(self.c(f"{n}.conv_hn", xs_n_st))
        x_o = self.c(f"{n}.conv_o", torch.cat([xp_s, xn_s], 1))
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        pred = nhwc(F.pixel_shuffle(x_o, self.scale)) + bilinear_up(f2, self.scale).to(dt)
        return nhwc(x_h), nhwc(x_h_p), nhwc(x_h_n), pred


def skip_of(x: Tensor, scale: int) -> Tensor:
    """The HR head's bilinear skip of a window pair ``[B, 2, H, W, 2]``."""
    return bilinear_up(x[:, 1].float(), scale)
