"""Tensor parallelism: the crossings of the model axis and the forward of
``BMCNet`` and ``BMCNetPlain`` over channel slices.

The JAX package lays the train state over a ``("data", "model")`` mesh with
``channel_sharding`` and lets GSPMD partition the jitted step, so it has no
file like this one.  Here the partition is written out.  Rank ``r`` of a
model group of ``N`` holds output channels ``[r*C/N, (r+1)*C/N)`` of every
convolution and ``ChannelLayerNorm`` whose channels ``N`` divides
(``parallel/mesh.py::channel_sharding``); the rest is replicated.  What a
split convolution makes is this rank's channels of the activation; every
other tensor is whole on every rank.  :class:`ChannelParallelForward` walks
the submodules of ``models/bmcnet.py`` and ``models/layers.py`` on the
rank's parameters, and every cross-rank rule is in this file.

A tensor crosses the model axis where its layout is not the one its consumer
needs.  Each crossing is a ``torch.autograd.Function`` whose backward is the
sum over the model ranks of what they computed from it, and sums nothing
that every rank computed alike:

* a slice into a split consumer (a split convolution, the attention's
  ``v``): gathered along channels; backward, the sum over the ranks of the
  gradient, this rank's slice of it (reduce-scatter);
* a slice into a replicated consumer (the head's pixel shuffle, a
  convolution whose channels ``N`` does not divide): gathered; backward,
  this rank's slice of the gradient, which every rank computed alike;
* a whole tensor into split consumers (the recurrent HR output after pixel
  unshuffle, which feeds ``conv_fpst`` / ``conv_fs`` or ``conv_f1`` /
  ``conv_fs``): itself; backward, the sum over the ranks of its gradient
  (all-reduce).  Without it BPTT through the HR output gets ``1/N`` of it.

The per-module rules:

* ``ChannelLayerNorm`` (``layers.py:368``): the channel mean and variance
  are sums over the ranks (all-reduce forward and backward); the float32
  path keeps its two passes, two all-reduces, the bf16 path sums ``x`` and
  ``x**2`` in one;
* the BIE attention (``layers.py:437-492``): its logits ``[B, C, C]`` are
  channel against channel, summed over the pixels.  The rank that holds
  rows ``i`` of ``center`` gathers ``v`` whole, computes its rows of the
  logits, the softmax over whole rows, and its output channels: one gather,
  no reduction;
* QAT: the per-lane activation scale is a max over the convolution's input,
  which is whole; the per-output-channel weight scale is local.

On CUDA the forward runs its float32 convolutions through PyTorch's own
kernels (im2col and a GEMM, forward and backward), not cuDNN's.  At a
rank's sliced shapes (131, 150 or 128 -> 64 channels) cuDNN picks FFT
convolutions, whose output is not exactly zero where the input patch is.
At the first step, with zero biases and zero states, many ReLU inputs are
exactly 0, and through FFT about half of them pass their gradient: the
tensor-parallel gradient sat 35 times further from float64 than the
one-device one.  A GEMM over an all-zero patch sums exact zeros, and at
these shapes the own kernels also ran several times faster than the FFT
ones on an H100.  On the CPU ``F.conv2d`` stays:
there the sliced convolutions keep the one-device step's parameters within
atol 1e-5, QAT's included, and PyTorch's own kernels, which sum in another
order, move QAT's rounding past that.  Against the one-device forward,
float32 then differs by the order of the channel sums (the LayerNorm
statistics, a convolution's input gradient summed over the ranks) and by
the convolution kernels.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.utils import _pair
from torch.overrides import TorchFunctionMode

from bmcnet_esr_torch.models.bmcnet import Backbone
from bmcnet_esr_torch.models.layers import Conv, quant_mode
from bmcnet_esr_torch.ops.resize import upsample_bilinear
from bmcnet_esr_torch.parallel.mesh import splits

Tensor = torch.Tensor

# collectives over the model axis by kind, and the bytes of the whole tensor
# each moved (the gathered output, the reduce-scatter's input, the summed
# tensor), counted where they are issued, backward included
collectives: collections.Counter = collections.Counter()
collective_bytes: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class ChannelGroup:
    """The model axis as one rank sees it: the group, its size, the place.

    Its collectives take several ``[B, c_i, H, W]`` tensors at once and move
    them in one call (packed flat, NHWC), so the crossings that are ready
    together cost one collective."""

    group: object
    n: int
    rank: int

    @classmethod
    def of(cls, mesh, axis: str = "model") -> Optional["ChannelGroup"]:
        """``mesh``'s ``axis``, or ``None`` when it has no such axis."""
        if axis not in (mesh.mesh_dim_names or ()):
            return None
        group = mesh.get_group(axis)
        return cls(group, dist.get_world_size(group), dist.get_rank(group))

    @staticmethod
    def _count(kind: str, t: Tensor, copies: int = 1) -> None:
        collectives[kind] += 1
        collective_bytes[kind] += t.numel() * t.element_size() * copies

    def gather(self, xs: Sequence[Tensor]) -> List[Tensor]:
        """Every rank's ``xs`` joined along channels in rank order:
        ``[B, N*c_i, H, W]`` each, channels-last."""
        parts = [x.permute(0, 2, 3, 1) for x in xs]
        flat = torch.cat([p.reshape(-1) for p in parts])
        ranks = [torch.empty_like(flat) for _ in range(self.n)]
        dist.all_gather(ranks, flat, group=self.group)
        out, off = [], 0
        for p in parts:
            whole = torch.cat([r[off : off + p.numel()].view(p.shape) for r in ranks], 3)
            out.append(whole.permute(0, 3, 1, 2))
            off += p.numel()
        self._count("all_gather", flat, self.n)
        return out

    def reduce_scatter(self, gs: Sequence[Tensor]) -> List[Tensor]:
        """This rank's channels of the sum over the ranks of each of ``gs``."""
        chunks = [g.permute(0, 2, 3, 1).chunk(self.n, 3) for g in gs]
        flats = [torch.cat([c[r].reshape(-1) for c in chunks]) for r in range(self.n)]
        out = torch.empty_like(flats[0])
        dist.reduce_scatter(out, flats, group=self.group)
        self._count("reduce_scatter", out, self.n)
        res, off = [], 0
        for c in chunks:
            shape = c[self.rank].shape
            res.append(out[off : off + c[self.rank].numel()].view(shape).permute(0, 3, 1, 2))
            off += c[self.rank].numel()
        return res

    def own(self, g: Tensor) -> Tensor:
        """This rank's channels of ``g``."""
        return g.chunk(self.n, 1)[self.rank]

    def all_reduce(self, t: Tensor) -> Tensor:
        """The sum over the ranks of ``t``, a new tensor."""
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.group)
        self._count("all_reduce", out)
        return out


class _Gather(torch.autograd.Function):
    """Slices made whole; backward: reduce-scatter for split consumers
    (``scatter``), this rank's slices for replicated ones."""

    @staticmethod
    def forward(ctx, axis: ChannelGroup, scatter: bool, *xs):
        ctx.axis, ctx.scatter = axis, scatter
        return tuple(axis.gather(xs))

    @staticmethod
    def backward(ctx, *gs):
        a = ctx.axis
        return (None, None, *(a.reduce_scatter(gs) if ctx.scatter else [a.own(g) for g in gs]))


class _SumGrad(torch.autograd.Function):
    """A whole tensor into split consumers: itself; backward, all-reduce."""

    @staticmethod
    def forward(ctx, x, axis: ChannelGroup):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


class _Sum(torch.autograd.Function):
    """The sum over the ranks, each rank's copy used for its own channels;
    backward, all-reduce."""

    @staticmethod
    def forward(ctx, x, axis: ChannelGroup):
        ctx.axis = axis
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


def cross(ts: Sequence[Tensor], axis: ChannelGroup, split: bool, to_split: bool) -> List[Tensor]:
    """``ts`` whole for their consumers, in one collective: ``split`` says
    whether each is this rank's channels, ``to_split`` whether the consumers
    compute this rank's channels only (the crossings of the module
    docstring)."""
    if split:
        return list(_Gather.apply(axis, to_split, *ts))
    return [_SumGrad.apply(t, axis) for t in ts] if to_split else list(ts)


def sum_ranks(t: Tensor, axis: ChannelGroup) -> Tensor:
    """The sum over the model ranks of ``t``, differentiable."""
    return _Sum.apply(t, axis)


def own_conv2d(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None, stride=1, padding=0,
               dilation=1, groups=1) -> Optional[Tensor]:
    """``F.conv2d`` through PyTorch's own kernels, whose derivative is their
    own too (``aten._slow_conv2d_forward`` / ``_slow_conv2d_backward``):
    float32, ungrouped and undilated; ``None`` for any other call."""
    if (x.dtype != torch.float32 or groups != 1 or isinstance(padding, str)
            or _pair(dilation) != (1, 1)):
        return None
    # NCHW, the kernels' own layout.  A channels-last 1x1 weight counts as
    # contiguous but keeps strides that the CPU backward misreads (a wrong
    # weight gradient), so the weight is always copied to NCHW's strides
    return torch.ops.aten._slow_conv2d_forward(
        x.contiguous(), weight.clone(memory_format=torch.contiguous_format),
        list(weight.shape[2:]), bias, list(_pair(stride)), list(_pair(padding)))


class OwnConvolutions(TorchFunctionMode):
    """Inside it, every float32 ``F.conv2d`` goes through :func:`own_conv2d`
    (the module docstring says why); other dtypes keep cuDNN."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.conv2d:
            out = own_conv2d(*args, **kwargs)
            if out is not None:
                return out
        return func(*args, **kwargs)


class ChannelParallelForward(nn.Module):
    """``forward(x, *states)`` of ``model`` on one rank of a model group,
    the parameters cut to the rank's slices (``shard_tree_channels``).

    Takes and returns what the model does, but each recurrent state is this
    rank's channels of it (``init_state`` makes them); the prediction is
    whole on every rank.  The int8 serving modes run on one device; QAT
    trains here.  On CUDA, float32 convolutions run under
    :class:`OwnConvolutions`."""

    def __init__(self, model: nn.Module, axis: ChannelGroup):
        super().__init__()
        if quant_mode(model.quant) not in ("", "qat"):
            raise ValueError(f"quant={model.quant!r} serves on one device; the channel-parallel "
                             "forward trains float models and quant='qat'")
        self.model, self.axis = model, axis
        n = axis.n
        self.split = splits(model.n_c, n)  # the n_c-channel activations are slices
        self.split_o = splits(model.neuro.conv_o.out_channels, n)
        for name, m in model.named_modules():
            if isinstance(m, Conv):
                want = m.out_channels // n if splits(m.out_channels, n) else m.out_channels
                if m.weight.shape[0] != want:
                    raise ValueError(f"{name} holds {m.weight.shape[0]} output channels, not "
                                     f"this rank's {want}: cut the state to the rank's slices "
                                     "with parallel.shard_tree_channels")

    def init_state(self, batch: int, h: int, w: int, device=None):
        """Zero states, this rank's channels of each, and the zeros-HR output."""
        *hidden, o = self.model.init_state(batch, h, w, device)
        c = self.model.n_c // self.axis.n if self.split else self.model.n_c
        z = o.new_zeros((batch, h, w, c))
        return (z,) * len(hidden) + (o,)

    def forward(self, x: Tensor, *states: Tensor):
        with OwnConvolutions() if x.is_cuda else contextlib.nullcontext():
            return self._forward(x, *states)

    def _forward(self, x: Tensor, *states: Tensor):
        m = self.model
        f2, (*args, o) = m._prologue(x, *states)
        o, = cross([o], self.axis, False, self.split)  # feeds only n_c-channel convolutions
        if isinstance(m.neuro, Backbone):
            *hidden, x_o = self._backbone(m.neuro, *args, o)
        else:
            *hidden, x_o = self._plain_backbone(m.neuro, *args, o)
        x_o, = cross([x_o], self.axis, self.split_o, False)
        pred = m._head(x_o, upsample_bilinear(f2, m.scale))
        return (*[h.permute(0, 2, 3, 1) for h in hidden], pred)

    # -- the modules (models/bmcnet.py, models/layers.py) ---------------------

    def _whole(self, *ts: Tensor) -> List[Tensor]:
        """n_c-channel activations for n_c-channel consumers."""
        return cross(ts, self.axis, self.split, self.split)

    def _backbone(self, b, xs, hp, hn, hs, o):
        g = self._whole
        x1p, x1n, x2p, x2n = xs
        xp, xn = torch.cat([x1p, x2p], 1), torch.cat([x1n, x2n], 1)
        op, on = o[:, : b.s2], o[:, b.s2 :]
        hp_, hn_, hs_ = g(hp, hn, hs)
        xp_st = F.relu(b.conv_fpst(torch.cat([xp, hp_, op], 1)))
        xn_st = F.relu(b.conv_fpst(torch.cat([xn, hn_, on], 1)))
        xp_s = F.relu(b.conv_fps(torch.cat([x2p, hp_], 1)))
        xn_s = F.relu(b.conv_fps(torch.cat([x2n, hn_], 1)))
        xs_ = torch.cat(g(xp_st, xn_st), 1)
        x_s = F.relu(b.conv_fs(torch.cat([xs_, hs_, o], 1)))
        xs_p_st = F.relu(b.conv_fs(torch.cat([xs_, hp_, o], 1)))
        xs_n_st = F.relu(b.conv_fs(torch.cat([xs_, hn_, o], 1)))
        for _ in range(b.n_b):
            xp_s, xn_s, x_s, xp_st, xn_st, xs_p_st, xs_n_st = self._parallel_blk(
                b.para_reschunk, xp_s, xn_s, x_s, xp_st, xn_st, xs_p_st, xs_n_st)
        w_s, w_p, w_n = g(x_s, xs_p_st, xs_n_st)
        x_h, x_h_p, x_h_n = F.relu(b.conv_hs(w_s)), F.relu(b.conv_hp(w_p)), F.relu(b.conv_hn(w_n))
        x_o = b.conv_o(torch.cat(cross([xp_s, xn_s], self.axis, self.split, self.split_o), 1))
        return x_h, x_h_p, x_h_n, x_o

    def _plain_backbone(self, b, x1, x2, h, o):
        xs = torch.cat([x1, x2], 1)
        o1, o2 = o[:, : b.s2], o[:, b.s2 :]
        h_, = self._whole(h)
        x1 = F.relu(b.conv_f1(torch.cat([x1, h_, o1], 1)))
        x2 = F.relu(b.conv_f1(torch.cat([x2, h_, o2], 1)))
        xs = F.relu(b.conv_fs(torch.cat([xs, h_, o], 1)))
        for _ in range(b.n_b):
            x1, x2, xs = self._bie(b.para_reschunk, x1, x2, xs)
        x_h = F.relu(b.conv_h(*self._whole(xs)))
        return x_h, b.conv_o(torch.cat(cross([x1, x2], self.axis, self.split, self.split_o), 1))

    def _parallel_blk(self, m, x_1, x_2, x_s, x_1_st, x_2_st, x_1_s_st, x_2_s_st):
        x_1, x_2, x_1_st, x_2_st = self._residuals(
            [m.conv1, m.conv1, m.conv1_st, m.conv1_st], [x_1, x_2, x_1_st, x_2_st])
        x_1, x_1_st, x_1_s_st = self._bie(m.lBIE, x_1, x_1_st, x_1_s_st)
        x_2, x_2_st, x_2_s_st = self._bie(m.lBIE, x_2, x_2_st, x_2_s_st)
        x_1, x_2, x_s = self._bie(m.gBIE, x_1, x_2, x_s)
        return x_1, x_2, x_s, x_1_st, x_2_st, x_1_s_st, x_2_s_st

    def _residuals(self, blocks, xs, wholes=None) -> List[Tensor]:
        """``ResidualBlock`` ``blocks[i]`` on ``xs[i]``: ``x + conv2(relu(
        conv1(x)))``; ``wholes`` are ``xs`` already gathered."""
        wholes = self._whole(*xs) if wholes is None else wholes
        hs = self._whole(*[F.relu(b.conv1(w)) for b, w in zip(blocks, wholes)])
        return [x + b.conv2(h) for b, x, h in zip(blocks, xs, hs)]

    def _bie(self, m, x_1, x_2, x_s):
        g = self._whole
        w_1, w_2, w_s = g(x_1, x_2, x_s)
        x_1_, x_2_ = self._residuals([m.conv1, m.conv1], [x_1, x_2], [w_1, w_2])
        f_2, f_1 = (m.convf1(torch.cat([w_s, w], 1)) for w in (w_2, w_1))
        center1, center2 = (m.clustering(t) for t in g(*self._norms(m.norm_s, f_2, f_1)))
        v_1, v_2 = g(m.v1(w_1), m.v2(w_2))
        out_1, out_2 = m._attend(center1, v_1), m._attend(center2, v_2)
        x_s_ = m.unclustering(torch.cat(g(center1, center2), 1)) + x_s
        return out_1 + x_2_, out_2 + x_1_, x_s_

    def _norms(self, m, *xs: Tensor) -> List[Tensor]:
        """``ChannelLayerNorm`` ``m`` on each of ``xs``, this rank's
        channels of it: the statistics of all ``m.features`` channels,
        summed over the ranks (one all-reduce for every ``x`` a pass)."""
        if not self.split:
            return [m(x) for x in xs]
        x32 = [x.to(torch.promote_types(x.dtype, torch.float32)) for x in xs]
        k = len(xs)

        def total(parts):  # [B, k*j, H, W] channel sums of every rank, split per x
            return sum_ranks(torch.cat(parts, 1), self.axis).div(m.features).chunk(k, 1)

        if m.dtype != torch.bfloat16:
            mus = total([x.sum(1, keepdim=True) for x in x32])
            var = total([(x - mu).square().sum(1, keepdim=True) for x, mu in zip(x32, mus)])
        else:
            moments = total([torch.cat([x.sum(1, keepdim=True), x.square().sum(1, keepdim=True)],
                                       1) for x in x32])
            mus = [t[:, :1] for t in moments]
            var = [torch.clamp(t[:, 1:] - t[:, :1].square(), min=0.0) for t in moments]
        return [((x - mu) * torch.rsqrt(v + m.eps) * m.weight[:, None, None]
                 + m.bias[:, None, None]).to(m.dtype) for x, mu, v in zip(x32, mus, var)]
