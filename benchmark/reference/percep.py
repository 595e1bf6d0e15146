"""The RGB perceptual recipe's training steps in plain PyTorch.

One BPTT step's loss (``configs/train_RGB_percep.yml``) is

    mse + w_recon * recon + w_lpips * lpips + w_tc * temporal_consistency

with ``mse`` each clip's mean squared error between the HR prediction and
the GT counts of the pair's second window, averaged over the clips;
``recon`` the mean ``|pool(pred) - lr|``, the prediction mean-pooled by the
scale to the LR grid against that window's LR counts; ``lpips`` the count
images' LPIPS distance (``reference/lpips.py::perceptual``); and
``temporal_consistency`` the mean ``|pred_t - pred_{t-1}|``, zero at step 0.
A clip's loss sums the steps, the recurrent state starting at zero.

An iteration of ``accum`` micro-batches sums each micro-batch's gradient and
divides by ``accum``, its loss the mean of theirs: with every term a mean
over the clips, that is the whole batch's gradient.  Adam is
``reference/train.py``'s.  Each step's body is checkpointed
(``torch.utils.checkpoint``), recomputed in the backward from its inputs, so
that an RGB-size unroll fits: the recomputation repeats the same float32
arithmetic, and only memory differs from keeping every activation."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference import lpips as ref_lpips
from benchmark.reference import model as ref_model
from benchmark.reference import raster
from benchmark.reference.train import Adam

Tensor = torch.Tensor


def mse(pred: Tensor, gt: Tensor) -> Tensor:
    return torch.mean(torch.square(pred - gt), dim=(1, 2, 3)).mean()


def recon(pred: Tensor, lr: Tensor) -> Tensor:
    """``pred [B, kH, kW, C]`` mean-pooled to ``lr [B, H, W, C]``'s grid, L1."""
    b, kh, kw, c = pred.shape
    h, w = lr.shape[1], lr.shape[2]
    return torch.mean(torch.abs(pred.reshape(b, h, kh // h, w, kw // w, c).mean(dim=(2, 4)) - lr))


def temporal_consistency(pred: Tensor, prev: Tensor, step: int) -> Tensor:
    return torch.mean(torch.abs(pred - prev)) if step > 0 else pred.new_zeros(())


def step_loss(lp: Dict[str, Tensor], weights: Dict[str, float], pred: Tensor, gt: Tensor,
              lr: Tensor, prev: Tensor, step: int) -> Tensor:
    """One step's loss of NHWC ``pred``/``gt`` ``[B, kH, kW, 2]``, ``lr`` ``[B, H, W, 2]``."""
    total = (mse(pred, gt) + weights.get("recon", 0.0) * recon(pred, lr)
             + weights.get("temporal_consistency", 0.0) * temporal_consistency(pred, prev, step))
    if weights.get("lpips"):
        total = total + weights["lpips"] * ref_lpips.perceptual(lp, pred, gt)
    return total


def clip_loss(net: ref_model.Net, lp: Dict[str, Tensor], weights: Dict[str, float],
              inp: Tensor, gt: Tensor, hw, gt_hw, remat: bool = True) -> Tensor:
    """``inp [B, L, 4, N]``, ``gt [B, L, 4, M]`` raw event windows."""
    frames = raster.counts(inp, hw)
    gts = raster.counts(gt, gt_hw)
    b, length = frames.shape[:2]
    carry = net.init_state(b, *hw, device=inp.device)
    total = frames.new_zeros(())
    for t in range(length - 1):
        def body(pair, g, lr, *state, t=t):
            out = net(pair, *state)
            return (*out, step_loss(lp, weights, out[-1], g, lr, state[-1], t))

        args = (frames[:, t:t + 2], gts[:, t + 1], frames[:, t + 1], *carry)
        out = checkpoint(body, *args, use_reentrant=False) if remat else body(*args)
        carry = out[:-1]
        total = total + out[-1]
    return total


def steps(params: Dict[str, Tensor], lp: Dict[str, Tensor], dims: Dict[str, int],
          weights: Dict[str, float], batches: Sequence, hw, gt_hw, lr: float,
          weight_decay: float, accum: int = 2, remat: bool = True) -> Dict[str, object]:
    """Train ``len(batches)`` iterations from ``params`` (float32); as
    ``reference/train.py::steps`` returns them: each iteration's loss, the
    first gradient as the optimizer takes it and the parameters."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    net = ref_model.Net(leaves, **dims)
    opt = Adam(leaves, lr, weight_decay)
    losses: List[float] = []
    first = None
    for inp, gt in batches:
        for v in leaves.values():
            v.grad = None
        m = inp.shape[0] // accum
        loss = 0.0
        for a in range(accum):
            part = clip_loss(net, lp, weights, inp[a * m:(a + 1) * m], gt[a * m:(a + 1) * m],
                             hw, gt_hw, remat)
            part.backward()  # sums into .grad
            loss += float(part.detach())
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)) / accum
                 for k, v in leaves.items()}
        if first is None:
            first = {k: (g + weight_decay * leaves[k]).detach().clone() for k, g in grads.items()}
        opt.step(grads)
        losses.append(loss / accum)
    return {"losses": losses, "first_grad": first,
            "params": {k: v.detach() for k, v in leaves.items()}}
