"""BPTT training steps in plain PyTorch: the loss, the gradients and Adam.

The loss of one batch of ``B`` clips of ``L`` windows is the sum over the
``L - 1`` stride-1 pairs of the batch mean of each clip's MSE between the
HR prediction and the GT counts of the pair's second window, the recurrent
state starting at zero (the reference ``train.py:213-234``).  Adam is the
reference's ``torch.optim.Adam`` written out: L2 decay added to the
gradient, amsgrad on the raw second moment, eps outside the bias-corrected
square root."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from benchmark.reference import model as ref_model
from benchmark.reference import raster


def batch_loss(net: ref_model.Net, inp: torch.Tensor, gt: torch.Tensor, hw, gt_hw) -> torch.Tensor:
    """``inp [B, L, 4, N]``, ``gt [B, L, 4, M]`` raw event windows."""
    frames = raster.counts(inp, hw)     # [B, L, H, W, 2]
    gts = raster.counts(gt, gt_hw)      # [B, L, kH, kW, 2]
    b, length = frames.shape[:2]
    carry = net.init_state(b, *hw, device=inp.device)
    total = frames.new_zeros(())
    for t in range(length - 1):
        carry = net(frames[:, t:t + 2], *carry)
        total = total + torch.mean(torch.square(carry[-1] - gts[:, t + 1]), dim=(1, 2, 3)).mean()
    return total


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.p, self.lr, self.wd, self.b1, self.b2, self.eps = params, lr, weight_decay, *betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.vmax = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.p.items():
            g = grads[k] + self.wd * p
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            torch.maximum(self.vmax[k], self.v[k], out=self.vmax[k])
            denom = self.vmax[k].sqrt() / bc2 ** 0.5 + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)


def steps(params: Dict[str, torch.Tensor], dims: Dict[str, int], batches: Sequence, hw, gt_hw,
          lr: float, weight_decay: float) -> Dict[str, object]:
    """Train ``len(batches)`` steps from ``params`` (float32, changed in
    place).  Returns each step's loss, the first gradient as the optimizer
    takes it (``grad + weight_decay * param``) and the optimizer."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    net = ref_model.Net(leaves, **dims)
    opt = Adam(leaves, lr, weight_decay)
    losses: List[float] = []
    first = None
    for inp, gt in batches:
        for v in leaves.values():
            v.grad = None
        loss = batch_loss(net, inp, gt, hw, gt_hw)
        loss.backward()
        grads = {k: v.grad if v.grad is not None else torch.zeros_like(v) for k, v in leaves.items()}
        if first is None:
            first = {k: (g + weight_decay * leaves[k]).detach().clone() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grad": first, "params": {k: v.detach() for k, v in leaves.items()}}
