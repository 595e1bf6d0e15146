"""BPTT train and eval steps: rasterize -> recurrent unroll -> backward -> update.

Counterpart of ``bmcnet_esr_tpu/training/train_step.py``, where one iteration
is one jitted XLA program.  Here it is eager PyTorch on the device:

  padded event windows [B, L, ...] --(one rasterizer launch per prefix)-->
  count frames [B, L, H, W, 2] --(sliding pairs, a Python loop over
  S = L - seqn + 1 steps)--> per-step MSE against the second window's GT
  counts (``gt_cnt[:, 1]``, ``train.py:213``), plus the ``loss:`` block's
  terms (``training/losses.py``) --(autograd)--> gradients
  --> ``optimizer.step()``

``use_remat`` wraps each step's body (model + losses) in
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, the counterpart
of ``jax.checkpoint`` on the scan body.  The loss is the sum over steps of
the batch mean (``train.py:227-234``); the bicubic fit-up applies when the
prediction and GT resolutions differ (``train.py:228``).  The JAX package
has no backward Pallas kernel, so the gradients come from autograd through
cuDNN / cuBLAS; the rasterizer runs only forward, on data.  A term marked
``needs_events`` gets the step's raw window and its valid count in ``aux``
(raw batches only: the compact form drops timestamps).

Unlike a jitted step, a torch optimizer updates in place, so the non-finite
guard (``skip_nonfinite``) decides on the host *before* ``optimizer.step()``
from the loss and the global gradient norm: a skipped step leaves the
parameters, the optimizer's moments and its step count untouched.  That
decision reads two device scalars, one host sync per step while the guard is
on (it is off by default).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from bmcnet_esr_torch.ops.batch import counts_from_batch, sliding_pairs
from bmcnet_esr_torch.ops.resize import resize_bicubic
from bmcnet_esr_torch.training.losses import adapt_term, needs_events
from bmcnet_esr_torch.utils.device import strict_fp32

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainState:
    """Model, optimizer and schedule with the counts a checkpoint carries.

    ``step`` counts train steps (skipped ones too, as the JAX
    ``TrainState.step``); ``updates`` counts applied optimizer updates, the
    schedule's count; ``ema`` maps parameter names to their exponential
    moving average (``None`` without ``trainer.ema``)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    updates: int = 0
    ema: Optional[Dict[str, Tensor]] = None

    def state_dict(self) -> Dict[str, Any]:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "updates": self.updates,
            "ema": self.ema,
        }

    def load_state_dict(self, payload: Dict[str, Any]) -> None:
        """Load a :meth:`state_dict`; tensors land on the model's device."""
        self.model.load_state_dict(payload["model"], strict=True)
        self.optimizer.load_state_dict(payload["optimizer"])
        self.step = int(payload["step"])
        self.updates = int(payload["updates"])
        ema = payload.get("ema")
        if (ema is None) != (self.ema is None):
            raise ValueError("the checkpoint and this state disagree on keeping an EMA "
                             "(trainer.ema)")
        if ema is not None:
            with torch.no_grad():
                for name, e in self.ema.items():
                    e.copy_(ema[name])


def init_train_state(model: nn.Module, optimizer, schedule, ema: bool = False) -> TrainState:
    """``ema=True`` seeds the EMA at the current parameters (own buffers)."""
    averages = (
        {n: p.detach().clone() for n, p in model.named_parameters()} if ema else None
    )
    return TrainState(model, optimizer, schedule, ema=averages)


def ema_update(state: TrainState, decay: float) -> None:
    """``ema <- ema * decay + params * (1 - decay)``, in place."""
    if state.ema is None:
        raise ValueError(
            "ema_decay is set but the state has no EMA: build it with "
            "init_train_state(..., ema=True)"
        )
    names = list(state.ema)
    params = dict(state.model.named_parameters())
    with torch.no_grad():
        ema = [state.ema[n] for n in names]
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul([params[n].detach() for n in names],
                                                    1.0 - decay))


def global_norm(tensors) -> Tensor:
    """``sqrt(sum of squares)`` over all ``tensors`` (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def _rollout(
    model: nn.Module,
    inp_frames: Tensor,  # [B, L, H, W, 2]
    gt_frames: Tensor,  # [B, L, kH, kW, 2]
    seqn: int,
    gt_resolution: Tuple[int, int],
    use_remat: bool,
    extra_losses: Tuple = (),
    inp_events: Optional[Tensor] = None,  # [B, L, 4, N] raw, for event-consuming terms
    inp_lens: Optional[Tensor] = None,  # [B, L] valid counts of the padded windows
    batch_scale: float = 1.0,
    batch_max: Optional[Callable[[Tensor], Tensor]] = None,
) -> Tuple[Tensor, Tensor]:
    """The recurrent unroll's per-step per-clip MSE ``[S, B]`` and per-step
    sum of the extra terms ``[S]``.  ``extra_losses`` are
    ``(name, weight, fn)`` with ``fn(pred_fit, gt, aux) -> scalar``; a
    step's terms are ``sum(w * fn(...))``.  ``aux`` holds the raw prediction
    (``pred``), the previous step's output (``prev_pred``), the step's
    input pair (``inp``) and index (``step``), and with ``inp_events`` the
    step's raw window (``events``, the pair's second window) and, with
    ``inp_lens``, its valid event count (``events_len``); the contract of
    ``bmcnet_esr_torch/losses/terms.py``.  A term marked ``batch_sum`` (a
    sum over the batch's clips, not a mean) is multiplied by
    ``batch_scale``: the data-parallel step passes its data axis's size, so
    that the ranks' mean is the whole batch's sum.  ``batch_max``, when
    given, is ``aux['batch_max']``: the elementwise max of a tensor over the
    ranks that share the batch (the data-parallel step's), for a term that
    reads a statistic of the whole batch (``ssim``'s GT range)."""
    b, _, h, w, _ = inp_frames.shape
    pairs = sliding_pairs(inp_frames, seqn)  # [B, S, seqn, H, W, 2]
    s = pairs.shape[1]
    gt_resolution = tuple(gt_resolution)

    def body(x, gt, step, events, events_len, *carry):
        prev_pred = carry[-1]  # the recurrent output slot (both variants)
        outs = model(x, *carry)
        pred = outs[-1]
        pred_fit = (resize_bicubic(pred, gt_resolution)
                    if tuple(pred.shape[1:3]) != tuple(gt.shape[1:3]) else pred)
        mse = torch.mean(torch.square(pred_fit - gt), dim=(1, 2, 3))  # [B]
        extra = mse.new_zeros(())
        if extra_losses:
            aux = {"pred": pred, "prev_pred": prev_pred, "inp": x, "step": step}
            if batch_max is not None:
                aux["batch_max"] = batch_max
            if events is not None:
                aux["events"] = events
                if events_len is not None:
                    aux["events_len"] = events_len
            for _, weight, fn in extra_losses:
                if getattr(fn, "batch_sum", False):
                    weight = weight * batch_scale
                extra = extra + weight * fn(pred_fit, gt, aux)  # scalar
        return (*outs, mse, extra)

    carry = tuple(model.init_state(b, h, w, device=inp_frames.device))
    mses, extras = [], []
    for t in range(s):
        # the step's "current" window is the pair's second one (index 1),
        # the one its GT aligns to
        args = (
            pairs[:, t], gt_frames[:, 1 + t], t,
            None if inp_events is None else inp_events[:, 1 + t],
            None if inp_lens is None else inp_lens[:, 1 + t],
            *carry,
        )
        out = checkpoint(body, *args, use_reentrant=False) if use_remat else body(*args)
        carry = tuple(out[:-2])
        mses.append(out[-2])
        extras.append(out[-1])
    return torch.stack(mses), torch.stack(extras)


def _rollout_losses(*args, **kwargs) -> Tuple[Tensor, Tensor]:
    """Per-step per-clip ``(MSE, total)`` over the recurrent unroll: two
    ``[S, B]`` tensors, the total ``mse + sum(w * fn(...))``; the arguments
    of :func:`_rollout`."""
    mses, extras = _rollout(*args, **kwargs)
    return mses, mses + extras[:, None]


def _normalized(extra_losses: Tuple) -> Tuple:
    """Adapt two-argument terms to the ``fn(pred, gt, aux)`` contract."""
    return tuple((n, w, adapt_term(fn)) for n, w, fn in extra_losses)


def _events_for_terms(batch: Dict[str, Tensor], extra_losses: Tuple):
    """Raw per-clip event windows (and valid counts) when a term consumes
    ``aux['events']``; the compact transfer drops timestamps, so such terms
    need ``compact_transfer: False``."""
    if not needs_events(extra_losses):
        return None, None
    if "inp_events" not in batch:
        raise ValueError(
            "an attached loss term consumes raw event windows (needs_events) "
            "but the batch has no 'inp_events' — the compact transfer format "
            "drops timestamps; set compact_transfer: False in the dataloader config"
        )
    return batch["inp_events"], batch.get("inp_len")


def sequence_loss(
    model: nn.Module,
    batch: Dict[str, Tensor],
    inp_resolution: Tuple[int, int],
    gt_resolution: Tuple[int, int],
    seqn: int = 2,
    use_remat: bool = True,
    extra_losses: Tuple = (),
    batch_scale: float = 1.0,
    batch_max: Optional[Callable[[Tensor], Tensor]] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Total BPTT loss of one batch of clips (raw ``{inp,gt}_events`` or the
    compact ``{inp,gt}_{xy,p}``) and the reference's log metrics
    (``batch_scale``, ``batch_max``: :func:`_rollout_losses`)."""
    extra_losses = _normalized(extra_losses)
    inp_frames = counts_from_batch(batch, "inp", tuple(inp_resolution))
    gt_frames = counts_from_batch(batch, "gt", tuple(gt_resolution))
    inp_events, inp_lens = _events_for_terms(batch, extra_losses)
    mses, totals = _rollout_losses(
        model, inp_frames, gt_frames, seqn, gt_resolution, use_remat, extra_losses,
        inp_events=inp_events, inp_lens=inp_lens, batch_scale=batch_scale, batch_max=batch_max,
    )  # [S, B] each
    total = totals.mean(dim=1).sum()
    return total, {"mse_loss": mses[-1].mean(), "loss": total}


def make_train_step(
    inp_resolution: Tuple[int, int],
    gt_resolution: Tuple[int, int],
    seqn: int = 2,
    use_remat: bool = True,
    extra_losses: Tuple = (),
    grad_accum: int = 1,
    skip_nonfinite: bool = False,
    ema_decay: float = 0.0,
) -> Callable[[TrainState, Dict[str, Tensor]], Tuple[TrainState, Dict[str, Any]]]:
    """One optimizer iteration, ``step(state, batch) -> (state, metrics)``;
    ``state`` is updated in place.  The metrics stay on the device.

    ``grad_accum > 1`` splits the batch into that many micro-batches run one
    after the other, averaging their gradients before one update (the loss
    is a batch mean, so this is the full-batch gradient) and taking the loss
    as the mean of the micro-batch losses.  ``ema_decay > 0`` keeps the EMA
    of the parameters; it moves on a skipped step too, towards the unchanged
    parameters, as in the JAX step."""
    strict_fp32()

    def batch_loss(model, batch):
        return sequence_loss(model, batch, inp_resolution, gt_resolution, seqn, use_remat,
                             extra_losses)

    def backward(model, batch) -> Tuple[Tensor, Tensor]:
        if grad_accum == 1:
            total, aux = batch_loss(model, batch)
            total.backward()
            return total.detach(), aux["mse_loss"].detach()
        b = next(iter(batch.values())).shape[0]
        if b % grad_accum != 0:
            raise ValueError(f"batch {b} must divide grad_accum {grad_accum}")
        m = b // grad_accum
        totals, mses = [], []
        for a in range(grad_accum):
            total, aux = batch_loss(model, {k: v[a * m : (a + 1) * m] for k, v in batch.items()})
            total.backward()  # sums into .grad
            totals.append(total.detach())
            mses.append(aux["mse_loss"].detach())
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(grad_accum)
        return torch.stack(totals).mean(), torch.stack(mses).mean()

    def step(state: TrainState, batch: Dict[str, Tensor]):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            total, mse = backward(state.model, batch)
        fill_missing_grads(state.model)
        return state, apply_update(state, total, mse, skip_nonfinite, ema_decay)

    return step


def fill_missing_grads(model: nn.Module) -> None:
    """An unused parameter gets a zero gradient, as under ``jax.grad``."""
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def apply_update(state: TrainState, total: Tensor, mse: Tensor, skip_nonfinite: bool,
                 ema_decay: float, gnorm: Optional[Tensor] = None) -> Dict[str, Any]:
    """The optimizer update from the gradients in ``.grad``: the scheduled
    learning rate, the non-finite guard on ``total`` and the gradient norm
    (``gnorm``, else the norm of ``.grad``), the EMA and the counts.
    Returns the step's metrics."""
    if gnorm is None:
        gnorm = global_norm(p.grad for p in state.model.parameters())
    metrics: Dict[str, Any] = {"train_loss": total, "train_mse_loss": mse, "grad_norm": gnorm}
    apply = True
    if skip_nonfinite:
        apply = bool(torch.isfinite(total) & torch.isfinite(gnorm))
        metrics["train_skipped"] = int(not apply)
    if apply:
        lr = state.schedule(state.updates)  # the count before this update
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.updates += 1
    if ema_decay:
        ema_update(state, ema_decay)
    state.step += 1
    return metrics


def make_eval_step(
    inp_resolution: Tuple[int, int],
    gt_resolution: Tuple[int, int],
    seqn: int = 2,
    extra_losses: Tuple = (),
) -> Callable[[nn.Module, Dict[str, Tensor]], Dict[str, Tensor]]:
    """Validation rollout without gradients: the reference ``_valid``
    metrics (``train.py:466-532``).  A batch's ``clip_mask`` (from
    ``SequenceLoader(pad_last=True)``) weights the clips, so the wrap-padded
    clips of the final batch count for nothing in the MSE terms.  Extra terms
    return batch-mean scalars by contract, so their part of ``valid_loss``
    still includes the padded clips (as in the JAX package)."""
    strict_fp32()
    terms = _normalized(extra_losses)

    def step(model: nn.Module, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        return eval_metrics(eval_sums(model, batch, inp_resolution, gt_resolution, seqn, terms))

    return step


@torch.no_grad()
def eval_sums(model: nn.Module, batch: Dict[str, Tensor], inp_resolution, gt_resolution,
              seqn: int, terms: Tuple, batch_scale: float = 1.0,
              batch_max: Optional[Callable[[Tensor], Tensor]] = None) -> Tensor:
    """``[2 S + 2]``: per step the ``clip_mask``-weighted sum over the clips
    of the MSE, per step the extra terms (a value of the batch, not of a
    clip) over ``batch_scale``, then the last step's weighted MSE sum, then
    the weights' sum.  The sums of the ranks that share a batch add up to
    the whole batch's (the data-parallel eval step, which passes its data
    axis's size as ``batch_scale`` and its max over the ranks as
    ``batch_max``): the terms' parts to their mean over the ranks, the
    whole batch's value, however the valid clips fall on the ranks."""
    model.eval()
    inp_frames = counts_from_batch(batch, "inp", tuple(inp_resolution))
    gt_frames = counts_from_batch(batch, "gt", tuple(gt_resolution))
    inp_events, inp_lens = _events_for_terms(batch, terms)
    mses, extras = _rollout(
        model, inp_frames, gt_frames, seqn, gt_resolution, False, terms,
        inp_events=inp_events, inp_lens=inp_lens, batch_scale=batch_scale, batch_max=batch_max,
    )  # [S, B], [S]
    w = batch.get("clip_mask")
    if w is None:
        w = torch.ones(inp_frames.shape[0], device=inp_frames.device)
    return torch.cat([(mses * w).sum(-1), extras / batch_scale,
                      (mses[-1] * w).sum(-1, keepdim=True), w.sum().reshape(1)])


def eval_metrics(sums: Tensor) -> Dict[str, Tensor]:
    """The validation metrics of :func:`eval_sums`: weighted means, each
    step's terms counted for every weighted clip."""
    s = (sums.shape[0] - 2) // 2
    wsum = torch.clamp(sums[-1], min=1.0)
    return {
        "valid_loss": ((sums[:s] + sums[s : 2 * s] * sums[-1]) / wsum).sum(),
        "valid_mse_loss": sums[-2] / wsum,
        "valid_clips": sums[-1],
    }
