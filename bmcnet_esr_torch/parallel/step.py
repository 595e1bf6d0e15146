"""Data- and tensor-parallel train and eval steps over a process mesh.

Counterpart of ``bmcnet_esr_tpu/parallel/step.py``.  There GSPMD turns the
in-graph batch mean into an ICI ``psum``; here every rank runs the port's
``sequence_loss`` on its rows of the batch and calls ``backward``, then one
all-reduce sums the gradients of all ranks and the step divides by the data
degree.  The reduction is written out rather than left to
``DistributedDataParallel``: the BPTT rollout calls the model ``seqn x L``
times before its one ``backward``, and DDP re-arms its reducer at every
forward call of the module it wraps.

* The gradients travel in one flat float32 bucket (~11 MB for the full
  model's 2.7M parameters) with the rank's loss and MSE appended, so a step
  makes one collective (two on a multi-slice mesh: within ``data``, then
  across ``dcn_data``, ``mesh.py:55-96``).  Copying into and out of the
  bucket keeps each gradient's dtype and memory format (channels-last
  parameters), so one rank reproduces the single-device step bit for bit.
* ``train_loss``, ``train_mse_loss`` and ``grad_norm`` are the global
  batch's, equal on every rank; ``skip_nonfinite`` decides on them, so every
  rank skips together (``tests/test_parallel.py:75``).
* Adam, the stepped schedule and the EMA run replicated on every rank
  (``step.py:64-75``).
* The eval step all-reduces the ``clip_mask``-weighted sums and the weights'
  sum, so its means equal the single-device ones however the valid clips
  fall on the ranks (``step.py:79-102``).

On a ``("data", "model")`` mesh (``trainer.model_parallel``, the JAX
step's ``state_shardings`` / ``params_shardings``) the state is this rank's
channel slices (``shard_tree_channels``) and the model runs through
``parallel/tensor.py::ChannelParallelForward``:

* the bucket is reduced over the ``data`` group only, divided by its size;
  every rank of a model group holds the same rows and the same loss;
* ``grad_norm`` is the global norm: the squares of the split parameters'
  gradients summed over the ``model`` group, the replicated ones counted
  once; ``skip_nonfinite`` decides on it and the loss, alike on every rank;
* Adam, the stepped schedule and the EMA run on the local slices, which
  computes the slices of the one-device update: every one of them works
  element by element;
* the eval sums are reduced over the ``data`` group.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.distributed as dist

from bmcnet_esr_torch.parallel.mesh import channel_sharding
from bmcnet_esr_torch.parallel.tensor import ChannelGroup, ChannelParallelForward
from bmcnet_esr_torch.training.train_step import (
    TrainState,
    _normalized,
    apply_update,
    eval_metrics,
    eval_sums,
    fill_missing_grads,
    sequence_loss,
)

Tensor = torch.Tensor


def _groups(mesh) -> List:
    """The groups of the data axes to reduce over in turn: within ``data``
    first."""
    names = mesh.mesh_dim_names or ()
    if "dcn_data" in names:
        return [mesh.get_group("data"), mesh.get_group("dcn_data")]
    if "model" in names:
        return [mesh.get_group("data")]
    return [mesh.get_group()]


def all_reduce_sum(flat: Tensor, mesh) -> Tensor:
    """Sum ``flat`` over the data axes of ``mesh``, in place."""
    for group in _groups(mesh):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return flat


def _data_size(mesh) -> int:
    axis = ChannelGroup.of(mesh)
    return mesh.size() // (axis.n if axis is not None else 1)


def _reduce_step(grads: List[Tensor], scalars: List[Tensor], mesh) -> List[Tensor]:
    """Mean over the data axes of every gradient (written back in place)
    and of ``scalars``, in one float32 bucket.  Returns the scalars' means."""
    if any(g.dtype != torch.float32 for g in grads):
        raise TypeError("the gradient bucket is float32: the parameters must be float32")
    flat = torch.cat([g.reshape(-1) for g in grads] + [s.reshape(1) for s in scalars])
    all_reduce_sum(flat, mesh).div_(_data_size(mesh))
    off = 0
    for g in grads:
        g.copy_(flat[off : off + g.numel()].view(g.shape))
        off += g.numel()
    return list(flat[off:])


def _sum_sq(tensors: List[Tensor], device) -> Tensor:
    if not tensors:
        return torch.zeros((), device=device)
    return torch.stack(torch._foreach_norm(tensors)).square().sum()


def grad_norm(model: torch.nn.Module, axis: ChannelGroup) -> Tensor:
    """The global gradient norm of a model cut to one rank's channel slices:
    the split parameters' squares summed over the model axis, the
    replicated ones' counted once."""
    from torch.distributed.tensor import Shard

    placements = channel_sharding(model, axis.n)
    split, whole = [], []
    for name, p in model.named_parameters():
        (split if isinstance(placements[name], Shard) else whole).append(p.grad)
    device = next(model.parameters()).device
    return torch.sqrt(axis.all_reduce(_sum_sq(split, device)) + _sum_sq(whole, device))


def _forward(model: torch.nn.Module, axis):
    return model if axis is None else ChannelParallelForward(model, axis)


def make_parallel_train_step(
    inp_resolution: Tuple[int, int],
    gt_resolution: Tuple[int, int],
    mesh,
    seqn: int = 2,
    use_remat: bool = True,
    extra_losses: Tuple = (),
    skip_nonfinite: bool = False,
    ema_decay: float = 0.0,
) -> Callable[[TrainState, Dict[str, Tensor]], Tuple[TrainState, Dict[str, Any]]]:
    """``step(state, batch) -> (state, metrics)`` on this rank's rows of the
    global batch; ``mesh`` is a ``DeviceMesh`` (:func:`make_process_mesh`).
    The state is updated in place and stays equal on every rank of the data
    axes; on a mesh with a ``model`` axis it is the rank's channel slices."""
    axis = ChannelGroup.of(mesh)

    def step(state: TrainState, batch: Dict[str, Tensor]):
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            total, aux = sequence_loss(_forward(model, axis), batch, inp_resolution,
                                       gt_resolution, seqn, use_remat, extra_losses)
            total.backward()
        fill_missing_grads(model)
        grads = [p.grad for p in model.parameters()]
        total, mse = _reduce_step(grads, [total.detach(), aux["mse_loss"].detach()], mesh)
        gnorm = None if axis is None else grad_norm(model, axis)
        return state, apply_update(state, total.reshape(()), mse.reshape(()), skip_nonfinite,
                                   ema_decay, gnorm)

    return step


def make_parallel_eval_step(
    inp_resolution: Tuple[int, int],
    gt_resolution: Tuple[int, int],
    mesh,
    seqn: int = 2,
    extra_losses: Tuple = (),
) -> Callable[[torch.nn.Module, Dict[str, Tensor]], Dict[str, Tensor]]:
    """Validation on this rank's rows (the model cut to the rank's channel
    slices on a mesh with a ``model`` axis); the metrics are the global
    batch's."""
    terms = _normalized(extra_losses)
    axis = ChannelGroup.of(mesh)

    def step(model: torch.nn.Module, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        sums = eval_sums(_forward(model, axis), batch, inp_resolution, gt_resolution, seqn,
                         terms)
        return eval_metrics(all_reduce_sum(sums.to(torch.float32), mesh))

    return step
