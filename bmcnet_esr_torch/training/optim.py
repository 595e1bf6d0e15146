"""Optimizer and LR-schedule registry on ``torch.optim``.

Counterpart of ``bmcnet_esr_tpu/training/optim.py``.  The default recipe
(``configs/train_nfs.yml``) is Adam(lr 1e-4, weight_decay 1e-5, amsgrad)
with the learning rate times 0.95 every ``lr_change_rate`` updates while it
is at least 1e-5 (``train.py:291-294``).  The JAX package wrote
``scale_by_torch_adam`` to be ``torch.optim.Adam`` (L2 decay into the
gradient, amsgrad on the raw second moment, eps outside the bias-corrected
square root), so here Adam *is* ``torch.optim.Adam``.

The schedule is a plain function of the number of updates applied so far.
optax evaluates it at the count *before* the update (``scale_by_schedule``),
so update ``i`` (counting from 0) runs at ``schedule(i)``; the train step
sets every group's ``lr`` to ``schedule(state.updates)`` right before
``optimizer.step()`` and counts the update after it.  A step that the
non-finite guard skips counts no update, as the JAX guard keeps the
schedule's count too.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable

import torch


def exponential_decay_with_floor(
    base_lr: float,
    gamma: float = 0.95,
    step_every: int = 4000,
    floor: float = 1e-5,
) -> Callable[[int], float]:
    """lr(i) = base * gamma**min(i // step_every, k_max).

    ``k_max`` is the largest k reachable under the reference's guard "step
    only while the current lr >= floor": one more decay fires from the last
    lr at or above the floor (``train.py:291-294``)."""
    if base_lr < floor:
        k_max = 0
    else:
        k_max = int(math.floor(math.log(floor / base_lr) / math.log(gamma))) + 1
        while base_lr * gamma ** (k_max - 1) < floor:  # guard fp edge cases
            k_max -= 1

    def schedule(count: int) -> float:
        return base_lr * gamma ** min(int(count) // step_every, k_max)

    return schedule


def _adam(params, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, amsgrad=False):
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay, amsgrad=amsgrad)


def _adamw(params, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4):
    # optax.adamw's defaults (decoupled decay of 1e-4), not torch's 1e-2
    return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay)


def _sgd(params, lr, momentum=0.0, weight_decay=0.0):
    return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay)


OPTIMIZER_REGISTRY: Dict[str, Callable] = {"Adam": _adam, "AdamW": _adamw, "SGD": _sgd}

SCHEDULE_REGISTRY: Dict[str, Callable] = {
    "ExponentialLR": exponential_decay_with_floor,
    "Constant": lambda base_lr, **_: (lambda count: base_lr),
}


def build_optimizer(
    params: Iterable[torch.nn.Parameter], optimizer_cfg: Dict, scheduler_cfg: Dict,
    trainer_cfg: Dict,
):
    """``(optimizer, schedule)`` from reference-style YAML blocks:
    ``optimizer: {name, args: {lr, weight_decay, amsgrad}}``,
    ``lr_scheduler: {name, args: {gamma}}`` and the trainer's
    ``lr_change_rate`` (``config/train_nfs.yml:28-40,58``)."""
    oname = optimizer_cfg.get("name", "Adam")
    oargs = dict(optimizer_cfg.get("args", {}))
    lr = float(oargs.pop("lr", 1e-4))

    sname = scheduler_cfg.get("name", "ExponentialLR") if scheduler_cfg else "Constant"
    sargs = dict(scheduler_cfg.get("args", {})) if scheduler_cfg else {}
    if sname == "ExponentialLR":
        schedule = exponential_decay_with_floor(
            lr, gamma=float(sargs.get("gamma", 0.95)),
            step_every=int(trainer_cfg.get("lr_change_rate", 4000)),
        )
    elif sname in SCHEDULE_REGISTRY:
        schedule = SCHEDULE_REGISTRY[sname](lr, **sargs)
    else:
        raise KeyError(f"unknown lr scheduler {sname!r} (registry: {list(SCHEDULE_REGISTRY)})")

    if oname not in OPTIMIZER_REGISTRY:
        raise KeyError(f"unknown optimizer {oname!r} (registry: {list(OPTIMIZER_REGISTRY)})")
    return OPTIMIZER_REGISTRY[oname](params, schedule(0), **oargs), schedule
