"""Training: optimizers, the BPTT train step, checkpoints and the trainer."""

from bmcnet_esr_torch.training.optim import (
    OPTIMIZER_REGISTRY,
    SCHEDULE_REGISTRY,
    build_optimizer,
    exponential_decay_with_floor,
)
from bmcnet_esr_torch.training.train_step import (
    TrainState,
    init_train_state,
    make_eval_step,
    make_train_step,
    sequence_loss,
)
from bmcnet_esr_torch.training.trainer import Trainer

__all__ = [
    "OPTIMIZER_REGISTRY", "SCHEDULE_REGISTRY", "build_optimizer",
    "exponential_decay_with_floor", "TrainState", "init_train_state", "make_eval_step",
    "make_train_step", "sequence_loss", "Trainer",
]
