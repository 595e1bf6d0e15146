"""Training checkpoints: ``torch.save`` of the train state plus a meta file.

Counterpart of ``bmcnet_esr_tpu/training/checkpoint.py`` (Orbax there; the
reference's ``torch.save`` at ``train.py:534-563``), with its layout:
``<save_dir>/iteration_<N>/`` or ``<save_dir>/best/``, each holding
``state.pt`` (``{model, optimizer, step, updates, ema}``, see
``TrainState.state_dict``) and ``trainer_meta.json`` (training mode, monitor
best, experiment, iteration).  A checkpoint is written into a temporary
directory and renamed into place, so a reader never sees half of one.  The
JAX package's Orbax directories are not read here (they need JAX);
``models/convert.py::train_state_from_jax`` carries a JAX train state over.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from bmcnet_esr_torch.models.convert import TRAIN_STATE_FILE
from bmcnet_esr_torch.training.train_step import TrainState

META_FILE = "trainer_meta.json"


def save_checkpoint(
    ckpt_dir: str,
    state: TrainState,
    *,
    iteration: int,
    best: bool = False,
    meta: Optional[Dict[str, Any]] = None,
) -> str:
    path = os.path.join(os.path.abspath(ckpt_dir), "best" if best else f"iteration_{iteration}")
    tmp, old = f"{path}.tmp-{os.getpid()}", f"{path}.old-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state.state_dict(), os.path.join(tmp, TRAIN_STATE_FILE))
    with open(os.path.join(tmp, META_FILE), "w") as f:
        json.dump({**(meta or {}), "iteration": iteration}, f)
    if os.path.isdir(path):  # a directory is not replaced over a full one
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old)
    else:
        os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
    """Load the checkpoint at ``path`` into ``state`` (in place; tensors go to
    the model's device) and return it with the meta.  As with the reference
    ``Resumer``, callers check the experiment name recorded in the meta."""
    path = os.path.abspath(path)
    state.load_state_dict(
        torch.load(os.path.join(path, TRAIN_STATE_FILE), map_location="cpu", weights_only=True))
    meta: Dict[str, Any] = {}
    if os.path.exists(os.path.join(path, META_FILE)):
        with open(os.path.join(path, META_FILE)) as f:
            meta = json.load(f)
    return state, meta


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    iters = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("iteration_"):
            try:
                iters.append((int(name.split("_", 1)[1]), name))
            except ValueError:
                continue  # a temporary directory of an unfinished save
    if not iters:
        return None
    return os.path.join(ckpt_dir, max(iters)[1])
