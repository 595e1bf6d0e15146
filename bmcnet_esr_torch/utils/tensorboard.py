"""Tensorboard writer with train/valid tag modes and steps/sec (counterpart
of ``bmcnet_esr_tpu/utils/tensorboard.py``, the reference
``logger/visualization.py:5-73``).  With no tensorboard backend importable it
drops the scalars, with one warning."""

from __future__ import annotations

import time
from typing import Optional


class TensorboardWriter:
    def __init__(self, log_dir: Optional[str], enabled: bool = True, logger=None):
        self.writer = None
        self.mode = ""
        self.step = 0
        self._prev_step_time = None
        if enabled and log_dir is not None:
            for module in ("torch.utils.tensorboard", "tensorboardX"):
                try:
                    mod = __import__(module, fromlist=["SummaryWriter"])
                    self.writer = mod.SummaryWriter(log_dir)
                    break
                except Exception:
                    continue
            if self.writer is None and logger is not None:
                logger.warning("tensorboard unavailable; scalars will be dropped")

    def set_step(self, step: int, mode: str = "train") -> None:
        self.mode = mode
        self.step = step
        now = time.time()
        if self._prev_step_time is not None and step > 0:
            self.add_scalar("steps_per_sec", 1.0 / max(now - self._prev_step_time, 1e-9))
        self._prev_step_time = now

    def add_scalar(self, tag: str, value, step: Optional[int] = None) -> None:
        if self.writer is None:
            return
        name = f"{tag}/{self.mode}" if self.mode else tag
        self.writer.add_scalar(name, float(value), self.step if step is None else step)

    def flush(self) -> None:
        if self.writer is not None:
            self.writer.flush()

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
