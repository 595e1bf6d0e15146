"""Streaming metric averaging (counterpart of
``bmcnet_esr_tpu/utils/metrics.py``, the reference ``MetricTracker``)."""

from __future__ import annotations

from typing import Dict, Iterable


class MetricTracker:
    """total/count/average accumulator with optional tensorboard push."""

    def __init__(self, keys: Iterable[str], writer=None):
        self._keys = list(keys)
        self.writer = writer
        self.reset()

    def reset(self) -> None:
        self._total: Dict[str, float] = {k: 0.0 for k in self._keys}
        self._count: Dict[str, int] = {k: 0 for k in self._keys}

    def update(self, key: str, value: float, n: int = 1) -> None:
        if key not in self._total:
            self._keys.append(key)
            self._total[key] = 0.0
            self._count[key] = 0
        if self.writer is not None:
            self.writer.add_scalar(key, value)
        self._total[key] += float(value) * n
        self._count[key] += n

    def avg(self, key: str) -> float:
        c = self._count.get(key, 0)
        return self._total.get(key, 0.0) / c if c else 0.0

    def result(self) -> Dict[str, float]:
        return {k: self.avg(k) for k in self._keys if self._count[k]}
