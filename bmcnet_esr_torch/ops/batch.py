"""Batched rasterization of padded event windows.

Counterpart of ``bmcnet_esr_tpu/ops/batch.py``: ``compact_events`` is the
host-side transfer compaction (``batch.py:62-91``, kept bit for bit);
``batch_events_to_counts`` / ``batch_counts_from_compact`` rasterize
``[..., 4, N]`` raw or compact windows into ``[..., H, W, 2]`` NHWC count
images through :mod:`bmcnet_esr_torch.kernels.rasterize` (the CUDA kernel for
CUDA tensors, its plain version for CPU tensors); ``counts_from_batch``
picks the form a batch carries; ``sliding_pairs`` is the stride-1 window
pairing.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from bmcnet_esr_torch.kernels import rasterize


def batch_events_to_counts(events: torch.Tensor, sensor_size: Tuple[int, int]) -> torch.Tensor:
    """``[..., 4, N]`` padded float32 events -> ``[..., H, W, 2]`` counts."""
    lead = events.shape[:-2]
    flat = events.reshape((-1,) + tuple(events.shape[-2:])).contiguous()
    imgs = rasterize.counts_from_events(flat, sensor_size)
    return imgs.reshape(tuple(lead) + tuple(imgs.shape[1:]))


def compact_events(events) -> Tuple[np.ndarray, np.ndarray]:
    """``[..., 4, N]`` float32 events -> ``(xy int16 [..., 2, N], p int8 [..., N])``.

    The count path never reads timestamps and x/y/p are small integers.
    Negative coordinates clamp to -1 and the high side to int16-max, both
    still rejected by the rasterizer, while in-range values truncate toward
    zero exactly as the rasterizer's own cast does, so rasterizing the
    compact form equals rasterizing the raw one.  The JAX package documents
    one exception on its XLA path: subnormal negative coordinates, which
    XLA flushes to -0.0 (a valid pixel) while this clamp rejects them.  The
    port's rasterizers do not flush, so here compact and raw agree there too.
    """
    events = np.asarray(events)
    xy = events[..., 0:2, :]
    xy = np.where(xy < 0, -1.0, np.minimum(xy, np.float32(np.iinfo(np.int16).max)))
    xy = xy.astype(np.int16)
    p = events[..., 3, :].astype(np.int8)
    return xy, p


def batch_counts_from_compact(
    xy: torch.Tensor, p: torch.Tensor, sensor_size: Tuple[int, int]
) -> torch.Tensor:
    """Compact ``(xy [..., 2, N], p [..., N])`` windows -> ``[..., H, W, 2]``
    counts (equal to :func:`batch_events_to_counts` on the raw input)."""
    lead = xy.shape[:-2]
    fxy = xy.reshape((-1,) + tuple(xy.shape[-2:])).contiguous()
    fp = p.reshape((-1, p.shape[-1])).contiguous()
    imgs = rasterize.counts_from_compact(fxy, fp, sensor_size)
    return imgs.reshape(tuple(lead) + tuple(imgs.shape[1:]))


def counts_from_batch(batch, prefix: str, sensor_size: Tuple[int, int]) -> torch.Tensor:
    """Rasterize ``batch[f'{prefix}_events']`` or its compact form
    (``{prefix}_xy`` + ``{prefix}_p``): one kernel launch for all the
    ``[B, L]`` windows of a batch."""
    if f"{prefix}_xy" in batch:
        return batch_counts_from_compact(batch[f"{prefix}_xy"], batch[f"{prefix}_p"], sensor_size)
    return batch_events_to_counts(batch[f"{prefix}_events"], sensor_size)


def sliding_pairs(frames: torch.Tensor, seqn: int = 2) -> torch.Tensor:
    """``[B, L, H, W, C]`` -> ``[B, L - seqn + 1, seqn, H, W, C]``."""
    steps = frames.shape[1] - seqn + 1
    idx = (
        torch.arange(steps, device=frames.device)[:, None]
        + torch.arange(seqn, device=frames.device)[None, :]
    )
    return frames[:, idx]
