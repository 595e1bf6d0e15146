"""Torch-matched separable resizing as two dense matrix products.

Counterpart of ``bmcnet_esr_tpu/ops/resize.py``.  ``_resize_matrix`` is a copy
of the JAX package's (``resize.py:46``): the ``[out, in]`` interpolation
matrix of ``F.interpolate(..., align_corners=False)`` with Keys ``A = -0.75``
bicubic taps and border clamping.  Applying it as two ``torch.matmul``
products gives the JAX package's arithmetic by construction.  Inputs of a
narrower float type are promoted to float32 first, as ``jnp.einsum`` promotes
them against the float32 matrices.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

_A = -0.75  # Keys cubic coefficient used by PyTorch's bicubic.


def _cubic1(t: np.ndarray) -> np.ndarray:
    """Cubic convolution weight for |offset| <= 1."""
    return ((_A + 2.0) * t - (_A + 3.0)) * t * t + 1.0


def _cubic2(t: np.ndarray) -> np.ndarray:
    """Cubic convolution weight for 1 < |offset| < 2."""
    return ((_A * t - 5.0 * _A) * t + 8.0 * _A) * t - 4.0 * _A


@functools.lru_cache(maxsize=256)
def _resize_matrix(in_size: int, out_size: int, mode: str) -> np.ndarray:
    """``[out_size, in_size]`` row-stochastic interpolation matrix (source
    index ``(dst + 0.5) * in/out - 0.5``, border-clamped taps)."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)

    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)

    if mode == "bilinear":
        src = np.maximum(src, 0.0)
        i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
        i1 = np.minimum(i0 + 1, in_size - 1)
        w1 = np.clip(src - i0, 0.0, 1.0)
        np.add.at(mat, (rows, i0), 1.0 - w1)
        np.add.at(mat, (rows, i1), w1)
    elif mode == "bicubic":
        i = np.floor(src).astype(np.int64)
        t = src - i
        weights = [_cubic2(t + 1.0), _cubic1(t), _cubic1(1.0 - t), _cubic2(2.0 - t)]
        for k, wk in enumerate(weights):
            idx = np.clip(i - 1 + k, 0, in_size - 1)
            np.add.at(mat, (rows, idx), wk)
    else:
        raise ValueError(f"unsupported resize mode {mode!r}")
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _matrix(in_size: int, out_size: int, mode: str, device: torch.device) -> torch.Tensor:
    # cached per device: a fresh host-to-device copy per call would stall
    # the asynchronous rollout on every window
    return torch.from_numpy(_resize_matrix(in_size, out_size, mode)).to(device)


def _matrix_for(in_size: int, out_size: int, mode: str, device: torch.device) -> torch.Tensor:
    # a trace (torch.export) makes fake tensors: keep them out of the cache
    # that eager calls read; the program takes the matrix as a constant
    fn = _matrix.__wrapped__ if torch.compiler.is_compiling() else _matrix
    return fn(in_size, out_size, mode, device)


def _resize(x: torch.Tensor, out_hw: Tuple[int, int], mode: str, channel_last: bool) -> torch.Tensor:
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if channel_last:  # [..., H, W, C]
        *lead, in_h, in_w, c = x.shape
        my = _matrix_for(in_h, out_h, mode, x.device).to(x.dtype)
        mx = _matrix_for(in_w, out_w, mode, x.device).to(x.dtype)
        y = torch.matmul(my, x.reshape(*lead, in_h, in_w * c)).reshape(*lead, out_h, in_w, c)
        return torch.matmul(mx, y)  # [P, W] @ [..., O, W, C] -> [..., O, P, C]
    in_h, in_w = x.shape[-2], x.shape[-1]
    my = _matrix_for(in_h, out_h, mode, x.device).to(x.dtype)
    mx = _matrix_for(in_w, out_w, mode, x.device).to(x.dtype)
    return torch.matmul(torch.matmul(my, x), mx.T)


def resize_bicubic(
    x: torch.Tensor, out_hw: Tuple[int, int], *, channel_last: bool = True
) -> torch.Tensor:
    """Bicubic resize equal to ``F.interpolate(mode='bicubic',
    align_corners=False)``; trailing axes ``[H, W, C]`` (or ``[H, W]``)."""
    return _resize(x, out_hw, "bicubic", channel_last)


def resize_bilinear(
    x: torch.Tensor, out_hw: Tuple[int, int], *, channel_last: bool = True
) -> torch.Tensor:
    """Bilinear resize equal to ``F.interpolate(mode='bilinear',
    align_corners=False)``."""
    return _resize(x, out_hw, "bilinear", channel_last)


def upsample_bilinear(x: torch.Tensor, scale: int, *, channel_last: bool = True) -> torch.Tensor:
    """Integer-factor bilinear upsample (the model's HR skip path)."""
    h, w = (x.shape[-3], x.shape[-2]) if channel_last else (x.shape[-2], x.shape[-1])
    return _resize(x, (h * scale, w * scale), "bilinear", channel_last)
