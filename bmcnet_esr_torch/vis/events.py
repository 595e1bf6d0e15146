"""Event count-image renderer for the inference PNG streams.

Counterpart of ``bmcnet_esr_tpu/vis/events.py`` (``render_event_count`` and
``EventVisualizer.plot_event_cnt``), numpy only.  PNGs are written with cv2,
imported when a file is written.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _normalize(pos: np.ndarray, neg: np.ndarray, is_norm: bool):
    pos = pos.astype(np.float64)
    neg = neg.astype(np.float64)
    # one two-quantile partition per polarity (identical values to separate
    # percentile calls; ~2x faster — percentile dominates render time)
    pos_min, pos_max = np.percentile(pos, (1, 99))
    neg_min, neg_max = np.percentile(neg, (1, 99))
    vmax = max(pos_max, neg_max)
    if is_norm:
        if pos_min != vmax:
            pos = (pos - pos_min) / (vmax - pos_min)
        if neg_min != vmax:
            neg = (neg - neg_min) / (vmax - neg_min)
    else:
        dominant_pos = (pos >= neg) & (pos != 0)
        dominant_neg = (pos < neg) & (neg != 0)
        pos = np.where(dominant_pos, 1.0, 0.0)
        neg = np.where(dominant_neg, 1.0, 0.0)
    return np.clip(pos, 0, 1), np.clip(neg, 0, 1)


def render_event_count(
    event_cnt: np.ndarray,
    color_scheme: str = "blue_red",
    is_black_background: bool = False,
    is_norm: bool = True,
) -> np.ndarray:
    """``[H, W, 2]`` counts (0 pos, 1 neg) -> RGB uint8 image.

    Pixel rule (white background): the dominant polarity colors the pixel —
    positive full-saturation blue (blue_red) or green (green_red), negative
    red; intensity scales with the normalized count.
    """
    if color_scheme not in ("blue_red", "green_red", "gray"):
        raise ValueError(f"unsupported color scheme {color_scheme!r}")
    pos, neg = _normalize(event_cnt[:, :, 0], event_cnt[:, :, 1], is_norm)

    if color_scheme == "gray":
        img = 0.5 + 0.5 * pos - 0.5 * neg
        rgb = np.repeat(img[:, :, None], 3, axis=2)
        return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)

    h, w = pos.shape
    pos_active = pos > 0
    neg_active = neg > 0
    pos_dominant = pos_active & (~neg_active | (pos >= neg))
    neg_dominant = neg_active & ~pos_dominant

    if is_black_background:
        rgb = np.zeros((h, w, 3))
        primary = 2 if color_scheme == "blue_red" else 1  # RGB channel of pos
        rgb[..., primary] = np.where(pos_active, pos, 0.0)
        rgb[..., 0] = np.where(neg_active, neg, rgb[..., 0])
    else:
        rgb = np.ones((h, w, 3))
        fade_pos = 1.0 - pos
        fade_neg = 1.0 - neg
        if color_scheme == "blue_red":
            # pos-dominant pixel: RGB = (1-p, 1-p, 1); neg: (1, 1-n, 1-n)
            rgb[..., 0] = np.where(pos_dominant, fade_pos, rgb[..., 0])
            rgb[..., 1] = np.where(pos_dominant, fade_pos, rgb[..., 1])
            rgb[..., 1] = np.where(neg_dominant, fade_neg, rgb[..., 1])
            rgb[..., 2] = np.where(neg_dominant, fade_neg, rgb[..., 2])
        else:  # green_red
            # pos-dominant: (1-p, 1, 1-p); neg: (1, 1-n, 1-n)
            rgb[..., 0] = np.where(pos_dominant, fade_pos, rgb[..., 0])
            rgb[..., 2] = np.where(pos_dominant, fade_pos, rgb[..., 2])
            rgb[..., 1] = np.where(neg_dominant, fade_neg, rgb[..., 1])
            rgb[..., 2] = np.where(neg_dominant, fade_neg, rgb[..., 2])

    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


class EventVisualizer:
    """File-writing facade (reference ``event_visualisation`` class)."""

    def plot_event_cnt(
        self,
        event_cnt: np.ndarray,
        is_save: bool = False,
        path: Optional[str] = None,
        color_scheme: str = "blue_red",
        is_black_background: bool = False,
        is_norm: bool = True,
    ) -> np.ndarray:
        rgb = render_event_count(event_cnt, color_scheme, is_black_background, is_norm)
        if is_save and path is not None:
            write_png(path, rgb)
        return rgb


def write_png(path: str, rgb: np.ndarray) -> None:
    import cv2

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
