"""Seeded event traffic: one general generator of event windows.

A traffic mix is a data file (``benchmark/mixes/<name>.json``) of parameters
that this module reads; nothing here knows a cell.  Every window holds
exactly ``n_events`` events ``[x, y, t, p]`` (float32 rows) with integer
pixel coordinates inside the sensor, sorted timestamps in ``[k, k + 1)`` for
window ``k`` of its stream, and polarities +-1.  Events lie along a few
straight edges that move across the sensor from window to window (each edge
a line with a Gaussian profile across it, polarity by the side of the edge
that leads the motion), plus a uniform background share.  Real event
streams are edge-clustered; uniform events would flatter the rasterizer's
atomics.

Every stream draws from its own ``SeedSequence([seed, purpose, stream])``,
so a stream is the same whatever else a run generates, and the same seed
gives the same windows on any machine.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

PURPOSE = {"events": 1, "sample": 3, "weights": 4}


def rng(seed: int, purpose: str, *stream: int) -> np.random.Generator:
    """The generator of one purpose and stream of a run's ``seed``."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2**64, PURPOSE[purpose], *map(int, stream)]))


def _edges(g: np.random.Generator, n_edges: int, hw: Tuple[int, int], speed: float):
    """Per edge: angle, start offset, velocity (px a window) and sweep range."""
    h, w = hw
    reach = 0.8 * min(h, w) / 2.0
    theta = g.uniform(0.0, np.pi, n_edges)
    offset = g.uniform(-reach, reach, n_edges)
    velocity = speed * g.choice([-1.0, 1.0], n_edges) * g.uniform(0.5, 1.5, n_edges)
    return theta, offset, velocity, reach


def _bounce(x: np.ndarray, reach: float) -> np.ndarray:
    """Reflect ``x`` into ``[-reach, reach]`` (a triangle wave)."""
    period = 4.0 * reach
    y = np.mod(x + reach, period)
    return np.where(y < 2.0 * reach, y, period - y) - reach


def stream_windows(seed: int, stream: int, first: int, count: int, hw: Sequence[int],
                   n_events: int, params: Dict) -> np.ndarray:
    """Windows ``first .. first + count - 1`` of one stream: ``[count, 4, n_events]``
    float32.  ``params``: ``edges`` (lines), ``background_share`` (uniform
    events), ``edge_width_px`` (sigma across an edge), ``speed_px_per_window``."""
    h, w = int(hw[0]), int(hw[1])
    g = rng(seed, "events", stream)
    theta, offset, velocity, reach = _edges(g, int(params["edges"]), (h, w),
                                            float(params["speed_px_per_window"]))
    width = float(params["edge_width_px"])
    n_bg = int(round(n_events * float(params["background_share"])))
    n_edge = n_events - n_bg
    out = np.empty((count, 4, n_events), np.float32)
    half_diag = 0.5 * float(np.hypot(h, w))
    for i in range(count):
        k = first + i
        # each window draws from its own child stream: window k is the same
        # whichever windows a caller asks for
        gk = np.random.default_rng(np.random.SeedSequence(
            [int(seed) % 2**64, PURPOSE["events"], int(stream), 1 + k]))
        e = gk.integers(0, len(theta), 4 * n_edge)
        d = _bounce(offset[e] + velocity[e] * k, reach)
        u = gk.uniform(-half_diag, half_diag, 4 * n_edge)
        across = gk.normal(0.0, width, 4 * n_edge)
        nx, ny = np.cos(theta[e]), np.sin(theta[e])
        x = np.floor(w / 2.0 + (d + across) * nx - u * ny)
        y = np.floor(h / 2.0 + (d + across) * ny + u * nx)
        inside = np.flatnonzero((x >= 0) & (x < w) & (y >= 0) & (y < h))[:n_edge]
        lead = np.where(across[inside] * np.sign(velocity[e[inside]]) >= 0, 1.0, -1.0)
        m = n_events - len(inside)  # background, and any edge events short
        xs = np.concatenate([x[inside], gk.integers(0, w, m)])
        ys = np.concatenate([y[inside], gk.integers(0, h, m)])
        ps = np.concatenate([lead, gk.choice([-1.0, 1.0], m)])
        order = gk.permutation(n_events)
        out[i, 0], out[i, 1], out[i, 3] = xs[order], ys[order], ps[order]
        out[i, 2] = k + np.sort(gk.uniform(0.0, 1.0, n_events))
    return out


def compact(windows: np.ndarray):
    """``[..., 4, N]`` integer-pixel windows -> ``(xy int16 [..., 2, N], p int8 [..., N])``."""
    return windows[..., 0:2, :].astype(np.int16), windows[..., 3, :].astype(np.int8)


def sample(seed: int, stream: int, population: int, k: int, include_last: bool = True):
    """``k`` sorted indices of ``range(population)`` drawn from the seed,
    the last one among them when ``include_last``."""
    g = rng(seed, "sample", stream)
    picks = set(g.choice(population, size=min(k, population), replace=False).tolist())
    if include_last:
        picks.add(population - 1)
    return sorted(picks)

