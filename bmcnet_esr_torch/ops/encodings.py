"""Event-window encoders (plain PyTorch).

Counterpart of ``bmcnet_esr_tpu/ops/encodings.py``: the count rasterizers
``events_to_image`` and ``events_to_channels`` (``:53-111``), the auxiliary
encodings ``events_to_voxel``, ``events_to_mask``, the two time-binned
stacks, ``get_hot_event_mask``, ``stack_to_count``, ``event_conversion``
and ``event_restore`` (``:114-374``), the loss helpers
``normalize_event_times`` and ``events_polarity_mask`` (``:270-294``), and
the host-side numpy ``event_redistribute_stack`` (``:377``).  The encoders
keep the reference quirks:

* the y axis is flipped (``y -> H - 1 - y``) unless ``flip_y=False``; the
  stacks and the mask do not flip (the reference's torch path);
* out-of-range events are redirected to pixel ``(0, 0)`` with value 0, i.e.
  dropped; coordinates truncate toward zero;
* ``events_to_channels`` squares the polarity into positive counts and picks
  the channel by ``p < 0`` (padding with ``p == 0`` adds nothing);
* stack bins are inclusive at both ends, so an event on a boundary lands in
  both bins, and a window with ``sum(ts) == 0`` or ``n <= 3`` gives zeros.

The range test is written as "inside" tests, so a NaN coordinate is dropped
too (the JAX version leaves NaN undefined).  Every encoder accumulates
through ``index_put_(accumulate=True)``; on CUDA that adds in no fixed
order, which leaves counts, stacks and masks exact (sums of +-1, a max) and
voxels (fractional weights) within round-off.  Batched count images of the
inference path go through :mod:`bmcnet_esr_torch.kernels.rasterize`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _pixels(xs, ys, ps, h: int, w: int, flip_y: bool, dtype):
    valid = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    x = torch.where(valid, xs, 0).long()
    y = torch.where(valid, ys, 0).long()
    v = torch.where(valid, ps, 0).to(dtype)
    if flip_y:
        y = (h - 1) - y
    return y * w + x, v


def events_to_image(
    xs: torch.Tensor,
    ys: torch.Tensor,
    ps: torch.Tensor,
    sensor_size: Tuple[int, int],
    *,
    flip_y: bool = True,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Scatter-add an event list into an ``[H, W]`` image of signed ``ps``."""
    h, w = int(sensor_size[0]), int(sensor_size[1])
    idx, v = _pixels(xs, ys, ps, h, w, flip_y, dtype)
    flat = torch.zeros(h * w, dtype=dtype, device=xs.device)
    flat.index_put_((idx,), v, accumulate=True)
    return flat.reshape(h, w)


def events_to_channels(
    xs: torch.Tensor,
    ys: torch.Tensor,
    ps: torch.Tensor,
    sensor_size: Tuple[int, int],
    *,
    flip_y: bool = True,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Two-channel (positive, negative) count image ``[2, H, W]``."""
    h, w = int(sensor_size[0]), int(sensor_size[1])
    idx, v = _pixels(xs, ys, ps, h, w, flip_y, dtype)
    idx = (v < 0).long() * (h * w) + idx
    flat = torch.zeros(2 * h * w, dtype=dtype, device=xs.device)
    flat.index_put_((idx,), v * v, accumulate=True)
    return flat.reshape(2, h, w)


def normalize_event_times(ts: torch.Tensor, n_valid=None) -> torch.Tensor:
    """Window timestamps ``[..., N]`` to ``[0, 1]``:
    ``(ts - ts[0]) / (ts[last] - ts[0] + 1e-6)`` (``base_dataset.py:24-31``).

    ``last`` is ``N - 1``, or ``n_valid - 1`` (``[...]``, clamped into the
    window) for zero-padded windows, so the last valid event anchors the end."""
    n = ts.shape[-1]
    t0 = ts[..., :1]
    if n_valid is None:
        t_last = ts[..., -1:]
    else:
        last = torch.clamp(torch.as_tensor(n_valid, device=ts.device).long() - 1, 0, n - 1)
        t_last = torch.gather(ts, -1, last.reshape(tuple(ts.shape[:-1]) + (1,)))
    return (ts - t0) / (t_last - t0 + 1e-6)


def events_polarity_mask(ps: torch.Tensor) -> torch.Tensor:
    """``[..., N]`` polarities -> ``[..., N, 2]``: ``max(p, 0)`` and
    ``-min(p, 0)`` (``encodings.py:335-346``)."""
    return torch.stack([torch.clamp(ps, min=0), -torch.clamp(ps, max=0)], dim=-1)


def _scatter_add(idx: torch.Tensor, v: torch.Tensor, size: int) -> torch.Tensor:
    flat = torch.zeros(size, dtype=v.dtype, device=v.device)
    flat.index_put_((idx.reshape(-1),), v.reshape(-1), accumulate=True)
    return flat


def events_to_voxel(
    xs: torch.Tensor,
    ys: torch.Tensor,
    ts: torch.Tensor,
    ps: torch.Tensor,
    num_bins: int,
    sensor_size: Tuple[int, int],
    *,
    flip_y: bool = True,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Temporal-bilinear voxel grid ``[num_bins, H, W]``: each event adds
    ``p * max(0, 1 - |t * (B - 1) - b|)`` to bin ``b`` (``ts`` normalized to
    [0, 1] beforehand)."""
    h, w = int(sensor_size[0]), int(sensor_size[1])
    idx, v = _pixels(xs, ys, ps, h, w, flip_y, dtype)
    tb = ts * (num_bins - 1)
    bins = torch.arange(num_bins, dtype=dtype, device=xs.device)[:, None]
    weights = torch.clamp(1.0 - torch.abs(tb[None, :].to(dtype) - bins), min=0.0)
    plane = torch.arange(num_bins, device=xs.device)[:, None] * (h * w)
    return _scatter_add(plane + idx[None, :], v[None, :] * weights,
                        num_bins * h * w).reshape(num_bins, h, w)


def events_to_mask(
    xs: torch.Tensor,
    ys: torch.Tensor,
    ps: torch.Tensor,
    sensor_size: Tuple[int, int],
    *,
    flip_y: bool = False,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``[H, W]`` activity mask: the largest ``|p|`` per pixel (a scatter-max
    over zeros; the reference writes ``|p|``, last writer winning, which is
    the same for ``|p|`` in {0, 1})."""
    h, w = int(sensor_size[0]), int(sensor_size[1])
    idx, v = _pixels(xs, ys, torch.abs(ps), h, w, flip_y, dtype)
    flat = torch.zeros(h * w, dtype=dtype, device=xs.device)
    flat.scatter_reduce_(0, idx, v, reduce="amax", include_self=True)
    return flat.reshape(h, w)


def _stack_bin_weights(ts: torch.Tensor, num_bins: int, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[num_bins, N]`` membership of each event in each bin and the
    window's validity.  Bin ``b`` covers ``[t0 + d b, t0 + d (b + 1)]``,
    inclusive at both ends, with ``d = (t_last - t0 + 1e-6) / num_bins``; a
    window with ``sum(ts) == 0`` or ``N <= 3`` is invalid (all zeros)."""
    n = ts.shape[0]
    t0 = ts[0]
    delta = (ts[n - 1] - t0 + 1e-6) / num_bins
    b = torch.arange(num_bins, dtype=dtype, device=ts.device)[:, None]
    tstart = t0 + delta * b
    tend = tstart + delta
    member = (ts[None, :] >= tstart) & (ts[None, :] <= tend)
    valid = torch.logical_not((torch.sum(ts) == 0) | (n <= 3))
    return member.to(dtype), valid.to(dtype)


def events_to_stack_no_polarity(
    xs: torch.Tensor,
    ys: torch.Tensor,
    ts: torch.Tensor,
    ps: torch.Tensor,
    num_bins: int,
    sensor_size: Tuple[int, int],
    *,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Time-binned signed stack ``[num_bins, H, W]`` (no y flip)."""
    h, w = int(sensor_size[0]), int(sensor_size[1])
    member, valid = _stack_bin_weights(ts, num_bins, dtype)
    idx, v = _pixels(xs, ys, ps, h, w, False, dtype)
    plane = torch.arange(num_bins, device=xs.device)[:, None] * (h * w)
    flat = _scatter_add(plane + idx[None, :], v[None, :] * member, num_bins * h * w)
    return flat.reshape(num_bins, h, w) * valid


def events_to_stack_polarity(
    xs: torch.Tensor,
    ys: torch.Tensor,
    ts: torch.Tensor,
    ps: torch.Tensor,
    num_bins: int,
    sensor_size: Tuple[int, int],
    *,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Per-polarity time-binned stack ``[2, num_bins, H, W]`` of ``p**2``
    routed by sign (no y flip); an invalid window gives zeros of this
    shape."""
    h, w = int(sensor_size[0]), int(sensor_size[1])
    member, valid = _stack_bin_weights(ts, num_bins, dtype)
    idx, v = _pixels(xs, ys, ps, h, w, False, dtype)
    idx = (v < 0).long() * (num_bins * h * w) + idx
    plane = torch.arange(num_bins, device=xs.device)[:, None] * (h * w)
    flat = _scatter_add(plane + idx[None, :], (v * v)[None, :] * member, 2 * num_bins * h * w)
    return flat.reshape(2, num_bins, h, w) * valid


def get_hot_event_mask(
    event_rate: torch.Tensor,
    idx: int,
    max_px: int = 100,
    min_obvs: int = 5,
    max_rate: float = 0.8,
) -> torch.Tensor:
    """``[H, W]`` mask that zeroes up to ``max_px`` of the hottest pixels
    whose rate exceeds ``max_rate``, once more than ``min_obvs`` windows were
    observed (``idx``).  The hottest are taken by a stable descending sort
    of the flattened rate, so among tied rates the lower flat index comes
    first, as ``lax.top_k`` orders them (``torch.topk`` fixes no order)."""
    h, w = event_rate.shape
    flat = event_rate.reshape(-1)
    k = min(int(max_px), flat.shape[0])
    top_vals, top_idx = torch.sort(flat, descending=True, stable=True)
    top_vals, top_idx = top_vals[:k], top_idx[:k]
    mask = torch.ones_like(flat)
    mask[top_idx] = torch.where(top_vals > max_rate, 0.0, 1.0).to(flat.dtype)
    if not int(idx) > min_obvs:
        mask = torch.ones_like(flat)
    return mask.reshape(h, w)


def stack_to_count(stack: torch.Tensor) -> torch.Tensor:
    """Signed ``[B, T, H, W]`` stack -> ``[B, 2, H, W]`` counts: round (half
    to even), split by sign, negate the negative part, sum over the bins."""
    stack = torch.round(stack)
    pos = torch.clamp(stack, min=0.0).sum(dim=1)
    neg = (-torch.clamp(stack, max=0.0)).sum(dim=1)
    return torch.stack([pos, neg], dim=1)


def event_conversion(
    event_list: torch.Tensor,
    time_bins: int,
    resolution: Tuple[int, int],
    time_bins_voxel: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """``[B, N, 4]`` (x, y, t, p) event lists -> ``{"e_cnt" [B, 2, H, W],
    "e_voxel" [B, Tv, H, W], "e_stack" [B, T, H, W]}``: each list is sorted
    by t (stable), then rasterized three ways; padding (``p == 0``) adds
    nothing."""
    if time_bins_voxel is None:
        time_bins_voxel = time_bins
    order = torch.sort(event_list[:, :, 2], dim=1, stable=True).indices
    ev = torch.gather(event_list, 1, order[:, :, None].expand(-1, -1, 4))
    cnt, voxel, stack = [], [], []
    for e in ev:
        xs, ys, ts, ps = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
        cnt.append(events_to_channels(xs, ys, ps, resolution))
        voxel.append(events_to_voxel(xs, ys, ts, ps, time_bins_voxel, resolution))
        stack.append(events_to_stack_no_polarity(xs, ys, ts, ps, time_bins, resolution))
    return {"e_cnt": torch.stack(cnt), "e_voxel": torch.stack(voxel),
            "e_stack": torch.stack(stack)}


def event_restore(events: torch.Tensor, resolution: Tuple[int, int]) -> torch.Tensor:
    """Denormalize ``[B, N, 4]`` events: coordinates back to pixels,
    polarity snapped to {-1, 0, +1} (padding stays zero)."""
    x = events[..., 0] * resolution[1]
    y = events[..., 1] * resolution[0]
    return torch.stack([x, y, events[..., 2], torch.sign(events[..., 3])], dim=-1)


def event_redistribute_stack(
    event_stack: np.ndarray,
    mode: str = "linear",
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Binned stack -> event cloud, in numpy on the host (the output is
    ragged).  Accepts ``[B, C, Y, X]`` or, with polarity, ``[B, P, C, Y, X]``;
    each nonzero cell of rounded magnitude ``m`` emits ``m`` events at its
    ``(x, y)`` with polarity ``sign(value)`` and timestamps spread over its
    bin ``c``: ``linspace(c/C + 1/(100C), (c+1)/C, m)`` (``linear``) or
    uniform draws from ``rng`` (``random``).  Each item's events are sorted
    by t (stable) and zero-padded to the longest item: ``[B, N_max, 4]``
    float32 (x, y, t, p).  The native :func:`bmcnet_esr_torch.native.
    redistribute_stack` computes the same in C++."""
    if event_stack.ndim == 5:
        num_bins = event_stack.shape[2]
        bin_dim = 1
    elif event_stack.ndim == 4:
        num_bins = event_stack.shape[1]
        bin_dim = 0
    else:
        raise ValueError(f"unsupported stack rank {event_stack.ndim}")
    if rng is None:
        rng = np.random.default_rng()

    stack = np.round(np.asarray(event_stack, dtype=np.float64))
    if stack.sum() == 0:
        return np.zeros((stack.shape[0], 1, 4), dtype=np.float32)
    clouds = []
    for entry in stack:
        coords = np.argwhere(entry)
        if coords.shape[0] == 0:
            clouds.append(np.zeros((1, 4), dtype=np.float32))
            continue
        pieces = []
        for coord in coords:
            value = entry[tuple(coord)]
            m = int(abs(value))
            if m == 0:
                continue
            c = coord[bin_dim]
            t0 = c / num_bins + 1.0 / (100 * num_bins)
            t1 = (c + 1) / num_bins
            if mode == "linear":
                t = np.linspace(t0, t1, m)
            elif mode == "random":
                t = rng.random(m) * (t1 - t0) + t0
            else:
                raise ValueError(f"unsupported mode {mode!r}")
            el = np.empty((m, 4), dtype=np.float32)
            el[:, 0] = coord[-1]
            el[:, 1] = coord[-2]
            el[:, 2] = t
            el[:, 3] = 1.0 if value > 0 else -1.0
            pieces.append(el)
        elist = np.concatenate(pieces, axis=0)
        clouds.append(elist[np.argsort(elist[:, 2], kind="stable")])
    out = np.zeros((len(clouds), max(c.shape[0] for c in clouds), 4), dtype=np.float32)
    for i, c in enumerate(clouds):
        out[i, : c.shape[0]] = c
    return out
