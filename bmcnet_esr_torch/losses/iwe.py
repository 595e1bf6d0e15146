"""Images of warped events (IWE).

Counterpart of ``bmcnet_esr_tpu/losses/iwe.py`` (reference
``myutils/iwe.py``).  Event lists are ``[B, N, 4]`` with columns
``(ts, y, x, p)``, ``ts`` normalized to [0, 1]; every function is batch
first, of fixed shape and differentiable through the warp weights.

The scatters and gathers go through ``index_put(accumulate=True)`` and
tensor indexing (whose backward is that same accumulation): on the GPU it
sorts by destination and adds each segment in event order, so two runs give
the same bits, where ``scatter_add_`` / ``index_add_`` add with atomics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def scatter_rows(idx: Tensor, values: Tensor, size: int) -> Tensor:
    """Per row ``b``: ``out[b, idx[b, i]] += values[b, i]`` into ``[B, size]``
    zeros; indices outside ``[0, size)`` are dropped (XLA's ``mode='drop'``)."""
    b = idx.shape[0]
    valid = (idx >= 0) & (idx < size)
    flat = torch.where(valid, idx, 0) + size * torch.arange(b, device=idx.device)[:, None]
    vals = torch.where(valid, values, torch.zeros((), dtype=values.dtype, device=values.device))
    out = torch.zeros(b * size, dtype=values.dtype, device=values.device)
    return out.index_put((flat.reshape(-1),), vals.reshape(-1), accumulate=True).reshape(b, size)


def gather_rows(src: Tensor, idx: Tensor) -> Tensor:
    """Per row ``b``: ``src[b, idx[b, i]]`` with ``jnp.take_along_axis``'s
    bounds: a negative index counts from the end once, and one still out of
    range gives NaN."""
    n = src.shape[1]
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    rows = torch.arange(src.shape[0], device=src.device)[:, None]
    vals = src[rows, torch.where(valid, idx, 0)]
    return torch.where(valid, vals, torch.full((), float("nan"), dtype=src.dtype,
                                               device=src.device))


def purge_unfeasible(idx: Tensor, res: Tuple[int, int]) -> Tuple[Tensor, Tensor]:
    """Zero out-of-frame (y, x) indices and return the validity mask
    (``iwe.py:4-17``)."""
    mask = (
        (idx[..., 0:1] >= 0)
        & (idx[..., 0:1] < res[0])
        & (idx[..., 1:2] >= 0)
        & (idx[..., 1:2] < res[1])
    ).to(idx.dtype)
    return idx * mask, mask


def get_interpolation(
    events: Tensor,
    flow: Tensor,
    tref: float,
    res: Tuple[int, int],
    flow_scaling: float,
    round_idx: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Warp events by their per-event (y, x) flow ``[B, N, 2]`` to ``tref``:
    flat indices ``[B, M, 1]`` and bilinear weights ``[B, M, 1]`` (``M = N``
    when rounded, else ``4N``: top-left, top-right, bottom-left,
    bottom-right) (``iwe.py:20-72``)."""
    warped = events[:, :, 1:3] + (tref - events[:, :, 0:1]) * flow * flow_scaling
    if round_idx:
        idx = torch.round(warped)
        weights = torch.ones_like(idx)
    else:
        top_y = torch.floor(warped[:, :, 0:1])
        bot_y = top_y + 1.0
        left_x = torch.floor(warped[:, :, 1:2])
        right_x = left_x + 1.0
        idx = torch.cat(
            [
                torch.cat([top_y, left_x], 2),
                torch.cat([top_y, right_x], 2),
                torch.cat([bot_y, left_x], 2),
                torch.cat([bot_y, right_x], 2),
            ],
            dim=1,
        )
        warped4 = torch.cat([warped] * 4, dim=1)
        weights = torch.maximum(torch.zeros((), dtype=idx.dtype, device=idx.device),
                                1.0 - torch.abs(warped4 - idx))
    idx, mask = purge_unfeasible(idx, res)
    weights = weights[..., 0:1] * weights[..., 1:2] * mask
    flat = idx[..., 0:1] * res[1] + idx[..., 1:2]
    return flat, weights


def interpolate(
    idx: Tensor,
    weights: Tensor,
    res: Tuple[int, int],
    polarity_mask: Optional[Tensor] = None,
) -> Tensor:
    """Scatter warped events into ``[B, 1, H, W]`` (``iwe.py:75-90``)."""
    if polarity_mask is not None:
        weights = weights * polarity_mask
    flat = scatter_rows(idx[:, :, 0].to(torch.int32).long(), weights[:, :, 0],
                        res[0] * res[1])
    return flat.reshape(idx.shape[0], 1, res[0], res[1])


def event_flow_lookup(flow_map: Tensor, events: Tensor, res: Tuple[int, int]) -> Tensor:
    """Per-event (y, x) flow ``[B, N, 2]`` read at each event's source pixel
    from ``flow_map`` ``[B, 2, H, W]`` (channel 0 = x, 1 = y)
    (``iwe.py:107-117``)."""
    flat_idx = (events[:, :, 1] * res[1] + events[:, :, 2]).to(torch.int32).long()
    fm = flow_map.reshape(flow_map.shape[0], 2, -1)
    fy = gather_rows(fm[:, 1, :], flat_idx)
    fx = gather_rows(fm[:, 0, :], flat_idx)
    return torch.stack([fy, fx], dim=-1)


def deblur_events(
    flow_map: Tensor,
    event_list: Tensor,
    res: Tuple[int, int],
    flow_scaling: float = 128,
    round_idx: bool = True,
    polarity_mask: Optional[Tensor] = None,
) -> Tensor:
    """Forward-warp events to ``tref = 1`` (``iwe.py:93-127``)."""
    event_flow = event_flow_lookup(flow_map, event_list, res)
    fw_idx, fw_weights = get_interpolation(
        event_list, event_flow, 1.0, res, flow_scaling, round_idx=round_idx
    )
    if not round_idx and polarity_mask is not None:
        polarity_mask = torch.cat([polarity_mask] * 4, dim=1)
    return interpolate(fw_idx, fw_weights, res, polarity_mask=polarity_mask)


def compute_pol_iwe(
    flow_map: Tensor,
    event_list: Tensor,
    res: Tuple[int, int],
    pos_mask: Tensor,
    neg_mask: Tensor,
    flow_scaling: float = 128,
    round_idx: bool = True,
) -> Tensor:
    """Per-polarity IWE, ``[B, 2, H, W]`` (``iwe.py:130-151``)."""
    iwe_pos = deblur_events(
        flow_map, event_list, res, flow_scaling, round_idx, polarity_mask=pos_mask
    )
    iwe_neg = deblur_events(
        flow_map, event_list, res, flow_scaling, round_idx, polarity_mask=neg_mask
    )
    return torch.cat([iwe_pos, iwe_neg], dim=1)


def events_to_iwe_order(events_xytp: Tensor) -> Tensor:
    """Pipeline layout ``[..., 4, N]`` (x, y, t, p) -> IWE layout
    ``[..., N, 4]`` (ts, y, x, p)."""
    e = torch.movedim(events_xytp, -2, -1)
    return torch.stack([e[..., 2], e[..., 1], e[..., 0], e[..., 3]], dim=-1)
