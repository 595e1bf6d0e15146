"""Unsupervised flow losses: contrast maximization and the averaged IWE.

Counterpart of ``bmcnet_esr_tpu/losses/flow.py`` (reference ``loss/flow.py``):

* :func:`event_warping_loss`: per-polarity images of the averaged timestamps
  of forward- and backward-warped events, minimized, plus a Charbonnier flow
  smoothness term (``flow.py:15-110``);
* :func:`averaged_iwe`: per pixel and polarity, the warped event count over
  the number of distinct source pixels that reach it (``flow.py:113-232``).
  The distinct (polarity, source, destination) triples come from one sort
  of a packed int64 key and a first-occurrence mask, where the JAX package
  sorts on three keys.

Event lists are ``[B, N, 4]`` (ts, y, x, p); ``pol_mask`` is ``[B, N, 2]``
(:func:`bmcnet_esr_torch.ops.encodings.events_polarity_mask`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from bmcnet_esr_torch.losses.iwe import (
    event_flow_lookup,
    get_interpolation,
    interpolate,
    scatter_rows,
)

Tensor = torch.Tensor

_SRC_SPAN = 1 << 32  # every int32 source index, shifted to [0, 2**32)


def event_warping_loss(
    flow_list: Sequence[Tensor],
    event_list: Tensor,
    pol_mask: Tensor,
    resolution: Tuple[int, int],
    flow_regul_weight: float,
) -> Tensor:
    """Contrast-maximization loss over a list of ``[B, 2, H, W]`` flow maps.

    Computed in the inputs' dtype, as the JAX package computes it.  In
    float32 the loss is ill-conditioned by construction: the averaged
    timestamp images divide by the warped counts plus 1e-9, so a corner
    weight of a few 1e-8, which float32 rounds to zero at a position of ten
    pixels or more (and float64 keeps), adds a whole timestamp.  Float32
    results of either package sit up to about 1e-3 of the value (and 2e-3
    of the flow gradient's norm) from float64 ones; float64 inputs give
    float64 results."""
    res = resolution
    flow_scaling = max(res)
    pol4 = torch.cat([pol_mask] * 4, dim=1)
    ts4 = torch.cat([event_list[:, :, 0:1]] * 4, dim=1)

    total = 0.0
    for flow in flow_list:
        event_flow = event_flow_lookup(flow, event_list, res)

        def avg_ts_images(tref, ts_weight):
            idx, weights = get_interpolation(event_list, event_flow, tref, res, flow_scaling)
            iwe_pos = interpolate(idx, weights, res, polarity_mask=pol4[:, :, 0:1])
            iwe_neg = interpolate(idx, weights, res, polarity_mask=pol4[:, :, 1:2])
            ts_pos = interpolate(idx, weights * ts_weight, res, polarity_mask=pol4[:, :, 0:1])
            ts_neg = interpolate(idx, weights * ts_weight, res, polarity_mask=pol4[:, :, 1:2])
            return ts_pos / (iwe_pos + 1e-9), ts_neg / (iwe_neg + 1e-9)

        fw_pos_ts, fw_neg_ts = avg_ts_images(1.0, ts4)
        bw_pos_ts, bw_neg_ts = avg_ts_images(0.0, 1.0 - ts4)

        flow_map = flow.reshape(flow.shape[0], 2, res[0], res[1])
        flow_dx = flow_map[:, :, :-1, :] - flow_map[:, :, 1:, :]
        flow_dy = flow_map[:, :, :, :-1] - flow_map[:, :, :, 1:]
        smooth = (torch.sum(torch.sqrt(flow_dx**2 + 1e-6))
                  + torch.sum(torch.sqrt(flow_dy**2 + 1e-6)))

        total = total + (
            torch.sum(fw_pos_ts**2)
            + torch.sum(fw_neg_ts**2)
            + torch.sum(bw_pos_ts**2)
            + torch.sum(bw_neg_ts**2)
            + flow_regul_weight * smooth
        )
    return total


def _unique_contrib(pol: Tensor, src: Tensor, dst: Tensor, hw: int) -> Tuple[Tensor, Tensor]:
    """Per row, the number of distinct (pol, src) pairs that reach each
    destination pixel, split by polarity: two ``[B, hw]`` float32 maps.

    ``pol`` is 0 (negative), 1 (positive) or 2 (unfeasible); ``src`` any
    int32; ``dst`` in ``[0, hw)``, all ``[B, N]``.  The key
    ``(pol * 2**32 + src + 2**31) * hw + dst`` orders the triples as the
    JAX package's three-key sort does, and two triples share a key exactly
    when they are equal, so the first of each run of equal keys counts each
    distinct triple once, however the sort orders equal keys."""
    if 3 * _SRC_SPAN * hw >= 1 << 63:
        raise ValueError(f"a {hw}-pixel image overflows the int64 sort key")
    key = ((pol.long() * _SRC_SPAN + (src.to(torch.int32).long() + (1 << 31))) * hw
           + dst.to(torch.int32).long())
    skey, perm = torch.sort(key, dim=1)
    first = torch.ones_like(skey, dtype=torch.bool)
    first[:, 1:] = skey[:, 1:] != skey[:, :-1]
    spol = torch.gather(pol, 1, perm)
    sdst = torch.gather(dst.to(torch.int32).long(), 1, perm)
    pos = scatter_rows(sdst, (first & (spol == 1)).to(torch.float32), hw)
    neg = scatter_rows(sdst, (first & (spol == 0)).to(torch.float32), hw)
    return pos, neg


def averaged_iwe(
    flow: Tensor,
    event_list: Tensor,
    pol_mask: Tensor,
    resolution: Tuple[int, int],
) -> Tensor:
    """Per-pixel, per-polarity average number of warped events
    (``flow.py:113-232``), ``[B, 2, H, W]``."""
    res = resolution
    hw = res[0] * res[1]
    flow_scaling = max(res)

    src_idx = (event_list[:, :, 1] * res[1] + event_list[:, :, 2]).to(torch.int32)
    event_flow = event_flow_lookup(flow, event_list, res)
    fw_idx, fw_weights = get_interpolation(
        event_list, event_flow, 1.0, res, flow_scaling, round_idx=True
    )
    iwe_pos = interpolate(fw_idx, fw_weights, res, polarity_mask=pol_mask[:, :, 0:1])
    iwe_neg = interpolate(fw_idx, fw_weights, res, polarity_mask=pol_mask[:, :, 1:2])

    # polarity code: 1 pos, 0 neg, 2 unfeasible mapping (flow.py:161-163)
    pol = torch.where(event_list[:, :, 3] < 1, 0, 1)
    pol = torch.where(fw_weights[:, :, 0] == 0, 2, pol)

    with torch.no_grad():
        pos_c, neg_c = _unique_contrib(pol, src_idx, fw_idx[:, :, 0].to(torch.int32), hw)
    pos_c = pos_c.reshape(-1, 1, res[0], res[1])
    neg_c = neg_c.reshape(-1, 1, res[0], res[1])

    iwe_pos = torch.where(pos_c > 0, iwe_pos / torch.clamp(pos_c, min=1.0), iwe_pos)
    iwe_neg = torch.where(neg_c > 0, iwe_neg / torch.clamp(neg_c, min=1.0), iwe_neg)
    return torch.cat([iwe_pos, iwe_neg], dim=1)
