"""Loss-term builders that the trainer's ``loss:`` block attaches.

Counterpart of ``bmcnet_esr_tpu/losses/terms.py``.  A builder is
``build(cfg: dict, ctx: LossContext) -> term`` and a term is
``fn(pred_fit, gt, aux) -> scalar tensor``, called once a step of the
recurrent unroll (``training/train_step.py::_rollout_losses``):

* ``pred_fit``: the HR prediction, bicubic-resized to the GT grid where the
  two differ (NHWC);
* ``gt``: the GT count image of the step's second window (NHWC);
* ``aux``: the step's context:
    ``pred``        the raw model output (NHWC)
    ``prev_pred``   the previous step's output (the recurrent output slot)
    ``inp``         the step's input windows ``[B, seqn, H, W, 2]``
    ``step``        the step's index
    ``events``      the step's raw event window ``[B, 4, N]`` (x, y, ts, p),
                    only when a term sets ``needs_events`` (which needs
                    ``compact_transfer: False``: the compact form drops ts)
    ``events_len``  the window's valid event counts ``[B]``, with ``events``
    ``batch_max``   on a data-parallel step, the elementwise max of a tensor
                    over the ranks that share the batch

A term is a mean over the batch's clips, but the two event terms, which
sum over them (as the reference's losses do) and say so with
``fn.batch_sum``: the data-parallel step scales those by its data axis's
size, so each rank's share adds up to the whole batch's sum.  ``ssim``
without a pinned ``data_range`` reads the GT's range over the whole batch,
through ``aux['batch_max']`` on a data-parallel step, as the JAX mesh step
reads it over the global batch.

The recon-family term of count-image SR is ``lr_consistency``: the HR
prediction mean-pooled to the LR grid must reproduce the LR counts (the GT
window holds ``scale**2`` times the input window's events over the same
span, so densities agree under mean pooling).  The flow terms
(``event_warping``, ``brightness_constancy``) read a flow map from ``aux``;
the BMCNet models predict counts, not flow, so they serve recipes whose
model emits one (``flow_key: pred``), or a ``fn:`` builder that supplies it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from bmcnet_esr_torch.losses.flow import event_warping_loss
from bmcnet_esr_torch.losses.reconstruction import _warp_grid, generative_model_loss
from bmcnet_esr_torch.losses.restore import ssim as ssim_fn
from bmcnet_esr_torch.ops.encodings import events_polarity_mask, normalize_event_times
from bmcnet_esr_torch.ops.warp import grid_sample_bilinear

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LossContext:
    """Static shape and config facts that term builders read."""

    inp_resolution: Tuple[int, int]
    gt_resolution: Tuple[int, int]
    scale: int
    seqn: int = 2


def _require_ctx(ctx, name):
    if ctx is None:
        raise ValueError(
            f"loss term {name!r} needs a LossContext (resolutions/scale); "
            "build it through the Trainer or pass ctx= to build_extra_losses"
        )
    return ctx


def _iwe_event_list(events: Tensor, n_valid: Optional[Tensor] = None
                    ) -> Tuple[Tensor, Tensor]:
    """Raw ``[B, 4, N]`` (x, y, ts, p) window -> the IWE event list
    ``[B, N, 4]`` (ts, y, x, p), ts normalized to [0, 1], and the polarity
    mask ``[B, N, 2]``.  ``n_valid`` (``aux['events_len']``) anchors the
    normalization on the last valid event of a zero-padded window, whose
    padding would otherwise set the window's end to 0."""
    xs, ys, ts, ps = events[:, 0], events[:, 1], events[:, 2], events[:, 3]
    ts_n = normalize_event_times(ts, None if n_valid is None else n_valid.to(torch.int32))
    return torch.stack([ts_n, ys, xs, ps], dim=-1), events_polarity_mask(ps)


def _flow_nchw(aux: Dict, flow_key: str, name: str) -> Tensor:
    flow = aux.get(flow_key)
    if flow is None:
        raise ValueError(
            f"loss term {name!r} reads the flow map from aux[{flow_key!r}], "
            "which this model does not provide — it applies to recipes whose "
            "model outputs flow (set flow_key: pred to use the prediction)"
        )
    if flow.shape[-1] == 2 and flow.shape[1] != 2:  # NHWC -> NCHW
        flow = torch.movedim(flow, -1, 1)
    return flow


# -- reconstruction family ---------------------------------------------------

def lr_consistency(cfg: Dict, ctx: Optional[LossContext]) -> Callable:
    """The HR prediction mean-pooled to the LR grid against the step's LR
    input counts, ``norm`` l1 (default) or l2."""
    norm = cfg.get("norm", "l1")
    if norm not in ("l1", "l2"):
        raise ValueError(f"lr_consistency norm must be l1|l2, got {norm!r}")

    def fn(pred, gt, aux):
        # the pair's index 1 is the step's current window, the one the GT
        # aligns to; [:, -1] would read a later window when seqn > 2
        x = aux["inp"][:, 1]  # [B, H, W, 2]
        b, kh, kw, c = pred.shape
        h, w = x.shape[1], x.shape[2]
        if kh % h or kw % w:
            raise ValueError(
                f"lr_consistency needs integer HR/LR factor, got {kh}x{kw} over {h}x{w}"
            )
        down = pred.reshape(b, h, kh // h, w, kw // w, c).mean(dim=(2, 4))
        err = down - x
        return torch.mean(torch.abs(err)) if norm == "l1" else torch.mean(torch.square(err))

    return fn


def temporal_consistency(cfg: Dict, ctx: Optional[LossContext]) -> Callable:
    """L1 between consecutive HR predictions (``reconstruction.py:99-132``);
    with ``flow_key`` the previous prediction is first backward-warped by
    ``aux[flow_key]``.  Step 0, whose previous output is the zero initial
    state, counts for nothing."""
    flow_key = cfg.get("flow_key")

    def fn(pred, gt, aux):
        cur, prev = aux["pred"], aux["prev_pred"]
        if flow_key is not None:
            flow = _flow_nchw(aux, flow_key, "temporal_consistency")
            res = (cur.shape[1], cur.shape[2])
            grid = _warp_grid(flow, res, max(res))
            prev = torch.movedim(grid_sample_bilinear(torch.movedim(prev, -1, 1), grid), 1, -1)
        valid = float(aux["step"] > 0)
        return valid * torch.mean(torch.abs(cur - prev))

    return fn


def total_variation(cfg: Dict, ctx: Optional[LossContext]) -> Callable:
    """Mean-reduced TV of the prediction (``reconstruction.py:134-145``)."""

    def fn(pred, gt, aux):
        dx = torch.abs(pred[:, :-1] - pred[:, 1:])
        dy = torch.abs(pred[:, :, :-1] - pred[:, :, 1:])
        return torch.mean(dx) + torch.mean(dy)

    return fn


def brightness_constancy(cfg: Dict, ctx: Optional[LossContext]) -> Callable:
    """The generative-model brightness-increment error on the step's raw
    window (``reconstruction.py:17``), for recipes whose model predicts flow
    (``flow_key``, default ``flow``) and brightness (``img_key``, default
    ``pred``).  The window is rasterized through the raw float32 rasterizer
    (``bmcnet::rasterize_counts_f32`` on the card)."""
    ctx = _require_ctx(ctx, "brightness_constancy")
    flow_key = cfg.get("flow_key", "flow")
    img_key = cfg.get("img_key", "pred")

    def fn(pred, gt, aux):
        from bmcnet_esr_torch.ops.batch import batch_events_to_counts

        flow = _flow_nchw(aux, flow_key, "brightness_constancy")
        img = aux[img_key]
        if img.shape[-1] in (1, 2) and img.dim() == 4:
            img = torch.movedim(img, -1, 1)
        img = torch.mean(img, dim=1, keepdim=True)  # [B, 1, H, W] brightness
        events = aux["events"]
        res = ctx.inp_resolution
        # counts are integers: the rasterizer's float32 form serves any dtype
        event_cnt = torch.movedim(batch_events_to_counts(events.float(), res), -1, 1)
        event_list, pol_mask = _iwe_event_list(events, aux.get("events_len"))
        raw = generative_model_loss(flow, img, event_cnt, event_list, pol_mask, res)
        return raw / event_list.shape[1]  # per-event scale

    fn.needs_events = fn.batch_sum = True
    return fn


# -- flow family -------------------------------------------------------------

def event_warping(cfg: Dict, ctx: Optional[LossContext]) -> Callable:
    """Contrast-maximization flow loss (``flow.py:15-110``): the step's
    events warped by ``aux[flow_key]`` (default ``pred``)."""
    ctx = _require_ctx(ctx, "event_warping")
    flow_key = cfg.get("flow_key", "pred")
    regul = float(cfg.get("flow_regul_weight", 0.001))

    def fn(pred, gt, aux):
        flow = _flow_nchw(aux, flow_key, "event_warping")
        event_list, pol_mask = _iwe_event_list(aux["events"], aux.get("events_len"))
        raw = event_warping_loss([flow], event_list, pol_mask, ctx.inp_resolution, regul)
        return raw / event_list.shape[1]  # per-event scale

    fn.needs_events = fn.batch_sum = True
    return fn


# -- fidelity extras ---------------------------------------------------------

def ssim(cfg: Dict, ctx: Optional[LossContext]) -> Callable:
    """``1 - SSIM`` of the fitted prediction (skimage semantics); the data
    range is the whole batch's GT's unless ``data_range`` pins it."""
    win = int(cfg.get("win_size", 7))
    pinned_range = cfg.get("data_range")

    def fn(pred, gt, aux):
        if pinned_range is not None:
            dr = torch.as_tensor(pinned_range, dtype=pred.dtype, device=pred.device)
        else:
            hi_lo = torch.stack([torch.max(gt), -torch.min(gt)])
            if "batch_max" in aux:  # the other ranks' rows of the batch
                hi_lo = aux["batch_max"](hi_lo)
            dr = torch.clamp(hi_lo[0] + hi_lo[1], min=1e-6)
        # each channel is an independent 2-D count image
        return 1.0 - ssim_fn(torch.movedim(pred, -1, 1), torch.movedim(gt, -1, 1), dr,
                             win_size=win)

    return fn
