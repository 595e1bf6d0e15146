"""Config-driven loss composition for the trainer.

Counterpart of ``bmcnet_esr_tpu/training/losses.py``.  The base term is the
per-step MSE (``train_step._rollout_losses``); a ``loss:`` config block adds
weighted extra terms, one entry ``name: spec`` each:

.. code-block:: yaml

    loss:
        recon:                        # builtin (losses/terms.py)
            weight: 0.5
        lpips:
            weight: 1.0
            weights: weights/lpips_alex.npz   # an LPIPS bundle (LPIPS.to_npz)
        my_term:                      # any importable builder
            fn: my_pkg.losses:build_my_term
            weight: 0.2

* ``spec`` a bare number -> the weight, builder config ``{}``;
* ``spec`` a dict -> its ``weight`` key (default 1.0) plus builder kwargs;
* ``name`` in :data:`REGISTRY` -> that builder (``l1``, ``charbonnier``,
  ``lpips``, ``ssim``, ``lr_consistency`` alias ``recon``,
  ``temporal_consistency``, ``total_variation``, ``event_warping``,
  ``brightness_constancy``);
* otherwise ``fn: "module.path:attr"`` names a builder, imported and called
  as ``attr(spec, ctx) -> term``.

A term is ``fn(pred_fit, gt, aux)`` on NHWC count images -> scalar tensor;
two-argument ``fn(pred, gt)`` callables are adapted.  ``aux`` carries the raw
prediction, the previous step's output, the input windows, the step index
and, for terms marked ``needs_events``, the step's raw event window and its
valid length (``losses/terms.py`` documents the contract).
"""

from __future__ import annotations

import importlib
import inspect
from typing import Callable, Dict, List, Optional, Tuple

import torch

from bmcnet_esr_torch.losses.terms import (
    LossContext,
    brightness_constancy,
    event_warping,
    lr_consistency,
    ssim,
    temporal_consistency,
    total_variation,
)


def _l1(pred, gt, aux=None):
    return torch.mean(torch.abs(pred - gt))


def _charbonnier(pred, gt, aux=None, eps: float = 1e-6):
    return torch.mean(torch.sqrt(torch.square(pred - gt) + eps))


def _build_lpips_term(cfg: Dict, ctx=None) -> Callable:
    """The LPIPS perceptual term on the fitted prediction and the GT, each
    count channel broadcast to three (``losses/lpips.py::perceptual_loss``).

    ``weights:`` names an LPIPS bundle ``.npz``, written by
    ``LPIPS.to_npz`` in either package or by
    ``python -m bmcnet_esr_tpu.cli.convert --lpips_backbone <features.pth>
    --lpips_lin <lin.pth> --net alex --out <bundle.npz>``.  The legacy pair
    ``backbone_weights`` (a torchvision ``features`` state dict ``.pth``)
    and ``lin_weights`` (the reference's heads ``.pth``) with ``net`` works
    too.  The LPIPS weights are frozen and move to the prediction's device
    at the first call (float64 for a float64 prediction, else float32); they
    never enter the model's checkpoint."""
    from bmcnet_esr_torch.losses.lpips import LPIPS, perceptual_loss

    if "weights" in cfg:
        lp = LPIPS.from_npz(cfg["weights"])
    elif "backbone_weights" not in cfg or "lin_weights" not in cfg:
        raise ValueError("the lpips term needs its weights: weights: <bundle.npz>, or "
                         "backbone_weights: <features.pth> with lin_weights: <lin.pth>")
    else:
        state = torch.load(cfg["backbone_weights"], map_location="cpu", weights_only=True)
        lp = LPIPS.from_torch(state, cfg["lin_weights"], cfg.get("net", "alex"))

    def fn(pred, gt, aux=None):
        dtype = torch.promote_types(pred.dtype, torch.float32)  # float64 stays float64
        if lp.shift.device != pred.device or lp.shift.dtype != dtype:
            lp.to(pred.device, dtype)
        return perceptual_loss(lp, torch.movedim(pred, -1, 1), torch.movedim(gt, -1, 1),
                               normalize=True)

    return fn


# builtin name -> builder(cfg, ctx) -> term
REGISTRY: Dict[str, Callable] = {
    "l1": lambda cfg, ctx: _l1,
    "charbonnier": lambda cfg, ctx: _charbonnier,
    "lpips": _build_lpips_term,
    "ssim": ssim,
    "lr_consistency": lr_consistency,
    "recon": lr_consistency,  # the recon-family alias
    "temporal_consistency": temporal_consistency,
    "total_variation": total_variation,
    "event_warping": event_warping,
    "brightness_constancy": brightness_constancy,
}


def _resolve_dotted(path: str) -> Callable:
    """``module.sub:attr`` (or ``module.sub.attr``) -> the attribute."""
    if ":" in path:
        mod_name, attr = path.split(":", 1)
    else:
        mod_name, _, attr = path.rpartition(".")
    if not mod_name:
        raise KeyError(f"loss fn spec {path!r} is not an importable path")
    obj = importlib.import_module(mod_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    if not callable(obj):
        raise TypeError(f"loss fn {path!r} resolved to non-callable {obj!r}")
    return obj


def adapt_term(fn: Callable) -> Callable:
    """Accept two-argument ``fn(pred, gt)`` terms beside the full
    ``fn(pred, gt, aux)`` contract; the ``needs_events`` and ``batch_sum``
    marks carry over."""
    try:
        params = [
            p for p in inspect.signature(fn).parameters.values()
            if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                          inspect.Parameter.POSITIONAL_OR_KEYWORD,
                          inspect.Parameter.VAR_POSITIONAL)
        ]
        takes_aux = any(p.kind == inspect.Parameter.VAR_POSITIONAL for p in params) or (
            len(params) >= 3
        )
    except (TypeError, ValueError):
        takes_aux = True  # builtins / partials: assume the full contract
    if takes_aux:
        return fn

    def wrapped(pred, gt, aux=None):
        return fn(pred, gt)

    for mark in ("needs_events", "batch_sum"):
        if getattr(fn, mark, False):
            setattr(wrapped, mark, True)
    return wrapped


def build_extra_losses(cfg: Optional[Dict], ctx: Optional[LossContext] = None) -> Tuple:
    """``loss:`` config block -> tuple of ``(name, weight, fn)``."""
    if not cfg:
        return ()
    out: List = []
    for name, spec in cfg.items():
        if name == "mse":
            continue  # the base term, always present
        if isinstance(spec, dict):
            spec = dict(spec)
            weight = float(spec.pop("weight", 1.0))
        else:
            weight, spec = float(spec), {}
        if name in REGISTRY:
            builder = REGISTRY[name]
        elif "fn" in spec:
            builder = _resolve_dotted(spec.pop("fn"))
        else:
            raise KeyError(
                f"unknown loss term {name!r} (builtins: {sorted(REGISTRY)}; "
                "custom terms attach via fn: 'module.path:builder')"
            )
        out.append((name, weight, adapt_term(builder(spec, ctx))))
    return tuple(out)


def needs_events(extra_losses: Tuple) -> bool:
    """True when any term consumes per-step raw event windows (``aux['events']``)."""
    return any(getattr(fn, "needs_events", False) for _, _, fn in extra_losses)
