"""Config-driven loss composition for the trainer.

Counterpart of ``bmcnet_esr_tpu/training/losses.py``.  The base term is the
per-step MSE (``train_step._rollout_losses``); a ``loss:`` config block adds
weighted extra terms, one entry ``name: spec`` each:

* ``spec`` a bare number -> the weight, builder config ``{}``;
* ``spec`` a dict -> its ``weight`` key (default 1.0) plus builder kwargs;
* ``name`` in :data:`REGISTRY` -> that builder;
* otherwise ``fn: "module.path:attr"`` names a builder, imported and called
  as ``attr(spec, ctx) -> term``.

A term is ``fn(pred_fit, gt, aux)`` on NHWC count images -> scalar tensor;
two-argument ``fn(pred, gt)`` callables are adapted.  ``aux`` carries the raw
prediction, the previous step's output, the input windows, the step index
and, for terms marked ``needs_events``, the step's raw event window and its
valid length.  ``l1`` and ``charbonnier`` are ported; LPIPS and the terms of
``bmcnet_esr_tpu/losses/terms.py`` raise ``NotImplementedError``
(ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
from typing import Callable, Dict, List, Optional, Tuple

import torch

TERMS_TODO = "not ported yet (ROADMAP.md Queue 1 item 10)"


@dataclasses.dataclass(frozen=True)
class LossContext:
    """Static shape/config facts available to term builders
    (``bmcnet_esr_tpu/losses/terms.py::LossContext``)."""

    inp_resolution: Tuple[int, int]
    gt_resolution: Tuple[int, int]
    scale: int
    seqn: int = 2


def _l1(pred, gt, aux=None):
    return torch.mean(torch.abs(pred - gt))


def _charbonnier(pred, gt, aux=None, eps: float = 1e-6):
    return torch.mean(torch.sqrt(torch.square(pred - gt) + eps))


def _unported(name: str) -> Callable:
    def builder(cfg, ctx=None):
        raise NotImplementedError(f"loss term {name!r}: {TERMS_TODO}")

    return builder


# builtin name -> builder(cfg, ctx) -> term
REGISTRY: Dict[str, Callable] = {
    "l1": lambda cfg, ctx: _l1,
    "charbonnier": lambda cfg, ctx: _charbonnier,
    **{name: _unported(name) for name in (
        "lpips", "ssim", "lr_consistency", "recon", "temporal_consistency",
        "total_variation", "event_warping", "brightness_constancy",
    )},
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
    ``fn(pred, gt, aux)`` contract; a ``needs_events`` mark carries over."""
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

    if getattr(fn, "needs_events", False):
        wrapped.needs_events = True
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
