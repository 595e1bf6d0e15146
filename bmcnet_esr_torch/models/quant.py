"""Static activation scales for the int8 serving modes.

Counterpart of ``bmcnet_esr_tpu/models/quant.py``.  Every ``QuantConv``
quantizes its input per lane: with a static ``act_scale`` buffer when one is
installed, else with the lane's dynamic ``max|x| / 127``.  Calibration runs
the recurrent model for a few steps on the dynamic path while every
``QuantConv`` records its running per-lane ``max|x|`` (or, for percentile
calibration, its |x| quantiles, which cost a sort per call), then installs
the scales.  A module called at several sites (tied convolutions,
the block applied ``n_b`` times) keeps ONE scale per lane: the maximum over
every site and step, as the JAX package's ``sow`` with a ``maximum`` reduce.

Where the JAX package returns variables with a ``quant`` collection, the
port installs the scales into the modules' ``act_scale`` buffers, which are
not part of the state dict: the checkpoint format does not change.
``calibrate_from_h5`` (used by the serving CLIs) is not ported yet
(ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

from bmcnet_esr_torch.kernels.quantize import symmetric_scale
from bmcnet_esr_torch.models.layers import _CALIB_QUANTILES as CALIB_QUANTILES
from bmcnet_esr_torch.models.layers import QuantConv


def quant_convs(model: torch.nn.Module) -> Dict[str, QuantConv]:
    """Every ``QuantConv`` of ``model`` by module name."""
    return {n: m for n, m in model.named_modules() if isinstance(m, QuantConv)}


def act_scales(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The installed static scales by module name (empty when dynamic)."""
    return {n: m.act_scale for n, m in quant_convs(model).items() if m.act_scale is not None}


def set_act_scales(model: torch.nn.Module, scales: Optional[Mapping[str, torch.Tensor]]) -> None:
    """Install per-module scales (scalar, ``[1]`` or ``[B]`` each) on the
    module's device; modules not named, or ``scales=None``, go dynamic."""
    convs = quant_convs(model)
    unknown = set(scales or {}) - set(convs)
    if unknown:
        raise KeyError(f"no QuantConv named {sorted(unknown)}")
    for name, m in convs.items():
        s = (scales or {}).get(name)
        m.act_scale = None if s is None else torch.as_tensor(
            s, dtype=torch.float32, device=m.weight.device).reshape(-1).clone()


def _stats_to_scales(
    stats: Mapping[str, Mapping[str, torch.Tensor]], q_index: Optional[int] = None
) -> Dict[str, torch.Tensor]:
    """Recorded stats -> scales: ``max(stat, 1e-12) / 127`` of the per-lane
    max (``q_index is None``) or of that row of the quantile grid."""
    return {
        name: symmetric_scale(st["act_max"] if q_index is None else st["act_q"][q_index])
        for name, st in stats.items()
    }


@torch.no_grad()
def calibrate_act_scales(
    model: torch.nn.Module,
    pairs: torch.Tensor,
    carry: Sequence[torch.Tensor],
    max_steps: int = 16,
    percentile: Optional[float] = None,
) -> Dict[str, torch.Tensor]:
    """Run up to ``max_steps`` recurrent steps over ``pairs`` (``[S, B, 2, H,
    W, 2]`` count-window pairs, the engine layout) from ``carry``, advancing
    the carry as the rollout does, and install per-lane static scales from
    the recorded activation ranges.  Returns the scales by module name.

    ``percentile``: ``None`` takes the per-lane ``max|x|``; a value of
    :data:`CALIB_QUANTILES` clips at that |x| quantile instead.  Any scales
    installed before are dropped first (calibration runs the dynamic path).
    A model without a ``quant`` mode is left as it is.
    """
    q_index = None
    if percentile is not None:
        if percentile not in CALIB_QUANTILES:
            raise ValueError(
                f"percentile must be one of {CALIB_QUANTILES} (the grid the "
                f"calibration pass records), got {percentile!r}"
            )
        q_index = CALIB_QUANTILES.index(percentile)
    if not getattr(model, "quant", False):
        return {}
    convs = quant_convs(model)
    set_act_scales(model, None)
    for m in convs.values():
        # the quantile grid costs a sort per call: record it only for
        # percentile calibration
        m.calib = {"act_max": None} if q_index is None else {"act_q": None}
    try:
        carry = tuple(carry)
        for i in range(min(int(pairs.shape[0]), max_steps)):
            carry = model(pairs[i], *carry)
        stats = {n: m.calib for n, m in convs.items() if None not in m.calib.values()}
    finally:
        for m in convs.values():
            m.calib = None
    scales = _stats_to_scales(stats, q_index)
    set_act_scales(model, scales)
    return scales
