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
``calibrate_from_h5`` calibrates from the first windows of a recording (the
serving and export CLIs' ``--calib_h5``); its array part after the file
read is ``_calibrate_from_events``.  ``frozen_weights`` fixes the int8
weights for ``torch.export`` (``inference/export.py``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
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


@contextlib.contextmanager
def frozen_weights(model: torch.nn.Module) -> Iterator[None]:
    """Within: every ``QuantConv`` of ``model`` serves the weights quantized
    (and, on CUDA, packed) on entry from buffers, and reads neither its
    float weight nor its weight cache, so that ``torch.export`` can trace it
    and carries the int8 weights in the program.  Raises while calibration
    records (a traced program would bake in one recording's side effects)."""
    convs = quant_convs(model).values()
    if any(m.calib is not None for m in convs):
        raise RuntimeError("calibration is recording: finish it before freezing the weights")
    for m in convs:
        m.freeze()
    try:
        yield
    finally:
        for m in convs:
            m.thaw()


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


def calibrate_from_h5(
    model: torch.nn.Module,
    path: str,
    prefix: str,
    resolution: Tuple[int, int],
    window: int,
    n_windows: int = 16,
) -> Dict[str, torch.Tensor]:
    """Startup calibration from a recording (packager schema): the first
    ``n_windows + 1`` windows of ``window`` events of ``{prefix}_events`` in
    ``path``, rasterized at ``resolution`` on the model's device, give
    single-lane (``[1]``) static scales, which broadcast to any pool width.
    Installs and returns them, as :func:`calibrate_act_scales`."""
    import h5py

    with h5py.File(path, "r") as f:
        g = f[f"{prefix}_events"]
        need = (n_windows + 1) * window
        xs = np.asarray(g["xs"][:need], np.float32)
        ys = np.asarray(g["ys"][:need], np.float32)
        ts = np.asarray(g["ts"][:need], np.float64)
        ps = np.asarray(g["ps"][:need], np.float32)
    return _calibrate_from_events(model, xs, ys, ts, ps, resolution, window, path)


def _calibrate_from_events(
    model: torch.nn.Module, xs: np.ndarray, ys: np.ndarray, ts: np.ndarray, ps: np.ndarray,
    resolution: Tuple[int, int], window: int, source: str = "events",
) -> Dict[str, torch.Tensor]:
    """:func:`calibrate_from_h5` after the file read: whole windows of the
    event columns, each through the serving ``pad_window`` (so calibration
    frames are what the pool rasterizes), stride-1 pairs, one lane."""
    from bmcnet_esr_torch.inference.streaming import pad_window
    from bmcnet_esr_torch.ops.batch import batch_events_to_counts

    h, w = int(resolution[0]), int(resolution[1])
    count = len(xs) // window
    if count < 2:
        raise ValueError(
            f"{source} has {len(xs)} events: need at least 2 windows of {window} for calibration"
        )

    def win(i):
        sl = slice(i * window, (i + 1) * window)
        # float64 stamps shift to window-relative before the float32 cast
        t = (ts[sl] - ts[sl][0]).astype(np.float32)
        return pad_window(np.stack([xs[sl], ys[sl], t, ps[sl]]), window)[None]

    dev = next(model.parameters()).device
    ev = torch.from_numpy(np.stack([win(i) for i in range(count)])).to(dev)  # [S+1, 1, 4, N]
    with torch.no_grad():
        frames = batch_events_to_counts(ev, (h, w))  # [S+1, 1, H, W, 2]
        pairs = torch.stack([frames[:-1], frames[1:]], 2)  # [S, 1, 2, H, W, 2]
        carry = model.init_state(1, h, w, device=dev)
    return calibrate_act_scales(model, pairs, carry, max_steps=int(pairs.shape[0]))
