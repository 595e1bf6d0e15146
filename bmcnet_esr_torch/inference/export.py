"""Serving bundles: deploy the streaming step without the model code.

Counterpart of ``bmcnet_esr_tpu/inference/export.py``.  ``torch.export``
traces the step that ``StreamingSR.push`` runs (the rasterizer on the raw
window, the recurrent forward) into a program that carries its weights,
and this module writes it beside the stream's metadata as a bundle::

    bundle/
      step.pt2    torch.export.save of the step: graph, weights, int8 weights
      meta.json   stream geometry, model identity, carry layout

A consumer loads the bundle with :class:`ExportedStream` and serves a live
event stream exactly as ``StreamingSR`` does, importing only the kernels'
operator registrations (``bmcnet_esr_torch.kernels``), never the models.

Where the port differs from the JAX bundle:

* the weights live inside ``step.pt2`` (no ``variables.npz``); an int8
  bundle holds each convolution's int8 and, on CUDA, packed weights
  (``models/quant.py::frozen_weights``) and quantizes no weight per call,
  and its static activation scales, where calibrated, are baked in as the
  JAX bundle's ``quant`` collection is;
* a ``torch.export`` program runs on the device it was traced on, so
  ``meta.json`` has ``device`` where the JAX bundle has ``platforms``:
  export where you serve;
* ``carry_shapes`` / ``carry_dtypes`` are the port's carry, which is the
  JAX package's layout: ``n_states`` NHWC states ``[B, H, W, n_c]`` and the
  previous prediction ``[B, kH, kW, 2]``, in the model's dtype.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

import bmcnet_esr_torch.kernels  # noqa: F401  the operators a program calls
from bmcnet_esr_torch.ops.batch import batch_events_to_counts, pad_window
from bmcnet_esr_torch.utils.device import resolve_device, strict_fp32

STEP_FILE, META_FILE = "step.pt2", "meta.json"


class _StreamStep(torch.nn.Module):
    """``(carry, prev_frame, events [B, 4, W]) -> (carry', frame, pred)``:
    the step of ``StreamingSR.push``, the prediction also in the carry's
    feedback slot."""

    def __init__(self, model: torch.nn.Module, inp_resolution: Tuple[int, int]):
        super().__init__()
        self.model = model
        self.inp_resolution = inp_resolution

    def forward(self, carry: Tuple[torch.Tensor, ...], prev_frame: torch.Tensor,
                events: torch.Tensor):
        frame = batch_events_to_counts(events, self.inp_resolution)  # [B, H, W, 2]
        outs = self.model(torch.stack([prev_frame, frame], 1), *carry)
        return tuple(outs), frame, outs[-1]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def export_serving_bundle(
    model: torch.nn.Module,
    variables: Optional[Mapping],
    out_dir: str,
    inp_resolution: Tuple[int, int],
    window_size: int = 2048,
    batch: int = 1,
    device="cuda",
) -> str:
    """Trace the stream step of ``model`` with ``torch.export`` on
    ``device`` and write ``step.pt2`` and ``meta.json`` to ``out_dir``.

    ``variables`` (a ``serving_state``, or ``None`` for the module's own
    weights and installed scales) is loaded into ``model`` first, as
    ``StreamingSR`` does; ``model`` moves to ``device`` (channels-last, eval
    mode).  Calibration must be finished: static scales installed at export
    time are baked into the program, and without them each call computes
    per-lane dynamic scales."""
    # the export side needs the models; the consumer below does not
    from bmcnet_esr_torch.inference.streaming import _apply_state
    from bmcnet_esr_torch.models.quant import act_scales, frozen_weights

    dev = resolve_device(device)
    strict_fp32()
    model = model.to(dev, memory_format=torch.channels_last).eval()
    if variables is not None:
        _apply_state(model, variables)
    h, w = int(inp_resolution[0]), int(inp_resolution[1])
    # distinct tensors: init_state repeats one zero state, and an input passed
    # twice would be traced as one
    carry = tuple(c.clone() for c in model.init_state(batch, h, w, device=dev))
    prev = torch.zeros((batch, h, w, 2), device=dev)
    events = torch.zeros((batch, 4, window_size), device=dev)
    with torch.no_grad(), frozen_weights(model):
        program = torch.export.export(_StreamStep(model, (h, w)), (carry, prev, events),
                                      strict=False)
    os.makedirs(out_dir, exist_ok=True)
    with warnings.catch_warnings():
        # channels-last weights are strided views of their storage, which the
        # archive writer reports as "no complete tensor" and saves whole
        warnings.filterwarnings("ignore", message="No complete tensor found")
        torch.export.save(program, os.path.join(out_dir, STEP_FILE))
    quant = getattr(model, "quant", False)
    meta = {
        "inp_resolution": [h, w],
        "window_size": int(window_size),
        "batch": int(batch),
        "carry_shapes": [list(c.shape) for c in carry],
        "carry_dtypes": [_dtype_name(c.dtype) for c in carry],
        "scale": int(model.scale),
        "n_c": int(model.n_c),
        "n_b": int(model.n_b),
        "variant": type(model).__name__,
        # as the JAX bundle: "quant" a strict bool, the mode apart
        "quant": bool(quant),
        "quant_mode": "xla" if quant is True else str(quant) if quant else None,
        # static scales baked in (calibrated) or dynamic per-call scales
        "quant_static": bool(act_scales(model)),
        "device": str(events.device),
        "torch_version": torch.__version__,
    }
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


class ExportedStream:
    """Serve a live event stream from a bundle directory, without the model
    code.

    Mirrors ``StreamingSR.push``: push ``[4, n]`` event windows (or ``[B, 4,
    n]`` when the bundle was exported with ``batch > 1``) and receive the
    ``[B, kH, kW, 2]`` float32 predictions once two windows have been seen.
    The bundle runs on the device it was exported on; ``device`` must name
    that kind of device."""

    def __init__(self, bundle_dir: str, device="cuda"):
        with open(os.path.join(bundle_dir, META_FILE)) as f:
            self.meta = json.load(f)
        self.device = torch.device(self.meta["device"])
        if resolve_device(device).type != self.device.type:
            raise ValueError(f"the bundle was exported on {self.meta['device']} and runs "
                             f"there only, not on {device}: export where you serve")
        strict_fp32()  # the program's float32 convolutions, whatever this process set
        self._step = torch.export.load(os.path.join(bundle_dir, STEP_FILE)).module()
        self._batch = int(self.meta["batch"])
        self._res = tuple(self.meta["inp_resolution"])
        self._window = int(self.meta["window_size"])
        self.reset()

    def reset(self) -> None:
        """Start a new stream (reference: ``init=True`` once per file)."""
        self._carry = None
        self._prev_frame = None
        self.windows_seen = 0

    def _init_carry(self) -> Tuple[torch.Tensor, ...]:
        return tuple(
            torch.zeros(shape, dtype=getattr(torch, dtype), device=self.device)
            for shape, dtype in zip(self.meta["carry_shapes"], self.meta["carry_dtypes"])
        )

    def _pad(self, events: np.ndarray) -> np.ndarray:
        events = np.asarray(events, np.float32)
        if events.ndim == 2:
            events = events[None]
        if events.shape[0] != self._batch:
            raise ValueError(f"bundle serves batch {self._batch}, got {events.shape[0]} streams")
        return pad_window(events, self._window)

    def push(self, events: np.ndarray) -> Optional[np.ndarray]:
        ev = torch.from_numpy(self._pad(events)).to(self.device)
        with torch.inference_mode():
            if self._carry is None:
                # first window: rasterize through the program itself (its
                # ``frame`` output) and discard its carry and prediction; the
                # stream starts from the initial carry, as StreamingSR's does
                self._carry = self._init_carry()
                zero_prev = torch.zeros((self._batch, *self._res, 2), device=self.device)
                _, self._prev_frame, _ = self._step(self._carry, zero_prev, ev)
                self.windows_seen = 1
                return None
            self._carry, self._prev_frame, pred = self._step(self._carry, self._prev_frame, ev)
        self.windows_seen += 1
        # numpy has no bfloat16: widen on the host (exact)
        return pred.float().cpu().numpy()
