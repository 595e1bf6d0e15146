"""CUDA graphs of the model's per-window body for the file rollout.

The JAX engine compiles a chunk's body into one program; here the model's
forward enqueues several hundred kernels a window from Python, and at the
RGB size the host, not the device, set the rollout's pace.
:class:`ForwardGraphs` captures the model's body (``_Model._body``: the
prologue and the backbone) once per key and replays it for every later
window, so a window costs the host a few copies and one graph launch.

``InferenceEngine`` builds one for its model on a CUDA device and installs
it (:meth:`ForwardGraphs.installed`) for each rollout on its solo shard,
inside ``torch.inference_mode``.  ``model(pair, *carry)`` stays a call of
the module, so its forward hooks fire once a window; ``_Model.forward``
hands the body to the graphs where :meth:`ForwardGraphs.engages` says so,
and computes the HR head eagerly from what they return.  Within a rollout
the model runs three kinds of call: calibration's (``calib`` set on a
``QuantConv``), the flop count (``FlopCounterMode``, a dispatch mode) and
the windows'; only the windows' replay.  Training, tracing
(``torch.export``, ``frozen_weights``) and serving (``StreamingSR``,
``StreamPool``) never run inside an installed rollout of the thread that
installed it, so they stay eager.

A graph's key is the input's shape and dtype, the states' and which int8
scales are static with their shapes.  ``ForwardGraphs`` keeps one graph, the last
key's: another key drops it (and its memory pool) and captures anew, so an
engine holds one graph's static buffers and pool whatever shapes it has
seen, and a rollout of another batch or resolution than the last one's
captures once more.  At capture the body runs once eagerly on a side
stream (the int8 weights are packed, cuDNN's and cuBLAS's plans and
workspaces made), then is captured on it.  A replay:

* copies the input and the states into the graph's static inputs;
* copies every ``QuantConv``'s current ``act_scale`` into the scale
  tensor the graph reads, in place, so that a recording's new calibration
  reaches the next replay and no rollout captures again for it (the
  captured tensors are the graph's own, never the model's);
* returns clones of the static outputs: no caller is handed a buffer
  that the next replay overwrites.

The kernels' ``launches`` counters count their wrappers' Python calls: the
warm-up's and the capture's count, a replay's kernels do not (no Python
call launches them).  A replayed window's kernels are counted on the
device, by the profiler's records of the graph's kernel nodes.

Spans (``utils/timers.py``): ``rollout.capture`` around a warm-up and
capture, ``rollout.replay`` around a replay, with ``windows`` its lanes.
The graph is dropped when the model's parameters were replaced or written
since it was captured.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from bmcnet_esr_torch.models.quant import quant_convs
from bmcnet_esr_torch.utils.timers import Timer


def available(device: torch.device) -> bool:
    """Whether a rollout on ``device`` can replay graphs."""
    return device.type == "cuda"


class _Graph:
    """One captured body: its static inputs and outputs, and the scale
    tensors it reads with the modules they stand for."""

    def __init__(self, graph, inputs, outputs, scales, convs):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.scales, self.convs = scales, convs

    def replay(self, x: torch.Tensor, states: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        torch._foreach_copy_(self.inputs, [x, *states])
        if self.scales:
            torch._foreach_copy_(self.scales, [m.act_scale for m in self.convs])
        self.graph.replay()
        return tuple(o.clone() for o in self.outputs)


class ForwardGraphs:
    """The CUDA graph of ``model``'s body for the last key, for the
    rollouts of the thread that installs it (module docstring)."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.key: Optional[Tuple] = None
        self.graph: Optional[_Graph] = None
        self._convs = list(quant_convs(model).values())
        self._thread: Optional[int] = None
        self._weights: Optional[Tuple] = None
        self._stream = None

    def _weights_key(self) -> Tuple:
        # as QuantConv's weight cache: a replaced, moved or written
        # parameter changes its pointer or its version
        return tuple((p.data_ptr(), p._version) for p in self.model.parameters())

    @contextlib.contextmanager
    def installed(self):
        """Within: the model's forward, called from this thread, replays."""
        weights = self._weights_key()
        if weights != self._weights:
            self.key = self.graph = None
            self._weights = weights
        self._thread = threading.get_ident()
        self.model._graphs = self
        try:
            yield
        finally:
            self.model._graphs = None
            self._thread = None

    def engages(self) -> bool:
        """Whether the model's call replays: in the thread that installed
        the graphs, under no dispatch mode (the flop counter) and with no
        calibration recording."""
        return (threading.get_ident() == self._thread
                and not torch._C._len_torch_dispatch_stack()
                and all(m.calib is None for m in self._convs))

    def _key(self, x: torch.Tensor, states: Sequence[torch.Tensor]) -> Tuple:
        return ((tuple(x.shape), x.dtype), tuple((tuple(s.shape), s.dtype) for s in states),
                tuple(None if m.act_scale is None else tuple(m.act_scale.shape)
                      for m in self._convs))

    def __call__(self, x: torch.Tensor, *states: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The body's outputs for ``(x, *states)``, fresh tensors."""
        key = self._key(x, states)
        if key != self.key:
            self.key = self.graph = None  # the old graph's pool goes before the capture
            with Timer("rollout.capture"):
                self.graph = self._capture(x, states)
            self.key = key
        with Timer("rollout.replay", windows=x.shape[0]):
            return self.graph.replay(x, states)

    def _capture(self, x: torch.Tensor, states: Sequence[torch.Tensor]) -> _Graph:
        """Warm the body up and capture it, on static copies of the inputs
        and private copies of the static scales."""
        inputs = [t.clone() for t in (x, *states)]
        convs = [m for m in self._convs if m.act_scale is not None]
        held = [m.act_scale for m in convs]
        scales = [s.clone() for s in held]
        try:
            for m, s in zip(convs, scales):
                m.act_scale = s
            self._warm_up(inputs)
            graph, outputs = self._record(inputs)
        finally:
            for m, s in zip(convs, held):
                m.act_scale = s
        return _Graph(graph, inputs, outputs, scales, convs)

    def _warm_up(self, inputs: List[torch.Tensor]) -> None:
        """One eager run of the body on the side stream that captures: the
        int8 weights are packed, strided inputs made dense, and cuDNN's and
        cuBLAS's plans and workspaces made for that stream."""
        device = inputs[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        self._stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self._stream):
            self.model._body(*inputs)

    def _record(self, inputs: List[torch.Tensor]):
        """Capture the body on the side stream: ``(graph, static outputs)``."""
        graph = torch.cuda.CUDAGraph()
        # thread_local: the loader thread pins host memory meanwhile
        with torch.cuda.graph(graph, stream=self._stream, capture_error_mode="thread_local"):
            outputs = list(self.model._body(*inputs))
        torch.cuda.current_stream(inputs[0].device).wait_stream(self._stream)
        return graph, outputs
