"""Live serving: one recurrent stream (``StreamingSR``) and slots of streams
batched into one device tick (``StreamPool``).

Counterpart of ``bmcnet_esr_tpu/inference/streaming.py``.  Kept from the JAX
module: the wire encodings (``WIRE_MODES``, ``_wire_encode``,
``wire_decode``), the chunked fetch (``_fetch_split``, ``assemble_fetch``),
the window helpers (``pad_window``, ``pad_window_compact``,
``valid_polarity``, bit for bit), the hot-swap check (``_validate_swap``)
and the pool's lane semantics:

* a fresh slot's first window zeroes its carry, takes this frame as its
  previous frame and outputs nothing (the reference's ``init=True``);
* a live slot with a window advances;
* an idle slot passes through untouched;
* a dispatch that raises leaves first-window semantics intact.

What the port does in its own way:

* **Weights live in the module.**  The serving state that plays the part of
  the JAX ``variables`` is ``{"params": model.state_dict(), "quant":
  models.quant.act_scales(model)}`` (:func:`serving_state`); ``reload``
  copies a new one into the module in place.
* **The tick is a Python body on the pool's own CUDA stream**: one
  rasterizer launch over every window of the tick, the model, ``torch.where``
  masks, the wire encoding.  A deep tick of depth K runs the same body K
  times (the JAX package scans it); the frames do not depend on the carry,
  so all K x B windows rasterize in ONE launch, and a tick launches the
  rasterizer once whatever its depth.
* **The dispatch returns a** :class:`PredFetch` **instead of an on-device
  array**: the encoded prediction is copied (``non_blocking``) into pinned
  host buffers on the pool's stream and an event is recorded after the
  copies; ``is_ready()`` polls the event and ``get()`` waits on it alone,
  never on ticks dispatched later.
* Every call names its device and stream, so pool calls may come from any
  thread (the daemon's bounded shutdown drain runs them on a helper thread).

Not ported: ``mesh=`` (spatial and slot sharding, ROADMAP.md Queue 1 item
8), which raises.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from bmcnet_esr_torch.models.quant import act_scales, quant_convs, set_act_scales
from bmcnet_esr_torch.ops.batch import (
    batch_counts_from_compact,
    batch_events_to_counts,
    compact_events,
    pad_window,
)
from bmcnet_esr_torch.utils import resolve_device

#: Prediction wire encodings for :class:`StreamPool` (``out_wire=``), as in
#: the JAX package: ``"f32"`` the model's own output dtype (bfloat16 widens
#: to float32 on the host, exactly); ``"f16"`` a cast to IEEE float16 on
#: the device (lossless for bfloat16 compute); ``"i8"`` per-window
#: symmetric int8 with a max-abs scale computed on the device, decoded as
#: ``q * scale`` (worst-case error scale / 2).
WIRE_MODES = ("f32", "f16", "i8")

_MESH_TODO = "mesh= (sharded serving) is not ported yet (ROADMAP.md Queue 1 item 8)"


def _wire_encode(pred: torch.Tensor, out_wire: str):
    """Encode one prediction batch ``[..., kH, kW, C]`` for the wire."""
    if out_wire == "f32":
        return pred
    if out_wire == "f16":
        return pred.to(torch.float16)
    # i8: per-lane max-abs scale over the spatial/channel axes; a true
    # division and round-half-to-even, as jnp.round
    x = pred.float()
    amax = x.abs().amax(dim=(-3, -2, -1))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.round(x / scale[..., None, None, None]).to(torch.int8)
    return q, scale


def _tree_map(fn, enc):
    """``fn`` over every array of a wire encoding: a bare array, an i8
    ``(q, scale)`` tuple, or a LIST of either (a chunked fetch)."""
    if isinstance(enc, list):
        return [_tree_map(fn, e) for e in enc]
    if isinstance(enc, tuple):
        return tuple(fn(a) for a in enc)
    return fn(enc)


def _fetch_split(enc, n: int, axis: int):
    """Split each array of a wire encoding into ``n`` equal chunks along the
    slot axis, returned as a LIST of chunk encodings (a list marks
    "chunked"; the i8 pair inside each chunk stays a tuple).  Each chunk is
    its own host buffer; :func:`assemble_fetch` undoes the split."""
    if n <= 1:
        return enc

    def cut(i):
        return _tree_map(
            lambda a: a.narrow(axis, i * (a.shape[axis] // n), a.shape[axis] // n), enc
        )

    return [cut(i) for i in range(n)]


def assemble_fetch(host, deep: bool = False):
    """Host-side inverse of the pool's fetch split: concatenate a LIST of
    fetched chunk encodings along the slot axis (axis 1 for deep ticks,
    whose predictions are ``[K, B, ...]``, else 0).  A non-list input (an
    unchunked fetch) passes through unchanged."""
    if not isinstance(host, list):
        return host
    axis = 1 if deep else 0
    if isinstance(host[0], tuple):
        return tuple(np.concatenate(xs, axis=axis) for xs in zip(*host))
    return np.concatenate(host, axis=axis)


def wire_decode(pred, out_wire: str = "f32") -> np.ndarray:
    """Host-side inverse of :func:`_wire_encode` -> float32 ndarray.  ``i8``
    takes any leading batch shape: ``q [..., kH, kW, C]`` with ``scale
    [...]`` (one scale per window)."""
    if out_wire == "i8":
        q, scale = pred
        q = np.asarray(q, np.float32)
        s = np.asarray(scale, np.float32)
        return q * s.reshape(s.shape + (1,) * (q.ndim - s.ndim))
    return np.asarray(pred, np.float32)


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: widen on the host (exact), as the JAX
    # package's consumers do with the f32 wire
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _pinned_empty(shape, dtype: torch.dtype) -> torch.Tensor:
    """A pinned host buffer that the fetch's copy writes whole."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


class PredFetch:
    """A tick's encoded predictions on their way to the host.

    On CUDA the constructor enqueues a ``non_blocking`` copy of every array
    into a pinned host buffer on ``stream`` and records an event after the
    copies; :meth:`is_ready` polls that event and :meth:`get` waits on it
    alone, so fetching tick N never waits for ticks dispatched after it.
    On the CPU the arrays are already on the host.  :meth:`get` returns the
    encoding's structure with numpy arrays (a LIST for a chunked fetch)."""

    def __init__(self, enc, stream: Optional[torch.cuda.Stream] = None):
        self._event, self._host = None, enc
        if stream is None:
            return

        self._host = _tree_map(
            lambda a: _pinned_empty(a.shape, a.dtype).copy_(a, non_blocking=True), enc)
        self._event = torch.cuda.Event()
        self._event.record(stream)

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def get(self):
        if self._event is not None:
            self._event.synchronize()
        return _tree_map(_host_numpy, self._host)


def pad_window_compact(events: np.ndarray, window_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """``compact_events(pad_window(ev))`` without the timestamp work (the
    count rasterizer never reads timestamps): compact the raw ``[4, n]``
    window, then zero-pad the small int arrays."""
    events = np.asarray(events, np.float32)
    if events.ndim != 2:
        raise ValueError(f"expected a [4, n] window, got shape {events.shape}")
    n = events.shape[1]
    if n > window_size:
        raise ValueError(f"window of {n} events exceeds window_size {window_size}")
    xy = np.zeros((2, window_size), np.int16)
    p = np.zeros((window_size,), np.int8)
    if n:
        if not valid_polarity(events[3]):
            # the int8 polarity cast is exact only on {-1, 0, +1}
            raise ValueError("event polarity must be -1, 0 (padding) or +1")
        xy[:, :n], p[:n] = compact_events(events)
    return xy, p


def valid_polarity(pol: np.ndarray) -> bool:
    """True iff every polarity is exactly -1, 0 (padding) or +1, the domain
    on which the compact int8 transfer is exact (NaN fails).  The daemon's
    per-client check and the pool's own guard both call this."""
    return bool(np.isin(pol, (-1.0, 0.0, 1.0)).all())


def serving_state(model: torch.nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's counterpart of the JAX ``variables``: the state dict under
    ``params`` and the installed static activation scales under ``quant``
    (empty on dynamic scales)."""
    return {"params": model.state_dict(), "quant": act_scales(model)}


def _collections(variables: Mapping) -> Dict[str, Mapping]:
    """``params`` and ``quant`` of a serving state (no ``quant``: dynamic)."""
    return {"params": variables["params"], "quant": variables.get("quant") or {}}


def _validate_swap(old: Mapping, new: Mapping) -> None:
    """Reject a weight hot-swap that changes the serving state's structure,
    or any leaf's shape or dtype; raises ``ValueError`` naming the first
    leaf that differs."""
    old, new = _collections(old), _collections(new)
    for col in ("params", "quant"):
        o, n = old[col], new[col]
        if set(o) != set(n):
            first = ([k for k in o if k not in n] + [k for k in n if k not in o])[0]
            raise ValueError(
                f"reload: new variables have a different structure in {col!r} (leaf "
                f"['{col}']['{first}'] is in one only; {len(o)} leaves expected, "
                f"{len(n)} given)"
            )
        for name in o:
            os_, ns_ = tuple(o[name].shape), tuple(n[name].shape)
            od = str(o[name].dtype).replace("torch.", "")
            nd = str(n[name].dtype).replace("torch.", "")
            if os_ != ns_ or od != nd:
                raise ValueError(
                    f"reload: leaf ['{col}']['{name}'] changed from {os_}/{od} to "
                    f"{ns_}/{nd}: a swap must preserve shapes and dtypes"
                )


def _apply_state(model: torch.nn.Module, variables: Mapping) -> None:
    """Copy a serving state into ``model`` in place (weights, then scales)."""
    cols = _collections(variables)
    model.load_state_dict(cols["params"])
    set_act_scales(model, cols["quant"] or None)


def _on(device: torch.device, stream: Optional[torch.cuda.Stream], inference: bool = True):
    """Inference mode (unless ``inference=False``) on ``device`` and
    ``stream`` (``None``: the device's current stream), from any thread."""
    ctx = contextlib.ExitStack()
    if inference:
        ctx.enter_context(torch.inference_mode())
    if stream is not None:
        ctx.enter_context(torch.cuda.device(device))
        ctx.enter_context(torch.cuda.stream(stream))
    return ctx


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array onto ``device`` (pinned, ``non_blocking`` on the current
    stream for CUDA)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class StreamingSR:
    """Stateful stride-1 super-resolution over a live event stream.

    >>> stream = StreamingSR(model, None, inp_resolution=(45, 80))
    >>> for events in camera:              # events: [4, n] (x, y, t, p)
    ...     hr = stream.push(events)       # HR count image after >= 2 windows

    ``variables`` (a :func:`serving_state`, or ``None`` for the module's
    own weights) is loaded into ``model``, which moves to ``device``
    (channels-last, eval mode).  Each push rasterizes its window (one
    launch), runs the model and returns the prediction as float32."""

    def __init__(
        self,
        model: torch.nn.Module,
        variables: Optional[Mapping] = None,
        inp_resolution: Tuple[int, int] = (45, 80),
        window_size: int = 2048,
        mesh=None,
        spatial_axis: str = "data",
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(_MESH_TODO)
        self.device = resolve_device(device)
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        if variables is not None:
            _apply_state(self.model, variables)
        self.inp_resolution = tuple(inp_resolution)
        self.window_size = window_size
        self._carry = None
        self._prev_frame = None
        self.windows_seen = 0

    @property
    def variables(self):
        return serving_state(self.model)

    def reset(self) -> None:
        """Start a new stream (reference: ``init=True`` once per file)."""
        self._carry = None
        self._prev_frame = None
        self.windows_seen = 0

    def reload(self, variables: Mapping) -> None:
        """Hot-swap the weights without dropping the stream: the recurrent
        state carries across.  A serving state of another structure, shape
        or dtype raises ``ValueError`` and the current weights keep serving."""
        _validate_swap(self.variables, variables)
        _apply_state(self.model, variables)

    def push(self, events: np.ndarray) -> Optional[np.ndarray]:
        """Feed one event window ``[4, n]`` (x, y, t, p); returns the HR
        prediction ``[kH, kW, 2]`` (float32) once two windows have been
        seen, else ``None``."""
        ev = pad_window(events, self.window_size)
        with _on(self.device, None):
            frame = batch_events_to_counts(_upload(ev[None], self.device), self.inp_resolution)
            if self._carry is None:
                self._carry = self.model.init_state(1, *self.inp_resolution, device=self.device)
                self._prev_frame = frame
                self.windows_seen = 1
                return None
            outs = self.model(torch.stack([self._prev_frame, frame], 1), *self._carry)
            self._carry, self._prev_frame = tuple(outs), frame
            self.windows_seen += 1
            return _host_numpy(outs[-1][0].cpu())


def _sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)


class StreamPool:
    """Continuous batching of live event streams into fixed device slots.

    ``slots`` recurrent state slots live on the device; streams
    :meth:`attach` into free slots and :meth:`detach` when done; each tick
    advances every slot with masked state carry (``torch.where`` on ``[B]``
    masks), so attach, detach and idle slots never touch host state:

    * fresh slot, first window: carry forced to zeros, previous frame :=
      this frame, output discarded;
    * live slot with a window: carry advances, output valid;
    * idle slot (no window): carry and previous frame pass through.

    >>> pool = StreamPool(model, None, (45, 80), slots=8)
    >>> a, b = pool.attach(), pool.attach()
    >>> preds = pool.push({a: ev_a, b: ev_b})   # {slot: HR image}

    int8: activation scales are per lane (``QuantConv``), so lanes equal
    their solo rollouts in both scale modes; static scales (a ``[1]``
    calibration broadcasts to every lane) drop the per-call max pass.
    ``fetch_chunks`` splits the fetched predictions into that many slot-axis
    chunks (each its own host buffer; must divide ``slots``); callers of the
    async methods reassemble with :func:`assemble_fetch`.  ``out_wire``: see
    :data:`WIRE_MODES`.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        variables: Optional[Mapping],
        inp_resolution: Tuple[int, int],
        slots: int = 8,
        window_size: int = 2048,
        mesh=None,
        out_wire: str = "f32",
        fetch_chunks: int = 1,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(_MESH_TODO)
        if out_wire not in WIRE_MODES:
            raise ValueError(f"unknown out_wire {out_wire!r}; choose one of {WIRE_MODES}")
        self.inp_resolution = tuple(inp_resolution)
        self.slots = int(slots)
        self.window_size = window_size
        self.out_wire = out_wire
        self.fetch_chunks = int(fetch_chunks)
        if self.fetch_chunks < 1 or self.slots % self.fetch_chunks:
            raise ValueError(
                f"fetch_chunks ({fetch_chunks}) must be >= 1 and divide slots ({self.slots})"
            )
        self.device = resolve_device(device)
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        if variables is not None:
            _apply_state(self.model, variables)
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # the weights (and any static scales) were written on the
            # device's default stream: the pool's stream starts after them
            self._stream.wait_stream(torch.cuda.default_stream(self.device))
        h, w = self.inp_resolution
        with _on(self.device, self._stream):
            self._carry = tuple(self.model.init_state(self.slots, h, w, device=self.device))
            self._prev = torch.zeros((self.slots, h, w, 2), device=self.device)
        self._active = np.zeros(self.slots, bool)
        self._seen = np.zeros(self.slots, np.int64)
        # tick shapes run so far: 1 (shallow), K (deep), (K, k) (compacted)
        self.warmed: set = set()

    @property
    def variables(self):
        return serving_state(self.model)

    # -- the tick ------------------------------------------------------------

    def _tick(self, xy: np.ndarray, p: np.ndarray, masks: np.ndarray, deep: bool,
              lanes: Optional[np.ndarray] = None) -> PredFetch:
        """Enqueue one tick over ``xy [K, B, 2, N]``, ``p [K, B, N]`` and
        ``masks [2, K, B]`` (update, first); the state advances at once.
        Returns the fetch of the ``[B, ...]`` (shallow) or ``[K, B, ...]``
        (deep) encoded predictions, gathered to ``lanes`` on the slot axis
        when given (in ``gcd(fetch_chunks, len(lanes))`` chunks)."""
        depth, b, res = xy.shape[0], self.slots, self.inp_resolution
        n_chunks = self.fetch_chunks
        with _on(self.device, self._stream):
            exy = _upload(xy.reshape(depth * b, 2, -1), self.device)
            ep = _upload(p.reshape(depth * b, -1), self.device)
            update, first = _upload(masks, self.device)
            # the frames do not depend on the carry: one rasterizer launch
            # for all K x B windows
            frames = batch_counts_from_compact(exy, ep, res).view(depth, b, *res, 2)
            carry, prev, encs = self._carry, self._prev, []
            for j in range(depth):
                frame = frames[j]
                outs = self.model(torch.stack([prev, frame], 1), *carry)
                advance, reset = update[j] & ~first[j], update[j] & first[j]
                # init_state is zeros, so "stay at init" is a zeroed lane
                carry = tuple(_sel(advance, n, _sel(reset, torch.zeros_like(o), o))
                              for n, o in zip(outs, carry))
                prev = _sel(update[j], frame, prev)
                encs.append(_wire_encode(outs[-1], self.out_wire))
            if deep:
                enc = (tuple(torch.stack(xs) for xs in zip(*encs))
                       if isinstance(encs[0], tuple) else torch.stack(encs))
            else:
                enc = encs[0]
            axis = 1 if deep else 0
            if lanes is not None:
                idx = _upload(lanes, self.device)
                enc = _tree_map(lambda a: a.index_select(axis, idx), enc)
                n_chunks = math.gcd(n_chunks, len(lanes))
            fetch = PredFetch(_fetch_split(enc, n_chunks, axis), self._stream)
        self._carry, self._prev = carry, prev
        self.warmed.add((depth, len(lanes)) if lanes is not None else depth if deep else 1)
        return fetch

    def push_async(self, windows: dict):
        """Dispatch one tick without waiting for the device: ``{slot: events
        [4, n]}`` in, ``(out_slots, preds)`` back as soon as the tick is
        enqueued.  ``preds`` is a :class:`PredFetch` of the ``[slots, kH,
        kW, 2]`` encoded predictions (``is_ready()`` polls, ``get()``
        fetches; with ``fetch_chunks > 1`` it holds a LIST of slot-axis
        chunks for :func:`assemble_fetch`).  Host-side slot state advances
        at once, so further ticks may be dispatched while earlier ones
        compute."""
        xy = np.zeros((1, self.slots, 2, self.window_size), np.int16)
        p = np.zeros((1, self.slots, self.window_size), np.int8)
        masks = np.zeros((2, 1, self.slots), bool)
        for slot, ev in windows.items():
            if not self._active[slot]:
                raise ValueError(f"slot {slot} is not attached")
            xy[0, slot], p[0, slot] = pad_window_compact(ev, self.window_size)
            masks[0, 0, slot] = True
            masks[1, 0, slot] = self._seen[slot] == 0
        preds = self._tick(xy, p, masks, deep=False)
        out_slots = [s for s in windows if not masks[1, 0, s]]
        # only after a successful dispatch: a raise above must leave
        # first-window semantics intact
        self._seen[masks[0, 0]] += 1
        return out_slots, preds

    def push(self, windows: dict) -> dict:
        """Advance one tick: ``{slot: events [4, n]}`` in, ``{slot: HR
        prediction [kH, kW, 2] float32}`` out for every pushed slot that has
        already seen a window."""
        out_slots, preds = self.push_async(windows)
        host = wire_decode(assemble_fetch(preds.get(), deep=False), self.out_wire)
        return {s: host[s] for s in out_slots}

    def push_async_deep(self, windows: dict, depth: int, compact: bool = False):
        """Dispatch ONE deep tick consuming up to ``depth`` queued windows
        per slot: ``{slot: [events [4, n], ...]}`` in (at most ``depth``
        each), ``(out_map, preds)`` back once enqueued.  ``out_map`` is
        ``{slot: [(step, has_output), ...]}`` in consumption order
        (``has_output=False`` marks a stream's first window); ``preds`` is
        the fetch of the ``[depth, slots, kH, kW, 2]`` stack (chunked:
        :func:`assemble_fetch(..., deep=True) <assemble_fetch>`).  Equal to
        ``depth`` consecutive :meth:`push_async` ticks.

        ``compact=True`` returns ``(out_map, preds, lane_of)`` where the
        fetched stack holds only the pushed slots' lanes: index it with
        ``preds[j, lane_of[slot]]``.  The pushed-slot count rounds up to a
        power-of-two bucket ``k`` (padding lanes repeat a live slot); at
        ``k == slots`` nothing is gathered and ``lane_of`` is the identity.
        """
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        xy = np.zeros((depth, self.slots, 2, self.window_size), np.int16)
        p = np.zeros((depth, self.slots, self.window_size), np.int8)
        masks = np.zeros((2, depth, self.slots), bool)
        out_map: dict = {}
        for slot, wins in windows.items():
            if not self._active[slot]:
                raise ValueError(f"slot {slot} is not attached")
            if len(wins) > depth:
                raise ValueError(f"slot {slot}: {len(wins)} windows exceed tick depth {depth}")
            entries = []
            for j, ev in enumerate(wins):
                xy[j, slot], p[j, slot] = pad_window_compact(ev, self.window_size)
                masks[0, j, slot] = True
                is_first = self._seen[slot] == 0 and j == 0
                masks[1, j, slot] = is_first
                entries.append((j, not is_first))
            out_map[slot] = entries
        active = sorted(windows)
        k = self.slots
        if compact and active:
            k = min(1 << (len(active) - 1).bit_length(), self.slots)
        if compact and active and k < self.slots:
            lane_of = {s: i for i, s in enumerate(active)}
            lanes = np.asarray(active + [active[-1]] * (k - len(active)), np.int64)
            preds = self._tick(xy, p, masks, deep=True, lanes=lanes)
        else:
            lane_of = {s: s for s in windows}  # identity: the padded layout
            preds = self._tick(xy, p, masks, deep=True)
        for slot, wins in windows.items():
            self._seen[slot] += len(wins)
        if compact:
            return out_map, preds, lane_of
        return out_map, preds

    def prewarm(self, depths=(1,), compact=()) -> None:
        """Run one all-masked-out tick per depth (and per ``(depth, k)``
        compaction rung, power-of-two ``k < slots``) before traffic: every
        slot's carry passes through untouched, and the kernels' first-launch
        costs (the CUDA builds, cuDNN's algorithm choice) are paid here
        instead of in a live tick."""
        for depth, k in compact:
            if not 1 <= k < self.slots:
                raise ValueError(f"compact bucket k={k} must be in [1, slots={self.slots})")
        n = self.window_size
        for depth, k in [(d, None) for d in depths] + list(compact):
            self._tick(np.zeros((depth, self.slots, 2, n), np.int16),
                       np.zeros((depth, self.slots, n), np.int8),
                       np.zeros((2, depth, self.slots), bool), deep=depth > 1 or k is not None,
                       lanes=None if k is None else np.zeros(k, np.int64)).get()

    def reload(self, variables: Mapping) -> None:
        """Hot-swap the weights in place without dropping any stream: every
        slot's state and first-window status carry across.  The copies run
        on the pool's stream, so ticks already dispatched read the old
        weights and later ticks the new ones; the int8 weight cache re-packs
        on the weights' version bump.  Static int8 scales travel in
        ``variables["quant"]`` with the weights they were calibrated for.  A
        serving state of another structure, shape or dtype raises
        ``ValueError`` and the old weights keep serving.  Device tensors in
        ``variables`` must have been written on the device's default stream
        or be ready (host tensors always are)."""
        _validate_swap(self.variables, variables)
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.default_stream(self.device))
            # buffers the swap frees (old scales, the int8 weight cache) may
            # still be read by dispatched ticks: keep them until the stream
            # passes this point
            for m in quant_convs(self.model).values():
                for t in (m.act_scale, *(m._wcache or ())[1:]):
                    if t is not None and t.is_cuda:
                        t.record_stream(self._stream)
        with _on(self.device, self._stream, inference=False):
            _apply_state(self.model, variables)

    # -- slots ---------------------------------------------------------------

    @property
    def free_slots(self) -> int:
        return int((~self._active).sum())

    def windows_seen(self, slot: int) -> int:
        """Windows this slot has consumed since it was (re)attached."""
        return int(self._seen[slot])

    def attach(self) -> int:
        """Claim a free slot for a new stream; returns the slot id."""
        free = np.flatnonzero(~self._active)
        if free.size == 0:
            raise RuntimeError(f"all {self.slots} stream slots are busy")
        slot = int(free[0])
        self._active[slot] = True
        self._seen[slot] = 0
        return slot

    def detach(self, slot: int) -> None:
        """Release a slot (its state is re-zeroed by its next first window)."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not attached")
        self._active[slot] = False
