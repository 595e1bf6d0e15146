"""Video -> event-stream simulator (PyTorch, on the simulator's device).

Counterpart of ``bmcnet_esr_tpu/data/simulator.py``: frames in, the
multi-scale event h5 files of the reference's DVS-Voltmeter chain out.

Model
-----
A contrast-threshold DVS pixel: per pixel, log intensity moves linearly
between frames and an event fires each time it moves one contrast threshold
away from the reference level set at the previous event.  Non-idealities:
per-pixel threshold mismatch (``threshold_sigma``); a refractory period whose
crossings are absorbed (the reference level still advances over them, only
the emission is suppressed); background shot noise (Poisson, ON and OFF);
hot pixels (a seeded fraction with ``hot_pixel_gain`` times the noise
rate); leak (the reference level decays at ``leak_rate_hz`` thresholds a
second, giving ON events on a static scene).

Shapes and order
----------------
Each interval is computed for every pixel at once with a fixed cap of
``max_events_per_pixel`` crossings, ``[H, W, M]``; ``chunk`` intervals run
per call of :meth:`EventSimulator._chunk_step`, the last chunk padded with
``dt = 0`` intervals whose output is dropped.  The kept crossings are
compacted on the device (``nonzero``, row-major) and only they are copied
to the host: signal events in ``(y, x, k)`` order, then noise events in
``(y, x, polarity, k)`` order, as the JAX package emits them, each
interval's stable-sorted by their float32 time relative to the interval's
start.  The host adds those times to the float64 frame times; where two
round to one float64 time it restores their arrival order, so each
interval's list is the stable sort by float64 time that the JAX package
makes on the host.

The three multiply-adds of the model (the leak, the crossing levels, the
reference update) round once: they are computed in float64 and rounded to
float32, which is a fused multiply-add but in the rare case where the
float64 sum lies on a float32 tie.  XLA's CPU backend fuses these three
into FMA instructions, so the port's CPU and CUDA runs give the JAX
package's CPU event list bit for bit; the other operations are single
float32 operations in the JAX program's order.  One more rewrite of XLA's
is followed: where the ON and OFF thresholds are the same array (no
mismatch), the JAX program divides by a constant, which XLA turns into a
product with its reciprocal, so the crossing count is then
``floor(|delta| * (1 / C))`` here too (it differs from the quotient's floor
where ``|delta|`` is a multiple of ``C``).

Random numbers come from a ``torch.Generator`` on the simulator's device
(seeded by ``config.seed``), carried across calls.  ``jax.random`` streams
cannot be reproduced here, so :func:`simulator_state_from_jax` carries a JAX
simulator's per-pixel thresholds and noise gains across: with the same
state and the noise off, both packages give the same event list.

Coordinates: ``y`` is the image row (row 0 = y 0), as the reference's h5
files store it; the count rasterizer flips y downstream.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SimulatorConfig:
    """Knobs of the DVS pixel model (defaults: a clean, noise-free sensor)."""

    contrast_threshold: float = 0.15      # nominal log-intensity step per event
    threshold_sigma: float = 0.0          # per-pixel mismatch, fraction of C
    threshold_min: float = 0.01           # clip for sampled thresholds
    refractory_s: float = 0.0             # absorb crossings closer than this
    max_events_per_pixel: int = 16        # static emission cap per interval
    noise_rate_hz: float = 0.0            # per-pixel background rate (ON+OFF)
    max_noise_per_pixel: int = 4          # static noise cap per interval/polarity
    hot_pixel_fraction: float = 0.0       # fraction of pixels with boosted noise
    hot_pixel_gain: float = 100.0         # their noise-rate multiplier
    leak_rate_hz: float = 0.0             # reference-level decay, thresholds/sec
    log_eps: float = 1e-3                 # I in [0,1] -> log(I + eps)
    chunk: int = 8                        # frame intervals per device call
    seed: int = 0


def _log_intensity(frames: np.ndarray, log_eps: float) -> np.ndarray:
    """uint8 [0, 255] or float [0, 1] frames -> float32 log intensity."""
    f = np.asarray(frames)
    if f.dtype == np.uint8:
        f = f.astype(np.float32) / 255.0
    f = f.astype(np.float32)
    return np.log(f + np.float32(log_eps))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (the product of two float32 is
    exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _arrival_stable_order(interval: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts events by ``(interval, t)``, ties in
    arrival order.  ``t >= 0``: its float32 bits order as integers, so one
    stable sort of the int64 keys ``interval << 31 | bits of t`` gives it."""
    bits = (t + 0.0).view(torch.int32).to(torch.int64)  # -0.0 -> +0.0
    return torch.sort(interval << 31 | bits, stable=True).indices


def simulator_state_from_jax(c_pos, c_neg, noise_gain, device=None) -> Dict[str, torch.Tensor]:
    """A simulator's per-pixel state from numpy arrays (a JAX
    ``EventSimulator``'s ``_c_pos``, ``_c_neg`` and ``_noise_gain``, or
    thresholds drawn on the host): ``{"c_pos", "c_neg", "noise_gain"}``
    float32 ``[H, W]`` tensors on ``device``, for ``EventSimulator(state=)``."""
    return {name: torch.as_tensor(np.array(a, np.float32), device=device)
            for name, a in (("c_pos", c_pos), ("c_neg", c_neg), ("noise_gain", noise_gain))}


class EventSimulator:
    """Stateful simulator for one sensor resolution on ``device`` (default
    ``cuda``).

    ``simulate(frames, timestamps)`` -> ``[N, 4]`` float64 ``(x, y, t, p)``
    with ``p`` in {-1, +1}, sorted by time; ``simulate_counts`` -> the
    per-interval ``[T - 1, 2, H, W]`` count images of the same events.
    ``state`` (:func:`simulator_state_from_jax`) replaces the sampled
    thresholds and noise gains."""

    def __init__(self, resolution: Tuple[int, int], config: SimulatorConfig = SimulatorConfig(),
                 *, device="cuda", state: Optional[Dict[str, torch.Tensor]] = None):
        self.resolution = (int(resolution[0]), int(resolution[1]))
        self.config = config
        self.device = torch.device(device)
        h, w = self.resolution
        c = config
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(c.seed)
        if state is None:
            base = torch.tensor(c.contrast_threshold, dtype=torch.float32, device=self.device)
            sig = base * np.float32(c.threshold_sigma)
            c_pos = torch.clamp(base + sig * self._randn((h, w)), min=c.threshold_min)
            c_neg = torch.clamp(base + sig * self._randn((h, w)), min=c.threshold_min)
            hot = self._rand((h, w)) < c.hot_pixel_fraction
            gain = torch.where(hot, np.float32(c.hot_pixel_gain), np.float32(1.0))
        else:
            c_pos, c_neg, gain = (state[k].to(self.device, torch.float32)
                                  for k in ("c_pos", "c_neg", "noise_gain"))
            if any(tuple(t.shape) != (h, w) for t in (c_pos, c_neg, gain)):
                raise ValueError(f"state shapes differ from the resolution {(h, w)}")
            hot = gain != 1.0
        self._c_pos, self._c_neg, self._noise_gain = c_pos, c_neg, gain
        # one threshold array for both polarities: count through its reciprocal
        self._inv_c = torch.reciprocal(c_pos) if torch.equal(c_pos, c_neg) else None
        self.hot_pixels = hot.cpu().numpy()
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)  # noqa: E731
        self._leak_c = f32(c.leak_rate_hz) * c_pos
        self._refr = f32(c.refractory_s)
        self._tiny = f32(1e-12)
        self._ks = torch.arange(1, c.max_events_per_pixel + 1, dtype=torch.float32,
                                device=self.device)

    def _randn(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self._gen, device=self.device)

    def _rand(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self._gen, device=self.device)

    # -- device step --------------------------------------------------------

    def _interval_step(self, ref, logl_prev, t_last, logl1, dt):
        """One frame interval for every pixel: ``[H, W]`` state in, the new
        state and ``(t_rel [H, W, M], keep [H, W, M], sgn [H, W], noise_t
        [H, W, 2, Mn], noise_keep [H, W, 2, Mn])`` out.  ``dt`` is a 0-dim
        float32 tensor."""
        c = self.config
        one = torch.ones((), dtype=torch.float32, device=self.device)
        # leak: the reference level decays -> spurious ON events on static scenes
        ref = _fma(-self._leak_c, dt, ref)
        delta = logl1 - ref
        rising = delta > 0
        if self._inv_c is None:
            cthr = torch.where(rising, self._c_pos, self._c_neg)
            n_full = torch.floor(torch.abs(delta) / cthr)  # uncapped crossing count
        else:
            cthr = self._c_pos
            n_full = torch.floor(torch.abs(delta) * self._inv_c)
        sgn = torch.where(rising, one, -one)

        # crossing times of the linear signal from logl_prev to logl1 over dt
        slope = (logl1 - logl_prev) / torch.maximum(dt, self._tiny)
        step = sgn * cthr
        levels = _fma(step[..., None], self._ks, ref[..., None])  # [H, W, M]
        safe = torch.abs(slope) > self._tiny
        t_rel = torch.where(
            safe[..., None],
            (levels - logl_prev[..., None]) / torch.where(safe, slope, one)[..., None],
            torch.zeros((), dtype=torch.float32, device=self.device),
        )
        t_rel = torch.minimum(torch.clamp(t_rel, min=0.0), dt)
        cand = self._ks <= n_full[..., None]

        if c.refractory_s > 0.0:
            # absorb filter over the (ascending) crossings; t_last is relative
            # to this interval's start (<= 0)
            t_prev, oks = t_last, []
            for k in range(c.max_events_per_pixel):
                tk = t_rel[..., k]
                ok = cand[..., k] & (tk - t_prev >= self._refr)
                t_prev = torch.where(ok, tk, t_prev)
                oks.append(ok)
            keep = torch.stack(oks, -1)
            last = torch.amax(torch.where(keep, t_rel, -torch.inf), -1)
            # relative to the NEXT interval's start
            t_last_new = torch.where(keep.any(-1), last, t_last) - dt
        else:
            keep = cand
            t_last_new = t_last
        # absorb semantics: the reference level consumes ALL crossings
        ref_new = _fma(step, n_full, ref)

        h, w = self.resolution
        mn = c.max_noise_per_pixel
        if c.noise_rate_hz > 0.0:
            lam = np.float32(c.noise_rate_hz) * np.float32(0.5) * self._noise_gain * dt
            n_on = torch.clamp(torch.poisson(lam, generator=self._gen), max=mn)
            n_off = torch.clamp(torch.poisson(lam, generator=self._gen), max=mn)
            noise_t = self._rand((h, w, 2, mn)) * dt
            kn = torch.arange(mn, dtype=torch.float32, device=self.device)
            noise_keep = kn < torch.stack([n_on, n_off], -1)[..., None]
        else:
            noise_t = torch.zeros((h, w, 2, 0), dtype=torch.float32, device=self.device)
            noise_keep = torch.zeros((h, w, 2, 0), dtype=torch.bool, device=self.device)
        return (ref_new, logl1, t_last_new), (t_rel, keep, sgn, noise_t, noise_keep)

    def _chunk_step(self, state, logl1s: torch.Tensor, dts: torch.Tensor):
        """``_interval_step`` over a ``[K, H, W]`` chunk; outputs stacked
        ``[K, ...]``."""
        outs = []
        for i in range(logl1s.shape[0]):
            state, out = self._interval_step(*state, logl1s[i], dts[i])
            outs.append(out)
        return state, tuple(torch.stack(o) for o in zip(*outs))

    # -- host side ----------------------------------------------------------

    def _run(self, frames: np.ndarray, timestamps: np.ndarray
             ) -> Iterator[Tuple[int, int, Tuple[torch.Tensor, ...]]]:
        """Yield ``(first interval, intervals, device outputs [K, ...])``
        chunk by chunk; padding intervals are cut off."""
        c = self.config
        h, w = self.resolution
        frames = np.asarray(frames)
        if frames.shape[1:] != (h, w):
            raise ValueError(f"frames {frames.shape[1:]} != resolution {(h, w)}")
        ts = np.asarray(timestamps, np.float64)
        if len(ts) != len(frames):
            raise ValueError("one timestamp per frame required")
        if len(frames) < 2:
            return
        logl = _log_intensity(frames, c.log_eps)
        dts = np.diff(ts).astype(np.float32)
        if (dts < 0).any():
            raise ValueError("timestamps must be non-decreasing")
        first = torch.as_tensor(logl[0], device=self.device)
        state = (first, first, torch.full((h, w), -torch.inf, device=self.device))
        n_int = len(frames) - 1
        for start in range(0, n_int, c.chunk):
            stop = min(start + c.chunk, n_int)
            k = stop - start
            chunk_logl = logl[start + 1 : stop + 1]
            chunk_dt = dts[start:stop]
            pad = c.chunk - k
            if pad:  # dt = 0 repeats emit nothing (residual < threshold)
                chunk_logl = np.concatenate([chunk_logl, np.repeat(chunk_logl[-1:], pad, 0)])
                chunk_dt = np.concatenate([chunk_dt, np.zeros(pad, np.float32)])
            state, outs = self._chunk_step(
                state, torch.as_tensor(chunk_logl, device=self.device),
                torch.as_tensor(chunk_dt, device=self.device))
            yield start, k, tuple(o[:k] for o in outs)

    @staticmethod
    def _compact(outs) -> Tuple[np.ndarray, ...]:
        """The kept crossings of a chunk, compacted and ordered on the device,
        then copied to the host: the events of each interval (``[K]``
        counts), each interval's sorted by ``t`` (stable, from the arrival
        order: signal events row-major, then noise events row-major), with
        their arrival ranks (int32), ``(y, x)`` int16, ``t`` float32
        (relative to the interval) and ``p`` int8."""
        t_rel, keep, sgn, noise_t, noise_keep = outs
        sig = keep.nonzero()
        noise = noise_keep.nonzero()
        interval = torch.cat([sig[:, 0], noise[:, 0]])
        t = torch.cat([t_rel[keep], noise_t[noise_keep]])
        p = torch.cat([sgn[sig[:, 0], sig[:, 1], sig[:, 2]],
                       torch.where(noise[:, 3] == 0, 1.0, -1.0)])
        order = _arrival_stable_order(interval, t)
        yx = torch.cat([sig[:, 1:3], noise[:, 1:3]])[order]
        return tuple(a.cpu().numpy() for a in (
            torch.bincount(interval, minlength=keep.shape[0]), order.to(torch.int32),
            yx.to(torch.int16), t[order], p[order].to(torch.int8)))

    def simulate(self, frames: np.ndarray, timestamps: np.ndarray) -> np.ndarray:
        """The video's event list: ``[N, 4]`` float64 ``(x, y, t, p)``, each
        interval's events stable-sorted by ``t`` (frame time + ``t_rel``)
        from their arrival order, as the JAX package lists them."""
        ts = np.asarray(timestamps, np.float64)
        chunks: List[np.ndarray] = []
        for start, _, outs in self._run(frames, timestamps):
            per, rank, yx, t, p = self._compact(outs)
            at = np.concatenate([[0], np.cumsum(per)])
            for i in range(len(per)):
                a, b = at[i], at[i + 1]
                if a == b:
                    continue
                ev = np.empty((b - a, 4), np.float64)
                ev[:, 0], ev[:, 1], ev[:, 3] = yx[a:b, 1], yx[a:b, 0], p[a:b]
                ev[:, 2] = t[a:b].astype(np.float64) + ts[start + i]
                # the order by t_rel is the order by time, but where two times
                # round to one float64 the arrival order must decide
                r = rank[a:b]
                if ((np.diff(ev[:, 2]) == 0) & (np.diff(r) < 0)).any():
                    ev = ev[np.lexsort((r, ev[:, 2]))]
                chunks.append(ev)
        if not chunks:
            return np.zeros((0, 4), np.float64)
        return np.concatenate(chunks, 0)

    def simulate_counts(self, frames: np.ndarray, timestamps: np.ndarray) -> np.ndarray:
        """Per-interval 2-channel count images ``[T - 1, 2, H, W]`` float32
        (channel 0 positive, 1 negative, y not flipped), counted on the
        device from the same kept crossings as :meth:`simulate`."""
        h, w = self.resolution
        out = np.zeros((max(len(frames) - 1, 0), 2, h, w), np.float32)
        for start, k, (_, keep, sgn, _, noise_keep) in self._run(frames, timestamps):
            n_sig = keep.sum(-1).to(torch.float32)
            pos = torch.where(sgn > 0, n_sig, 0.0) + noise_keep[..., 0, :].sum(-1)
            neg = torch.where(sgn < 0, n_sig, 0.0) + noise_keep[..., 1, :].sum(-1)
            out[start : start + k] = torch.stack([pos, neg], 1).cpu().numpy()
        return out


# ---------------------------------------------------------------------------
# multi-scale runs
# ---------------------------------------------------------------------------


def downscale_frames(frames: np.ndarray, factor: int) -> np.ndarray:
    """Per-scale frame pyramid: bilinear resize to ``(H // factor, W //
    factor)`` (``cv2.resize``'s default, as the reference prescribes)."""
    if factor == 1:
        return np.asarray(frames)
    h, w = frames.shape[1], frames.shape[2]
    return resize_frames(frames, (h // factor, w // factor))


def resize_frames(frames: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Bilinear-resize a ``[T, H, W]`` frame stack to ``shape`` with
    ``cv2.resize`` (``INTER_LINEAR``).  Without ``cv2``, half-pixel bilinear
    ``F.interpolate`` on the CPU (no antialiasing), rounded back to uint8 for
    uint8 frames: for an integer factor, the mean of the two middle source
    pixels in each direction, as ``cv2`` takes it."""
    nh, nw = int(shape[0]), int(shape[1])
    frames = np.asarray(frames)
    if (frames.shape[1], frames.shape[2]) == (nh, nw):
        return frames
    try:
        import cv2
    except ImportError:
        x = torch.as_tensor(frames.astype(np.float32))[:, None]
        out = torch.nn.functional.interpolate(x, size=(nh, nw), mode="bilinear",
                                              align_corners=False)[:, 0].numpy()
        if frames.dtype == np.uint8:
            out = np.clip(np.round(out), 0, 255).astype(np.uint8)
        return out
    return np.stack([cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR) for f in frames])


def write_voltmeter_txt(events: np.ndarray, path: str) -> str:
    """Write ``(x, y, t, p in {-1, +1})`` events in the DVS-Voltmeter dump
    layout the synthesis scripts read: one header row, then ``t x y p`` rows
    with ``p`` in {0, 1}."""
    x, y, t, p = events[:, 0], events[:, 1], events[:, 2], events[:, 3]
    cols = np.column_stack((t, x.astype(np.int64), y.astype(np.int64), (p > 0).astype(np.int64)))
    np.savetxt(path, cols, fmt="%.9f %d %d %d", header="t x y p", comments="# ")
    return path


def simulate_multiscale(
    frames: np.ndarray,
    timestamps: np.ndarray,
    scales: Sequence[int] = (1, 2, 4, 8),
    prefixes: Optional[Sequence[str]] = None,
    config: SimulatorConfig = SimulatorConfig(),
    out_h5: Optional[str] = None,
    txt_dir: Optional[str] = None,
    store_frames: bool = False,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Per-scale event streams of one video, simulated on ``device``.

    ``scales[i]`` is a downsample factor and ``prefixes[i]`` the h5 group
    prefix it lands in (default ``ori, down2, ...``).  Each scale gets its
    own generator (seed offset by its index).  Writes ``out_h5`` through
    :class:`MultiScaleEventPackager` (with ``ori_images`` and per-prefix
    event indices when ``store_frames``) and/or DVS-Voltmeter ``.txt``
    dumps into ``txt_dir``.  The declared ``sensor_resolution`` is the grid
    of the ``ori`` prefix (or, without one, the grid the first ``downN``
    prefix implies), and every prefix must sit on ``sensor / N`` as the
    dataset layer derives it."""
    from bmcnet_esr_torch.data.packager import MultiScaleEventPackager

    if prefixes is None:
        prefixes = ["ori" if s == 1 else f"down{s}" for s in scales]
    if len(prefixes) != len(scales):
        raise ValueError("one prefix per scale required")
    streams: Dict[str, np.ndarray] = {}
    for i, (s, prefix) in enumerate(zip(scales, prefixes)):
        fs = downscale_frames(frames, int(s))
        sim = EventSimulator(fs.shape[1:], dataclasses.replace(config, seed=config.seed + i),
                             device=device)
        streams[prefix] = sim.simulate(fs, timestamps)

    if txt_dir is not None:
        os.makedirs(txt_dir, exist_ok=True)
        for prefix, ev in streams.items():
            write_voltmeter_txt(ev, os.path.join(txt_dir, f"{prefix}.txt"))
    if out_h5 is not None:
        raw_h, raw_w = frames.shape[1], frames.shape[2]
        if "ori" in prefixes:
            anchor, anchor_n = prefixes.index("ori"), 1
        else:
            anchor = 0
            m = re.fullmatch(r"down(\d+)", prefixes[0])
            if m is None:
                raise ValueError(f"cannot infer sensor resolution from prefix {prefixes[0]!r}")
            anchor_n = int(m.group(1))
        sensor_h = raw_h // int(scales[anchor]) * anchor_n
        sensor_w = raw_w // int(scales[anchor]) * anchor_n
        for s, prefix in zip(scales, prefixes):
            m = re.fullmatch(r"down(\d+)", prefix)
            n = int(m.group(1)) if m else 1
            if (raw_h // int(s), raw_w // int(s)) != (round(sensor_h / n), round(sensor_w / n)):
                raise ValueError(
                    f"prefix {prefix!r} at scale {s} is inconsistent with "
                    f"sensor_resolution ({sensor_h}, {sensor_w}); the dataset "
                    "layer derives per-prefix grids as sensor/downN"
                )
        with MultiScaleEventPackager(out_h5) as pk:
            pk.set_sensor_resolution((sensor_h, sensor_w))
            for prefix, ev in streams.items():
                pk.append_events(prefix, ev[:, 0], ev[:, 1], ev[:, 2], ev[:, 3])
            if store_frames:
                imgs = resize_frames(frames, (sensor_h, sensor_w))
                for img, t in zip(imgs, np.asarray(timestamps, np.float64)):
                    u8 = img if img.dtype == np.uint8 else np.clip(img * 255, 0, 255).astype(
                        np.uint8)
                    pk.append_image("ori", u8, float(t))
                for prefix in prefixes:
                    pk.annotate_image_event_indices("ori", prefix)
    return streams
