"""Event window datasets over multi-scale HDF5 files.

Counterpart of ``bmcnet_esr_tpu/data/h5dataset.py``: ``SequenceConfig``,
``DatasetConfig`` (with ``from_dict``), ``ScaleLayout``,
``resolve_scale_layout``, ``EventH5Dataset.get_window`` and
``EventSequenceDataset.get_clip``, with the same windowing (``events``,
``time`` and ``frame`` modes), count-based GT alignment, fixed zero-padded
``[4, N]`` float32 windows, GT frames (``need_gt_frame``: the stored frame
nearest a window's middle, bicubic-resized to the GT grid with ``cv2``,
imported on use) and the same numpy random draws: seeded H/V/polarity flips
(one ``default_rng(seed + offset)`` draw per mechanism), uniform noise
events (``seed + 17``), the running hot-pixel filter (counted through
:func:`bmcnet_esr_torch.ops.encodings.events_to_channels` on the CPU, in the
same y-flipped raster coordinates as the JAX package's native counter) and
pause windows.  The host-side auxiliary encodings (``create_*``) run the
port's encoders on CPU tensors.  ``h5py`` is imported when a file is
opened, so the package imports without it.

One deliberate difference: the stored frames (``ori_images``) are ordered
by their ``timestamp`` attribute, ties by the number their name ends in,
so ``frame_ts`` is ascending whatever the names; the JAX package sorts the
names as text, which puts ``image10`` before ``image2``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bmcnet_esr_torch.ops.encodings import (
    events_to_channels,
    events_to_stack_no_polarity,
    events_to_voxel,
)
from bmcnet_esr_torch.ops.resize import resize_bicubic

_DOWN_FACTOR = {"ori": 1, "down2": 2, "down4": 4, "down8": 8, "down16": 16}
_FACTOR_PREFIX = {1: "ori", 2: "down2", 4: "down4", 8: "down8", 16: "down16"}

# streaming-read block for timestamp scans (float64 -> 32 MB per block);
# window/GT-alignment indexing never materializes a full ts array in RAM
_TS_BLOCK = 4 * 1024 * 1024


def _stream_searchsorted(dset, queries: np.ndarray, side: str = "left") -> np.ndarray:
    """``np.searchsorted(dset[:], queries, side)`` without loading ``dset``.

    ``queries`` must be ascending (window starts / frame stamps are).  Scans
    the sorted dataset in ``_TS_BLOCK`` chunks; since both sides are sorted,
    finalized queries form a prefix per block — one O(n) pass, O(block) RAM.
    """
    queries = np.asarray(queries)
    out = np.empty(len(queries), np.int64)
    qi = 0
    n = dset.shape[0]
    for base in range(0, n, _TS_BLOCK):
        if qi == len(queries):
            break
        block = dset[base : base + _TS_BLOCK]
        r = np.searchsorted(block, queries[qi:], side)
        inside = r < len(block)  # insertion point strictly inside this block
        n_done = int(np.argmin(inside)) if not inside.all() else len(r)
        out[qi : qi + n_done] = base + r[:n_done]
        qi += n_done
    out[qi:] = n
    return out


def _gather_sorted(dset, indices: np.ndarray) -> np.ndarray:
    """``dset[:][indices]`` for ascending (possibly repeated) indices without
    loading the dataset (h5py fancy selection requires strictly-increasing,
    duplicate-free index lists)."""
    uniq, inverse = np.unique(np.asarray(indices, np.int64), return_inverse=True)
    return dset[uniq.tolist()][inverse] if len(uniq) else np.empty(0, dset.dtype)


@dataclasses.dataclass
class AugmentConfig:
    enabled: bool = False
    mechanisms: Sequence[str] = ("Horizontal", "Vertical", "Polarity")
    probabilities: Sequence[float] = (0.5, 0.5, 0.5)


@dataclasses.dataclass
class NoiseConfig:
    enabled: bool = False
    noise_level: float = 0.01  # noise events as a fraction of the window


@dataclasses.dataclass
class HotFilterConfig:
    """Hot-pixel suppression for real-world captures (the reference carries
    this block in every recipe with ``enabled: False`` and never wires its
    ``create_hot_mask`` — here the same block actually filters when enabled;
    ``train_EventZoom.yml:89-93``, ``h5dataset.py:528-548``)."""

    enabled: bool = False
    max_px: int = 100
    min_obvs: int = 5
    max_rate: float = 0.8


@dataclasses.dataclass
class PauseConfig:
    enabled: bool = False
    proba_pause_when_running: float = 0.05
    proba_pause_when_paused: float = 0.9


@dataclasses.dataclass
class SequenceConfig:
    sequence_length: int = 9
    seqn: int = 2
    step_size: Optional[int] = None
    pause: PauseConfig = dataclasses.field(default_factory=PauseConfig)


@dataclasses.dataclass
class DatasetConfig:
    scale: int = 4
    ori_scale: str = "down8"
    window: int = 2048
    sliding_window: int = 1024
    mode: str = "events"  # events | time | frame
    time_bins: int = 1
    need_gt_events: bool = True
    need_gt_frame: bool = False
    real_world_test: bool = False
    dataset_length: Optional[int] = None
    custom_resolution: Optional[Sequence[int]] = None
    augment: AugmentConfig = dataclasses.field(default_factory=AugmentConfig)
    noise: NoiseConfig = dataclasses.field(default_factory=NoiseConfig)
    hot_filter: HotFilterConfig = dataclasses.field(default_factory=HotFilterConfig)
    sequence: SequenceConfig = dataclasses.field(default_factory=SequenceConfig)

    @classmethod
    def from_dict(cls, cfg: Dict) -> "DatasetConfig":
        """Build from a reference-style YAML dataset dict (train_nfs.yml:76-101)."""
        aug = cfg.get("data_augment", {})
        noise = cfg.get("add_noise", {})
        hot = cfg.get("hot_filter", {})
        seq = cfg.get("sequence", {})
        pause = seq.get("pause", {})
        return cls(
            scale=cfg.get("scale", 4),
            ori_scale=cfg.get("ori_scale", "down8"),
            window=cfg.get("window", 2048),
            sliding_window=cfg.get("sliding_window", 1024),
            mode=cfg.get("mode", "events"),
            time_bins=cfg.get("time_bins", 1),
            need_gt_events=cfg.get("need_gt_events", True),
            need_gt_frame=cfg.get("need_gt_frame", False),
            real_world_test=cfg.get("real_world_test", False),
            dataset_length=cfg.get("dataset_length"),
            custom_resolution=cfg.get("custom_resolution"),
            augment=AugmentConfig(
                enabled=aug.get("enabled", False),
                mechanisms=tuple(aug.get("augment", ("Horizontal", "Vertical", "Polarity"))),
                probabilities=tuple(aug.get("augment_prob", (0.5, 0.5, 0.5))),
            ),
            noise=NoiseConfig(
                enabled=noise.get("enabled", False),
                noise_level=noise.get("noise_level", 0.01),
            ),
            hot_filter=HotFilterConfig(
                enabled=hot.get("enabled", False),
                max_px=hot.get("max_px", 100),
                min_obvs=hot.get("min_obvs", 5),
                max_rate=hot.get("max_rate", 0.8),
            ),
            sequence=SequenceConfig(
                sequence_length=seq.get("sequence_length", 9),
                seqn=seq.get("seqn", 2),
                step_size=seq.get("step_size"),
                pause=PauseConfig(
                    enabled=pause.get("enabled", False),
                    proba_pause_when_running=pause.get("proba_pause_when_running", 0.05),
                    proba_pause_when_paused=pause.get("proba_pause_when_paused", 0.9),
                ),
            ),
        )


@dataclasses.dataclass(frozen=True)
class ScaleLayout:
    inp_prefix: str
    gt_prefix: str
    inp_resolution: Tuple[int, int]
    gt_resolution: Tuple[int, int]
    inp_down_resolution: Tuple[int, int]


def resolve_scale_layout(
    sensor_resolution: Sequence[int],
    scale: int,
    ori_scale: str,
    need_gt_events: bool,
    real_world_test: bool = False,
) -> ScaleLayout:
    """Map (ori_scale, scale) to h5 group prefixes + resolutions.

    Generic formulation of the reference's per-case ladder
    (``h5dataset.py:32-146``): input lives at ``sensor / down``, GT events at
    ``sensor / (down / scale)`` (which must be a power-of-two scale present in
    the file), GT-as-resolution otherwise at ``inp * scale``.
    """
    sh, sw = int(sensor_resolution[0]), int(sensor_resolution[1])
    if real_world_test:
        # EventZoom real capture: only down8 input without gt events exists
        # (reference raises otherwise, h5dataset.py:45-60).
        if ori_scale != "down8" or need_gt_events:
            raise ValueError("real_world_test supports ori_scale='down8' without gt events")
        down = 8
        inp_res = (round(sh / down), round(sw / down))
        gt_factor = max(down // scale, 1)
        gt_res = (round(sh / gt_factor), round(sw / gt_factor))
        return ScaleLayout(
            "down8_real",
            "down8_real",
            inp_res,
            gt_res,
            (round(inp_res[0] / scale), round(inp_res[1] / scale)),
        )

    if ori_scale not in _DOWN_FACTOR:
        raise ValueError(f"unknown ori_scale {ori_scale!r}")
    down = _DOWN_FACTOR[ori_scale]
    inp_res = (round(sh / down), round(sw / down))
    inp_down_res = (round(inp_res[0] / scale), round(inp_res[1] / scale))

    if not need_gt_events:
        return ScaleLayout(
            ori_scale, ori_scale, inp_res, (inp_res[0] * scale, inp_res[1] * scale), inp_down_res
        )

    if scale == 1 and down == 1:
        return ScaleLayout("ori", "ori", inp_res, inp_res, inp_down_res)
    gt_factor, rem = divmod(down, scale)
    if rem != 0 or gt_factor not in _FACTOR_PREFIX:
        raise ValueError(f"unsupported scale {scale} for ori_scale {ori_scale}")
    gt_res = (round(sh / gt_factor), round(sw / gt_factor))
    return ScaleLayout(ori_scale, _FACTOR_PREFIX[gt_factor], inp_res, gt_res, inp_down_res)


def _cpu_rows(events: np.ndarray):
    """``[4, N]`` events -> four float32 CPU tensors (x, y, t, p)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(r, np.float32)) for r in events)


def frame_order(f) -> Tuple[List[str], np.ndarray]:
    """The stored frames of ``ori_images`` in time order: their names and
    ``timestamp`` attributes, sorted by timestamp, ties by the number the
    name ends in (``image2`` before ``image10``), then by name.  Returns
    ``([], empty)`` for a file without frames."""
    if "ori_images" not in f:
        return [], np.zeros(0, np.float64)
    grp = f["ori_images"]
    entries = []
    for name in grp.keys():
        m = re.search(r"(\d+)$", name)
        entries.append((float(grp[name].attrs["timestamp"]), int(m.group(1)) if m else -1, name))
    entries.sort()
    return [e[2] for e in entries], np.array([e[0] for e in entries], np.float64)


class EventH5Dataset:
    """Windowed view over one multi-scale event h5 file; items are
    fixed-size zero-padded raw-event windows."""

    def __init__(self, h5_path: str, config: DatasetConfig):
        import h5py

        self.path = h5_path
        self.config = config
        self._file = None

        with h5py.File(h5_path, "r") as f:
            self.sensor_resolution = [int(v) for v in f.attrs["sensor_resolution"]]
            self.layout = resolve_scale_layout(
                self.sensor_resolution,
                config.scale,
                config.ori_scale,
                config.need_gt_events,
                config.real_world_test,
            )
            ts = f[f"{self.layout.inp_prefix}_events/ts"]
            self.num_events = ts.shape[0]
            self.t0 = float(ts[0]) if self.num_events else 0.0
            self.tk = float(ts[-1]) if self.num_events else 0.0
            if config.need_gt_events:
                self.num_gt_events = f[f"{self.layout.gt_prefix}_events/ts"].shape[0]
            else:
                self.num_gt_events = 0
            if config.need_gt_frame or config.mode == "frame":
                self.frame_names, self.frame_ts = frame_order(f)
                self.num_frames = len(self.frame_names)
            else:
                self.frame_ts = None
                self.num_frames = 0
            self.duration = self.tk - self.t0
            self.window = config.window
            self.sliding_window = config.sliding_window
            self._compute_windows(f)

        # fixed padded sizes: events mode windows are exact (config.window);
        # time mode pads to the largest interval; GT windows are count-based
        # off the FIRST window's length (reference h5dataset.py:367)
        if config.mode == "events":
            base_window = config.window
        else:
            base_window = int(np.max(self.event_indices[:, 1] - self.event_indices[:, 0]))
        if config.need_gt_events:
            self.gt_window = int(
                np.max(self.gt_event_indices[:, 1] - self.gt_event_indices[:, 0])
            )
        else:
            self.gt_window = config.scale**2 * base_window
        self.noise_events = (
            int(base_window * config.noise.noise_level) if config.noise.enabled else 0
        )
        self.padded_window = base_window + self.noise_events

        # hot-pixel filter running state (reference h5dataset.py:528-548)
        self.hot_events = np.zeros(self.layout.inp_resolution, np.float32)
        self.hot_idx = 0

    def _compute_windows(self, f) -> None:
        cfg = self.config
        inp_ts = f[f"{self.layout.inp_prefix}_events/ts"]
        stride = self.window - self.sliding_window
        if cfg.mode == "events":
            max_length = max(self.num_events // stride, 0)
            self.length = min(cfg.dataset_length or max_length, max_length)
            idx0 = stride * np.arange(self.length, dtype=np.int64)
            idx1 = np.minimum(idx0 + self.window, self.num_events - 1)
            self.event_indices = np.stack([idx0, idx1], 1)
        elif cfg.mode == "time":
            max_length = max(int(self.duration // stride), 0)
            self.length = min(cfg.dataset_length or max_length, max_length)
            starts = self.t0 + stride * np.arange(self.length, dtype=np.float64)
            idx0 = _stream_searchsorted(inp_ts, starts, "left")
            idx1 = _stream_searchsorted(inp_ts, starts + self.window, "left")
            idx1 = np.minimum(idx1, self.num_events - 1)
            self.event_indices = np.stack([idx0, idx1], 1)
        elif cfg.mode == "frame":
            # one window between each two consecutive stored frames
            max_length = max(self.num_frames - 1, 0)
            self.length = min(cfg.dataset_length or max_length, max_length)
            bounds = _stream_searchsorted(inp_ts, self.frame_ts[: self.length + 1], "left")
            bounds = np.minimum(bounds, self.num_events - 1)
            self.event_indices = np.stack([bounds[:-1], bounds[1:]], 1)
        else:
            raise ValueError(f"invalid data mode {cfg.mode!r}")

        if self.length == 0:
            raise ValueError(f"{self.path}: window parameters produce an empty dataset")

        if cfg.need_gt_events:
            # GT count = scale**2 x the FIRST window's event count
            # (reference h5dataset.py:362-390)
            first_len = int(self.event_indices[0, 1] - self.event_indices[0, 0])
            gt_count = cfg.scale**2 * first_len
            t_starts = _gather_sorted(inp_ts, self.event_indices[:, 0])
            gt_ts = f[f"{self.layout.gt_prefix}_events/ts"]
            g0 = _stream_searchsorted(gt_ts, t_starts, "left")
            g1 = g0 + gt_count
            over = g1 > self.num_gt_events - 1
            g1 = np.where(over, self.num_gt_events - 1, g1)
            g0 = np.where(over, np.maximum(g1 - gt_count, 0), g0)
            self.gt_event_indices = np.stack([g0, g1], 1)
        else:
            self.gt_event_indices = None

    def __len__(self) -> int:
        return self.length

    @property
    def file(self):
        if self._file is None:
            import h5py

            self._file = h5py.File(self.path, "r")
        return self._file

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def _read_events(self, prefix: str, i0: int, i1: int) -> np.ndarray:
        grp = self.file[f"{prefix}_events"]
        return np.stack(
            [
                grp["xs"][i0:i1].astype(np.float32),
                grp["ys"][i0:i1].astype(np.float32),
                grp["ts"][i0:i1].astype(np.float32),
                grp["ps"][i0:i1].astype(np.float32),
            ]
        )

    # -- transforms --------------------------------------------------------

    def _augment(self, events: np.ndarray, resolution, seed: int) -> np.ndarray:
        """Seeded H/V/polarity flips (reference h5dataset.py:559-578): one
        independent draw per mechanism from ``seed + offset``, so all windows
        sharing a seed flip identically."""
        cfg = self.config.augment
        xs, ys, ts, ps = events
        for offset, (mech, prob) in enumerate(zip(cfg.mechanisms, cfg.probabilities)):
            u = np.random.default_rng(seed + offset).random()
            if u >= prob:
                continue
            if mech == "Horizontal":
                xs = resolution[1] - 1 - xs
            elif mech == "Vertical":
                ys = resolution[0] - 1 - ys
            elif mech == "Polarity":
                ps = -ps
        return np.stack([xs, ys, ts, ps])

    def augment_frame(self, img: np.ndarray, seed: int) -> np.ndarray:
        """The same H/V flips on an ``[H, W(, C)]`` image (polarity ignored)."""
        cfg = self.config.augment
        for offset, (mech, prob) in enumerate(zip(cfg.mechanisms, cfg.probabilities)):
            u = np.random.default_rng(seed + offset).random()
            if u >= prob:
                continue
            if mech == "Horizontal":
                img = np.flip(img, 1)
            elif mech == "Vertical":
                img = np.flip(img, 0)
        return np.ascontiguousarray(img)

    @staticmethod
    def _normalize_ts(events: np.ndarray) -> np.ndarray:
        """ts -> [0, 1] within the window (reference base_dataset.py:24-31)."""
        if events.shape[1] == 0:
            return events
        ts = events[2]
        events = events.copy()
        events[2] = (ts - ts[0]) / (ts[-1] - ts[0] + 1e-6)
        return events

    def _noise_events(self, resolution, seed: int) -> np.ndarray:
        """Uniform spurious events appended to the window (reference
        h5dataset.py:623-634: x, y uniform, t = 1, p in {-1, +1})."""
        n = self.noise_events
        u = np.random.default_rng(seed).random((4, n))
        return np.stack(
            [
                np.floor(u[0] * resolution[1]).astype(np.float32),
                np.floor(u[1] * resolution[0]).astype(np.float32),
                np.ones(n, np.float32),
                (np.floor(u[3] * 2) * 2 - 1).astype(np.float32),
            ]
        )

    @staticmethod
    def _pad(events: np.ndarray, size: int) -> Tuple[np.ndarray, int]:
        n = events.shape[1]
        if n > size:
            raise ValueError(f"window of {n} events exceeds padded size {size}")
        out = np.zeros((4, size), np.float32)
        out[:, :n] = events
        return out, n

    # -- hot-pixel filter --------------------------------------------------

    @staticmethod
    def create_cnt_encoding(events: np.ndarray, resolution) -> np.ndarray:
        """``[2, H, W]`` float32 count image of ``[4, N]`` events
        (h5dataset.py:518-526): y flipped, out-of-range events dropped."""
        xs, ys, _, ps = _cpu_rows(events)
        return events_to_channels(xs, ys, ps, tuple(resolution)).numpy()

    def update_hot_mask(self, count_image: np.ndarray, max_px=100, min_obvs=5, max_rate=0.8):
        """Running hot-pixel mask over observed activity
        (reference h5dataset.py:528-548 + encodings.py:349-364)."""
        self.hot_events += (np.abs(count_image).sum(0) > 0).astype(np.float32)
        self.hot_idx += 1
        rate = self.hot_events / self.hot_idx
        mask = np.ones_like(rate)
        if self.hot_idx > min_obvs:
            flat = rate.reshape(-1)
            order = np.argsort(flat)[::-1][:max_px]
            hot = order[flat[order] > max_rate]
            mask.reshape(-1)[hot] = 0.0
        return mask

    def _apply_hot_filter(self, events: np.ndarray) -> np.ndarray:
        """Update the per-file running rate from this window's count image,
        then zero the polarity of events on masked pixels (every encoder
        ignores ``p == 0``, so shapes stay static).  The mask lives in
        y-flipped raster coordinates; the lookup flips accordingly."""
        hf = self.config.hot_filter
        res = self.layout.inp_resolution
        cnt = self.create_cnt_encoding(events, res)
        mask = self.update_hot_mask(cnt, hf.max_px, hf.min_obvs, hf.max_rate)
        xs, ys, _, ps = events
        xi = np.clip(xs.astype(np.int64), 0, res[1] - 1)
        yi = np.clip(res[0] - 1 - ys.astype(np.int64), 0, res[0] - 1)
        keep = mask[yi, xi] > 0
        out = events.copy()
        out[3] = np.where(keep, ps, 0.0)
        return out

    # -- items -------------------------------------------------------------

    def get_window(self, index: int, *, seed: Optional[int] = None, pause: bool = False) -> Dict:
        """One event window: ``inp_events [4, padded_window]``, ``inp_len``
        and ``gt_events [4, gt_window]``, ``gt_len`` (a ``[4, 1]`` zero
        sentinel without GT events).  ``seed`` drives augmentation and noise
        (a fresh one when ``None``); ``pause`` zeroes the input window."""
        if seed is None:
            seed = int(np.random.default_rng().integers(0, 2**31))
        cfg = self.config
        i0, i1 = self.event_indices[index]
        item: Dict = {}
        if pause:
            # zeroed input, same shapes (reference Pause, h5dataset.py:305-306)
            item["inp_events"], item["inp_len"] = np.zeros((4, self.padded_window), np.float32), 0
        else:
            ev = self._read_events(self.layout.inp_prefix, i0, i1)
            if cfg.hot_filter.enabled:
                ev = self._apply_hot_filter(ev)
            if cfg.augment.enabled:
                ev = self._augment(ev, self.layout.inp_resolution, seed)
            ev = self._normalize_ts(ev)
            if self.noise_events:
                noise = self._noise_events(self.layout.inp_resolution, seed + 17)
                ev = np.concatenate([ev, noise], axis=1)
            item["inp_events"], item["inp_len"] = self._pad(ev, self.padded_window)
        if cfg.need_gt_events:
            g0, g1 = self.gt_event_indices[index]
            gt = self._read_events(self.layout.gt_prefix, g0, g1)
            if cfg.augment.enabled:
                gt = self._augment(gt, self.layout.gt_resolution, seed)
            gt = self._normalize_ts(gt)
            item["gt_events"], item["gt_len"] = self._pad(gt, self.gt_window)
        else:
            item["gt_events"] = np.zeros((4, 1), np.float32)
            item["gt_len"] = 0
        if cfg.need_gt_frame and self.num_frames:
            item["gt_frame"] = self._gt_frame(i0, i1, seed)
        return item

    def _gt_frame(self, i0: int, i1: int, seed: int) -> np.ndarray:
        """The stored frame nearest the window's middle event (the first at
        or after its timestamp, clamped), flipped as the window, resized to
        the GT grid (bicubic, ``cv2``), ``[C, H, W]`` float32 in [0, 1]."""
        import cv2

        mid_ts = self.file[f"{self.layout.inp_prefix}_events/ts"][(i0 + i1) // 2]
        gi = int(np.searchsorted(self.frame_ts, mid_ts, "left"))
        gi = min(max(gi, 0), self.num_frames - 1)
        img = self.file[f"ori_images/{self.frame_names[gi]}"][:]
        if self.config.augment.enabled:
            img = self.augment_frame(img, seed)
        img = cv2.resize(img, dsize=tuple(self.layout.gt_resolution[::-1]),
                         interpolation=cv2.INTER_CUBIC).astype(np.float32) / 255.0
        return img[None] if img.ndim == 2 else img.transpose(2, 0, 1)

    # -- auxiliary encodings (reference h5dataset.py:425-516) ---------------

    @staticmethod
    def normalize_events(events: np.ndarray, resolution) -> np.ndarray:
        """(x, y) -> [0, 1] (``create_normalized_events``)."""
        out = np.asarray(events, np.float32).copy()
        out[0] = out[0] / resolution[1]
        out[1] = out[1] / resolution[0]
        return out

    def create_voxel_encoding(self, events: np.ndarray, resolution) -> np.ndarray:
        """``[time_bins, H, W]`` voxel grid."""
        xs, ys, ts, ps = _cpu_rows(events)
        return events_to_voxel(xs, ys, ts, ps, self.config.time_bins, tuple(resolution)).numpy()

    def create_stack_encoding(self, events: np.ndarray, resolution) -> np.ndarray:
        """``[time_bins, H, W]`` signed stack."""
        xs, ys, ts, ps = _cpu_rows(events)
        return events_to_stack_no_polarity(
            xs, ys, ts, ps, self.config.time_bins, tuple(resolution)).numpy()

    def create_scaled_encoding(self, normalized_events: np.ndarray, resolution, mode: str):
        """Normalized events at another resolution: a count image
        (``cnt``), a stack (``stack``) or the events with floored
        coordinates (``events``)."""
        ev = np.asarray(normalized_events, np.float32).copy()
        ev[0] = ev[0] * resolution[1]
        ev[1] = ev[1] * resolution[0]
        if mode == "cnt":
            return self.create_cnt_encoding(ev, resolution)
        if mode == "stack":
            return self.create_stack_encoding(ev, resolution)
        if mode == "events":
            ev[0] = np.floor(ev[0])
            ev[1] = np.floor(ev[1])
            return ev
        raise ValueError(f"mode {mode!r} is not supported")

    def create_unsupervised_data(self, normalized_events: np.ndarray):
        """Count pairs for unsupervised recipes: the events quantized to the
        down grid, counted there and at the input grid, each count divided
        by ``scale**2`` and truncated."""
        down_res = self.layout.inp_down_resolution
        ev = np.asarray(normalized_events, np.float32).copy()
        down = ev.copy()
        down[0] = np.floor(ev[0] * down_res[1])
        down[1] = np.floor(ev[1] * down_res[0])
        down_norm = self.normalize_events(down, down_res)
        s2 = self.config.scale**2
        inp_down_cnt = np.trunc(self.create_scaled_encoding(down_norm, down_res, "cnt") / s2)
        inp_down_scaled_cnt = np.trunc(
            self.create_scaled_encoding(down_norm, self.layout.inp_resolution, "cnt") / s2
        )
        return inp_down_cnt, inp_down_scaled_cnt

    def create_custom_data(self, inp_cnt, inp_scaled_cnt, inp_down_cnt, inp_down_scaled_cnt,
                           gt_cnt):
        """Every stream bicubic-resized to ``custom_resolution`` (times the
        stream's scale) and rounded."""
        if self.config.custom_resolution is None:
            raise ValueError("custom_resolution is not configured")
        cr = tuple(self.config.custom_resolution)
        s = self.config.scale

        def rz(img_chw, out_hw):
            x = torch.from_numpy(np.ascontiguousarray(img_chw, np.float32))
            return torch.round(resize_bicubic(x, tuple(out_hw), channel_last=False)).numpy()

        return (
            rz(inp_cnt, cr),
            rz(inp_scaled_cnt, (cr[0] * s, cr[1] * s)),
            rz(inp_down_cnt, (round(cr[0] / s), round(cr[1] / s))),
            rz(inp_down_scaled_cnt, cr),
            rz(gt_cnt, (cr[0] * s, cr[1] * s)),
        )

    @staticmethod
    def create_polarity_mask(ps: np.ndarray) -> np.ndarray:
        """``[N, 2]`` polarity mask: ``max(p, 0)`` and ``-min(p, 0)``."""
        return np.stack([np.maximum(ps, 0), -np.minimum(ps, 0)], axis=1)


class EventSequenceDataset:
    """Length-L temporal clips with optional stochastic pause replay.

    Parity: reference ``SequenceDataset`` (``h5dataset.py:637-700``) and
    ``bmcnet_esr_tpu/data/h5dataset.py:682-729``: clip i starts at window
    ``i * step_size``; one shared seed per clip (the clip rng's first draw)
    flips every window alike; when paused, the previous window index repeats
    with zeroed input; L clamps to the file length."""

    def __init__(self, h5_path: str, config: DatasetConfig):
        self.dataset = EventH5Dataset(h5_path, config)
        self.config = config
        seq = config.sequence
        self.L = seq.sequence_length
        self.step_size = seq.step_size if seq.step_size is not None else self.L
        if self.L >= len(self.dataset):
            self.length = 1
            self.L = len(self.dataset)
        else:
            self.length = (len(self.dataset) - self.L) // self.step_size + 1

    def __len__(self) -> int:
        return self.length

    def get_clip(self, i: int, *, seed: Optional[int] = None) -> List[Dict]:
        if not 0 <= i < self.length:
            raise IndexError(i)
        rng = np.random.default_rng(seed)
        shared_seed = int(rng.integers(0, 2**31))
        pause_cfg = self.config.sequence.pause

        j = i * self.step_size
        items = [self.dataset.get_window(j, seed=shared_seed)]
        k = 0
        paused = False
        for _ in range(self.L - 1):
            if pause_cfg.enabled:
                p = (pause_cfg.proba_pause_when_paused if paused
                     else pause_cfg.proba_pause_when_running)
                paused = rng.random() < p
            if paused:
                items.append(self.dataset.get_window(j + k, seed=shared_seed, pause=True))
            else:
                k += 1
                items.append(self.dataset.get_window(j + k, seed=shared_seed))
        return items
