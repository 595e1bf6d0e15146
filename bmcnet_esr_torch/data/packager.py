"""Multi-scale event HDF5 writer (schema-compatible with the reference).

Produces the exact on-disk layout the reference datasets use
(``generate_dataset/tools/event_packagers.py:119-224``):

* groups ``{prefix}_events/{xs, ys, ts, ps}`` for each scale prefix in
  ``{ori, down2, down4, down8, down16}`` (plus ``down8_real`` for EventZoom),
  dtypes int16 / int16 / float64 / float64, chunked and append-resizable;
* optional ``{type}_images/image{:09d}`` uint8 datasets with a ``timestamp``
  attribute and per-image ``{prefix}_event_idx`` attributes;
* file attribute ``sensor_resolution`` = [H, W] of the ``ori`` scale.

Files written here load in *either* framework, which is the compatibility
contract that lets a reference user switch over without regenerating data.

Counterpart of ``bmcnet_esr_tpu/data/packager.py``; ``h5py`` is imported when
a file is created, so the package imports without it.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np

SCALE_PREFIXES = ("ori", "down2", "down4", "down8", "down16")

_EVENT_SPECS = (
    ("xs", np.int16),
    ("ys", np.int16),
    ("ts", np.float64),
    ("ps", np.float64),
)


class MultiScaleEventPackager:
    """Append-oriented writer for multi-scale event h5 files."""

    def __init__(self, output_path: str, chunk_size: int = 10000):
        import h5py

        self.file = h5py.File(output_path, "w")
        self.chunk_size = chunk_size
        self._event_dsets: Dict[str, Dict] = {}
        self._image_counters: Dict[str, int] = {}

    # -- events ------------------------------------------------------------

    def _ensure_event_group(self, prefix: str) -> Dict:
        if prefix not in self._event_dsets:
            grp = self.file.require_group(f"{prefix}_events")
            dsets = {}
            for name, dtype in _EVENT_SPECS:
                dsets[name] = grp.create_dataset(
                    name,
                    shape=(0,),
                    maxshape=(None,),
                    dtype=dtype,
                    chunks=(self.chunk_size,),
                    compression=None,
                )
            self._event_dsets[prefix] = dsets
        return self._event_dsets[prefix]

    def append_events(
        self,
        prefix: str,
        xs: np.ndarray,
        ys: np.ndarray,
        ts: np.ndarray,
        ps: np.ndarray,
    ) -> None:
        """Append an event chunk ``(x, y, t, p)`` to ``{prefix}_events``.

        Polarity convention on disk is ``{-1, +1}`` (the synthesis scripts map
        simulator ``{0, 1}`` to that before packaging, ``syn_nfs.py:22-25``).
        """
        dsets = self._ensure_event_group(prefix)
        arrays = dict(zip(("xs", "ys", "ts", "ps"), (xs, ys, ts, ps)))
        n = len(xs)
        for name, arr in arrays.items():
            d = dsets[name]
            old = d.shape[0]
            d.resize((old + n,))
            d[old:] = np.asarray(arr, d.dtype)

    def num_events(self, prefix: str) -> int:
        grp = self.file.get(f"{prefix}_events")
        return 0 if grp is None else grp["ts"].shape[0]

    # -- images ------------------------------------------------------------

    def append_image(self, kind: str, image: np.ndarray, timestamp: float) -> None:
        """Store ``{kind}_images/image{idx:09d}`` with its timestamp attr."""
        grp = self.file.require_group(f"{kind}_images")
        idx = self._image_counters.get(kind, 0)
        d = grp.create_dataset(f"image{idx:09d}", data=np.asarray(image, np.uint8))
        d.attrs["size"] = image.shape
        d.attrs["timestamp"] = timestamp
        d.attrs["type"] = "greyscale" if image.ndim == 2 else "color_bgr"
        self._image_counters[kind] = idx + 1
        grp.attrs["num_images"] = idx + 1

    def annotate_image_event_indices(self, kind: str, prefix: str) -> None:
        """Attach per-image ``{prefix}_event_idx`` attrs: index of the first
        event at-or-after each image timestamp (reference
        ``event_packagers.py:200-219`` semantics)."""
        grp = self.file.get(f"{kind}_images")
        ev = self.file.get(f"{prefix}_events")
        if grp is None or ev is None:
            return
        ts = ev["ts"][:]
        for name in grp:
            t = grp[name].attrs["timestamp"]
            grp[name].attrs[f"{prefix}_event_idx"] = int(np.searchsorted(ts, t, "left"))

    # -- metadata ----------------------------------------------------------

    def set_sensor_resolution(self, resolution: Sequence[int]) -> None:
        self.file.attrs["sensor_resolution"] = np.asarray(resolution, np.int64)

    def set_metadata(self, **attrs) -> None:
        for k, v in attrs.items():
            self.file.attrs[k] = v

    def close(self) -> None:
        self.file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_synthetic_fixture(
    path: str,
    sensor_resolution: Sequence[int] = (64, 96),
    prefixes: Iterable[str] = ("ori", "down2", "down4"),
    events_per_scale: Optional[Dict[str, int]] = None,
    seed: int = 0,
    t_span: float = 1.0,
) -> str:
    """Fabricate a tiny multi-scale h5 file for tests.

    Event density scales down by the square of the scale factor, mirroring
    real multi-scale simulation output so count-based GT alignment
    (``h5dataset.py:362-390`` semantics) is exercised realistically.
    """
    rng = np.random.default_rng(seed)
    h, w = sensor_resolution
    with MultiScaleEventPackager(path) as pk:
        pk.set_sensor_resolution(sensor_resolution)
        for prefix in prefixes:
            factor = 1 if prefix == "ori" else int(prefix.replace("down", "").replace("_real", ""))
            ph, pw = round(h / factor), round(w / factor)
            if events_per_scale and prefix in events_per_scale:
                n = events_per_scale[prefix]
            else:
                n = int(4000 / factor**2)
            ts = np.sort(rng.random(n)) * t_span
            pk.append_events(
                prefix,
                rng.integers(0, pw, n),
                rng.integers(0, ph, n),
                ts,
                rng.integers(0, 2, n) * 2 - 1,
            )
    return path
