"""Offline dataset synthesis: simulator event dumps -> multi-scale h5.

Counterpart of ``bmcnet_esr_tpu/data/synthesis.py`` (the reference's
``generate_dataset/{syn_nfs,syn_RGB,convert_eventzoom}.py`` and tools),
numpy, pandas and ``h5py`` on the host.  DVS-Voltmeter event dumps are
whitespace text files ``t x y p`` with ``p`` in {0, 1} and one header row;
packaging maps ``p`` to {-1, +1} and reorders to (x, y, t, p).

Dataset presets (directory -> h5 group prefix, sensor resolution) are the
reference's relabelings; the simulator's scale names shift one level up on
disk (NFS: simulated ``down2`` becomes the ``ori`` group):

=========  =====================================================  ==========
preset     directory -> prefix mapping                            resolution
=========  =====================================================  ==========
nfs        down2->ori, down4->down2, down8->down4, down16->down8  (360, 640)
rgb        down2->ori, down4->down2, down8->down4                 (720, 760)
eventzoom  ev_hr->ori, ev_lr_1->down2, ev_llr_1->down4            (124, 222)
=========  =====================================================  ==========
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, List, Sequence, Tuple

import numpy as np

from bmcnet_esr_torch.data.packager import MultiScaleEventPackager

PRESETS: Dict[str, Dict] = {
    "nfs": {
        "mapping": [("down2", "ori"), ("down4", "down2"), ("down8", "down4"), ("down16", "down8")],
        "resolution": (360, 640),
    },
    "rgb": {
        "mapping": [("down2", "ori"), ("down4", "down2"), ("down8", "down4")],
        "resolution": (720, 760),
    },
    "eventzoom": {
        "mapping": [("ev_hr", "ori"), ("ev_lr_1", "down2"), ("ev_llr_1", "down4")],
        "resolution": (124, 222),
    },
}


def read_simulator_txt(path: str, skiprows: int = 1) -> np.ndarray:
    """Read a DVS-Voltmeter dump -> ``[N, 4]`` (x, y, t, p) with p in {-1,+1}."""
    import pandas as pd

    df = pd.read_csv(
        path,
        sep=r"\s+",
        header=None,
        names=["t", "x", "y", "pol"],
        dtype={"t": np.float64, "x": np.int32, "y": np.int32, "pol": np.float64},
        engine="c",
        skiprows=skiprows,
    )
    t = df["t"].to_numpy()
    x = df["x"].to_numpy().astype(np.float64)
    y = df["y"].to_numpy().astype(np.float64)
    p = df["pol"].to_numpy()
    p = np.where(p == 0, -1.0, p)
    return np.stack([x, y, t, p], axis=1)


def package_sequence(
    txt_paths_by_prefix: Sequence[Tuple[str, str]],
    out_path: str,
    resolution: Sequence[int],
    chunk: int = 1_000_000,
) -> str:
    """Write one multi-scale h5 from per-scale txt dumps."""
    with MultiScaleEventPackager(out_path) as pk:
        pk.set_sensor_resolution(resolution)
        for txt_path, prefix in txt_paths_by_prefix:
            events = read_simulator_txt(txt_path)
            for start in range(0, len(events), chunk):
                e = events[start : start + chunk]
                pk.append_events(prefix, e[:, 0], e[:, 1], e[:, 2], e[:, 3])
    return out_path


def synthesize_dataset(
    root_data_path: str,
    path_to_h5: str,
    preset: str = "nfs",
) -> List[str]:
    """Convert every aligned txt sequence under ``root_data_path``."""
    if preset not in PRESETS:
        raise KeyError(f"unknown preset {preset!r}; have {list(PRESETS)}")
    cfg = PRESETS[preset]
    mapping = cfg["mapping"]

    per_dir = []
    for dirname, _ in mapping:
        d = os.path.join(root_data_path, dirname)
        if not os.path.isdir(d):
            raise FileNotFoundError(d)
        per_dir.append(sorted(glob(os.path.join(d, "*.txt"))))
    counts = {len(files) for files in per_dir}
    if len(counts) != 1:
        raise ValueError(f"unaligned sequence counts across scales: {counts}")

    os.makedirs(path_to_h5, exist_ok=True)
    outputs = []
    for seq_files in zip(*per_dir):
        names = {os.path.basename(f) for f in seq_files}
        if len(names) != 1:
            raise ValueError(f"sequence name mismatch: {names}")
        out = os.path.join(
            path_to_h5, os.path.basename(seq_files[0]).rsplit(".", 1)[0] + ".h5"
        )
        package_sequence(
            list(zip(seq_files, (prefix for _, prefix in mapping))),
            out,
            cfg["resolution"],
        )
        outputs.append(out)
    return outputs


def txt_to_h5(txt_path: str, out_path: str, resolution: Sequence[int], prefix="ori") -> str:
    """Single-scale txt -> h5 (reference ``tools/txt_to_h5.py``)."""
    return package_sequence([(txt_path, prefix)], out_path, resolution)


def h5_to_memmap(h5_path: str, out_dir: str, prefix: str = "ori") -> Dict[str, str]:
    """Export event arrays as raw memmaps (reference ``tools/h5_to_memmap.py``)."""
    import h5py

    os.makedirs(out_dir, exist_ok=True)
    out = {}
    with h5py.File(h5_path, "r") as f:
        grp = f[f"{prefix}_events"]
        for name in ("xs", "ys", "ts", "ps"):
            arr = grp[name][:]
            path = os.path.join(out_dir, f"{prefix}_{name}.dat")
            mm = np.memmap(path, dtype=arr.dtype, mode="w+", shape=arr.shape)
            mm[:] = arr
            mm.flush()
            out[name] = path
        with open(os.path.join(out_dir, f"{prefix}_meta.txt"), "w") as meta:
            meta.write(f"n={grp['ts'].shape[0]} dtypes=int16,int16,f8,f8\n")
    return out


def add_hdf5_attribute(h5_path: str, key: str, value) -> None:
    """In-place attribute edit (reference ``tools/add_hdf5_attribute.py``)."""
    import h5py

    with h5py.File(h5_path, "a") as f:
        f.attrs[key] = value


def read_events_summary(h5_path: str) -> Dict[str, Dict]:
    """Quick inspection summary (reference ``tools/read_events.py``)."""
    import h5py

    out = {}
    with h5py.File(h5_path, "r") as f:
        out["attrs"] = {k: np.asarray(v).tolist() for k, v in f.attrs.items()}
        for name in f:
            if name.endswith("_events"):
                ts = f[name]["ts"]
                out[name] = {
                    "num_events": int(ts.shape[0]),
                    "t0": float(ts[0]) if ts.shape[0] else None,
                    "tk": float(ts[-1]) if ts.shape[0] else None,
                }
    return out
