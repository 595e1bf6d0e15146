"""Self-contained quickstart dataset: the README's commands work on a fresh
clone.

Counterpart of ``bmcnet_esr_tpu/data/demo.py``::

    python -m bmcnet_esr_torch.cli.generate demo --device cuda

renders a short high-contrast video per file, simulates correlated
multi-scale event streams from it (``down2`` and ``down8``, the two groups
the NFS x4 recipe reads: input at ``ori_scale: down8``, GT events at
down8 / 4 = down2), writes packager-schema h5 files and points
``{datalist_dir}/{train,valid}_nfs.txt`` at them.  The default video is
small (a 96x128 ori grid, 12x16 down8 input), so the full-model recipe
steps in seconds on a CPU; the scales are downsamples of the same video, so
the SR task is learnable.  Each file is checked against the NFS loader
settings (window 2048, sliding 1024, 9-window clips) before the datalists
are written.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np

# the NFS recipe constants the demo must satisfy (configs/train_nfs.yml)
_NFS_SCALE = 4
_NFS_ORI_SCALE = "down8"
_NFS_WINDOW = 2048
_NFS_SLIDING = 1024
_NFS_SEQ_LEN = 9
_NFS_SEQN = 2
_NFS_BATCH = 2


def demo_video(
    n_frames: int, resolution: Tuple[int, int], seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """A short synthetic clip with broadband, moving content: two drifting
    sinusoidal plaids and an orbiting Gaussian blob, so every downscale of
    the same video still drives the simulator, at a steady event rate.
    Returns ``(frames [T, H, W] float32 in [0, 1], timestamps [T] s)`` at
    80 frames a second."""
    h, w = resolution
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, 3)
    frames = np.empty((n_frames, h, w), np.float32)
    for i in range(n_frames):
        t = i / n_frames
        # fast drift: every pixel crosses several thresholds an interval, so
        # a 12x16 down8 grid sustains the recipe's 2048-event windows
        g1 = np.sin(2 * np.pi * (xx / 16 + yy / 24 + 6 * t) + ph[0])
        g2 = np.sin(2 * np.pi * (xx / 9 - yy / 13 - 4 * t) + ph[1])
        cy = h * (0.35 + 0.3 * np.sin(2 * np.pi * t + ph[2]))
        cx = w * (0.5 + 0.3 * np.cos(2 * np.pi * t))
        blob = np.exp(-(((yy - cy) / (h * 0.15)) ** 2 + ((xx - cx) / (w * 0.15)) ** 2))
        frames[i] = np.clip(0.5 + 0.28 * g1 + 0.18 * g2 + 0.4 * (blob - 0.2), 0.02, 0.98)
    timestamps = np.arange(n_frames, dtype=np.float64) / 80.0
    return frames, timestamps


def _count_nfs_clips(h5_path: str) -> int:
    """Clips this file yields under the NFS recipe's loader settings."""
    from bmcnet_esr_torch.data.h5dataset import (
        DatasetConfig,
        EventSequenceDataset,
        SequenceConfig,
    )

    cfg = DatasetConfig(
        scale=_NFS_SCALE, ori_scale=_NFS_ORI_SCALE, window=_NFS_WINDOW,
        sliding_window=_NFS_SLIDING, need_gt_events=True, mode="events", time_bins=1,
        sequence=SequenceConfig(sequence_length=_NFS_SEQ_LEN, seqn=_NFS_SEQN, step_size=None),
    )
    ds = EventSequenceDataset(h5_path, cfg)
    if ds.L < _NFS_SEQ_LEN:  # too few windows: the clip length was clamped
        return 0
    return len(ds)


def generate_demo(
    out_dir: str,
    datalist_dir: str = "datalist",
    n_train: int = 2,
    n_valid: int = 1,
    n_frames: int = 40,
    resolution: Sequence[int] = (96, 128),
    seed: int = 0,
    device="cuda",
) -> Dict[str, object]:
    """Write the quickstart h5 files and the NFS datalists, simulating on
    ``device``; returns a summary.  Raises, naming the remedy (more frames),
    when a file would yield fewer clips than a training batch needs: the
    check runs the port's dataset layer on each file."""
    from bmcnet_esr_torch.data.simulator import SimulatorConfig, simulate_multiscale

    if n_train < 1 or n_valid < 1:
        raise RuntimeError(
            "generate_demo needs n_train >= 1 and n_valid >= 1 "
            f"(got {n_train}, {n_valid}): the stock recipe reads both lists"
        )
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(datalist_dir, exist_ok=True)
    files: Dict[str, list] = {"train": [], "valid": []}
    summary: Dict[str, object] = {"files": {}}
    idx = 0
    for split, count in (("train", n_train), ("valid", n_valid)):
        for j in range(count):
            path = os.path.abspath(os.path.join(out_dir, f"demo_{split}_{j}.h5"))
            frames, ts = demo_video(n_frames, tuple(resolution), seed + idx)
            # down2 carries the GT events (x4 from down8); the noise stays
            # off so the streams are driven by the video alone
            streams = simulate_multiscale(
                frames, ts, scales=(2, 8), prefixes=("down2", "down8"),
                config=SimulatorConfig(seed=seed + idx), out_h5=path, device=device,
            )
            clips = _count_nfs_clips(path)
            need = _NFS_BATCH if split == "train" else 1
            if clips < need:
                raise RuntimeError(
                    f"{path}: only {clips} NFS-recipe clips "
                    f"(need >= {need}); regenerate with more --frames "
                    f"(got {n_frames}; events down8={len(streams['down8'])}, "
                    f"down2={len(streams['down2'])})"
                )
            files[split].append(path)
            summary["files"][os.path.basename(path)] = {
                "clips": clips,
                "events_down8": int(len(streams["down8"])),
                "events_down2": int(len(streams["down2"])),
                "mbytes": round(os.path.getsize(path) / 1e6, 2),
            }
            idx += 1
    train_txt = os.path.join(datalist_dir, "train_nfs.txt")
    valid_txt = os.path.join(datalist_dir, "valid_nfs.txt")
    with open(train_txt, "w") as f:
        f.write("\n".join(files["train"]) + "\n")
    with open(valid_txt, "w") as f:
        f.write("\n".join(files["valid"]) + "\n")
    summary["train_datalist"] = train_txt
    summary["valid_datalist"] = valid_txt
    return summary
