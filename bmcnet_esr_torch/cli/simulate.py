"""Video -> multi-scale event h5 simulator CLI: the JAX package's
``cli/simulate.py`` flags plus ``--device``.

Replaces the external DVS-Voltmeter step of the reference's synthetic-data
chain (frames -> DVS-Voltmeter -> per-scale ``.txt`` -> ``syn_nfs.py`` ->
h5) with one command::

    python -m bmcnet_esr_torch.cli.simulate \
        --frames "video_frames/*.png" --fps 240 \
        --scales 2,4,8,16 --prefixes ori,down2,down4,down8 \
        --out_h5 seq.h5 --contrast 0.15 --noise_rate 0.1 --device cuda

``--txt_dir`` instead (or as well) writes DVS-Voltmeter-layout ``.txt``
dumps for the ``cli.generate`` presets.  Image frames are read with ``cv2``.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def load_frames(spec: str) -> np.ndarray:
    """``.npy`` video [T, H, W], or a directory / glob of image files."""
    if spec.endswith(".npy"):
        frames = np.load(spec)
        if frames.ndim == 4:  # [T, H, W, C] -> grayscale
            frames = frames.mean(-1).astype(frames.dtype)
        return frames
    paths = sorted(glob.glob(os.path.join(spec, "*")) if os.path.isdir(spec) else glob.glob(spec))
    if not paths:
        raise FileNotFoundError(f"no frames match {spec!r}")
    import cv2

    frames = [cv2.imread(p, cv2.IMREAD_GRAYSCALE) for p in paths]
    bad = [p for p, f in zip(paths, frames) if f is None]
    if bad:
        raise ValueError(f"unreadable frames: {bad[:3]}")
    return np.stack(frames)


def main(argv=None):
    p = argparse.ArgumentParser(description="video -> event-stream simulator")
    p.add_argument("--frames", required=True, help=".npy video or image dir/glob")
    p.add_argument("--fps", type=float, default=240.0)
    p.add_argument("--scales", default="1,2,4,8", help="comma-separated downsample factors")
    p.add_argument("--prefixes", default=None, help="h5 prefixes per scale (default ori,downN,...)")
    p.add_argument("--out_h5", default=None)
    p.add_argument("--txt_dir", default=None)
    p.add_argument("--store_frames", action="store_true", help="keep ori frames + event-idx attrs in the h5")
    p.add_argument("--contrast", type=float, default=0.15)
    p.add_argument("--sigma", type=float, default=0.0, help="per-pixel threshold mismatch fraction")
    p.add_argument("--refractory_us", type=float, default=0.0)
    p.add_argument("--noise_rate", type=float, default=0.0, help="per-pixel background Hz")
    p.add_argument("--hot_fraction", type=float, default=0.0)
    p.add_argument("--hot_gain", type=float, default=100.0)
    p.add_argument("--leak_rate", type=float, default=0.0)
    p.add_argument("--max_events_per_pixel", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; fails without a GPU) or cpu")
    args = p.parse_args(argv)

    if args.out_h5 is None and args.txt_dir is None:
        p.error("at least one of --out_h5 / --txt_dir is required")

    from bmcnet_esr_torch.data.simulator import SimulatorConfig, simulate_multiscale

    frames = load_frames(args.frames)
    timestamps = np.arange(len(frames), dtype=np.float64) / args.fps
    scales = [int(s) for s in args.scales.split(",") if s]
    prefixes = args.prefixes.split(",") if args.prefixes else None
    cfg = SimulatorConfig(
        contrast_threshold=args.contrast,
        threshold_sigma=args.sigma,
        refractory_s=args.refractory_us * 1e-6,
        max_events_per_pixel=args.max_events_per_pixel,
        noise_rate_hz=args.noise_rate,
        hot_pixel_fraction=args.hot_fraction,
        hot_pixel_gain=args.hot_gain,
        leak_rate_hz=args.leak_rate,
        seed=args.seed,
    )
    streams = simulate_multiscale(
        frames,
        timestamps,
        scales=scales,
        prefixes=prefixes,
        config=cfg,
        out_h5=args.out_h5,
        txt_dir=args.txt_dir,
        store_frames=args.store_frames,
        device=args.device,
    )
    for prefix, ev in streams.items():
        print(f"{prefix}: {len(ev)} events")
    if args.out_h5:
        print(f"wrote {args.out_h5}")


if __name__ == "__main__":
    main()
