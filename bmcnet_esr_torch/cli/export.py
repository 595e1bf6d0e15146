"""Export a serving bundle (``torch.export`` step with its weights + metadata).

    python -m bmcnet_esr_torch.cli.export \\
        --model_path pretrain/BMCNet_plain_nfs_x4.pth --variant plain \\
        --scale 4 --height 45 --width 80 --window 2048 \\
        --output_path out/bundle --device cuda

The JAX package's ``cli/export.py`` flags, with ``--device`` in place of
``--platforms``: a ``torch.export`` program runs on the device it was
traced on, so export on the device you serve from.  The bundle serves a
live event stream with :class:`bmcnet_esr_torch.inference.export.
ExportedStream`, without the model code.  The checkpoint may be a ``.pth``,
an ``.npz`` or a training checkpoint directory of the port.
"""

from __future__ import annotations

import argparse

from bmcnet_esr_torch.inference.engine import DTYPES, INT8_DTYPES, load_model_for_inference
from bmcnet_esr_torch.inference.export import export_serving_bundle
from bmcnet_esr_torch.models import calibrate_from_h5


def main(argv=None):
    p = argparse.ArgumentParser(description="bmcnet_esr_torch serving-bundle export")
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--variant", type=str, default="full", choices=["full", "plain"])
    p.add_argument("--n_c", type=int, default=128)
    p.add_argument("--n_b", type=int, default=5)
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--height", type=int, required=True, help="input (LR) height")
    p.add_argument("--width", type=int, required=True, help="input (LR) width")
    p.add_argument("--window", type=int, default=2048, help="events per window")
    p.add_argument("--batch", type=int, default=1, help="parallel stream lanes")
    p.add_argument(
        "--dtype", type=str, default="float32", choices=list(DTYPES) + list(INT8_DTYPES),
        help="serving compute mode; int8 uses per-lane dynamic activation scales unless "
        "--calib_h5 bakes static ones into the bundle (no per-call max pass)",
    )
    p.add_argument(
        "--calib_h5", type=str, default=None,
        help="int8 only: h5 file (packager schema) whose first windows calibrate static "
        "activation scales baked into the bundle",
    )
    p.add_argument("--calib_group", type=str, default="ori",
                   help="event-group prefix inside --calib_h5 (e.g. ori, down8)")
    p.add_argument("--calib_windows", type=int, default=16,
                   help="windows of --window events used for calibration")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to trace and serve on (cuda or cpu): the program runs there")
    args = p.parse_args(argv)

    model = load_model_for_inference(
        args.model_path, scale=args.scale, n_c=args.n_c, n_b=args.n_b,
        variant=args.variant, dtype=args.dtype, device=args.device,
    )
    if args.dtype.startswith("int8") and args.calib_h5:
        calibrate_from_h5(model, args.calib_h5, args.calib_group, (args.height, args.width),
                          args.window, args.calib_windows)
    out = export_serving_bundle(
        model, None, args.output_path, (args.height, args.width),
        window_size=args.window, batch=args.batch, device=args.device,
    )
    print(f"wrote serving bundle: {out}")
    return out


if __name__ == "__main__":
    main()
