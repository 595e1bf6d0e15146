"""Inference CLI: the JAX package's ``cli/infer.py`` flags plus ``--device``.

    python -m bmcnet_esr_torch.cli.infer --infer_mode 1 \\
        --model_path pretrain/BMCNet_plain_nfs_x4.pth --variant plain \\
        --data_list datalist/valid_nfs.txt --output_path out/ \\
        --scale 4 --ori_scale down16 --window 2048 --sliding_window 1024 \\
        --device cuda

The rollout is the stride-1 stateful pass of the reference scripts;
``--seql`` and ``--step_size`` are accepted for interface parity and do not
change its outputs.  ``--dtype int8*`` runs the int8 serving modes (static
scales calibrated on each file's first windows).  ``--ema`` and
``--mesh_devices > 1`` are not ported yet and exit naming their ROADMAP.md
item.
"""

from __future__ import annotations

import argparse
import os

from bmcnet_esr_torch.inference.engine import DTYPES, INT8_DTYPES


def build_dataset_config(args):
    from bmcnet_esr_torch.data import DatasetConfig, SequenceConfig

    return DatasetConfig(
        scale=args.scale,
        ori_scale=args.ori_scale,
        window=args.window,
        sliding_window=args.sliding_window,
        mode=args.mode,
        time_bins=args.time_bins,
        need_gt_events=args.need_gt_events,
        need_gt_frame=args.need_gt_frame,
        real_world_test=args.real_world_test,
        sequence=SequenceConfig(
            sequence_length=args.seql, seqn=args.seqn, step_size=args.step_size
        ),
    )


def main(argv=None):
    p = argparse.ArgumentParser(description="bmcnet_esr_torch inference")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--data_list", type=str, default=None)
    p.add_argument("--infer_mode", type=int, default=1, choices=[0, 1, 2])
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--variant", type=str, default="full", choices=["full", "plain"])
    p.add_argument("--n_c", type=int, default=128)
    p.add_argument("--n_b", type=int, default=5)
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--seqn", type=int, default=2)
    p.add_argument("--seql", type=int, default=9)
    p.add_argument("--step_size", type=int, default=1)
    p.add_argument("--time_bins", type=int, default=1)
    p.add_argument("--ori_scale", type=str, default="down4")
    p.add_argument("--mode", type=str, default="events")
    p.add_argument("--window", type=int, default=2048)
    p.add_argument("--sliding_window", type=int, default=1024)
    p.add_argument("--need_gt_frame", action="store_true")
    p.add_argument("--need_gt_events", action="store_true")
    p.add_argument("--real_world_test", action="store_true")
    p.add_argument("--chunk_size", type=int, default=32)
    p.add_argument("--mesh_devices", type=int, default=0,
                   help="not ported yet: values above 1 exit (ROADMAP.md Queue 1 item 8)")
    p.add_argument("--batch_streams", type=int, default=1,
                   help="roll out N same-resolution files as one batch (skips PNGs)")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=list(DTYPES) + list(INT8_DTYPES),
                   help="float32 = parity path (TF32 off); bfloat16 = serving path "
                        "(rel-RMSE < 5e-2 against float32); int8* = W8A8 serving modes "
                        "(the same bound)")
    p.add_argument("--no_images", action="store_true", help="skip PNG streams")
    p.add_argument("--ema", action="store_true",
                   help="not ported yet: needs Orbax train-state checkpoints")
    p.add_argument("--psnr", action="store_true", help="also track PSNR")
    p.add_argument("--ssim", action="store_true", help="also track SSIM")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; fails without a GPU) or cpu")
    args = p.parse_args(argv)

    if args.mesh_devices > 1:
        raise SystemExit("--mesh_devices > 1: sharded rollouts are not ported yet "
                         "(ROADMAP.md Queue 1 item 8)")
    if args.ema:
        raise SystemExit("--ema: Orbax train-state checkpoints are not ported yet "
                         "(ROADMAP.md Queue 1 item 7)")
    if args.seqn != 2:
        # the models read only the first two windows of a seqn-window
        print(f"note: seqn={args.seqn} behaves identically to seqn=2 "
              "(the model consumes two windows per step)")
    if args.infer_mode != 1:
        raise SystemExit(f"infer mode {args.infer_mode} not supported (reference parity)")
    if not args.model_path or not os.path.isfile(args.model_path):
        raise SystemExit("--model_path must point to a .pth or .npz checkpoint")

    if args.data_list:
        with open(args.data_list) as f:
            paths = [line.strip() for line in f if line.strip()]
    elif args.data_path:
        paths = [args.data_path]
    else:
        raise SystemExit("pass --data_list or --data_path")

    from bmcnet_esr_torch.inference import InferenceEngine, load_model_for_inference

    model = load_model_for_inference(
        args.model_path, args.scale, args.n_c, args.n_b, args.variant,
        dtype=args.dtype, device=args.device,
    )
    extra = tuple(m for m, on in (("psnr", args.psnr), ("ssim", args.ssim)) if on)
    engine = InferenceEngine(
        model,
        build_dataset_config(args),
        chunk_size=args.chunk_size,
        visualize=not args.no_images,
        extra_metrics=extra,
        device=args.device,
    )
    out = engine.infer_datalist(
        paths, args.output_path, model_desc=args.model_path,
        batch_streams=args.batch_streams,
    )
    print("mean results:", out["mean"])
    return out


if __name__ == "__main__":
    main()
