"""Dataset generation CLI (reference ``generate_dataset/`` scripts): the JAX
package's ``cli/generate.py`` subcommands, ``demo`` with ``--device``.

    python -m bmcnet_esr_torch.cli.generate demo --device cuda  # h5s + datalists
    python -m bmcnet_esr_torch.cli.generate nfs --root_data_path /nfs --path_to_h5 /nfs/h5
    python -m bmcnet_esr_torch.cli.generate rgb ...
    python -m bmcnet_esr_torch.cli.generate eventzoom ...
    python -m bmcnet_esr_torch.cli.generate txt --txt in.txt --out out.h5 --resolution 180 240
    python -m bmcnet_esr_torch.cli.generate memmap --h5 in.h5 --out_dir mm/
    python -m bmcnet_esr_torch.cli.generate attr --h5 in.h5 --key sensor_resolution --value "[360,640]"
    python -m bmcnet_esr_torch.cli.generate inspect --h5 in.h5
"""

from __future__ import annotations

import argparse
import ast
import json


def main(argv=None):
    p = argparse.ArgumentParser(description="dataset generation tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser(
        "demo",
        help="self-contained quickstart: simulate tiny multi-scale h5 files "
        "and write datalist/{train,valid}_nfs.txt so the stock "
        "configs/train_nfs.yml recipe runs verbatim (data/demo.py)",
    )
    sp.add_argument("--out_dir", default="datalist/demo")
    sp.add_argument("--datalist_dir", default="datalist")
    sp.add_argument("--train_files", type=int, default=2)
    sp.add_argument("--valid_files", type=int, default=1)
    sp.add_argument("--frames", type=int, default=40)
    sp.add_argument("--resolution", nargs=2, type=int, default=(96, 128),
                    help="ori grid; the NFS recipe reads down8 input / "
                    "down2 GT derived from it")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                    help="where the simulator runs: cuda (default; fails without a GPU) or cpu")

    for preset in ("nfs", "rgb", "eventzoom"):
        sp = sub.add_parser(preset, help=f"synthesize {preset} multi-scale h5")
        sp.add_argument("--root_data_path", required=True)
        sp.add_argument("--path_to_h5", required=True)

    sp = sub.add_parser("txt", help="single txt -> h5")
    sp.add_argument("--txt", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--resolution", nargs=2, type=int, required=True)
    sp.add_argument("--prefix", default="ori")

    sp = sub.add_parser("memmap", help="h5 events -> raw memmaps")
    sp.add_argument("--h5", required=True)
    sp.add_argument("--out_dir", required=True)
    sp.add_argument("--prefix", default="ori")

    sp = sub.add_parser("attr", help="set an h5 attribute")
    sp.add_argument("--h5", required=True)
    sp.add_argument("--key", required=True)
    sp.add_argument("--value", required=True)

    sp = sub.add_parser("inspect", help="summarize an event h5")
    sp.add_argument("--h5", required=True)

    args = p.parse_args(argv)

    from bmcnet_esr_torch.data import synthesis

    if args.cmd == "demo":
        from bmcnet_esr_torch.data.demo import generate_demo

        summary = generate_demo(
            args.out_dir, args.datalist_dir,
            n_train=args.train_files, n_valid=args.valid_files,
            n_frames=args.frames, resolution=tuple(args.resolution),
            seed=args.seed, device=args.device,
        )
        print(json.dumps(summary, indent=2))
    elif args.cmd in ("nfs", "rgb", "eventzoom"):
        outs = synthesis.synthesize_dataset(args.root_data_path, args.path_to_h5, args.cmd)
        print(f"wrote {len(outs)} files")
    elif args.cmd == "txt":
        print(synthesis.txt_to_h5(args.txt, args.out, args.resolution, args.prefix))
    elif args.cmd == "memmap":
        print(json.dumps(synthesis.h5_to_memmap(args.h5, args.out_dir, args.prefix)))
    elif args.cmd == "attr":
        try:
            value = ast.literal_eval(args.value)
        except (ValueError, SyntaxError):
            value = args.value
        synthesis.add_hdf5_attribute(args.h5, args.key, value)
        print("ok")
    elif args.cmd == "inspect":
        print(json.dumps(synthesis.read_events_summary(args.h5), indent=2))


if __name__ == "__main__":
    main()
