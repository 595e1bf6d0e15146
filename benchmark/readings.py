"""The readings a cell's limits are set from, on the chip, in one process.

``python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 --seconds <s>
[--control | --fault <name>] [--out <file>]`` runs the cell once a seed, as
``run.py`` does but without the chip checks and in one process (the kernels
build once), and prints each run's compared numbers, ``correct`` and
end-to-end metrics as a JSON line.  ``--control`` runs the cell's
lower-precision control instead of the program: the overrides under
``control`` in the cell's file.  ``--fault`` plants a fault of
:data:`FAULTS` in the program.  The benchmark's own runs never run either."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402


def _stuck_state() -> None:
    """Every step of the model returns the recurrent state it was given."""
    from bmcnet_esr_torch.models import bmcnet

    forward = bmcnet._Model.forward

    def stuck(self, x, *states):
        out = forward(self, x, *states)
        return (*states[:-1], out[-1])

    bmcnet._Model.forward = stuck


FAULTS = {"stuck_state": _stuck_state}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted(FAULTS), default=None)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    harness._environment()
    overrides = None
    if args.control:
        overrides = harness.cell_files(args.workload)["cell"]["control"]
    if args.fault:
        FAULTS[args.fault]()
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.monotonic()
        r = harness.run_cell(args.workload, seed, args.seconds, bool(args.trace),
                             overrides=overrides, t_start=t0)
        run = r.pop("_run")
        row = {"workload": args.workload, "seed": seed, "control": args.control,
               "fault": args.fault, "correct": r["correct"], "failed": r["failed"], "attempted": r["attempted"],
               "checks": {k: v["value"] for k, v in r["checks"].items()},
               "metrics": {k: v["value"] for k, v in r["metrics"].items()},
               "peak": r["device"]["memory_peak_bytes"], "notes": run.get("notes", []),
               "counters": run.get("counters")}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
