"""The benchmark's driver: finds a cell's files by name, runs its mode and prints the result.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

Everything that belongs to one cell, configuration, traffic mix or metric is
a file of its own, found by name:

* ``benchmark/workloads/<cell>.json``: the configuration, the traffic mix,
  the mode and the mode's settings;
* ``benchmark/configs/<config>.json``: the model, its shapes and the
  precision it is served in;
* ``benchmark/mixes/<traffic>.json``: the traffic generator's parameters;
* ``benchmark/modes/<mode>.py``: how a cell of that mode runs the program;
* ``benchmark/metrics/<metric>.py``: how a per-layer metric is read.

``BENCHMARK.json`` at the root says which metrics a cell reports.  The last
line of standard output is one JSON object; the numbers that decide
``correct`` close standard error, each beside its limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "bmcnet_esr_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "bmcnet_esr_tpu")
CACHE = os.path.join(ROOT, ".bench_cache")


class Refused(RuntimeError):
    """A run that must print no result (exit status 2)."""


def load_json(*parts: str) -> Dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def cell_files(workload: str) -> Dict:
    """The cell's own file with its configuration and traffic mix merged in:
    ``{"cell", "config", "mix", "mode", "settings"}``.  The cell's
    ``traffic_params`` override the mix's parameters, and its ``settings``
    add to the configuration's (the precision it is served in)."""
    cell = load_json("workloads", f"{workload}.json")
    config = load_json("configs", f"{cell['config']}.json")
    mix = load_json("mixes", f"{cell['traffic']}.json")
    mix = {**mix, **cell.get("traffic_params", {})}
    return {"cell": cell, "config": config, "mix": mix, "mode": cell["mode"],
            "settings": {**config.get("settings", {}), **cell.get("settings", {})}}


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole: ``bmcnet_esr_torch`` is not
    ``bmcnet_esr_tpu``, and ``jaxtyping`` is not ``jax``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def spec_metrics(workload: str, kind: str) -> List[Dict]:
    """The ``kind`` (``end_to_end`` / ``per_layer``) metrics of
    ``BENCHMARK.json`` that this cell reports; a cell it does not list is
    refused."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    if not any(w["name"] == workload for w in spec["workloads"]):
        raise Refused(f"BENCHMARK.json lists no cell {workload}")
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    out = []
    for m in spec[kind]:
        if "workloads" in m:
            mine = workload in m["workloads"]
        elif kind == "end_to_end":
            mine = True
        else:  # a per-layer metric goes where its end-to-end metric goes
            target = e2e[m["moves"]]
            mine = "workloads" not in target or workload in target["workloads"]
        if mine:
            out.append(m)
    return out


def metric_reader(name: str):
    """``benchmark/metrics/<name>.py``'s ``read(run)``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def mode_module(mode: str):
    return importlib.import_module(f"benchmark.modes.{mode}")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             overrides: Optional[Dict] = None, t_start: Optional[float] = None) -> Dict:
    """Run one cell and return the result object (without printing it).
    ``overrides`` replaces parts of the merged files (``config``, ``mix``,
    ``settings``): the CPU tests run cells at a size a test can hold."""
    t_start = time.monotonic() if t_start is None else t_start
    files = cell_files(workload)
    for k, v in (overrides or {}).items():
        files[k] = {**files[k], **v} if isinstance(v, dict) else v
    run = mode_module(files["mode"]).run(files, seed=seed, seconds=seconds, trace=trace,
                                         device=device, t_start=t_start)
    measured = run["e2e"]
    result: Dict = {"correct": bool(run["correct"]), "attempted": int(run["attempted"]),
                    "failed": int(run["failed"])}
    metrics: Dict = {}
    if not trace:
        for m in spec_metrics(workload, "end_to_end"):
            if m["name"] not in measured:
                raise RuntimeError(f"{workload}: the mode measured no {m['name']}")
            metrics[m["name"]] = {"value": measured[m["name"]]["value"], "unit": m["unit"]}
    else:
        for m in spec_metrics(workload, "per_layer"):
            value = metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = run["device"]
    if trace and run.get("breakdown"):
        result["breakdown"] = run["breakdown"]
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in run["checks"]}
    result["_run"] = run
    return result


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _check_program() -> None:
    """The program must be this checkout's, not one found elsewhere."""
    spec = importlib.util.find_spec(PROGRAM)
    origin = os.path.abspath(spec.origin) if spec is not None and spec.origin else ""
    if not origin.startswith(ROOT + os.sep):
        raise Refused(f"{PROGRAM} is not in this checkout ({ROOT})")


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.monotonic() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    try:
        _check_program()
        chips = int(cell_files(args.workload)["cell"]["chips"])
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise Refused(f"the cell needs {chips} CUDA device(s); "
                          f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start)
    except Refused as e:
        print(f"benchmark refused: {e}", file=sys.stderr)
        return 2
    run = result.pop("_run")
    bad = forbidden_modules()
    if bad:
        print(f"benchmark refused: modules of the JAX package or of JAX were loaded: {bad}",
              file=sys.stderr)
        return 3
    for line in run.get("notes", []):
        print(line, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']} (attempted {result['attempted']}, failed "
          f"{result['failed']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
