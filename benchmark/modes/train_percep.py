"""Training with the RGB perceptual recipe through ``Trainer``'s loop.

The ``train`` mode's run (``modes/train.py``: set-up through the first three
iterations on three distinct batches, then the window, which ends when the
device has finished the iteration running at ``--seconds``, and under
``--trace 1`` three more iterations traced after it), with the recipe of
``configs/train_RGB_percep.yml``: the configuration's ``loss:`` block, its
LPIPS term reading a bundle that the program's ``LPIPS.to_npz`` writes from
the seeded weights (``benchmark/lpips_weights.py``) into the run's temporary
directory, and ``remat`` and ``grad_accum`` from the cell's settings.

The reference (``reference/percep.py``) follows the first three iterations
in float32 from the same weights and events; ``loss_gap``, ``grad_gap`` and
``change_gap`` compare them as the ``train`` mode does.  A traced run keeps,
beside the device records, each kernel's and each runtime call's
correlation id, so that a reader can tell which kernels a span launched.

Settings only the tests and the control runs use: ``control: tf32`` (the
reference in TF32 takes the program's place) and ``fault: no_lpips`` (the
program's recipe without its LPIPS term; the reference keeps it).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import devtrace, runtime, traffic
from benchmark.lpips_weights import seeded_lpips, write_bundle
from benchmark.modes.train import (CHECK_STEPS, TRACE_ITERATIONS, _batch_windows, _Loader,
                                   _norms, _recipe)
from benchmark.reference import compare
from benchmark.reference import percep as ref_percep
from benchmark.weights import model_dims, seeded_params


def _percep_recipe(config: Dict, mix: Dict, st: Dict, out_dir: str, bundle: str) -> Dict:
    cfg = _recipe(config, mix, st, out_dir)
    loss = {name: dict(spec) for name, spec in config["loss"].items()}
    loss["lpips"]["weights"] = bundle
    if st.get("fault") == "no_lpips":
        del loss["lpips"]
    cfg["loss"] = loss
    cfg["trainer"]["grad_accum"] = int(st["grad_accum"])
    return cfg


def correlated(prof) -> Tuple[List[Tuple[int, float, float]], List[Tuple[int, float]]]:
    """``(kernels, launches)`` of a trace: each device record's
    ``(correlation, start_us, end_us)`` and each host runtime call's
    ``(correlation, start_us)`` (the launches, copies and fills that CUPTI
    correlates with device records)."""
    from torch.autograd import DeviceType

    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    kernels: List[Tuple[int, float, float]] = []
    launches: List[Tuple[int, float]] = []
    if raw is None:
        return kernels, launches
    for e in raw.events():
        corr = e.correlation_id()
        if not corr:
            continue
        if e.device_type() == DeviceType.CUDA:
            kernels.append((corr, e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3))
        else:
            launches.append((corr, e.start_ns() / 1e3))
    return kernels, launches


def run(files: Dict, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> Dict:
    from bmcnet_esr_torch.training.config import RunConfig
    from bmcnet_esr_torch.training.trainer import Trainer

    config, mix, st = files["config"], files["mix"], files["settings"]
    dims = model_dims(config)
    hw, gt_hw = tuple(config["lr_resolution"]), tuple(config["hr_resolution"])
    dev = torch.device(device)
    raw = [_batch_windows(seed, i, config, mix) for i in range(int(mix["distinct_batches"]))]
    batches = []
    for inp, gt in raw:
        ixy, ip = traffic.compact(inp)
        gxy, gp = traffic.compact(gt)
        batches.append({"inp_xy": ixy, "inp_p": ip, "gt_xy": gxy, "gt_p": gp})
    checked = [raw[i] for i in range(CHECK_STEPS)]
    del raw
    out_dir = tempfile.mkdtemp(prefix="bench_percep_")
    try:
        bundle = write_bundle(config, seed, os.path.join(out_dir, "lpips_alex.npz"))
        loader = _Loader(batches, config)
        tr = Trainer(RunConfig(_percep_recipe(config, mix, st, out_dir, bundle), runid="bench"),
                     train_loader=loader, valid_loader=None, seed=int(seed) % 2**31, device=dev)
        params0 = seeded_params(config, seed, dev)
        tr.state.model.load_state_dict(params0, strict=True)
        step, losses = tr.train_step, []
        win = {"iterations": None, "done": 0, "end": None, "traced": None}

        def counted(state, batch):
            state, m = step(state, batch)
            losses.append(m["train_loss"])
            if win["end"] is None and len(losses) > CHECK_STEPS:
                win["done"] += 1
                if win["done"] == win["iterations"]:
                    close_window()
            elif (win["traced"] is not None
                  and len(losses) == CHECK_STEPS + win["done"] + TRACE_ITERATIONS):
                win["traced"].stop()
            return state, m

        def at_end(iteration, best=False):
            pass

        tr.train_step, tr.save = counted, at_end
        # set-up: the first iteration, then two more, on batches 0, 1, 2
        loader.start, tr.iterations = 0, 1
        tr.train(start_iteration=0)
        beta1 = tr.state.optimizer.param_groups[0]["betas"][0]
        names = dict((id(p), n) for n, p in tr.state.model.named_parameters())
        first = {names[id(p)]: s["exp_avg"] / (1 - beta1)
                 for p, s in tr.state.optimizer.state.items()}
        first_norms = _norms(first)
        del first
        loader.start, tr.iterations = 1, CHECK_STEPS
        tr.train(start_iteration=1)
        change_norms = _norms({n: p.detach() - params0[n]
                               for n, p in tr.state.model.named_parameters()})
        prog_losses = [float(v) for v in losses[:CHECK_STEPS]]
        del params0
        if trace:
            devtrace.warm()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        # the window
        t0 = time.monotonic()
        setup_s = t0 - t_start

        def close_window() -> None:
            runtime.sync(dev)
            win["end"] = time.monotonic()
            if trace:  # a few more iterations, traced, once the window has closed
                win["traced"] = devtrace.Span().start()

        def on_item(k: int) -> None:
            if win["iterations"] is None and k >= 1 and time.monotonic() - t0 >= seconds:
                win["iterations"] = k
                tr.iterations = CHECK_STEPS + k + (TRACE_ITERATIONS if trace else 0)
                if win["done"] == k:
                    close_window()

        loader.start, loader.on_item, tr.iterations = CHECK_STEPS, on_item, 10**9
        tr.train(start_iteration=CHECK_STEPS)
        runtime.sync(dev)
        traced = win["traced"]
        elapsed, iters = win["end"] - t0, win["iterations"]
        finite = all(np.isfinite(float(v)) for v in losses[CHECK_STEPS:])
        peak = runtime.memory_peak(dev)
        del tr, loader, step, counted, losses
        runtime.free(dev)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # the reference follows the first three iterations
    t_ref = time.monotonic()
    control = st.get("control")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    params = seeded_params(config, seed, dev)
    lp = {k: v.to(dev) for k, v in seeded_lpips(config, seed).items()}
    weights = {name: float(spec["weight"]) for name, spec in config["loss"].items()}
    dev_batches = [(torch.from_numpy(i).to(dev), torch.from_numpy(g).to(dev)) for i, g in checked]
    opt, accum, remat = st["optimizer"], int(st["grad_accum"]), bool(st["remat"])

    def reference():
        return ref_percep.steps(params, lp, dims, weights, dev_batches, hw, gt_hw, opt["lr"],
                                opt["weight_decay"], accum=accum, remat=remat)

    ref = reference()
    ref_first = _norms(ref["first_grad"])
    ref_change = _norms({k: v - params[k] for k, v in ref["params"].items()})
    if control == "tf32":  # the reference in TF32 takes the program's place
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        low = reference()
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        prog_losses, first_norms = low["losses"], _norms(low["first_grad"])
        change_norms = _norms({k: v - params[k] for k, v in low["params"].items()})
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog_losses, ref["losses"]))
    grad_gap, grad_leaf = compare.leaf_gap(first_norms, ref_first, list(ref_first))
    med = sorted(ref_first.values())[len(ref_first) // 2]
    moving = [k for k, v in ref_first.items() if v >= 1e-3 * med]
    change_gap, change_leaf = compare.leaf_gap(change_norms, ref_change, moving)
    lim = files["cell"]["limits"]
    checks = [("loss_gap", loss_gap, float(lim["loss_gap"])),
              ("grad_gap", grad_gap, float(lim["grad_gap"])),
              ("change_gap", change_gap, float(lim["change_gap"]))]
    res = {
        "correct": finite and all(v <= limit for _, v, limit in checks),
        "attempted": iters, "failed": 0 if finite else iters,
        "e2e": {"train_ms_per_iter": {"value": 1e3 * elapsed / iters, "unit": "ms/iter"},
                "setup_s": {"value": setup_s, "unit": "s"}},
        "checks": checks,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": peak},
        "window": {"windows": iters, "seconds": elapsed},
        "precision": "fp32",
        "notes": [f"set-up {setup_s:.3f} s; the reference {time.monotonic() - t_ref:.3f} s; "
                  f"window: {iters} iterations in {elapsed:.3f} s; losses {prog_losses} against "
                  f"{ref['losses']}; worst leaves: gradient {grad_leaf}, change {change_leaf} "
                  f"({len(moving)} of {len(ref_first)} leaves moved by the reference); "
                  f"peak {peak} bytes"],
    }
    if traced is not None:
        recs = traced.records()
        kernels, launches = correlated(traced.prof)
        res["device"].update(busy_s=devtrace.busy_us(recs) * 1e-6, window_s=traced.window_s)
        res["trace"] = {"records": recs, "window_s": traced.window_s, "windows": TRACE_ITERATIONS,
                        "kernels": kernels, "launches": launches}
        res["breakdown"] = {"device_ops": devtrace.top_ops(recs),
                            "idle_gaps": devtrace.idle_gaps(recs)}
    return res
