"""Training on one's own recordings: the NFS recipe through ``Trainer``'s loop.

Set-up builds one ``Trainer`` on a seeded in-memory loader of compact
batches (``B`` clips of ``L`` windows, LR and GT events), loads the
benchmark's seeded weights into its model and drives it through its first
three iterations through ``Trainer.train`` itself, on three distinct
batches: the loss of each, the first gradient as Adam holds it after one
step and the parameters after three are kept.  The same object then trains
on, from batches cycled from a pool, until the window has lasted
``--seconds``; the window ends when the device has finished the iteration
running then.  Validation, logging and checkpoints fall outside the window
(their periods are set past it, and no checkpoint is written).  With
``--trace 1`` the window runs as it does untraced, and a few more
iterations are traced once it has closed.

The reference follows the first three iterations in float32 from the same
weights and events; ``loss_gap``, ``grad_gap`` and ``change_gap`` compare
them (``benchmark/reference/compare.py::leaf_gap``).
"""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import devtrace, flops, runtime, traffic
from benchmark.reference import compare
from benchmark.reference import train as ref_train
from benchmark.weights import model_dims, seeded_params

CHECK_STEPS = 3
TRACE_ITERATIONS = 3  # traced once the window has closed


def _batch_windows(seed: int, index: int, config: Dict, mix: Dict):
    """Raw windows of batch ``index``: ``inp [B, L, 4, N]``, ``gt [B, L, 4, M]``."""
    b, length = int(mix["batch"]), int(mix["length"])
    hw, gt_hw = config["lr_resolution"], config["hr_resolution"]
    inp = np.stack([traffic.stream_windows(seed, 2 * (index * b + c), 0, length, hw,
                                           int(config["window"]), mix["events"])
                    for c in range(b)])
    gt = np.stack([traffic.stream_windows(seed, 2 * (index * b + c) + 1, 0, length, gt_hw,
                                          int(config["gt_window"]), mix["events"])
                   for c in range(b)])
    return inp, gt


class _Loader:
    """The recipe's loader as ``Trainer`` reads it, from memory: compact
    batches from ``start`` on, cycled; ``on_item(k)`` is called before the
    ``k``-th batch an ``iter`` hands out."""

    def __init__(self, batches: List[Dict], config: Dict):
        self.batches = batches
        self.inp_resolution = tuple(config["lr_resolution"])
        self.gt_resolution = tuple(config["hr_resolution"])
        self.seqn, self.compact, self.pad_last = 2, True, False
        self.batch_size = batches[0]["inp_xy"].shape[0]
        self.start = 0
        self.on_item = None

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        k = 0
        while True:
            if self.on_item is not None:
                self.on_item(k)
            yield self.batches[(self.start + k) % len(self.batches)]
            k += 1


def _recipe(config: Dict, mix: Dict, st: Dict, out_dir: str) -> Dict:
    dims = model_dims(config)
    dataset = {"scale": dims["scale"], "ori_scale": st["ori_scale"], "time_bins": 1,
               "need_gt_frame": False, "need_gt_events": True, "mode": "events",
               "window": int(config["window"]), "sliding_window": int(config["sliding_window"]),
               "data_augment": {"enabled": False},
               "sequence": {"sequence_length": int(mix["length"]), "seqn": 2}}
    never = 10**9
    return {
        "experiment": "bench", "model": {"args": {"variant": "full", "n_c": dims["n_c"],
                                                  "n_b": dims["n_b"]}},
        "optimizer": {"name": "Adam", "args": dict(st["optimizer"])},
        "lr_scheduler": {"name": "ExponentialLR", "args": {"gamma": st["lr_gamma"]}},
        "trainer": {"output_path": out_dir, "remat": bool(st["remat"]), "tensorboard": False,
                    "monitor": "off",
                    "iteration_based_train": {"enabled": True, "iterations": never,
                                              "save_period": never, "train_log_step": never,
                                              "valid_log_step": never, "valid_step": never,
                                              "lr_change_rate": int(st["lr_change_rate"])}},
        "train_dataloader": {"batch_size": int(mix["batch"]), "dataset": dataset},
    }


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


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
    out_dir = tempfile.mkdtemp(prefix="bench_train_")
    try:
        loader = _Loader(batches, config)
        tr = Trainer(RunConfig(_recipe(config, mix, st, out_dir), runid="bench"),
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
    dev_batches = [(torch.from_numpy(i).to(dev), torch.from_numpy(g).to(dev)) for i, g in checked]
    opt = st["optimizer"]
    ref = ref_train.steps(params, dims, dev_batches, hw, gt_hw, opt["lr"], opt["weight_decay"])
    ref_first = _norms(ref["first_grad"])
    ref_change = _norms({k: v - params[k] for k, v in ref["params"].items()})
    if control == "tf32":  # the reference in TF32 takes the program's place
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        low = ref_train.steps(params, dims, dev_batches, hw, gt_hw, opt["lr"], opt["weight_decay"])
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
    s = int(mix["length"]) - 1
    flops_iter = 3 * flops.forward_flops(dims, hw, batch=int(mix["batch"]) * s)
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
        "flops_per_window": flops_iter, "precision": "fp32",
        "notes": [f"set-up {setup_s:.3f} s; the reference {time.monotonic() - t_ref:.3f} s; "
                  f"window: {iters} iterations in {elapsed:.3f} s; losses {prog_losses} against "
                  f"{ref['losses']}; worst leaves: gradient {grad_leaf}, change {change_leaf} "
                  f"({len(moving)} of {len(ref_first)} leaves moved by the reference)"],
    }
    if traced is not None:
        recs = traced.records()
        res["device"].update(busy_s=devtrace.busy_us(recs) * 1e-6, window_s=traced.window_s)
        res["trace"] = {"records": recs, "window_s": traced.window_s, "windows": TRACE_ITERATIONS}
        res["breakdown"] = {"device_ops": devtrace.top_ops(recs),
                            "idle_gaps": devtrace.idle_gaps(recs)}
    return res
