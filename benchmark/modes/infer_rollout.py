"""Offline super-resolution of recordings: ``InferenceEngine.infer_windows``.

The call ``cli.infer`` makes once a recording's windows are read: batch 1,
stride-1 window pairs, ``chunk_size`` windows a chunk, no images, no GT
events (the engine's zero GT window), int8 scales calibrated on each
recording's first chunk.  Recordings of ``pairs`` window pairs run back to
back until the window has lasted ``--seconds``; the window ends with the
recording that was running then.  ``windows_per_s`` is every window pair
the rollouts completed over the whole window.

With ``--trace 1`` the window runs as it does untraced, and one more
recording is traced once it has closed: the per-layer metrics read the
trace, and ``infer.mfu_pct`` reads the untraced window's rate.

Correctness: a forward hook on the engine's model keeps the HR prediction
of a few windows of every recording (drawn from the seed, the last window
among them).  After the window, one recording drawn from the seed is rolled
out again by the reference from the same seeded weights and events, and
``pred_err`` compares the kept predictions with it.  The reference is the
float32 model; with ``reference_bits`` its convolutions are fake-quantized
at that width (``reference/quant.py``), its static scales calibrated again
by the program's rule: up to 16 recurrent steps over the recording's first
chunk.  ``control_bits`` puts the reference at a lower width in the
program's place.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import devtrace, flops, runtime, traffic
from benchmark.reference import compare
from benchmark.reference import model as ref_model
from benchmark.reference import raster
from benchmark.reference.quant import FakeQuantConv
from benchmark.weights import model_dims, seeded_params


def _recordings(seed: int, count: int, pairs: int, config: Dict, mix: Dict) -> List[np.ndarray]:
    hw, n = config["lr_resolution"], int(config["window"])
    return [traffic.stream_windows(seed, r, 0, pairs + 1, hw, n, mix["events"])
            for r in range(count)]


def _loader(windows: np.ndarray):
    xy, p = traffic.compact(windows[:, None])  # [W, 1, 2, N], [W, 1, N]
    gxy, gp = np.zeros((1, 1, 2, 1), np.int16), np.zeros((1, 1, 1), np.int8)

    def load_chunk(pos: int, steps: int):
        return ((xy[pos:pos + steps + 1], p[pos:pos + steps + 1]),
                (np.repeat(gxy, steps, 0), np.repeat(gp, steps, 0)))

    return load_chunk


class _Keep:
    """Forward hook: the HR predictions of the kept windows of each recording
    (calibration's forwards left out)."""

    def __init__(self, model, keep: List[int]):
        self.model, self.keep = model, set(keep)
        self.recording, self.window, self.kept = -1, 0, {}
        self.on = False
        self.handle = model.register_forward_hook(self)

    def start(self, recording: int) -> None:
        self.recording, self.window, self.on = recording, 0, True

    def __call__(self, module, args, out) -> None:
        if not self.on or getattr(module.neuro.conv_o, "calib", None) is not None:
            return
        if self.window in self.keep:
            self.kept[self.recording, self.window] = out[-1].detach()
        self.window += 1


def _kernel_calls(dims, hw, dtype: str, settings: Dict, pairs: int, n_events: int) -> Dict:
    """The port's kernel calls of one recording: ``{pattern: [(ops, bytes)]}``."""
    chunk = int(settings["chunk_size"])
    chunks = [min(chunk, pairs - s) for s in range(0, pairs, chunk)]
    kh, kw = dims["scale"] * hw[0], dims["scale"] * hw[1]
    calls = {"band_kernel": [], "qconv3x3_kernel": [], "qmm_kernel": []}
    int8 = dtype.startswith("int8")
    for i, s in enumerate(chunks):
        calls["band_kernel"].append(flops.raster_call(s + 1, n_events, hw))
        calls["band_kernel"].append(flops.raster_call(s, 1, (kh, kw)))
        if int8 and i == 0:  # calibration: its own rasterizer call, dynamic int8 input
            calls["band_kernel"].append(flops.raster_call(s + 1, n_events, hw))
            for _ in range(min(16, s)):
                calls["qconv3x3_kernel"] += flops.qconv_calls(dims, hw, 1, in_bytes=1)
                calls["qmm_kernel"] += flops.qmm_calls(dims, hw, 1, in_bytes=1)
    if dtype == "int8_pall":
        for _ in range(pairs):
            calls["qconv3x3_kernel"] += flops.qconv_calls(dims, hw, 1, in_bytes=2)
            calls["qmm_kernel"] += flops.qmm_calls(dims, hw, 1, in_bytes=2)
    elif not int8:
        calls.pop("qconv3x3_kernel"), calls.pop("qmm_kernel")
    return calls


def run(files: Dict, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> Dict:
    from bmcnet_esr_torch.data import DatasetConfig
    from bmcnet_esr_torch.inference import InferenceEngine

    config, mix, st = files["config"], files["mix"], files["settings"]
    dims = model_dims(config)
    hw = tuple(config["lr_resolution"])
    gt_hw = (dims["scale"] * hw[0], dims["scale"] * hw[1])
    pairs, n_events = int(mix["pairs"]), int(config["window"])
    dtype = st["dtype"]
    dev = torch.device(device)

    recs = _recordings(seed, int(mix["distinct_recordings"]), pairs, config, mix)
    warm = traffic.stream_windows(seed, 10_000, 0, int(mix["warm_pairs"]) + 1, hw, n_events,
                                  mix["events"])
    model = runtime.program_model(config, dtype, seed, dev)
    engine = InferenceEngine(model, DatasetConfig(scale=dims["scale"], window=n_events,
                                                  need_gt_events=False),
                             chunk_size=int(st["chunk_size"]), visualize=False, device=dev)
    # set-up: a shorter recording of the same chunk shapes, calibration and all
    engine.infer_windows(_loader(warm), int(mix["warm_pairs"]), hw, gt_hw)
    if trace:
        devtrace.warm()
    keep = runtime.sample(seed, 0, pairs, int(mix["check_windows"]))
    hook = _Keep(engine.model, keep)
    runtime.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    setup_s = t0 - t_start

    done, failed, walls = 0, 0, []
    r = 0
    while True:
        t_r = time.monotonic()
        hook.start(r)
        out = engine.infer_windows(_loader(recs[r % len(recs)]), pairs, hw, gt_hw)
        walls.append(round(time.monotonic() - t_r, 3))
        if hook.window == pairs and np.isfinite(out["esr_mse"]):
            done += pairs
        else:
            failed += pairs
        r += 1
        if time.monotonic() - t0 >= seconds:
            break
    runtime.sync(dev)
    elapsed = time.monotonic() - t0
    in_window, traced, after = r, None, 0
    if trace:  # one more recording, traced, once the window has closed
        hook.start(r)
        traced = devtrace.Span().start()
        out = engine.infer_windows(_loader(recs[r % len(recs)]), pairs, hw, gt_hw)
        traced.stop()
        if hook.window == pairs and np.isfinite(out["esr_mse"]):
            after += pairs
        else:
            failed += pairs
        r += 1
    peak = runtime.memory_peak(dev)
    hook.handle.remove()
    kept = hook.kept
    del engine, model, hook
    runtime.free(dev)

    # the check: one recording drawn from the seed, against the reference
    t_ref = time.monotonic()
    check_r = runtime.sample(seed, 1, r, 1, include_last=False)[0]
    windows = torch.from_numpy(recs[check_r % len(recs)]).to(dev)
    frames = raster.counts(windows, hw)  # [pairs + 1, H, W, 2]
    runtime.strict_float32()
    params = seeded_params(config, seed, dev)
    calib = [torch.stack([frames[i], frames[i + 1]])[None]
             for i in range(min(16, int(st["chunk_size"]), pairs))]

    def reference(bits):
        if not bits:
            return ref_model.Net(params, **dims)
        qconv = FakeQuantConv(int(bits))
        qnet = ref_model.Net(params, **dims, conv=qconv)
        qconv.calibrate(qnet, calib, qnet.init_state(1, *hw, device=dev))
        return qnet

    net = reference(st.get("reference_bits"))
    control = st.get("control_bits")
    low = reference(control) if control else None
    compared = []
    with torch.no_grad():
        carry = net.init_state(1, *hw, device=dev)
        low_carry = net.init_state(1, *hw, device=dev)
        for i in range(max(keep) + 1):
            x = torch.stack([frames[i], frames[i + 1]])[None]
            carry = net(x, *carry)
            if control:
                low_carry = low(x, *low_carry)
            if i in keep:
                prog = low_carry[-1] if control else kept.get((check_r, i))
                if prog is None:
                    failed += 1
                    continue
                compared.append((prog.float(), carry[-1], ref_model.skip_of(x, dims["scale"])))
    err = compare.pred_error(compared) if compared else float("inf")
    limit = float(files["cell"]["limits"]["pred_err"])
    flops_window = flops.forward_flops(dims, hw)
    res = {
        "correct": failed == 0 and err <= limit,
        "attempted": done + after + failed, "failed": failed,
        "e2e": {"windows_per_s": {"value": done / elapsed, "unit": "windows/s"},
                "setup_s": {"value": setup_s, "unit": "s"}},
        "checks": [("pred_err", err, limit)],
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": peak},
        "window": {"windows": done, "seconds": elapsed, "recordings": in_window,
                   "checked_recording": check_r},
        "flops_per_window": flops_window,
        "precision": st["precision"],
        "notes": [f"set-up {setup_s:.3f} s; window: {in_window} recordings, {done} windows in "
                  f"{elapsed:.3f} s (each {walls} s); checked recording {check_r}, windows "
                  f"{keep}; the reference {time.monotonic() - t_ref:.3f} s"],
    }
    if traced is not None:
        t = time.monotonic()
        records = traced.records()
        res["device"].update(busy_s=devtrace.busy_us(records) * 1e-6, window_s=traced.window_s)
        res["trace"] = {"records": records, "window_s": traced.window_s, "windows": pairs,
                        "calls": _kernel_calls(dims, hw, dtype, st, pairs, n_events)}
        res["breakdown"] = {"device_ops": devtrace.top_ops(records),
                            "idle_gaps": devtrace.idle_gaps(records)}
        res["notes"].append(f"trace: {len(records)} device records, the profiler's stop "
                            f"{traced.stop_s:.3f} s, reading {time.monotonic() - t:.3f} s")
    return res
