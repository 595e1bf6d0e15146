#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``bmcnet_esr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX or of
``bmcnet_esr_tpu`` and fails (non-zero exit, no result line) without CUDA or
without the port's package beside it.  Phases, each of which raises on
failure:

1. card identity (``nvidia-smi`` name and power limit);
2. build every CUDA kernel from ``bmcnet_esr_torch/csrc`` and hold each one
   bit-exact against its plain PyTorch version at the main path's shapes and
   on an adversarial window;
3. the released BMCNet_plain checkpoint (n_c=128, n_b=5, x4) on the card:
   RMSE < 1e-3 against the reference rollout in ``tests/goldens``, and bf16
   within rel-RMSE 5e-2 of float32;
4. the main path: chunked ``InferenceEngine`` rollouts of 64 windows at
   45x80 -> 180x320 (2048 LR events per window), full BMCNet with seeded
   random weights and the released plain checkpoint, float32 and bfloat16,
   fed compact windows made with numpy; kernel launch counts are reset just
   before and read just after; then the float32 engines' first windows are
   rolled out again on the CPU and compared;
5. when ``h5py`` imports: ``infer_file`` and ``cli.infer`` on the fixture of
   ``tests/goldens/infer_goldens.npz``, per-window MSEs against the goldens;
6. a JSON line with each kernel's launches, error, times and bound.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data-sheet memory rate
LR, GT, SCALE, N_LR = (45, 80), (180, 320), 4, 2048
N_WINDOWS, CHUNK = 64, 32
GOLDEN_TOL = dict(rtol=1e-3, atol=2e-5)  # GPU conv summation order vs CPU goldens


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device ms per call, CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def random_windows(rng, g: int, n: int, hw, pad: int = 0):
    """``[g, 4, n]`` float32 events, coordinates a little past the sensor on
    every side, polarity +-1, the last ``pad`` events zero padding."""
    import numpy as np

    h, w = hw
    ev = np.zeros((g, 4, n), np.float32)
    ev[:, 0] = rng.integers(-2, w + 2, (g, n))
    ev[:, 1] = rng.integers(-2, h + 2, (g, n))
    ev[:, 2] = np.sort(rng.random((g, n)), axis=1)
    ev[:, 3] = rng.integers(0, 2, (g, n)) * 2 - 1
    if pad:
        ev[:, :, -pad:] = 0
    return ev


def adversarial_window(hw):
    import numpy as np

    h, w = hw
    xs = [0, w - 1, w, -1, -0.5, 0.5, w - 0.5, 1e5, -1e5, 32767, 3, 3, 3, 7, 7]
    ys = [0, h - 1, 3, 3, 3, 3, 3, 3, 3, 3, h, -1, 32768, 2, 2]
    ps = [1, -1, 1, -1, 1, -1, 1, 1, -1, 1, 1, -1, 1, 0, -1]
    ev = np.zeros((1, 4, len(xs)), np.float32)
    ev[0, 0], ev[0, 1], ev[0, 3] = xs, ys, ps
    return ev


def phase_kernels(dev):
    """Build all kernels; hold each against its plain version."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.kernels import _build, rasterize
    from bmcnet_esr_torch.ops.batch import compact_events

    t0 = time.perf_counter()
    _build.build_all([rasterize.SOURCE])
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {rasterize.SOURCE}")

    rng = np.random.default_rng(0)
    cases = {
        "lr_chunk": (random_windows(rng, CHUNK + 1, N_LR, LR, pad=64), LR),
        "gt_chunk": (random_windows(rng, CHUNK, SCALE**2 * N_LR, GT, pad=512), GT),
        "adversarial": (adversarial_window(LR), LR),
    }
    err = 0.0
    inputs = {}
    for name, (ev, hw) in cases.items():
        xy, p = (torch.from_numpy(a).to(dev) for a in compact_events(ev))
        evd = torch.from_numpy(ev).to(dev)
        got = rasterize.counts_from_compact(xy, p, hw)
        want = rasterize.counts_plain(xy[:, 0], xy[:, 1], p, hw)
        got_raw = rasterize.counts_from_events(evd, hw)
        want_raw = rasterize.counts_plain(evd[:, 0], evd[:, 1], evd[:, 3], hw)
        torch.cuda.synchronize()
        d = max(float((got - want).abs().max()), float((got_raw - want_raw).abs().max()),
                float((got - got_raw).abs().max()))
        check(d == 0.0, f"rasterizer differs from its plain version on {name}: {d}")
        check(float(got.sum()) > 0, f"empty count image on {name}")
        err = max(err, d)
        inputs[name] = (xy, p, hw)
        print(f"rasterize {name}: G={ev.shape[0]} N={ev.shape[2]} {hw}: bit-exact, "
              f"{int(got.sum())} counts")
    return err, inputs


def time_rasterizer(inputs) -> dict:
    """Kernel, plain and library times at the main path's chunk shapes (one
    LR call + one GT call), beside the byte bound."""
    import torch

    from bmcnet_esr_torch.kernels import rasterize

    out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for name in ("lr_chunk", "gt_chunk"):
        xy, p, (h, w) = inputs[name]
        g, _, n = xy.shape
        ms = cuda_ms(lambda: rasterize.counts_from_compact(xy, p, (h, w)))
        plain = cuda_ms(lambda: rasterize.counts_plain(xy[:, 0], xy[:, 1], p, (h, w)))
        # library yardstick: one index_put_ scatter into a fresh zero image,
        # with the flat indices and values computed beforehand (not timed)
        x, y = xy[:, 0].long(), xy[:, 1].long()
        valid = (x >= 0) & (x < w) & (y >= 0) & (y < h) & (p != 0)
        gi = torch.arange(g, device=xy.device)[:, None].expand(g, n)
        idx = ((gi * h + (h - 1 - y)) * w + x) * 2 + (p < 0).long()
        idx, val = idx[valid], (p[valid].float() ** 2)
        lib = cuda_ms(lambda: torch.zeros(g * h * w * 2, device=xy.device)
                      .index_put_((idx,), val, accumulate=True))
        bound = (g * n * 5 + g * h * w * 2 * 4) / HBM_BYTES_PER_S * 1e3
        print(f"rasterize timing {name}: kernel {ms:.5f} ms, plain {plain:.5f} ms, "
              f"index_put_ {lib:.5f} ms, bound {bound:.5f} ms")
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", bound)):
            out[k] += v
    return out


def phase_checkpoint(dev):
    """Released plain checkpoint against the reference rollout."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.models import BMCNetPlain, count_params, load_checkpoint

    path = os.path.join(ROOT, "tests", "goldens", "plain_nfs_x4_ckpt.npz")
    with np.load(path) as z:
        x = np.transpose(z["x"], (0, 1, 3, 4, 5, 2))  # [S, B, C, T, H, W] -> NHWC
        want = np.transpose(z["preds"], (0, 1, 3, 4, 2))
    sd = load_checkpoint(path)
    preds = {}
    for dt in (torch.float32, torch.bfloat16):
        m = BMCNetPlain(scale=4, n_c=128, n_b=5, dtype=dt)
        m.load_state_dict(sd)
        check(count_params(m) == 1_003_296, f"unique params {count_params(m)}")
        m = m.to(dev, memory_format=torch.channels_last).eval()
        st = m.init_state(x.shape[1], x.shape[3], x.shape[4])
        out = []
        with torch.inference_mode():
            for xi in x:
                st = m(torch.from_numpy(xi).to(dev), *st)
                out.append(st[-1].float().cpu().numpy())
        preds[dt] = np.stack(out)
    rmse = float(np.sqrt(np.mean((preds[torch.float32] - want) ** 2)))
    check(rmse < 1e-3, f"released checkpoint fp32 RMSE {rmse} >= 1e-3")
    scale = max(float(np.abs(preds[torch.float32]).max()), 1.0)
    rel = float(np.sqrt(np.mean((preds[torch.bfloat16] - preds[torch.float32]) ** 2))) / scale
    check(rel < 5e-2, f"bf16 rel-RMSE {rel} >= 5e-2")
    print(f"released checkpoint: fp32 RMSE {rmse:.3e} vs reference (budget 1e-3); "
          f"bf16 rel-RMSE {rel:.3e} vs fp32 (bound 5e-2)")


def seeded_full_weights(model, seed: int = 0):
    """Seeded numpy weights in the shape of ``model``'s state dict."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if v.dim() == 4:
            arr = rng.normal(0.0, np.sqrt(0.02 / v[0].numel()), tuple(v.shape))
        elif k.endswith("norm_s.weight"):
            arr = 1.0 + rng.normal(0.0, 0.05, tuple(v.shape))
        else:
            arr = rng.normal(0.0, 0.01, tuple(v.shape))
        sd[k] = torch.from_numpy(arr.astype(np.float32))
    return sd


def phase_rollouts(dev, card: str) -> int:
    """The main path; returns the rasterizer launches made by it."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.data import DatasetConfig
    from bmcnet_esr_torch.inference import InferenceEngine
    from bmcnet_esr_torch.kernels import rasterize
    from bmcnet_esr_torch.models import BMCNet, BMCNetPlain, load_checkpoint
    from bmcnet_esr_torch.ops.batch import compact_events

    rng = np.random.default_rng(1)
    inp = compact_events(random_windows(rng, N_WINDOWS + 1, N_LR, LR)[:, None])
    gt = compact_events(random_windows(rng, N_WINDOWS, SCALE**2 * N_LR, GT)[:, None])

    def load_chunk(pos, steps):
        return ((inp[0][pos : pos + steps + 1], inp[1][pos : pos + steps + 1]),
                (gt[0][pos : pos + steps], gt[1][pos : pos + steps]))

    plain_sd = load_checkpoint(os.path.join(ROOT, "tests", "goldens", "plain_nfs_x4_ckpt.npz"))
    full_sd = seeded_full_weights(BMCNet(scale=SCALE))
    engines = []
    for variant, cls, sd in (("full", BMCNet, full_sd), ("plain", BMCNetPlain, plain_sd)):
        for dt in (torch.float32, torch.bfloat16):
            m = cls(scale=SCALE, n_c=128, n_b=5, dtype=dt)
            m.load_state_dict(sd)
            eng = InferenceEngine(m, DatasetConfig(scale=SCALE), chunk_size=CHUNK,
                                  visualize=False, device=dev)
            eng.infer_windows(load_chunk, 4, LR, GT)  # warm-up, outside the count
            engines.append((f"{variant} {str(dt).split('.')[-1]}", eng))

    torch.cuda.synchronize()
    rasterize.launches = 0
    results = []
    # each configuration twice, the second pass in reverse order, so that a
    # drift over the run shows as a spread between the two passes
    for name, eng in engines + engines[::-1]:
        t0 = time.perf_counter()
        r = eng.infer_windows(load_chunk, N_WINDOWS, LR, GT, return_per_window=True)
        wall = time.perf_counter() - t0
        results.append((name, r, wall))
    launches = rasterize.launches

    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"after the rollouts: SM clock, max SM clock, power draw = {clocks}")
    for name, r, wall in results:
        esr = r["per_window"]["esr_mse"]
        check(len(esr) == N_WINDOWS and np.all(np.isfinite(esr)), f"{name}: bad esr_mse")
        check(np.all(np.isfinite(r["per_window"]["bicubic_mse"])), f"{name}: bad bicubic_mse")
        print(f"rollout {name}: {N_WINDOWS} windows {LR} -> {GT}, "
              f"{wall / N_WINDOWS * 1e3:.3f} ms/window, {N_WINDOWS / wall:.2f} windows/s "
              f"(engine time {r['time']:.3f} ms/window, {r['macs']:.1f} MMAC/window, "
              f"mean esr_mse {r['esr_mse']:.5f}) on {card}")
    print(f"rasterizer launches on the main path: {launches}")
    check(launches > 0, "the main path never launched the rasterizer")
    for name, eng in engines:
        profile_rollout(name, eng, load_chunk, min(16, N_WINDOWS))

    # the same engine on the CPU (plain rasterizer, CPU convolutions) over
    # the first windows: per-window MSEs agree to float32 reassociation
    for (name, eng), (_, r, _) in zip(engines, results):  # the first pass
        if not name.endswith("float32"):
            continue
        n = min(8 if name.startswith("plain") else 4, N_WINDOWS)
        cpu = InferenceEngine(eng.model.cpu(), DatasetConfig(scale=SCALE), chunk_size=CHUNK,
                              visualize=False, device="cpu")
        ref = cpu.infer_windows(load_chunk, n, LR, GT, return_per_window=True)["per_window"]
        for key in ("esr_mse", "bicubic_mse"):
            got = r["per_window"][key][:n]
            np.testing.assert_allclose(got, ref[key], rtol=1e-4, atol=1e-6)
        d = float(np.abs(r["per_window"]["esr_mse"][:n] / ref["esr_mse"] - 1).max())
        print(f"engine {name}: CUDA vs CPU on the first {n} windows, max rel |d| esr_mse {d:.2e}"
              " (rtol 1e-4)")
    return launches


def profile_rollout(name: str, eng, load_chunk, n: int) -> None:
    """Where the time of a rollout goes: wall time per window against the
    device's busy time (sum of kernel times) under ``torch.profiler``, and
    the kernels that take most of it.  The profiler slows the host, so the
    wall time here is above the unprofiled rollout's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.infer_windows(load_chunk, n, LR, GT)
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # kernel rows only: operator rows repeat the time of the kernels they launch
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_time = lambda e: e.self_device_time_total  # noqa: E731
    busy_ms = sum(dev_time(e) for e in rows) / 1e3 / n
    check(busy_ms > 0, f"profile {name}: the trace shows no device time")
    top = sorted(rows, key=dev_time, reverse=True)[:4]
    print(f"profile {name}: wall {wall_ms:.3f} ms/window, device busy {busy_ms:.3f} ms/window "
          f"(idle share {1 - busy_ms / wall_ms:.1%}, {len(rows)} kernel kinds); top kernels: "
          + "; ".join(f"{e.key[:60]} {dev_time(e) / 1e3 / n:.3f} ms x{e.count / n:.1f}"
                      for e in top))


def phase_h5(dev) -> str:
    """Goldens through h5 when h5py imports; returns which route ran."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("h5 route skipped: h5py is not importable here")
        return "in-memory only"
    import numpy as np

    from bmcnet_esr_torch.cli import infer as cli_infer
    from bmcnet_esr_torch.data import DatasetConfig, SequenceConfig, write_synthetic_fixture
    from bmcnet_esr_torch.inference import InferenceEngine, load_model_for_inference

    ckpt = os.path.join(ROOT, "tests", "goldens", "plain_nfs_x4_ckpt.npz")
    with np.load(os.path.join(ROOT, "tests", "goldens", "infer_goldens.npz")) as z:
        g = {k: z[k] for k in z.files}
    scale, window, sliding, seqn, seql, step, seed = (int(v) for v in g["meta"])
    h, w = (int(v) for v in g["sensor"])
    work = os.path.join(ROOT, "outputs", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        path = write_synthetic_fixture(
            os.path.join(tmp, "fixture.h5"), (h, w), ("ori", "down4"),
            {"ori": int(g["events_ori"]), "down4": int(g["events_down4"])}, seed=seed,
        )
        model = load_model_for_inference(ckpt, scale, variant="plain", device=dev)
        cfg = DatasetConfig(scale=scale, ori_scale="down4", window=window,
                            sliding_window=sliding, sequence=SequenceConfig(seql, seqn, step))
        r = InferenceEngine(model, cfg, chunk_size=16, visualize=False, device=dev).infer_file(
            path, return_per_window=True)
        n = len(g["esr_mse"])
        for key in ("esr_mse", "bicubic_mse"):
            ours = r["per_window"][key][:n]
            np.testing.assert_allclose(ours, g[key], **GOLDEN_TOL)
            print(f"h5 goldens {key}: max |d| {float(np.abs(ours - g[key]).max()):.3e} "
                  f"over {n} windows ({GOLDEN_TOL})")
        out = cli_infer.main([
            "--model_path", ckpt, "--variant", "plain", "--data_path", path,
            "--output_path", os.path.join(tmp, "out"), "--scale", str(scale),
            "--ori_scale", "down4", "--window", str(window), "--sliding_window", str(sliding),
            "--seql", str(seql), "--chunk_size", "16", "--need_gt_events", "--no_images",
            "--device", "cuda",
        ])
        mean = out["mean"]["esr_mse"]
        want = float(np.mean(r["per_window"]["esr_mse"]))
        check(abs(mean - want) <= 1e-5 * abs(want), f"cli.infer mean esr {mean} vs {want}")
        print(f"cli.infer on the h5 fixture: mean esr_mse {mean:.6f} (infer_file {want:.6f})")
    return "h5 (infer_file + cli.infer)"


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip smoke: torch is not importable", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "bmcnet_esr_torch")):
        print("chip smoke: run from a checkout that holds bmcnet_esr_torch/", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from bmcnet_esr_torch.utils import strict_fp32

    strict_fp32()
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    err, inputs = phase_kernels(dev)
    phase_checkpoint(dev)
    launches = phase_rollouts(dev, card)
    route = phase_h5(dev)
    print(f"parity route: {route}")
    t = time_rasterizer(inputs)

    kernels = [{
        "name": "rasterize_counts",
        "route": "cuda",
        "source": "bmcnet_esr_torch/csrc/rasterize.cu",
        "replaces": "bmcnet_esr_tpu/ops/pallas/rasterize.py:44",
        "launches": launches,
        "max_abs_err": err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": t["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
