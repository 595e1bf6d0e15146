#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``bmcnet_esr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX or of
``bmcnet_esr_tpu`` and fails (non-zero exit, no result line) without CUDA or
without the port's package beside it.  Phases, each of which raises on
failure:

1. card identity (``nvidia-smi`` name and power limit);
2. build every CUDA kernel from ``bmcnet_esr_torch/csrc`` (one ``nvcc`` per
   source, all at once) and hold each one bit-exact against its plain
   PyTorch version: the rasterizer at the main path's chunk shapes, on an
   adversarial window, with every event on one pixel, on one window, on a
   one-row image, on odd N and odd W, on N = 4 mod 8, and at a shape its
   plan gives to the per-event kernel, each into an output pre-filled with
   NaN (nothing zero-fills it any more); ``quantize_act`` also on lanes that
   start off a vector's boundary; ``quantize_act``, ``quant_matmul`` and
   ``quant_conv3x3`` at every channel count of the int8 path at 45x80, one
   and four lanes, in each input and output form, and on adversarial values
   (exact half-steps of the scale, values past +-127 steps, a ``[1]`` scale
   broadcast to three lanes, a 7x13 image), on a ReLU output with ``-0.0``
   entries, at eight lanes, on 1x1 and 2x3 images, with 160 output channels
   and 640 input channels, and on every finite bf16 value at five scales;
3. the released BMCNet_plain checkpoint (n_c=128, n_b=5, x4) on the card:
   RMSE < 1e-3 against the reference rollout in ``tests/goldens``, bf16 and
   every int8 dtype within rel-RMSE 5e-2 of float32;
4. the main path: chunked ``InferenceEngine`` rollouts of 64 windows at
   45x80 -> 180x320 (2048 LR events per window), fed compact windows made
   with numpy: full BMCNet with seeded random weights in float32, bfloat16,
   int8, int8_pall and int8_chainq, and the released plain checkpoint in
   float32, bfloat16 and all seven int8 dtypes.  Every kernel's launch
   count is reset just before each rollout and read just after; for the
   int8 dtypes it must equal the count derived from the model's structure.
   Then ``torch.profiler`` breakdowns, and the float32 engines' first
   windows rolled out again on the CPU and compared;
5. when ``h5py`` imports: ``infer_file`` and ``cli.infer`` on the fixture of
   ``tests/goldens/infer_goldens.npz``, per-window MSEs against the goldens,
   and ``cli.infer --dtype int8_pall``;
6. each kernel's time against its plain version, its bound and a library
   call, at the main path's shapes (medians of three repeats with their
   spread, yardsticks timed in turns with the kernels, the SM clock before
   and after).  It runs between phases 3 and 4, because the profiler loses
   device records late in a long process; the JSON line with all of it is
   printed at the end.

The last line is ``{"ok": true, "device": {...}}``.  ``--phases`` runs a
subset of phases 2b-6 after the build, for work on one of them, and then
prints no result line.
"""

from __future__ import annotations

import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data-sheet memory rate
INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8 tensor-core peak
LR, GT, SCALE, N_LR = (45, 80), (180, 320), 4, 2048
N_WINDOWS, CHUNK, CALIB_STEPS = 64, 32, 16
GOLDEN_TOL = dict(rtol=1e-3, atol=2e-5)  # GPU conv summation order vs CPU goldens
INT8_BOUND = 5e-2  # rel-RMSE of an int8 dtype against float32 (TestInt8Serving)
FULL_INT8 = ("int8", "int8_pall", "int8_chainq")

# The int8 kernels' shapes on the main path (n_c=128, n_b=5, x4, 45x80) with
# their call sites per window of the full BMCNet, read off the model:
# 3x3 convs (Cin, Cout): conv_fpst x2 at 2*3+128+16 = 150, conv_fps x2 at
# 3+128 = 131, conv_fs x3 at 3*128+2*16 = 416, the 100 block convs and
# conv_hs / conv_hp / conv_hn at 128, conv_o at 256 -> 32; 1x1 convs (K):
# 15 BIE calls, each with convf1 x2 and unclustering at 256 and
# clustering x2, v1 and v2 at 128.  The plain model adds conv_fs at
# 4*3+128+2*16 = 172.
FULL_CONV3 = {(150, 128): 2, (131, 128): 2, (416, 128): 3, (128, 128): 103, (256, 32): 1}
PLAIN_CONV3 = {(150, 128): 2, (172, 128): 1, (128, 128): 21, (256, 32): 1}
FULL_QMM = {256: 45, 128: 60}


def site_counts(variant: str, n_b: int = 5):
    """Call sites per forward, from the model's structure: (3x3 convs, 1x1
    convs, ResidualBlock calls).  Plain: conv_f1 x2, conv_fs, conv_h, conv_o
    and n_b BIE calls (a ResidualBlock on each of two inputs, 7 1x1 convs).
    Full: conv_fpst x2, conv_fps x2, conv_fs x3, conv_hs / hp / hn, conv_o
    and n_b ParallelBlk calls (4 ResidualBlock calls and 3 BIE calls)."""
    if variant == "plain":
        return 5 + 4 * n_b, 7 * n_b, 2 * n_b
    return 11 + 20 * n_b, 3 * 7 * n_b, (4 + 3 * 2) * n_b


def expected_launches(variant: str, dtype: str, n_windows: int, calib_steps: int) -> dict:
    """int8 kernel launches of one engine rollout: ``calib_steps`` forwards
    on the dynamic path (every 3x3 conv, and every 1x1 conv in the p1x1
    modes, through the kernels' int8-input form), then ``n_windows``
    forwards on static scales."""
    n3, n1, n_rb = site_counts(variant)
    steps = calib_steps + n_windows
    quantize = {"int8_pquant": n3, "int8_chainq": n3 - n_rb}.get(dtype, 0)
    return {
        "quantize_act": n_windows * quantize,
        "quant_matmul": steps * n1 if dtype in ("int8_p1x1", "int8_pall") else 0,
        "quant_conv3x3": steps * n3 if dtype.startswith("int8") else 0,
    }


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean ms per call, CUDA events around ``iters`` back-to-back calls.
    Where a call's host work (Python, ctypes, small allocations) takes
    longer than its kernels, this is the host's rate, not the device's."""
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


def device_ms(fn, iters: int = 20, warmup: int = 3, launches: int = 0) -> float:
    """Mean device time per call: the summed duration of every kernel,
    copy and fill that ``iters`` calls put on the card (``torch.profiler``),
    free of the host's launch overhead.  The profiler here now and then
    returns a trace with no device record, or with only a part of them
    (seen late in a long process: a quarter of the launches made through
    ctypes).  So where the caller knows that ``fn`` puts ``launches`` kernels
    on the card, the time is the mean over the records that did arrive,
    times ``launches``; otherwise the number of records must be a multiple
    of ``iters``, and a trace that fails this is taken again (at most
    twice, and said so)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    ms = 0.0
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        us, n = sum(e.self_device_time_total for e in rows), sum(e.count for e in rows)
        if launches and n > 0:
            return us / n * launches / 1e3
        if us > 0:
            ms = us / 1e3 / iters
            if n % iters == 0:
                return ms
        print(f"device_ms: profiler trace {attempt + 1} recorded {n} device records for "
              f"{iters} calls, again")
        time.sleep(0.5)
    check(ms > 0, "the profiler saw no device time")
    print("device_ms: keeping a trace whose records are not a multiple of the calls")
    return ms


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

    from bmcnet_esr_torch.kernels import _build, qconv, qmm, quantize, rasterize
    from bmcnet_esr_torch.ops.batch import compact_events

    sources = [m.SOURCE for m in (rasterize, quantize, qmm, qconv)]
    t0 = time.perf_counter()
    _build.build_all(sources)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {', '.join(sources)}")
    for log in sorted(glob.glob(os.path.join(_build.BUILD_DIR, "*", "*.log"))):
        with open(log) as f:
            text = f.read()
        regs = [int(v) for v in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores", text))
        if regs:
            print(f"  {os.path.basename(log)[:-4]}.cu: {len(regs)} kernels, {min(regs)}-{max(regs)} "
                  f"registers a thread, {spills} bytes of spill stores")

    rng = np.random.default_rng(0)
    hot = random_windows(rng, CHUNK, SCALE**2 * N_LR, GT)
    hot[:, 0], hot[:, 1] = 7, 9  # every event of every window on one pixel
    wide = (2, 30000)  # one row of counters exceeds shared memory: the per-event kernel
    cases = {
        "lr_chunk": (random_windows(rng, CHUNK + 1, N_LR, LR, pad=64), LR),
        "gt_chunk": (random_windows(rng, CHUNK, SCALE**2 * N_LR, GT, pad=512), GT),
        "adversarial": (adversarial_window(LR), LR),
        "hot_pixel": (hot, GT),
        "one_window": (random_windows(rng, 1, SCALE**2 * N_LR, GT, pad=512), GT),
        "one_row": (random_windows(rng, 5, N_LR, (1, 320)), (1, 320)),
        "odd_n_odd_w": (random_windows(rng, 3, 2047, (9, 13), pad=9), (9, 13)),
        "n_4_mod_8": (random_windows(rng, 3, 2044, LR), LR),
        "one_pixel_image": (random_windows(rng, 2, 512, (1, 1)), (1, 1)),
        "per_event_route": (random_windows(rng, 2, 4096, wide), wide),
    }
    err = 0.0
    inputs = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (ev, hw) in cases.items():
        xy, p = (torch.from_numpy(a).to(dev) for a in compact_events(ev))
        evd = torch.from_numpy(ev).to(dev)
        g, _, n = ev.shape
        plans = [rasterize.raster_plan(g, n, *hw, compact, sms=sms) for compact in (True, False)]
        check((plans[0]["route"] == "event") == (name == "per_event_route"),
              f"{name}: the plan took the {plans[0]['route']} route")
        # into buffers full of NaN: an element no block writes would show
        junk = [torch.full((g, *hw, 2), float("nan"), device=dev) for _ in range(2)]
        got = rasterize.counts_from_compact(xy, p, hw, out=junk[0])
        want = rasterize.counts_plain(xy[:, 0], xy[:, 1], p, hw)
        got_raw = rasterize.counts_from_events(evd, hw, out=junk[1])
        want_raw = rasterize.counts_plain(evd[:, 0], evd[:, 1], evd[:, 3], hw)
        fresh = rasterize.counts_from_compact(xy, p, hw)
        torch.cuda.synchronize()
        d = max(float((got - want).abs().max()), float((got_raw - want_raw).abs().max()),
                float((got - got_raw).abs().max()), float((fresh - want).abs().max()))
        check(d == 0.0, f"rasterizer differs from its plain version on {name}: {d}")
        check(float(got.sum()) > 0, f"empty count image on {name}")
        err = max(err, d)
        inputs[name] = (xy, p, hw)
        print(f"rasterize {name}: G={g} N={n} {hw}: bit-exact into NaN-filled outputs, "
              f"{int(got.sum())} counts; plan compact {plans[0]}, raw {plans[1]}")
    # no events at all: the kernel still has to write the zeros
    xy = torch.zeros((2, 2, 0), dtype=torch.int16, device=dev)
    p = torch.zeros((2, 0), dtype=torch.int8, device=dev)
    got = rasterize.counts_from_compact(
        xy, p, LR, out=torch.full((2, *LR, 2), float("nan"), device=dev))
    torch.cuda.synchronize()
    check(float(got.abs().max()) == 0.0, "N = 0 does not give a zero image")
    return err, inputs


def per_event_counts(xy, p, hw):
    """The kept per-event kernel (memset + one atomicAdd per event) forced on
    a shape whose plan takes the band kernel: the earlier design, for timing
    beside the new one."""
    import torch

    from bmcnet_esr_torch.kernels import _build, rasterize

    g, _, n = xy.shape
    out = torch.empty((g, *hw, 2), dtype=torch.float32, device=xy.device)
    lib = rasterize._lib()
    _build.launch(lib.rasterize_counts_compact,
                  (xy.data_ptr(), p.data_ptr(), out.data_ptr(), g, n, *hw, 0, 256, 0),
                  xy.device, lib.rasterize_error_string)
    return out


def device_records(fn) -> dict:
    """Name -> count of everything one call of ``fn`` puts on the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def time_rasterizer(inputs) -> dict:
    """Kernel, plain and library times at the main path's chunk shapes (one
    LR call + one GT call), beside the byte bound; the kept per-event kernel
    at the same shapes, timed in turns with the band kernel; and both on a
    GT chunk with every event on one pixel.  Medians of three repeats."""
    import torch

    from bmcnet_esr_torch.kernels import rasterize

    xy, p, hw = inputs["gt_chunk"]
    recs = device_records(lambda: rasterize.counts_from_compact(xy, p, hw))
    print(f"rasterize profile of one counts_from_compact call (gt_chunk): {recs}")
    check(len(recs) == 1 and all("band_kernel" in k and c == 1 for k, c in recs.items()),
          f"one call put more than the one band kernel on the card: {recs}")
    out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "event_ms": 0.0}
    for name in ("lr_chunk", "gt_chunk", "hot_pixel"):
        xy, p, (h, w) = inputs[name]
        g, _, n = xy.shape
        want = rasterize.counts_plain(xy[:, 0], xy[:, 1], p, (h, w))
        check(torch.equal(per_event_counts(xy, p, (h, w)), want), f"per-event kernel on {name}")
        (ms, sp), (ems, esp) = median_ms(
            (lambda: rasterize.counts_from_compact(xy, p, (h, w)), 1),
            lambda: per_event_counts(xy, p, (h, w)))
        if name != "lr_chunk":  # the raw float32 form of the same windows (float counters)
            raw = torch.zeros((g, 4, n), device=xy.device)
            raw[:, 0], raw[:, 1], raw[:, 3] = xy[:, 0].float(), xy[:, 1].float(), p.float()
            check(torch.equal(rasterize.counts_from_events(raw, (h, w)), want), f"raw form {name}")
            ((rms, rsp),) = median_ms((lambda: rasterize.counts_from_events(raw, (h, w)), 1))
            print(f"rasterize timing {name}: raw float32 form, band kernel {rms:.5f} ms "
                  f"(spread {rsp:.1%})")
        if name == "hot_pixel":
            print(f"rasterize timing {name} (every event of a window on one pixel): band kernel "
                  f"{ms:.5f} ms (spread {sp:.1%}), per-event kernel with its memset {ems:.5f} ms "
                  f"(spread {esp:.1%})")
            continue
        ev = cuda_ms(lambda: rasterize.counts_from_compact(xy, p, (h, w)))
        plain = device_ms(lambda: rasterize.counts_plain(xy[:, 0], xy[:, 1], p, (h, w)))
        # library yardstick: one index_put_ scatter into a fresh zero image,
        # with the flat indices and values computed beforehand (not timed)
        x, y = xy[:, 0].long(), xy[:, 1].long()
        valid = (x >= 0) & (x < w) & (y >= 0) & (y < h) & (p != 0)
        gi = torch.arange(g, device=xy.device)[:, None].expand(g, n)
        idx = ((gi * h + (h - 1 - y)) * w + x) * 2 + (p < 0).long()
        idx, val = idx[valid], (p[valid].float() ** 2)
        lib = device_ms(lambda: torch.zeros(g * h * w * 2, device=xy.device)
                        .index_put_((idx,), val, accumulate=True))
        bound = (g * n * 5 + g * h * w * 2 * 4) / HBM_BYTES_PER_S * 1e3
        print(f"rasterize timing {name}: band kernel {ms:.5f} ms on the device (spread {sp:.1%}; "
              f"{ev:.5f} ms per call back to back, host included), per-event kernel with its "
              f"memset {ems:.5f} ms (spread {esp:.1%}), plain {plain:.5f} ms, index_put_ "
              f"{lib:.5f} ms, bound {bound:.5f} ms")
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", bound),
                     ("event_ms", ems)):
            out[k] += v
    print(f"rasterize timing LR + GT chunk: band kernel {out['ms']:.5f} ms, per-event kernel "
          f"{out['event_ms']:.5f} ms, bound {out['bound_ms']:.5f} ms "
          f"({out['bound_ms'] / out['ms']:.1%} of the time)")
    return out


def phase_int8_kernels(dev) -> dict:
    """quantize_act, quant_matmul and quant_conv3x3 bit-exact (int8 and
    bf16 outputs alike) against their plain versions on the card; returns
    the largest |difference| of each (0 when it passes)."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.kernels import qconv, qmm, quantize

    rng = np.random.default_rng(2)
    err = {"quantize_act": 0.0, "quant_matmul": 0.0, "quant_conv3x3": 0.0}
    cases = {k: 0 for k in err}

    def same(name, got, want, what):
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{name} on {what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
        d = float((got.float() - want.float()).abs().max())
        err[name] = max(err[name], d)
        check(d == 0.0, f"{name} differs from its plain version on {what}: max |d| {d}")
        cases[name] += 1

    def dev_t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev).to(dtype)

    def lane_scales(b):
        return dev_t(rng.uniform(3.0, 9.0, b) / 127.0)

    def conv_case(x, cin, cout, sx, what):
        wq, sw = qconv.quantize_weights3x3(dev_t(rng.normal(0, 0.05, (3, 3, cin, cout))))
        bias, se = dev_t(rng.normal(0, 0.5, cout)), lane_scales(x.shape[0])
        xq = quantize.quantize_plain(x, sx)
        for xin in (x, xq):  # fused quantize, then the int8-input form
            same("quant_conv3x3", qconv.quant_conv3x3(xin, wq, sw, sx, bias),
                 qconv.qconv3x3_plain(xin, wq, sw, sx, bias), f"{what} {xin.dtype}")
        same("quant_conv3x3",
             qconv.quant_conv3x3(x, wq, sw, sx, bias, out_dtype=torch.float32),
             qconv.qconv3x3_plain(x, wq, sw, sx, bias, torch.float32), f"{what} float32 out")
        same("quant_conv3x3",
             qconv.quant_conv3x3(xq, wq, sw, sx, bias, emit_scale=se, emit_relu=True),
             qconv.qconv3x3_plain(xq, wq, sw, sx, bias, emit_scale=se, emit_relu=True),
             f"{what} int8 emit")

    def qmm_case(x, k, sx, what, n=128):
        wq, sw = qmm.quantize_weights(dev_t(rng.normal(0, 0.1, (k, n))))
        bias = dev_t(rng.normal(0, 0.5, n))
        for xin in (x, quantize.quantize_plain(x, sx)):
            same("quant_matmul", qmm.quant_matmul(xin, wq, sw, sx, bias),
                 qmm.qmm_plain(xin, wq, sw, sx, bias), f"{what} {xin.dtype}")
        same("quant_matmul", qmm.quant_matmul(x, wq, sw, sx, bias, out_dtype=torch.float32),
             qmm.qmm_plain(x, wq, sw, sx, bias, torch.float32), f"{what} float32 out")

    h, w = LR
    cins = sorted({c for c, _ in [*FULL_CONV3, *PLAIN_CONV3]})
    for b in (1, 4):
        for c in cins:
            x, sx = dev_t(rng.normal(0, 2.0, (b, h, w, c)), torch.bfloat16), lane_scales(b)
            for relu in (False, True):
                same("quantize_act", quantize.quantize_act(x, sx, relu),
                     quantize.quantize_plain(x, sx, relu), f"B={b} C={c} relu={relu}")
        for k in FULL_QMM:
            x = dev_t(rng.normal(0, 2.0, (b, h * w, k)), torch.bfloat16)
            qmm_case(x, k, lane_scales(b), f"B={b} M={h * w} K={k}")
        for cin, cout in sorted({*FULL_CONV3, *PLAIN_CONV3}):
            x = dev_t(rng.normal(0, 2.0, (b, h, w, cin)), torch.bfloat16)
            conv_case(x, cin, cout, lane_scales(b), f"B={b} {h}x{w} {cin}->{cout}")

    # adversarial: a [1] scale of 2**-4 shared by 3 lanes, a 7x13 image, and
    # values at every half-step (k + 1/2) * sx up to +-127.5 steps (ties
    # round to even), on whole steps, and far past +-127 steps (clipped)
    sx1 = dev_t([2.0**-4])
    vals = np.concatenate([(np.arange(-128, 128) + 0.5) / 16, np.arange(-127, 128) / 16,
                           [300 / 16, -300 / 16, 2.0**14, -(2.0**14), 0.0]])
    for dtype in (torch.bfloat16, torch.float32):
        arr = np.resize(rng.permutation(vals), (3, 7, 13, 131)).astype(np.float32)
        x = dev_t(arr, dtype)
        check(torch.equal(x.float().cpu(), torch.from_numpy(arr)), f"adversarial {dtype} inexact")
        for relu in (False, True):
            same("quantize_act", quantize.quantize_act(x, sx1, relu),
                 quantize.quantize_plain(x, sx1, relu), f"adversarial {dtype} relu={relu}")
        qmm_case(x.reshape(3, 7 * 13, 131), 131, sx1, f"adversarial {dtype}")
        conv_case(x, 131, 32, sx1, f"adversarial {dtype} 7x13")

    # a ReLU output (half zeros) with -0.0 entries; eight lanes; images
    # smaller than one tile; a second, ragged block of output channels
    # (160) and a K longer than one pass of the product (640)
    x = torch.relu(dev_t(rng.normal(0, 2.0, (2, h, w, 128)), torch.bfloat16))
    x[:, ::3, 1::2, ::5] = -0.0
    check(bool((x == 0).float().mean() > 0.5) and bool(torch.signbit(x).any()), "no -0.0 input")
    sx2 = lane_scales(2)
    conv_case(x, 128, 128, sx2, "ReLU output with -0.0")
    qmm_case(x.reshape(2, h * w, 128), 128, sx2, "ReLU output with -0.0")
    x = dev_t(rng.normal(0, 2.0, (8, h, w, 128)), torch.bfloat16)
    sx8 = lane_scales(8)
    conv_case(x, 128, 128, sx8, f"B=8 {h}x{w} 128->128")
    qmm_case(x.reshape(8, h * w, 128), 128, sx8, f"B=8 M={h * w} K=128")
    for ih, iw in ((1, 1), (2, 3)):
        x = dev_t(rng.normal(0, 2.0, (2, ih, iw, 150)), torch.bfloat16)
        conv_case(x, 150, 128, sx2, f"B=2 {ih}x{iw} 150->128")
    x = dev_t(rng.normal(0, 2.0, (2, 9, 21, 256)), torch.bfloat16)
    conv_case(x, 256, 160, sx2, "B=2 9x21 256->160")
    x = dev_t(rng.normal(0, 2.0, (2, 9, 21, 640)), torch.bfloat16)
    conv_case(x, 640, 32, sx2, "B=2 9x21 640->32")
    qmm_case(x.reshape(2, 9 * 21, 640), 640, sx2, "B=2 M=189 K=640 N=160", n=160)

    # every finite bf16 value at several scales (the kernels' shortcut around
    # the division and its fallback against the plain version's division)
    allv = torch.arange(65536, dtype=torch.int32, device=dev).to(torch.int16).view(torch.bfloat16)
    allv = allv[torch.isfinite(allv)]
    allv = torch.cat([allv, allv.new_zeros(-allv.numel() % 128)])
    for scale in (6.0 / 127.0, 0.0371, 2.0**-4, 1e-12 / 127.0, 3.0e5):
        s1 = dev_t([scale])
        qmm_case(allv.view(1, -1, 128), 128, s1, f"every bf16 value at scale {scale:.3e}")
        conv_case(allv.view(1, 1, -1, 128), 128, 64, s1, f"every bf16 value at scale {scale:.3e}")
    # quantize_act's units with its scalar head and tail: lanes that start off
    # a unit's boundary (odd C on small images), float32 input, eight lanes, a
    # view whose first element is off the boundary (input and output never on
    # one together: no unit at all), ReLU on -0.0, and every finite bf16 value
    def quant_case(x, sx, what):
        for relu in (False, True):
            same("quantize_act", quantize.quantize_act(x, sx, relu),
                 quantize.quantize_plain(x, sx, relu), f"{what} relu={relu}")

    sx3 = lane_scales(3)
    for dtype in (torch.bfloat16, torch.float32):
        for ih, iw, c in ((1, 1, 131), (2, 3, 131), (1, 1, 7), (3, 5, 150), (7, 13, 129)):
            x = dev_t(rng.normal(0, 2.0, (3, ih, iw, c)), dtype)
            quant_case(x, sx3, f"B=3 {ih}x{iw}x{c} {dtype}")
        flat = dev_t(rng.normal(0, 2.0, 1 + 2 * 9 * 5 * 37), dtype)
        quant_case(flat[1:].view(2, 9, 5, 37), sx2, f"view off the boundary {dtype}")
        quant_case(dev_t(rng.normal(0, 2.0, (8, h, w, 128)), dtype), sx8, f"B=8 C=128 {dtype}")
    x = torch.relu(dev_t(rng.normal(0, 2.0, (2, h, w, 131)), torch.bfloat16))
    x[:, ::3, 1::2, ::5] = -0.0
    check(bool(torch.signbit(x).any()), "no -0.0 input")
    quant_case(x, sx2, "ReLU output with -0.0")
    for scale in (6.0 / 127.0, 0.0371, 2.0**-4, 1e-12 / 127.0, 3.0e5):
        quant_case(allv.view(1, 1, -1, 128), dev_t([scale]),
                   f"every bf16 value at scale {scale:.3e}")
        quant_case(allv[3:-2].view(1, 1, 1, -1), dev_t([scale]),
                   f"every bf16 value off the boundary at scale {scale:.3e}")
    print("int8 kernels bit-exact against their plain versions on the card: "
          + ", ".join(f"{k} {n} cases" for k, n in cases.items()))
    return err


def sm_clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def median_ms(*fns, repeats: int = 3, iters: int = 20):
    """``device_ms`` of each of ``fns`` ``repeats`` times, in turns (a, b, a,
    b, ...) so that a drift of the clock hits all alike; per function the
    median in ms and the spread ``(max - min) / median``.  A function given
    as ``(fn, launches)`` puts that many kernels on the card per call."""
    fns = [f if isinstance(f, tuple) else (f, 0) for f in fns]
    runs = [[] for _ in fns]
    for _ in range(repeats):
        for r, (fn, launches) in zip(runs, fns):
            r.append(device_ms(fn, iters=iters, launches=launches))
    out = []
    for r in runs:
        med = sorted(r)[len(r) // 2]
        out.append((med, (max(r) - min(r)) / med))
    return out


def time_int8(dev) -> dict:
    """Time of each int8 kernel per window of the full BMCNet (n_c=128, n_b=5,
    x4, 45x80): each main-path shape timed alone (device time, one lane,
    median of three repeats with the spread beside it), weighted by its call
    sites.  ``quant_conv3x3`` and ``quant_matmul`` in their fused form
    (int8_pall), each in turns with its yardstick (cuDNN's bf16 convolution,
    ``torch._int_mm`` on the pre-quantized operand) and the ratio printed;
    ``quantize_act`` in front of every 3x3 conv (int8_pquant), and at C=128
    (one and eight lanes) and C=416 beside an empty kernel on its grid and a
    cast of the same bytes.  The bound is
    the larger of the bytes over 3.35 TB/s and the int8 operations over 1,979
    TOP/s.  Then the 128 -> 128 conv and the K = 128 product at one and at
    eight lanes, and the conv on a ReLU output.  The SM clock is printed
    before and after."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from bmcnet_esr_torch.kernels import qconv, qmm, quantize

    rng = np.random.default_rng(4)
    hw = LR[0] * LR[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def dev_t(shape, sd, dtype=torch.float32):
        return torch.from_numpy(rng.normal(0, sd, shape).astype(np.float32)).to(dev).to(dtype)

    def bound(nbytes, ops):
        """(bound ms, bytes ms, operations ms) of one call."""
        b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
        return max(b, o), b, o

    def conv_bound(lanes, cin, cout):
        return bound(lanes * 2 * hw * (cin + cout) + 9 * cin * cout + 8 * cout + 4 * lanes,
                     lanes * 2 * hw * cout * 9 * cin)

    def mm_bound(lanes, k, n=128):
        return bound(lanes * 2 * hw * (k + n) + k * n + 8 * n + 4 * lanes, lanes * 2 * hw * k * n)

    out = {n: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None,
               "bytes_ms": 0.0, "ops_ms": 0.0}
           for n in ("quantize_act", "quant_matmul", "quant_conv3x3")}

    def add(name, sites, ms, plain, bnd, lib=None):
        o = out[name]
        o["ms"] += sites * ms
        o["plain_ms"] += sites * plain
        for key, v in zip(("bound_ms", "bytes_ms", "ops_ms"), bnd):
            o[key] += sites * v
        if lib is not None:
            o["library_ms"] = (o["library_ms"] or 0.0) + sites * lib

    def conv_setup(lanes, cin, cout):
        x = dev_t((lanes, *LR, cin), 2.0, torch.bfloat16)
        wq, sw = qconv.quantize_weights3x3(dev_t((3, 3, cin, cout), 0.05))
        bias, packed = dev_t((cout,), 0.5), qconv.pack_weights3x3(wq)
        sx = torch.full((lanes,), 6.0 / 127.0, device=dev)
        # dense yardstick: cuDNN's bf16 convolution of the same shape
        wc = wq.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        return (x, wq, sw, sx, bias, packed,
                lambda xin: qconv.quant_conv3x3(xin, wq, sw, sx, bias, packed=packed),
                lambda: F.conv2d(x.permute(0, 3, 1, 2), wc, padding=1))

    def mm_setup(lanes, k):
        x = dev_t((lanes, hw, k), 2.0, torch.bfloat16)
        wq, sw = qmm.quantize_weights(dev_t((k, 128), 0.1))
        bias, packed = dev_t((128,), 0.5), qmm.pack_weights(wq)
        sx = torch.full((lanes,), 6.0 / 127.0, device=dev)
        xq = quantize.quantize_plain(x, sx).view(lanes * hw, k)
        # library yardstick: the int8 product alone, on the pre-quantized operand
        return (x, wq, sw, sx, bias,
                lambda: qmm.quant_matmul(x, wq, sw, sx, bias, packed=packed),
                lambda: torch._int_mm(xq, wq))

    # bring the clock up before the first measurement
    spin = dev_t((4096, 4096), 1.0, torch.bfloat16)
    for _ in range(200):
        spin @ spin
    torch.cuda.synchronize()
    print(f"int8 timing: SM clock, max SM clock before = {sm_clocks()}")

    for (cin, cout), sites in FULL_CONV3.items():
        x, wq, sw, sx, bias, packed, conv, dense = conv_setup(1, cin, cout)
        (ms, sp), (dms, dsp) = median_ms((lambda: conv(x), 1), dense)
        ev = cuda_ms(lambda: conv(x))
        xq = quantize.quantize_act(x, sx)
        ((ms_q, sp_q),) = median_ms((lambda: conv(xq), 1))
        plain = device_ms(lambda: qconv.qconv3x3_plain(x, wq, sw, sx, bias), iters=5)
        ((qms, qsp),) = median_ms((lambda: quantize.quantize_act(x, sx), 1))
        qplain = device_ms(lambda: quantize.quantize_plain(x, sx))
        bnd, qbnd = conv_bound(1, cin, cout), bound(3 * hw * cin, 0)
        print(f"int8 timing quant_conv3x3 {cin}->{cout} x{sites}/window: fused {ms:.5f} ms "
              f"(spread {sp:.1%}; {ev:.5f} ms per call back to back, host included), int8-input "
              f"{ms_q:.5f} ms (spread {sp_q:.1%}), plain {plain:.5f} ms, bound {bnd[0]:.5f} ms, "
              f"cuDNN bf16 conv (yardstick) {dms:.5f} ms (spread {dsp:.1%}), ratio to it "
              f"{ms / dms:.2f}x; quantize_act C={cin}: {qms:.5f} ms (spread {qsp:.1%}), plain "
              f"{qplain:.5f} ms, bound {qbnd[0]:.5f} ms")
        add("quant_conv3x3", sites, ms, plain, bnd)
        add("quantize_act", sites, qms, qplain, qbnd)
    for k, sites in FULL_QMM.items():
        x, wq, sw, sx, bias, mm, lib_mm = mm_setup(1, k)
        (ms, sp), (lib, lsp) = median_ms((mm, 1), lib_mm)
        plain = device_ms(lambda: qmm.qmm_plain(x, wq, sw, sx, bias), iters=5)
        bnd = mm_bound(1, k)
        print(f"int8 timing quant_matmul M={hw} K={k} N=128 x{sites}/window: {ms:.5f} ms "
              f"(spread {sp:.1%}), plain {plain:.5f} ms, torch._int_mm (product alone) "
              f"{lib:.5f} ms (spread {lsp:.1%}), ratio to it {ms / lib:.2f}x, "
              f"bound {bnd[0]:.5f} ms")
        add("quant_matmul", sites, ms, plain, bnd, lib)

    # one lane against eight, and a ReLU output (half zeros) against dense input
    for lanes in (1, 8):
        x, *_, conv, dense = conv_setup(lanes, 128, 128)
        xr = torch.relu(x)
        (ms, sp), (rms, rsp), (dms, dsp) = median_ms(
            (lambda: conv(x), 1), (lambda: conv(xr), 1), dense)
        print(f"int8 timing quant_conv3x3 128->128 at {lanes} lane(s): fused {ms:.5f} ms (spread "
              f"{sp:.1%}), on a ReLU output {rms:.5f} ms (spread {rsp:.1%}, {rms / ms:.2f}x the "
              f"dense input), bound {conv_bound(lanes, 128, 128)[0]:.5f} ms, cuDNN bf16 conv "
              f"{dms:.5f} ms (spread {dsp:.1%}), ratio to it {ms / dms:.2f}x")
        *_, mm, lib_mm = mm_setup(lanes, 128)
        (ms, sp), (lib, lsp) = median_ms((mm, 1), lib_mm)
        print(f"int8 timing quant_matmul K=128 N=128 at {lanes} lane(s): {ms:.5f} ms (spread "
              f"{sp:.1%}), bound {mm_bound(lanes, 128)[0]:.5f} ms, torch._int_mm {lib:.5f} ms "
              f"(spread {lsp:.1%}), ratio to it {ms / lib:.2f}x")
    # quantize_act beside the floor of a launch (a kernel that does nothing on
    # the same grid) and a yardstick of its traffic (a cast of the same bytes
    # to int8: the same reads and writes, not the same function)
    for lanes, c in ((1, 128), (8, 128), (1, 416)):
        x = dev_t((lanes, *LR, c), 2.0, torch.bfloat16)
        sx = torch.full((lanes,), 6.0 / 127.0, device=dev)
        (ms, sp), (fms, fsp), (cms, csp) = median_ms(
            (lambda: quantize.quantize_act(x, sx), 1),
            (lambda: quantize.launch_empty_grid(x), 1), lambda: x.to(torch.int8))
        qb = bound(lanes * 3 * hw * c, 0)[0]
        grid = quantize.quantize_plan(lanes, hw * c, sms=sms)["grid"]
        print(f"int8 timing quantize_act C={c} at {lanes} lane(s), grid {grid}: {ms:.5f} ms "
              f"(spread {sp:.1%}), bound {qb:.5f} ms ({qb / ms:.1%} of the time), empty kernel "
              f"on the same grid {fms:.5f} ms (spread {fsp:.1%}; {ms / fms:.2f}x that floor), "
              f"x.to(torch.int8) (yardstick of the traffic) {cms:.5f} ms (spread {csp:.1%}; "
              f"ratio to it {ms / cms:.2f}x)")
    print(f"int8 timing: SM clock, max SM clock after = {sm_clocks()}")

    for name, o in out.items():
        o["bound_by"] = "bytes" if o.pop("bytes_ms") >= o.pop("ops_ms") else "operations"
        lib = o["library_ms"]
        print(f"int8 timing {name} per window of the full model: {o['ms']:.5f} ms, plain "
              f"{o['plain_ms']:.5f} ms, bound {o['bound_ms']:.5f} ms ({o['bound_by']}), "
              f"library {lib}" + (f", ratio to it {o['ms'] / lib:.2f}x" if lib else ""))
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

    # every int8 dtype, static scales calibrated on the same windows, and
    # the default dtype once more on dynamic scales
    from bmcnet_esr_torch.inference.engine import INT8_DTYPES
    from bmcnet_esr_torch.models import calibrate_act_scales

    xs = torch.from_numpy(x).to(dev)
    for name, mode in [*INT8_DTYPES.items(), ("int8 (dynamic scales)", True)]:
        m = BMCNetPlain(scale=4, n_c=128, n_b=5, dtype=torch.bfloat16, quant=mode)
        m.load_state_dict(sd)
        m = m.to(dev, memory_format=torch.channels_last).eval()
        st = m.init_state(x.shape[1], x.shape[3], x.shape[4])
        out = []
        with torch.inference_mode():
            if "dynamic" not in name:
                calibrate_act_scales(m, xs, st)
            for xi in xs:
                st = m(xi, *st)
                out.append(st[-1].float().cpu().numpy())
        rel8 = float(np.sqrt(np.mean((np.stack(out) - preds[torch.float32]) ** 2))) / scale
        check(rel8 < INT8_BOUND, f"released checkpoint {name}: rel-RMSE {rel8} >= {INT8_BOUND}")
        print(f"released checkpoint {name}: rel-RMSE {rel8:.3e} vs fp32 (bound {INT8_BOUND})")


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


KERNEL_MODULES = ("rasterize", "quantize", "qmm", "qconv")
KERNEL_NAMES = {"rasterize": "rasterize_counts", "quantize": "quantize_act",
                "qmm": "quant_matmul", "qconv": "quant_conv3x3"}


def phase_rollouts(dev, card: str) -> dict:
    """The main path; returns each kernel's launches made by it."""
    import importlib

    import numpy as np
    import torch

    from bmcnet_esr_torch.data import DatasetConfig
    from bmcnet_esr_torch.inference import InferenceEngine
    from bmcnet_esr_torch.inference.engine import DTYPES, INT8_DTYPES
    from bmcnet_esr_torch.models import BMCNet, BMCNetPlain, load_checkpoint
    from bmcnet_esr_torch.ops.batch import compact_events

    mods = {n: importlib.import_module(f"bmcnet_esr_torch.kernels.{n}") for n in KERNEL_MODULES}
    rng = np.random.default_rng(1)
    inp = compact_events(random_windows(rng, N_WINDOWS + 1, N_LR, LR)[:, None])
    gt = compact_events(random_windows(rng, N_WINDOWS, SCALE**2 * N_LR, GT)[:, None])

    def load_chunk(pos, steps):
        return ((inp[0][pos : pos + steps + 1], inp[1][pos : pos + steps + 1]),
                (gt[0][pos : pos + steps], gt[1][pos : pos + steps]))

    plain_sd = load_checkpoint(os.path.join(ROOT, "tests", "goldens", "plain_nfs_x4_ckpt.npz"))
    full_sd = seeded_full_weights(BMCNet(scale=SCALE))
    configs = [("full", BMCNet, full_sd, d) for d in ("float32", "bfloat16", *FULL_INT8)]
    configs += [("plain", BMCNetPlain, plain_sd, d) for d in ("float32", "bfloat16", *INT8_DTYPES)]
    engines = []
    for variant, cls, sd, dtype in configs:
        m = cls(scale=SCALE, n_c=128, n_b=5, dtype=DTYPES.get(dtype, torch.bfloat16),
                quant=INT8_DTYPES.get(dtype, False))
        m.load_state_dict(sd)
        eng = InferenceEngine(m, DatasetConfig(scale=SCALE), chunk_size=CHUNK,
                              visualize=False, device=dev)
        eng.infer_windows(load_chunk, 4, LR, GT)  # warm-up, outside the counts
        engines.append((variant, dtype, eng))

    torch.cuda.synchronize()
    totals = {KERNEL_NAMES[n]: 0 for n in KERNEL_MODULES}
    results = []
    # each configuration twice, the second pass in reverse order, so that a
    # drift over the run shows as a spread between the two passes
    for variant, dtype, eng in engines + engines[::-1]:
        for mod in mods.values():
            mod.launches = 0
        t0 = time.perf_counter()
        r = eng.infer_windows(load_chunk, N_WINDOWS, LR, GT, return_per_window=True)
        wall = time.perf_counter() - t0
        got = {KERNEL_NAMES[n]: mod.launches for n, mod in mods.items()}
        want = expected_launches(variant, dtype, N_WINDOWS, min(CALIB_STEPS, CHUNK, N_WINDOWS))
        check(got["rasterize_counts"] > 0, f"{variant} {dtype}: the rasterizer never launched")
        for k, v in want.items():
            check(got[k] == v, f"{variant} {dtype}: {got[k]} {k} launches, the model gives {v}")
        for k, v in got.items():
            totals[k] += v
        results.append((variant, dtype, r, wall, got, want))

    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"after the rollouts: SM clock, max SM clock, power draw = {clocks}")
    for variant, dtype, r, wall, got, want in results:
        name = f"{variant} {dtype}"
        esr = r["per_window"]["esr_mse"]
        check(len(esr) == N_WINDOWS and np.all(np.isfinite(esr)), f"{name}: bad esr_mse")
        check(np.all(np.isfinite(r["per_window"]["bicubic_mse"])), f"{name}: bad bicubic_mse")
        counts = ", ".join(f"{k} {got[k]} (model {want[k]})" for k in want)
        print(f"rollout {name}: {N_WINDOWS} windows {LR} -> {GT}, "
              f"{wall / N_WINDOWS * 1e3:.3f} ms/window, {N_WINDOWS / wall:.2f} windows/s "
              f"(engine time {r['time']:.3f} ms/window, {r['macs']:.1f} MMAC/window, "
              f"mean esr_mse {r['esr_mse']:.5f}) on {card}; launches: rasterize_counts "
              f"{got['rasterize_counts']}, {counts}")
    for variant in ("full", "plain"):
        macs = {round(r["macs"], 1) for v, d, r, *_ in results if v == variant}
        check(len(macs) == 1, f"{variant}: MMAC/window differs between dtypes: {macs}")
    print(f"kernel launches on the main path: {totals}")
    for variant, dtype, eng in engines:
        if dtype in ("float32", "bfloat16", "int8", "int8_pall"):
            profile_rollout(f"{variant} {dtype}", eng, load_chunk, min(16, N_WINDOWS))

    # the same engine on the CPU (plain rasterizer, CPU convolutions) over
    # the first windows: per-window MSEs agree to float32 reassociation
    for (variant, dtype, eng), (*_, r, _w, _g, _e) in zip(engines, results):  # the first pass
        if dtype != "float32":
            continue
        n = min(8 if variant == "plain" else 4, N_WINDOWS)
        cpu = InferenceEngine(eng.model.cpu(), DatasetConfig(scale=SCALE), chunk_size=CHUNK,
                              visualize=False, device="cpu")
        ref = cpu.infer_windows(load_chunk, n, LR, GT, return_per_window=True)["per_window"]
        for key in ("esr_mse", "bicubic_mse"):
            got = r["per_window"][key][:n]
            np.testing.assert_allclose(got, ref[key], rtol=1e-4, atol=1e-6)
        d = float(np.abs(r["per_window"]["esr_mse"][:n] / ref["esr_mse"] - 1).max())
        print(f"engine {variant} {dtype}: CUDA vs CPU on the first {n} windows, max rel |d| "
              f"esr_mse {d:.2e} (rtol 1e-4)")
    return totals


def _profiled(fn, n: int, name: str, what: str) -> None:
    """Run ``fn`` under ``torch.profiler`` and print, per ``what`` (of which
    ``fn`` does ``n``): wall time, the device's busy time (sum of kernel
    times), kernel launches, and the kernels that take most of the time.
    The profiler slows the host, so the wall time is above an unprofiled
    run's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # kernel rows only: operator rows repeat the time of the kernels they launch
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_time = lambda e: e.self_device_time_total  # noqa: E731
    busy_ms = sum(dev_time(e) for e in rows) / 1e3 / n
    check(busy_ms > 0, f"profile {name}: the trace shows no device time")
    top = sorted(rows, key=dev_time, reverse=True)[:4]
    print(f"profile {name}: wall {wall_ms:.3f} ms/{what}, device busy {busy_ms:.3f} ms/{what} "
          f"(idle share {1 - busy_ms / wall_ms:.1%}, {sum(e.count for e in rows) / n:.0f} "
          f"kernel launches/{what}, {len(rows)} kernel kinds); top kernels: "
          + "; ".join(f"{e.key[:60]} {dev_time(e) / 1e3 / n:.3f} ms x{e.count / n:.1f}"
                      for e in top))


def profile_rollout(name: str, eng, load_chunk, n: int) -> None:
    """Where the time of a rollout goes, per window; for an int8 engine also
    its calibration, per calibration step."""
    import torch

    from bmcnet_esr_torch.inference import InferenceEngine
    from bmcnet_esr_torch.inference.engine import _calib_pairs
    from bmcnet_esr_torch.models import calibrate_act_scales

    if eng.model.quant:
        (xy, p), _ = load_chunk(0, CALIB_STEPS)
        pairs = _calib_pairs(torch.from_numpy(xy).to(eng.device),
                             torch.from_numpy(p).to(eng.device), LR)
        with torch.inference_mode():
            _profiled(lambda: calibrate_act_scales(
                eng.model, pairs, eng.model.init_state(1, *LR, device=eng.device)),
                len(pairs), f"{name} calibration", "step")
        # a fresh engine keeps the scales just calibrated (it takes them for
        # the caller's), so the rollout's profile holds no calibration
        eng = InferenceEngine(eng.model, eng.config, chunk_size=eng.chunk_size,
                              visualize=False, device=eng.device)
        eng.infer_windows(load_chunk, 2, LR, GT)
    _profiled(lambda: eng.infer_windows(load_chunk, n, LR, GT), n, name, "window")


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
        out8 = cli_infer.main([
            "--model_path", ckpt, "--variant", "plain", "--data_path", path,
            "--output_path", os.path.join(tmp, "out8"), "--scale", str(scale),
            "--ori_scale", "down4", "--window", str(window), "--sliding_window", str(sliding),
            "--seql", str(seql), "--chunk_size", "16", "--need_gt_events", "--no_images",
            "--device", "cuda", "--dtype", "int8_pall",
        ])
        mean8 = out8["mean"]["esr_mse"]
        check(abs(mean8 - want) <= 5e-2 * abs(want), f"cli.infer int8_pall mean esr {mean8}")
        print(f"cli.infer --dtype int8_pall on the h5 fixture: mean esr_mse {mean8:.6f}")
    return "h5 (infer_file + cli.infer, float32 and int8_pall)"


PHASES = ("int8_kernels", "checkpoint", "rollouts", "h5", "timing")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the phases after the kernel build, for "
                         f"work on one of them (default: all of {', '.join(PHASES)}); a partial "
                         "run prints no result line")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if not set(phases) <= set(PHASES):
        ap.error(f"unknown phase in {phases}: choose from {PHASES}")
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
    if "int8_kernels" in phases:
        errs8 = phase_int8_kernels(dev)
    if "checkpoint" in phases:
        phase_checkpoint(dev)
    if "timing" in phases:  # before the rollouts: the profiler loses records late in a long run
        t = time_rasterizer(inputs)
        t8 = time_int8(dev)
    if "rollouts" in phases:
        launches = phase_rollouts(dev, card)
    if "h5" in phases:
        print(f"parity route: {phase_h5(dev)}")
    if set(phases) != set(PHASES):
        print(card)
        print(f"partial run ({', '.join(phases)}): no result line")
        return 0

    kernels = [{
        "name": "rasterize_counts",
        "route": "cuda",
        "source": "bmcnet_esr_torch/csrc/rasterize.cu",
        "replaces": "bmcnet_esr_tpu/ops/pallas/rasterize.py:44",
        "launches": launches["rasterize_counts"],
        "max_abs_err": err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": t["library_ms"],
    }]
    for name, src, body in (("quantize_act", "quantize.cu", "quantize.py:49"),
                            ("quant_matmul", "qmm.cu", "qmm.py:65"),
                            ("quant_conv3x3", "qconv.cu", "qconv.py:101")):
        o = t8[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"bmcnet_esr_torch/csrc/{src}",
            "replaces": f"bmcnet_esr_tpu/ops/pallas/{body}",
            "launches": launches[name],
            "max_abs_err": errs8[name],
            "ms": o["ms"],
            "plain_ms": o["plain_ms"],
            "bound_ms": o["bound_ms"],
            "bound_by": o["bound_by"],
            "library_ms": o["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
