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
   float32, bfloat16 and all seven int8 dtypes.  Each rollout replays the
   CUDA graph its warm-up captured; it runs again with the engine's graph
   off, per-window MSEs bit-equal.  Every kernel's launch count is reset
   just before each rollout and read just after; with the graph off, for
   the int8 dtypes, it must equal the count derived from the model's
   structure, and graphed only calibration's (replays make no Python
   call).  Then ``torch.profiler`` breakdowns, the port's int8 kernels'
   device records a replayed window equal to the model's sites, and the
   float32 engines' first windows rolled out again on the CPU and compared;
5. when ``h5py`` imports: ``infer_file`` and ``cli.infer`` on the fixture of
   ``tests/goldens/infer_goldens.npz``, per-window MSEs against the goldens,
   and ``cli.infer --dtype int8_pall``;
6. each kernel's time against its plain version, its bound and a library
   call, at the main path's shapes (medians of three repeats with their
   spread, yardsticks timed in turns with the kernels, the SM clock before
   and after), the rasterizer's at the training path's shapes, its raw
   float32 form at the NFS and RGB recipes' training shapes and on a hot
   pixel, each loss term's device time at the RGB shapes, and a rank's
   first split convolutions of tensor parallelism (10f) through PyTorch's
   own kernels: exact zeros over all-zero patches, and their cost against
   cuDNN's.  It runs
   between phases 3 and 4, because the profiler loses device records late in
   a long process; the JSON line with all of it is printed at the end;
7. the training path (after phase 6, before phase 4): BPTT gradients of
   both variants against ``tests/goldens/grad_goldens.npz`` and the first 25
   Adam iterations against its losses; the NFS recipe
   (``configs/train_nfs.yml``, written out in :func:`nfs_recipe`) at full
   width through ``Trainer`` on seeded in-memory batches: 13 iterations with
   a validation pass and a checkpoint, a resume from it that repeats the
   last two iterations exactly (``Trainer`` sets cuDNN deterministic itself),
   ``skip_nonfinite`` and the EMA at full width (a batch with a NaN leaves
   every parameter and the Adam state bit-identical and is counted as
   skipped; the EMA equals the update done by hand in float64), then float32 and bfloat16 with remat off and on, and float32 remat off
   with the deterministic flag off, each timed (ms/iteration, device busy
   and idle share, launches, peak memory) with a falling loss on a fixed
   batch and exactly two rasterizer kernels an iteration in the profile;
8. the serving path (after phase 6, before phase 7) at full width (full
   BMCNet, 45x80, windows of 2048 events, 8 slots): ``StreamPool`` lanes
   with churn against solo ``StreamingSR`` streams in float32, bfloat16,
   int8_pall and int8_chainq, a deep tick of K=4 bit-exact against 4
   shallow ticks, the released checkpoint through one lane against the
   engine, then ``EventSRServer`` on loopback in bfloat16 and int8_pall
   (1 and 8 client threads, a pipelining client with a RELOAD), every PRED
   equal to a pool replay of the same pushes, each kernel's launches per
   tick against the model's count, timed and profiled per tick;
9. serving bundles (after phase 8): the full model exported with
   ``export_serving_bundle`` and served by ``ExportedStream`` in this
   process, float32 and int8_pall (static scales), each bit-exact against
   ``StreamingSR`` over 16 windows with each kernel's launches a push
   against the model's count; an int8_pall bundle of 8 lanes against the
   1-lane bundle on each stream; the float32 bundle served by a fresh
   process that imports no model code and starts with TF32 on, bit-exact
   against ``StreamingSR``; ms/window of the bundle against
   ``StreamingSR``; and the host cost of a call through each operator
   (``torch.ops.bmcnet.*``) against a direct call of its CUDA
   implementation and against the same implementation as a ``custom_op``;
10. data parallelism (after phase 7) at the NFS recipe's full width:
   a 1-rank NCCL group in this process whose ``make_parallel_train_step``
   equals ``make_train_step`` bit for bit over 3 iterations (losses, grad
   norms, every parameter), with ms/iteration of both and the all-reduce's
   device time; two spawned ranks over gloo on this one card (NCCL refuses
   two ranks on one GPU), one row of the batch each, identical parameters,
   losses within rtol 1e-5 of the single-device step on the whole batch,
   2 rasterizer launches an iteration on each, peak memory per rank; the
   engine's ``mesh=`` of two on this card (2 streams x 16 windows, full
   model in float32, int8_pall and int8_chainq), each shard bit-exact
   against its stream's solo rollout and within the batched-vs-solo
   bounds of the unsharded batch-2 rollout, launches as the model gives;
   then sharded serving on meshes of this card repeated: (d) an 8-slot
   ``StreamPool(mesh=)`` in two groups (float32, bfloat16, int8_pall,
   int8_chainq), each group bit-exact against an unsharded 4-slot pool
   through a hot reload, deep and compacted ticks bit-exact against
   shallow ones, ``EventSRServer(mesh=)`` with 8 client threads equal to a
   pool replay, timed and profiled; (e) ``StreamingSR(mesh=)`` over 3 row
   bands (float32 within 1e-5 of the unsharded stream, bfloat16 and
   int8_pall on static and dynamic scales within rel-RMSE 5e-2),
   ``quant_conv3x3`` at the band shape, and the released checkpoint's
   golden through 4 bands, with launches and cross-band steps as the
   model gives; (f) tensor parallelism: two spawned gloo ranks on this card
   run the ``Trainer`` with ``model_parallel: 2`` at full width, each
   convolution's output channels split in two, against the one-device
   steps (loss rel 1e-5, ``grad_norm`` rel 1e-4, parameters at atol 1e-5
   but for a share bounded by ``TP_PARAM_SHARE``, the first step's gathered
   gradient against the same step in float64 on one device, within
   ``TP_GRAD_FACTOR`` times the one-device gradient's distance), with
   ms/iteration,
   the collectives and bytes and peak memory of a rank, and checkpoints that
   resume across the two layouts within rel 1e-5;
11. the loss terms (after phase 7, before phase 10): ``loss_goldens.npz``
   and the plain and resnet entries of ``lpips_goldens.npz`` on the card;
   every term of the ``loss:`` registry and its gradients in float32 at
   the RGB recipe's shapes against the CPU in float64 (where float32 is
   ill-conditioned, within ``TERM_F32_FACTOR`` times the CPU float32's own
   distance, and float64 against float64); the perceptual
   recipe (``configs/train_RGB_percep.yml``: recon + LPIPS + temporal
   consistency, remat, ``grad_accum: 2``) at full width through ``Trainer``
   with a resume that repeats an iteration bit for bit, timed and profiled;
   and the raw-transfer case with an event term attached through ``fn:``
   and a bit-identical resume;
12. video -> events on the card (after phase 6, before phase 8): the demo
   video at the NFS preset's 360x640, 65 frames at 240 frames a second,
   simulated at scales 1, 2, 4 and 8 (``data/simulator.py``, 16 crossings
   a pixel, 8 intervals a chunk): (a) with threshold mismatch drawn on the
   host, refractory and leak on, the card's event lists bit-identical to
   the CPU's plain run of the same code; (b) with noise and hot pixels,
   ``simulate_counts`` equal to ``simulate``'s per-interval counts, the
   noise Poisson at its rate and the hot pixels at their gain, within 4
   sigma; (c) the down8 stream cut into the NFS recipe's windows, 32 pairs
   through ``InferenceEngine.infer_windows`` with the full BMCNet, the
   rasterizer's counts of every window equal to ``events_to_channels``;
   (d) the auxiliary encodings of 8 windows, card against CPU; (e) ms an
   interval, events/s, peak memory, a profiled chunk's idle share, and the
   native redistribution against numpy on the host;
13. Super SloMo and the tools (after phase 6, before phase 12): (a) both
   UNets (``data/upsampling.py``, 39.6 M parameters, seeded fixture
   weights) on two demo frames at 352x640, the flows and the frames at t =
   0.25, 0.4 and 0.75 in float32 against float64 on the card, within
   ``SLOMO_F32_FACTOR`` times the CPU float32's distance from it (the
   card's float64 held to the CPU's at 64x128), ms a flow pass and a
   frame, peak memory, frames/s of ``upsample_sequence``; (b) ``slomo_goldens.npz`` within the JAX test's
   bounds; (c) ``SuperSloMoUpsampler`` from a written ``.ckpt`` whose flow
   bias is raised so that frames are inserted, counts, timestamps and
   frames against the CPU; (d) the flows through ``flow_to_image`` and
   ``FlowVisualizer``, and ``cli.convert --pth`` to an ``.npz`` and a
   directory, each loaded on the card, one window bit-equal to the
   ``.pth``'s; (e) ``utils/profiling``: a ``trace`` of two ``annotate``d
   windows holds the spans and the rasterizer's records, ``device_time``
   within 20 % of CUDA events.

Every kernel is called through its ``torch.library`` operator; the
rasterizer's ``out=`` form through the operator's ``.into`` overload.  The
last line is ``{"ok": true, "device": {...}}``.  ``--phases`` runs a subset
of phases 2b-13 after the build, for work on one of them, and then prints no
result line.
"""

from __future__ import annotations

import functools
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
# windows (and calibration steps) of each rollout's profile: the profiler's
# host records of up to ~5,000 launches a window or step take about 0.8 s
# each to process (and about 4 s a profile): 210 of the rollouts phase's
# 252 s on an H100 at 16, 130 of 177 at 8
PROFILE_WINDOWS = 4
TRAIN_B, TRAIN_L = 2, 9  # configs/train_nfs.yml: batch 2, sequence_length 9
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


def nfs_recipe() -> dict:
    """``configs/train_nfs.yml`` as ``yaml.safe_load`` reads it (anchors
    resolved), written out here because the GPU machine may lack PyYAML and
    has no h5py; ``tests/test_torch_training.py`` holds the two equal."""
    aug = ["Horizontal", "Vertical", "Polarity"]

    def dataset(augment: bool) -> dict:
        return {
            "scale": 4, "ori_scale": "down8", "time_bins": 1, "need_gt_frame": False,
            "need_gt_events": True, "mode": "events", "window": 2048, "sliding_window": 1024,
            "data_augment": {"enabled": augment, "augment": list(aug),
                             "augment_prob": [0.5, 0.5, 0.5]},
            "sequence": {"sequence_length": 9, "seqn": 2, "step_size": None,
                         "pause": {"enabled": False, "proba_pause_when_running": 0.05,
                                   "proba_pause_when_paused": 0.9}},
        }

    def loader(split: str, train: bool) -> dict:
        return {"path_to_datalist_txt": f"datalist/{split}_nfs.txt", "batch_size": 2,
                "shuffle": train, "num_workers": 4, "drop_last": train,
                "dataset": dataset(train)}

    return {
        "experiment": "BMCNet_nfs",
        "SCALE": 4, "SEQN": 2, "SEQL": 9, "TIME_BINS": 1, "ORI_SCALE": "down8",
        "MODE": "events", "WINDOW": 2048, "SLIDING_WINDOW": 1024, "NEED_GT_FRAME": False,
        "NEED_GT_EVENTS": True, "PATH_TO_OUTPUT": "runs/",
        "PATH_TO_TRAIN": "datalist/train_nfs.txt", "PATH_TO_VALID": "datalist/valid_nfs.txt",
        "model": {"name": "BMCNet_syn_4x", "args": {"variant": "full", "n_c": 128, "n_b": 5}},
        "optimizer": {"name": "Adam", "args": {"lr": 1e-4, "weight_decay": 1e-5,
                                               "amsgrad": True}},
        "lr_scheduler": {"name": "ExponentialLR", "args": {"gamma": 0.95}},
        "trainer": {
            "output_path": "runs/", "remat": False,
            "iteration_based_train": {"enabled": True, "iterations": 100000,
                                      "save_period": 5000, "train_log_step": 50,
                                      "valid_log_step": 50, "valid_step": 1000,
                                      "lr_change_rate": 4000},
            "monitor": "min valid_loss", "early_stop": 100000000, "tensorboard": True,
        },
        "train_dataloader": loader("train", True),
        "valid_dataloader": loader("valid", False),
    }


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


# Every trace here opens and closes on an idle device, with this much host
# time between an edge and the work it frames.  The profiler drops device
# records that lie close inside a trace's edges, the more the longer the
# process has run: a training iteration's first kernels (the rasterizer's)
# went missing from a trace late in a run, and so did the first quarter of
# a short loop of kernel calls.
PROFILE_EDGE_S = 0.1


def profile_edge() -> None:
    """Drain the device, then let ``PROFILE_EDGE_S`` of host time pass."""
    import torch

    torch.cuda.synchronize()
    time.sleep(PROFILE_EDGE_S)


def first_device_ms(prof) -> float:
    """How long after the trace opened its first device record starts, on
    the profiler's clock (ms); with ``profile_edge`` at the opening, the
    cushion less this is how far the device clock ran behind the host's."""
    from torch.autograd import DeviceType

    starts = [e.time_range.start for e in prof.events() if e.device_type == DeviceType.CUDA]
    return min(starts) / 1e3 if starts else float("nan")


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


def device_ms(fn, iters: int = 20, warmup: int = 3, launches: int = 0,
              exact: bool = True) -> float:
    """Mean device time per call: the summed duration of every kernel,
    copy and fill that ``iters`` calls put on the card (``torch.profiler``),
    free of the host's launch overhead.  The trace opens and closes on an
    idle device (``profile_edge``).  The profiler here has returned a trace
    with no device record, or with only a part of them (late in a long
    process, before the edges had a cushion: a quarter of the launches
    made through ctypes).  So where the caller knows that ``fn`` puts ``launches`` kernels
    on the card, the time is the mean over the records that did arrive,
    times ``launches``; otherwise the number of records must be a multiple
    of ``iters``, and a trace that fails this is taken again (at most
    twice, and said so), unless ``exact`` is off (a call whose kernels vary,
    or a short loop of small kernels where a record near an edge may go
    missing: the first trace with device time is kept)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    ms = 0.0
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profile_edge()
            for _ in range(iters):
                fn()
            profile_edge()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        us, n = sum(e.self_device_time_total for e in rows), sum(e.count for e in rows)
        if launches and n > 0:
            return us / n * launches / 1e3
        if us > 0:
            ms = us / 1e3 / iters
            if n % iters == 0 or not exact:
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
        # one training batch: B * L windows in one call
        "train_lr": (random_windows(rng, TRAIN_B * TRAIN_L, N_LR, LR, pad=64), LR),
        "train_gt": (random_windows(rng, TRAIN_B * TRAIN_L, SCALE**2 * N_LR, GT, pad=512), GT),
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
        profile_edge()
        fn()
        profile_edge()
    return {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def raster_bound_ms(g: int, n: int, h: int, w: int) -> float:
    """The rasterizer's byte bound: compact events read once (5 bytes an
    event), the float32 image written once."""
    return (g * n * 5 + g * h * w * 2 * 4) / HBM_BYTES_PER_S * 1e3


def index_put_ms(xy, p, hw) -> float:
    """The library yardstick: one ``index_put_`` scatter into a fresh zero
    image, with the flat indices and values computed beforehand (not timed)."""
    import torch

    h, w = hw
    g, _, n = xy.shape
    x, y = xy[:, 0].long(), xy[:, 1].long()
    valid = (x >= 0) & (x < w) & (y >= 0) & (y < h) & (p != 0)
    gi = torch.arange(g, device=xy.device)[:, None].expand(g, n)
    idx = ((gi * h + (h - 1 - y)) * w + x) * 2 + (p < 0).long()
    idx, val = idx[valid], (p[valid].float() ** 2)
    return device_ms(lambda: torch.zeros(g * h * w * 2, device=xy.device)
                     .index_put_((idx,), val, accumulate=True))


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
        lib, bound = index_put_ms(xy, p, (h, w)), raster_bound_ms(g, n, h, w)
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
    # one training batch (B * L windows a call, the two calls of an iteration)
    train = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for name in ("train_lr", "train_gt"):
        xy, p, (h, w) = inputs[name]
        g, _, n = xy.shape
        ((ms, sp),) = median_ms((lambda: rasterize.counts_from_compact(xy, p, (h, w)), 1))
        raw = torch.zeros((g, 4, n), device=xy.device)
        raw[:, 0], raw[:, 1], raw[:, 3] = xy[:, 0].float(), xy[:, 1].float(), p.float()
        ((rms, rsp),) = median_ms((lambda: rasterize.counts_from_events(raw, (h, w)), 1))
        plain = device_ms(lambda: rasterize.counts_plain(xy[:, 0], xy[:, 1], p, (h, w)))
        lib, bound = index_put_ms(xy, p, (h, w)), raster_bound_ms(g, n, h, w)
        plan = rasterize.raster_plan(g, n, h, w, True, sms=torch.cuda.get_device_properties(
            xy.device).multi_processor_count)
        print(f"rasterize timing {name} (G={g} windows of one training batch, N={n}, {h}x{w}, "
              f"{plan['grid']} blocks of {plan['rows']} rows): band kernel {ms:.5f} ms (spread "
              f"{sp:.1%}), raw float32 form {rms:.5f} ms (spread {rsp:.1%}), plain {plain:.5f} ms, "
              f"index_put_ {lib:.5f} ms, bound {bound:.5f} ms ({bound / ms:.1%} of the time)")
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", bound)):
            train[k] += v
    print(f"rasterize timing per training iteration (LR + GT call): {train['ms']:.5f} ms, plain "
          f"{train['plain_ms']:.5f} ms, index_put_ {train['library_ms']:.5f} ms, bound "
          f"{train['bound_ms']:.5f} ms ({train['bound_ms'] / train['ms']:.1%} of the time)")
    out["train"] = train
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
# each kernel's functions in csrc/, as the profiler names them
KERNEL_FAMILIES = {"rasterize_counts": "band_kernel", "quantize_act": "quantize_kernel",
                   "quant_matmul": "qmm_kernel", "quant_conv3x3": "qconv3x3_kernel"}


def phase_rollouts(dev, card: str) -> dict:
    """The main path; returns each kernel's launches made by it.

    Each engine's warm-up captures its CUDA graph (``inference/graphs.py``;
    the ``rollout.capture`` span times it).  The timed rollout replays it,
    and the kernels' ``launches`` counters, which count Python calls, see
    calibration's and the rasterizer's launches alone.  The same rollout
    with the engine's graph off then counts the model's launches where they
    launch, against :func:`expected_launches`, and holds the graphed
    rollout's per-window MSEs bit for bit."""
    import importlib

    import numpy as np
    import torch

    from bmcnet_esr_torch.data import DatasetConfig
    from bmcnet_esr_torch.inference import InferenceEngine
    from bmcnet_esr_torch.inference.engine import DTYPES, INT8_DTYPES
    from bmcnet_esr_torch.models import BMCNet, BMCNetPlain, load_checkpoint
    from bmcnet_esr_torch.ops.batch import compact_events
    from bmcnet_esr_torch.utils import timers

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
    mark, steps = [time.perf_counter()], {}

    def step(name):  # seconds since the last step, by name
        steps[name] = time.perf_counter() - mark[0]
        mark[0] = time.perf_counter()

    engines = []
    for variant, cls, sd, dtype in configs:
        m = cls(scale=SCALE, n_c=128, n_b=5, dtype=DTYPES.get(dtype, torch.bfloat16),
                quant=INT8_DTYPES.get(dtype, False))
        m.load_state_dict(sd)
        eng = InferenceEngine(m, DatasetConfig(scale=SCALE), chunk_size=CHUNK,
                              visualize=False, device=dev)
        with timers.record():  # warm-up, outside the counts: it captures the graph
            eng.infer_windows(load_chunk, 4, LR, GT)
        capture = timers.summary().get("rollout.capture", {"count": 0, "total_ms": 0.0})
        timers.clear()
        check(capture["count"] == 1, f"{variant} {dtype}: {capture['count']} graph captures "
                                     "in the warm-up, expected 1")
        engines.append((variant, dtype, eng, capture["total_ms"]))

    torch.cuda.synchronize()
    step("engines and warm-ups")
    totals = {KERNEL_NAMES[n]: 0 for n in KERNEL_MODULES}
    results = []

    def counted(roll):
        for mod in mods.values():
            mod.launches = 0
        t0 = time.perf_counter()
        r = roll()
        wall = time.perf_counter() - t0
        return r, wall, {KERNEL_NAMES[n]: mod.launches for n, mod in mods.items()}

    for variant, dtype, eng, capture_ms in engines:
        name = f"{variant} {dtype}"
        roll = lambda: eng.infer_windows(load_chunk, N_WINDOWS, LR, GT,  # noqa: E731
                                         return_per_window=True)
        r, wall, graphed = counted(roll)
        eng._graphs, graphs_off = None, eng._graphs  # the same engine, eager
        try:
            r_eager, wall_eager, got = counted(roll)
        finally:
            eng._graphs = graphs_off
        calib = min(CALIB_STEPS, CHUNK, N_WINDOWS)
        want = expected_launches(variant, dtype, N_WINDOWS, calib)
        check(got["rasterize_counts"] > 0, f"{name}: the rasterizer never launched")
        for k, v in want.items():
            check(got[k] == v, f"{name}: {got[k]} {k} launches, the model gives {v}")
        for k, v in {"rasterize_counts": got["rasterize_counts"],
                     **expected_launches(variant, dtype, 0, calib)}.items():
            check(graphed[k] == v, f"{name}: the graphed rollout counted {graphed[k]} {k} "
                                   f"Python launches, calibration and the rasterizer make {v}")
        for key in ("esr_mse", "bicubic_mse"):
            check(np.array_equal(r["per_window"][key], r_eager["per_window"][key]),
                  f"{name}: the graphed rollout's {key} differs from the eager one's")
        for k, v in got.items():
            totals[k] += v
        results.append((variant, dtype, r, wall, got, want, wall_eager, capture_ms))

    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"after the rollouts: SM clock, max SM clock, power draw = {clocks}")
    for variant, dtype, r, wall, got, want, wall_eager, capture_ms in results:
        name = f"{variant} {dtype}"
        esr = r["per_window"]["esr_mse"]
        check(len(esr) == N_WINDOWS and np.all(np.isfinite(esr)), f"{name}: bad esr_mse")
        check(np.all(np.isfinite(r["per_window"]["bicubic_mse"])), f"{name}: bad bicubic_mse")
        counts = ", ".join(f"{k} {got[k]} (model {want[k]})" for k in want)
        print(f"rollout {name}: {N_WINDOWS} windows {LR} -> {GT}, "
              f"{wall / N_WINDOWS * 1e3:.3f} ms/window, {N_WINDOWS / wall:.2f} windows/s "
              f"(engine time {r['time']:.3f} ms/window, {r['macs']:.1f} MMAC/window, "
              f"mean esr_mse {r['esr_mse']:.5f}) on {card}, replaying a CUDA graph captured "
              f"in {capture_ms:.1f} ms; graph off {wall_eager / N_WINDOWS * 1e3:.3f} ms/window, "
              f"per-window MSEs bit-equal; launches with the graph off: rasterize_counts "
              f"{got['rasterize_counts']}, {counts}")
    for variant in ("full", "plain"):
        macs = {round(r["macs"], 1) for v, d, r, *_ in results if v == variant}
        check(len(macs) == 1, f"{variant}: MMAC/window differs between dtypes: {macs}")
    print(f"kernel launches on the main path: {totals}")
    step("rollouts")
    for variant, dtype, eng, _ in engines:
        if dtype in ("float32", "bfloat16", "int8", "int8_pall"):
            profile_rollout(f"{variant} {dtype}", eng, load_chunk, min(PROFILE_WINDOWS, N_WINDOWS),
                            expected_launches(variant, dtype, 1, 0))
    step("profiles")

    # the same engine on the CPU (plain rasterizer, CPU convolutions) over
    # the first windows: per-window MSEs agree to float32 reassociation
    for (variant, dtype, eng, _), (_v, _d, r, *_) in zip(engines, results):
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
    step("the CPU's rollouts")
    print("rollouts phase, s: " + ", ".join(f"{k} {v:.1f}" for k, v in steps.items()))
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
        profile_edge()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
        time.sleep(PROFILE_EDGE_S)
    # kernel rows only: operator rows repeat the time of the kernels they
    # launch, and the program's spans show on the device's timeline as user
    # annotations that cover the kernels inside them
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    dev_time = lambda e: e.self_device_time_total  # noqa: E731
    busy_ms = sum(dev_time(e) for e in rows) / 1e3 / n
    check(busy_ms > 0, f"profile {name}: the trace shows no device time")
    top = sorted(rows, key=dev_time, reverse=True)[:4]
    launches = sum(e.count for e in rows) / n
    print(f"profile {name}: wall {wall_ms:.3f} ms/{what}, device busy {busy_ms:.3f} ms/{what} "
          f"(idle share {1 - busy_ms / wall_ms:.1%}, {launches:.0f} "
          f"kernel launches/{what}, {len(rows)} kernel kinds); top kernels: "
          + "; ".join(f"{e.key[:60]} {dev_time(e) / 1e3 / n:.3f} ms x{e.count / n:.1f}"
                      for e in top))
    # the port's kernels by name: device ms and records per ``what``
    ours = {k: [sum(dev_time(e) for e in rows if key in e.key) / 1e3 / n,
                sum(e.count for e in rows if key in e.key) / n]
            for k, key in KERNEL_FAMILIES.items()}
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle": 1 - busy_ms / wall_ms,
            "launches": launches, "kernels": ours}


def profile_rollout(name: str, eng, load_chunk, n: int, per_window: dict) -> None:
    """Where the time of a rollout goes, per window; for an int8 engine also
    its calibration, per calibration step.  The replayed windows' device
    records of the int8 kernels must be ``per_window`` a window."""
    import torch

    from bmcnet_esr_torch.inference import InferenceEngine
    from bmcnet_esr_torch.inference.engine import _calib_pairs
    from bmcnet_esr_torch.models import calibrate_act_scales

    if eng.model.quant:
        (xy, p), _ = load_chunk(0, n)
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
    p = _profiled(lambda: eng.infer_windows(load_chunk, n, LR, GT), n, name, "window")
    print(f"profile {name}: the port's kernels' device records a window, the graph's "
          "replays with the rasterizer: "
          + ", ".join(f"{k} {records:.1f}" for k, (_ms, records) in p["kernels"].items()))
    for k, v in per_window.items():
        records = round(p["kernels"][k][1] * n)
        check(records == v * n, f"profile {name}: {records} {k} device records in {n} "
                                f"replayed windows, the model gives {v * n}")


GRAD_TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_grad_parity.py's bound, CPU and card alike
TRAJ_RTOL = 1e-5  # the first 25 iterations of the Adam trajectory, as on the CPU
RESUME_RTOL = 1e-6  # resumed against uninterrupted losses, deterministic cuDNN


class MemoryLoader:
    """In-memory stand-in for ``SequenceLoader``: the same batches every
    epoch, the first one ``start`` batches in (a resumed run picks up where
    the uninterrupted one was)."""

    def __init__(self, batches, start: int = 0, pad_last: bool = False, res=None,
                 compact: bool = True):
        self.batches, self.start, self.pad_last, self.compact = batches, start, pad_last, compact
        self.inp_resolution, self.gt_resolution = res if res is not None else (LR, GT)
        self.seqn = 2
        self.batch_size = batches[0]["inp_xy" if compact else "inp_events"].shape[0]

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        for k in range(len(self.batches)):
            yield self.batches[(self.start + k) % len(self.batches)]


def train_batches(rng, n: int, mask=None) -> list:
    """``n`` batches of the NFS recipe's shapes in the compact transfer form:
    B x L windows of 2048 LR events at 45x80 and 32768 GT events at 180x320."""
    import numpy as np

    from bmcnet_esr_torch.ops.batch import compact_events

    out = []
    for _ in range(n):
        batch = {}
        for prefix, n_ev, hw in (("inp", N_LR, LR), ("gt", SCALE**2 * N_LR, GT)):
            ev = random_windows(rng, TRAIN_B * TRAIN_L, n_ev, hw, pad=n_ev // 32)
            xy, p = compact_events(ev.reshape(TRAIN_B, TRAIN_L, 4, n_ev))
            batch[f"{prefix}_xy"], batch[f"{prefix}_p"] = xy, p
        if mask is not None:
            batch["clip_mask"] = np.asarray(mask, np.float32)
        out.append(batch)
    return out


def _recipe(work: str, iterations: int, save_period: int, valid_step: int = 1000,
            dtype: str = "float32", remat: bool = False) -> dict:
    cfg = nfs_recipe()
    icfg = cfg["trainer"]["iteration_based_train"]
    icfg.update(iterations=iterations, save_period=save_period, valid_step=valid_step)
    cfg["trainer"].update(output_path=work, remat=remat)
    if dtype != "float32":
        cfg["model"]["args"]["dtype"] = dtype
    return cfg


def _recorded(trainer, events=None):
    """Wrap ``trainer.train_step`` to keep each step's device metrics (and,
    with ``events``, a CUDA event recorded after each step)."""
    import torch

    metrics, step = [], trainer.train_step

    def recording(state, batch):
        state, m = step(state, batch)
        metrics.append(m)
        if events is not None:
            done = torch.cuda.Event(enable_timing=True)
            done.record()
            events.append(done)
        return state, m

    trainer.train_step = recording
    return metrics


def profile_training(tr, start: int, n: int, bands: int = 2) -> dict:
    """Device records of ``n`` iterations of ``tr.train`` from ``start``,
    after one more that warms the profiler up (device activity only: host
    records slow a loop of ~40,000 launches an iteration twice over).  The
    window opens and closes on an idle device (``profile_edge``), so the
    trace holds exactly the window's kernels.  Per iteration: the device's
    timeline from the window's opening to the end of the last iteration,
    its busy time (kernels, copies, fills), the idle share, the records,
    the rasterizer's kernels, and the kernels that take most of the
    time; also when the first device record starts after the opening
    (``first_device_ms``).  A trace whose rasterizer kernels are not ``bands`` an
    iteration (two: one input and one GT call a micro-step) is taken again,
    at most twice, and said so.  The profiled iterations write no
    checkpoint."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    step = tr.train_step
    tr.save = lambda *a, **k: ""
    for attempt in range(3):
        marks = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=n, repeat=1)) as prof:
            def stepping(state, batch):
                state, m = step(state, batch)
                done = torch.cuda.Event(enable_timing=True)
                done.record()
                marks.append(done)
                if len(marks) in (1, n + 1):  # the window opens or closes
                    profile_edge()
                prof.step()
                if len(marks) == 1:
                    profile_edge()
                    marks[0] = torch.cuda.Event(enable_timing=True)
                    marks[0].record()
                return state, m

            tr.train_step, tr.iterations = stepping, start + 1 + n
            tr.train(start_iteration=start)
            torch.cuda.synchronize()
        start += 1 + n
        rows = [e for e in prof.key_averages()  # kernels, not the spans' annotations
                if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        # the rasterizer's kernels: band or, for long compact windows, per event
        band = sum(e.count for e in rows
                   if "band_kernel" in e.key or "event_kernel" in e.key) / n
        first = first_device_ms(prof)
        if band == bands:
            break
        print(f"profile_training: trace {attempt + 1} holds {band} rasterizer kernels an "
              f"iteration of the {bands} launched ({sum(e.count for e in rows) / n:.0f} records "
              f"and "
              f"{sum(e.self_device_time_total for e in rows) / 1e3 / n:.3f} device ms an "
              f"iteration, the first record {first:.3f} ms after the opening), again")
    span = marks[0].elapsed_time(marks[-1]) / n
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / n
    top = sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)[:4]
    return {
        "span_ms": span, "busy_ms": busy, "idle": 1 - busy / span, "band": band,
        "launches": sum(e.count for e in rows) / n, "first_ms": first,
        "top": "; ".join(f"{e.key[:50]} {e.self_device_time_total / 1e3 / n:.3f} ms "
                         f"x{e.count / n:.0f}" for e in top),
    }


def train_goldens(dev) -> None:
    """BPTT gradients of both variants against the torch reference goldens,
    and the first 25 Adam(amsgrad, wd) iterations against their losses."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.models import BMCNet, BMCNetPlain, convert_torch_state_dict
    from bmcnet_esr_torch.training.train_step import _rollout_losses

    with np.load(os.path.join(ROOT, "tests", "goldens", "grad_goldens.npz")) as z:
        g = {k: z[k] for k in z.files}
    meta = [int(v) for v in g["meta"][:3]]
    inp, gt = (torch.from_numpy(np.ascontiguousarray(np.transpose(g[k], (1, 0, 3, 4, 2))))
               .to(dev) for k in ("frames", "gt_frames"))

    def model(variant):
        cls = BMCNetPlain if variant == "plain" else BMCNet
        m = cls(scale=meta[0], n_c=meta[1], n_b=meta[2])
        n = len(f"{variant}/sd/")
        m.load_state_dict(convert_torch_state_dict(
            {k[n:]: v for k, v in g.items() if k.startswith(f"{variant}/sd/")}))
        return m.to(dev, memory_format=torch.channels_last)

    def loss_of(m):
        _, totals = _rollout_losses(m, inp, gt, 2, tuple(gt.shape[2:4]), use_remat=False)
        return totals.mean(1).sum()

    for variant in ("plain", "full"):
        m = model(variant)
        loss = loss_of(m)
        loss.backward()
        n = len(f"{variant}/grad/")
        want = convert_torch_state_dict(
            {k[n:]: v for k, v in g.items() if k.startswith(f"{variant}/grad/")})
        worst, where = 0.0, ""
        for name, p in m.named_parameters():
            w = want[name].to(dev)
            r = float(((p.grad - w).abs() / (GRAD_TOL["atol"] + GRAD_TOL["rtol"] * w.abs())).max())
            worst, where = max((worst, where), (r, name))
        rel = abs(float(loss.detach()) / float(g[f"{variant}/loss"]) - 1)
        print(f"train goldens {variant}: BPTT gradient at {worst:.3f} of the bound {GRAD_TOL} "
              f"(worst {where}), loss rel |d| {rel:.2e}")
        check(worst <= 1.0, f"{variant} BPTT gradient outside {GRAD_TOL}: {worst:.3f} at {where}")
        check(rel <= 1e-6, f"{variant} BPTT loss rel |d| {rel}")

    m = model("plain")
    opt = torch.optim.Adam(m.parameters(), lr=1e-3, weight_decay=1e-5, amsgrad=True)
    losses = []
    for _ in range(25):
        opt.zero_grad()
        loss = loss_of(m)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    rel = float(np.max(np.abs(np.asarray(losses) / g["traj_losses"][:25] - 1)))
    print(f"train goldens trajectory: 25 Adam(amsgrad, wd) iterations, max rel |d| {rel:.2e} "
          f"against the reference losses (bound rtol {TRAJ_RTOL})")
    check(rel <= TRAJ_RTOL, f"trajectory rel |d| {rel} > {TRAJ_RTOL}")


GUARD_EMA = 0.5        # the guard run's EMA decay: each update moves it half way
GUARD_EMA_RTOL = 1e-6  # the EMA against float64 by hand, relative to each tensor's largest


def train_guards(dev, mods, work: str, card: str) -> int:
    """``skip_nonfinite`` and the EMA at full width: the NFS recipe through
    ``Trainer`` with ``trainer.skip_nonfinite`` and ``trainer.ema``, on raw
    float32 batches, the third with a NaN polarity in its input.  The two
    good iterations' EMA equals the same update done by hand in float64;
    the NaN iteration is counted as skipped and leaves every parameter, the
    Adam state and the update count bit-identical.  Returns the
    rasterizer's launches."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.training import Trainer
    from bmcnet_esr_torch.training.config import RunConfig

    cfg = _recipe(work, 3, 10**6)
    cfg["trainer"].update(skip_nonfinite=True, ema=GUARD_EMA)
    cfg["trainer"]["iteration_based_train"]["train_log_step"] = 1
    del cfg["valid_dataloader"]
    data = raw_batches(np.random.default_rng(17), 3)
    data[2]["inp_events"][0, 3, 3, 100] = np.nan
    tr = Trainer(RunConfig(cfg, runid="guards"), train_loader=MemoryLoader(data, compact=False),
                 seed=0, device=dev)

    def snap(state, metrics=None):
        opt = {i: {k: v.clone() if torch.is_tensor(v) else v for k, v in st.items()}
               for i, st in state.optimizer.state_dict()["state"].items()}
        return {"params": {n: p.detach().clone() for n, p in state.model.named_parameters()},
                "ema": {n: e.clone() for n, e in state.ema.items()}, "opt": opt,
                "updates": state.updates, "metrics": metrics}

    snaps = [snap(tr.state)]
    step = tr.train_step

    def snapping(state, batch):
        state, m = step(state, batch)
        snaps.append(snap(state, m))
        return state, m

    tr.train_step = snapping
    zero_counts(mods)
    tr.train()
    launches = mods["rasterize"].launches
    check(launches == 2 * 3, f"guards: {launches} rasterizer launches in 3 iterations")
    skipped = [int(s["metrics"]["train_skipped"]) for s in snaps[1:]]
    check(skipped == [0, 0, 1] and tr.skipped_steps == 1,
          f"guards: skipped {skipped}, Trainer counted {tr.skipped_steps}")
    before, after = snaps[2], snaps[3]
    same_params = all(torch.equal(after["params"][n], p) for n, p in before["params"].items())
    same_opt = before["opt"].keys() == after["opt"].keys() and all(
        torch.equal(v, after["opt"][i][k]) if torch.is_tensor(v) else v == after["opt"][i][k]
        for i, st in before["opt"].items() for k, v in st.items())
    check(same_params and same_opt and after["updates"] == before["updates"] == 2,
          f"guards: the NaN step changed the state (parameters equal {same_params}, Adam state "
          f"equal {same_opt}, updates {before['updates']} -> {after['updates']})")
    # the EMA by hand in float64: it starts at the initial parameters and
    # moves on every step, the skipped one too (towards unchanged parameters)
    hand = {n: p.double() for n, p in snaps[0]["params"].items()}
    worst, moved = 0.0, 0.0
    for k in (1, 2, 3):
        for n, p in snaps[k]["params"].items():
            hand[n] = GUARD_EMA * hand[n] + (1 - GUARD_EMA) * p.double()
            e = snaps[k]["ema"][n].double()
            scale = float(hand[n].abs().max())
            if scale > 0:
                worst = max(worst, float((e - hand[n]).abs().max()) / scale)
                if k == 2:
                    moved = max(moved, float((e - snaps[0]["params"][n].double()).abs().max())
                                / scale)
    check(worst <= GUARD_EMA_RTOL and moved > 10 * GUARD_EMA_RTOL,
          f"guards: the EMA is {worst:.3e} from float64 by hand (bound {GUARD_EMA_RTOL}), "
          f"moved {moved:.3e} from the initial parameters")
    losses = [float(s["metrics"]["train_loss"]) for s in snaps[1:]]
    print(f"train guards (NFS recipe at full width, skip_nonfinite, ema {GUARD_EMA}): losses "
          f"{losses}; the NaN batch skipped ({skipped}, Trainer.skipped_steps "
          f"{tr.skipped_steps}), every parameter, the Adam state and the update count "
          f"bit-identical across it; the EMA after iterations 1-3 within {worst:.3e} of the "
          f"float64 update by hand (bound {GUARD_EMA_RTOL:g}, relative to each tensor's largest "
          f"magnitude; it moved {moved:.3e} from the initial parameters); {launches} rasterizer "
          f"launches; on {card}")
    return launches


def phase_train(dev, card: str) -> dict:
    """The training path at the NFS recipe's full width (full BMCNet, n_c=128,
    n_b=5, x4, batch 2, L=9, 45x80 -> 180x320) through ``Trainer``, on
    in-memory batches.  Returns the rasterizer's launches on this path."""
    import importlib

    import numpy as np
    import torch

    from bmcnet_esr_torch.kernels import rasterize
    from bmcnet_esr_torch.training import Trainer
    from bmcnet_esr_torch.training.checkpoint import latest_checkpoint
    from bmcnet_esr_torch.training.config import RunConfig

    mods = {n: importlib.import_module(f"bmcnet_esr_torch.kernels.{n}") for n in KERNEL_MODULES}
    train_goldens(dev)
    rng = np.random.default_rng(7)
    data = train_batches(rng, 4)
    valid = train_batches(rng, 1, mask=[1.0, 1.0]) + train_batches(rng, 1, mask=[1.0, 0.0])
    work = os.path.join(ROOT, "outputs", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    launches = 0
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        # 13 iterations with one validation pass and a checkpoint after
        # iteration 10; then a second trainer resumes from that checkpoint and
        # runs iterations 11 and 12 again.  Trainer itself sets cuDNN
        # deterministic (nothing here does).  The recipe's tensorboard stays
        # on (scalars dropped where no backend).
        flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        tr = Trainer(RunConfig(_recipe(tmp, 13, 10, valid_step=10), runid="a"),
                     train_loader=MemoryLoader(data),
                     valid_loader=MemoryLoader(valid, pad_last=True), seed=0, device=dev)
        metrics = _recorded(tr)
        for mod in mods.values():
            mod.launches = 0
        tr.train()
        got = {KERNEL_NAMES[n]: mod.launches for n, mod in mods.items()}
        want = 2 * (13 + len(valid))
        check(got["rasterize_counts"] == want and sum(got.values()) == want,
              f"training path launches {got}, expected {want} rasterizer launches only")
        launches += got["rasterize_counts"]
        losses = [float(m["train_loss"]) for m in metrics]
        check(np.all(np.isfinite(losses)), f"non-finite training loss: {losses}")
        # iteration 10 validates, improves on the monitor and saves best/
        # (a save on a new best takes the place of the periodic one)
        saved = os.path.join(tr.run.save_dir, "best")
        with open(os.path.join(saved, "trainer_meta.json")) as f:
            check(json.load(f)["iteration"] == 10, "best/ is not iteration 10")
        check(latest_checkpoint(tr.run.save_dir).endswith("iteration_12"), "no final checkpoint")
        print(f"train NFS recipe fp32: 13 iterations through Trainer, losses {losses[0]:.6f} .. "
              f"{losses[-1]:.6f}, validation valid_loss "
              f"{tr.valid_metrics.result()['valid_loss']:.6f}, "
              f"rasterizer launches {got['rasterize_counts']} (2 per iteration and per validation "
              f"batch), checkpoints {sorted(os.listdir(tr.run.save_dir))}")
        res = Trainer(RunConfig(_recipe(tmp, 13, 10, valid_step=10), runid="b"),
                      train_loader=MemoryLoader(data, start=11),
                      valid_loader=MemoryLoader(valid, pad_last=True), seed=1, device=dev)
        resumed = _recorded(res)
        start = res.resume(saved)
        check(start == 11, f"resumed at {start}")
        res.train(start_iteration=start)
        again = [float(m["train_loss"]) for m in resumed]
        rel = float(np.max(np.abs(np.asarray(again) / np.asarray(losses[11:]) - 1)))
        print(f"train resume: iterations 11-12 after resuming from best/ (iteration 10) {again}, "
              f"uninterrupted {losses[11:]}, max rel |d| {rel:.2e} (bound {RESUME_RTOL})")
        check(len(again) == 2 and rel <= RESUME_RTOL, f"resume differs: {again} vs {losses[11:]}")
        check(torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark,
              "Trainer did not leave cuDNN deterministic")
        del tr, res
        launches += train_guards(dev, mods, tmp, card)

        # fp32 and bf16, remat off (the recipe) and on: on one fixed batch,
        # warm-up and timed iterations, then 1 + prof under the profiler
        # (remat on, the slowest, fewer of each); float32 remat off also with
        # cuDNN's deterministic flag turned off after Trainer set it, for
        # the flag's cost within this call
        configs = [("float32", False, True), ("float32", False, False), ("float32", True, True),
                   ("bfloat16", False, True), ("bfloat16", True, True)]
        for dtype, remat, det in configs:
            warm, timed, prof = (1, 2, 1) if remat else (2, 4, 2)
            name = (f"{dtype} remat={'on' if remat else 'off'}"
                    + ("" if det else " deterministic=off"))
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            tr = Trainer(RunConfig(_recipe(tmp, warm + timed, 10**6, dtype=dtype, remat=remat),
                                   runid=name.replace(" ", "_")),
                         train_loader=MemoryLoader(data[:1]),
                         valid_loader=MemoryLoader(valid, pad_last=True), seed=0, device=dev)
            torch.backends.cudnn.deterministic = det
            events = []
            metrics = _recorded(tr, events)
            for mod in mods.values():
                mod.launches = 0
            tr.train()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev)
            got = mods["rasterize"].launches
            check(got == 2 * (warm + timed), f"{name}: {got} rasterizer launches")
            launches += got
            steps = [events[i - 1].elapsed_time(events[i]) for i in range(warm, len(events))]
            losses = [float(m["train_loss"]) for m in metrics]
            check(np.all(np.isfinite(losses)) and losses[-1] < losses[0],
                  f"{name}: the loss does not fall on a fixed batch: {losses}")
            check(all(p.dtype == torch.float32 for p in tr.state.model.parameters()),
                  f"{name}: parameters are not float32")
            for mod in mods.values():
                mod.launches = 0
            p = profile_training(tr, warm + timed, prof)
            launches += mods["rasterize"].launches
            check(mods["rasterize"].launches == 2 * (tr.state.step - warm - timed),
                  f"{name}: {mods['rasterize'].launches} rasterizer launches in "
                  f"{tr.state.step - warm - timed} profiled iterations")
            band = p["band"]
            check(band == 2, f"{name}: the profiler counted {band} rasterizer kernels an "
                             "iteration, expected 2")
            print(f"train {name}: {float(np.median(steps)):.3f} ms/iteration (median of "
                  f"{len(steps)}, min {min(steps):.3f}, max {max(steps):.3f}); profiled: "
                  f"{p['span_ms']:.3f} ms/iteration, device busy {p['busy_ms']:.3f} "
                  f"ms/iteration, idle share {p['idle']:.1%}, {p['launches']:.0f} kernel "
                  f"launches/iteration ({band:.0f} rasterizer; the first device record "
                  f"{p['first_ms']:.3f} ms after the window opened, {PROFILE_EDGE_S * 1e3:.0f} ms "
                  f"of host time after it); peak memory "
                  f"{peak / 2**30:.2f} GiB; loss {losses[0]:.6f} -> {losses[-1]:.6f} on a "
                  f"fixed batch; cuDNN deterministic {det}; on {card}; top kernels: {p['top']}")
            del tr
    # the phases after this one run with the flags as they were before it
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    return {"rasterize_counts": launches}


# The parallel phase: the NFS recipe's batch and model (model args from the
# recipe) at full width, cuDNN deterministic as Trainer sets it.
PARALLEL_ITERS = 3  # (a): the first iteration warms up, the other two are timed
DP_ITERS = 3        # (b): Trainer iterations; iteration 2 validates and saves
GLOO_JOIN_S = 300   # (b): the ranks must be done by then
MESH_WINDOWS = 16   # (c): windows of each of the two streams
TP_ITERS = 2        # (f): tensor-parallel steps from (a)'s state, and the Trainer's iterations
# (f): the share of parameters that may lie beyond atol 1e-5 of the one-device
# step's after TP_ITERS Adam steps.  Adam moves an element by up to lr a
# step whatever its gradient's size, so where a gradient is small against
# its rounding, two valid float32 implementations of one step part by up to
# 2 * lr: part (f) prints how many elements the one-device step with cuDNN
# off puts beyond atol 1e-5 (PERF.md, PR 10); atol 1e-5 on every element
# holds for neither.
TP_PARAM_SHARE = 1e-3
# (f): the first step's gathered tensor-parallel gradient against the same
# step in float64 on one device (||d||/||g||) sits at most TP_GRAD_FACTOR
# times the one-device float32 gradient's own distance, both measured in the
# run: the crossings and the split convolutions add float32 round-off only
# (parallel/tensor.py runs the split convolutions through PyTorch's own
# kernels: cuDNN's FFT convolutions at the ranks' shapes sat 35x away).
TP_GRAD_FACTOR = 3.0
PARALLEL_SEED = 11
# (d): 8 slots over a mesh of 2 (cuda:0 twice), ticks with a reload before
# SLOT_RELOAD, and the daemon's client windows; (e): one stream's 45 rows
# over a mesh of 3, its windows, and the golden's 16 rows over a mesh of 4
SLOT_MESH, SLOT_TICKS, SLOT_RELOAD, SLOT_CLIENT_WINDOWS = 2, 6, 3, 32
ROW_MESH, ROW_WINDOWS, ROW_GOLDEN_MESH = 3, 16, 4


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def recipe_state(dev):
    """The NFS recipe's model (seeded), Adam and schedule, as ``Trainer``
    builds them."""
    import torch

    from bmcnet_esr_torch.training import build_optimizer, init_train_state
    from bmcnet_esr_torch.training.trainer import build_model

    cfg = nfs_recipe()
    model = build_model(cfg, SCALE, torch.Generator().manual_seed(0))
    model = model.to(dev, memory_format=torch.channels_last)
    opt, sched = build_optimizer(model.parameters(), cfg["optimizer"], cfg["lr_scheduler"],
                                 cfg["trainer"]["iteration_based_train"])
    return init_train_state(model, opt, sched)


def parallel_batches(dev, n: int) -> list:
    import numpy as np
    import torch

    return [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            for b in train_batches(np.random.default_rng(PARALLEL_SEED), n)]


def flat_params(model):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu().numpy()


def flat_grads(model, mesh=None):
    """The gradients in parameter order; on a mesh with a ``model`` axis
    each split one gathered whole (a collective)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from bmcnet_esr_torch.parallel import ChannelGroup, channel_sharding

    axis = ChannelGroup.of(mesh) if mesh is not None else None
    placements = channel_sharding(model, axis.n) if axis is not None else {}
    out = []
    for name, p in model.named_parameters():
        g = p.grad.contiguous()
        if isinstance(placements.get(name), Shard):
            parts = [torch.empty_like(g) for _ in range(axis.n)]
            dist.all_gather(parts, g, group=axis.group)
            g = torch.cat(parts)
        out.append(g.reshape(-1))
    return torch.cat(out).cpu().numpy()


def timed_steps(step, state, batches):
    """Run ``step`` over ``batches``: its metrics as floats, ms per
    iteration (CUDA events, device synchronized), and the state."""
    import torch

    metrics, ms = [], []
    for b in batches:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, m = step(state, b)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, ms, state


def dp_trainer(work: str, runid: str, dev, make_dirs: bool = True):
    """(b)'s run: the NFS recipe's ``Trainer`` for ``DP_ITERS`` iterations on
    in-memory node batches of the recipe's 2 clips (a loader that does not
    split them: inside a group the Trainer keeps its rank's rows), with a
    validation over two batches, the second with one valid clip, and a
    checkpoint at iteration 2.  Returns the trainer and a record of each
    step's loss, rasterizer launches and a CUDA event after it."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.kernels import rasterize
    from bmcnet_esr_torch.training import Trainer
    from bmcnet_esr_torch.training.config import RunConfig

    rng = np.random.default_rng(PARALLEL_SEED)
    data = train_batches(rng, DP_ITERS)
    valid = train_batches(rng, 1, mask=[1.0, 1.0]) + train_batches(rng, 1, mask=[1.0, 0.0])
    tr = Trainer(RunConfig(_recipe(work, DP_ITERS, 2, valid_step=2), runid=runid,
                           make_dirs=make_dirs),
                 train_loader=MemoryLoader(data), valid_loader=MemoryLoader(valid, pad_last=True),
                 seed=0, device=dev)
    rec = {"metrics": [], "launches": [], "events": []}
    step = tr.train_step

    def recording(state, batch):
        before = rasterize.launches
        state, m = step(state, batch)
        rec["launches"].append(rasterize.launches - before)
        rec["metrics"].append(m)
        rec["events"].append(torch.cuda.Event(enable_timing=True))
        rec["events"][-1].record()
        return state, m

    tr.train_step = recording
    return tr, rec


def _gloo_rank(rank: int, store: str, out: str, sizes: dict) -> None:
    """One of phase (b)'s two ranks, a spawned process: gloo on ``cuda:0``
    (NCCL refuses two ranks on one card), the NFS recipe's ``Trainer`` on
    the node batches of ``dp_trainer``, then the resume from the shared
    checkpoint.  ``sizes`` carries the parent's module constants into the
    child."""
    globals().update(sizes)
    import numpy as np
    import torch

    from bmcnet_esr_torch.kernels import rasterize
    from bmcnet_esr_torch.parallel import init_distributed
    from bmcnet_esr_torch.parallel.step import all_reduce_sum
    from bmcnet_esr_torch.training.checkpoint import latest_checkpoint

    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2")
    dev = init_distributed(sizes["DEVICE"], backend="gloo", init_method=f"file://{store}",
                           timeout_s=GLOO_JOIN_S)
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        tr, rec = dp_trainer(sizes["WORK"], "dp", dev, make_dirs=rank == 0)
        check(tr.mesh is not None and tr.mesh.size() == 2, f"rank {rank}: no 2-rank mesh")
        rasterize.launches = 0
        tr.train()
        torch.cuda.synchronize(dev)
        launches = rasterize.launches
        peak = torch.cuda.max_memory_allocated(dev)
        ev = rec["events"]
        params = flat_params(tr.state.model)
        bucket = torch.zeros(sum(p.numel() for p in tr.state.model.parameters()) + 2, device=dev)
        reduce_ms = []
        for _ in range(5):  # the step's one collective, alone: host and device
            t0 = time.perf_counter()
            all_reduce_sum(bucket, tr.mesh)
            torch.cuda.synchronize(dev)
            reduce_ms.append((time.perf_counter() - t0) * 1e3)
        start = tr.resume(latest_checkpoint(tr.run.save_dir))
        np.savez(out, losses=[float(m["train_loss"]) for m in rec["metrics"]],
                 step_launches=rec["launches"], launches=launches, peak=peak,
                 ms=[a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])], reduce_ms=reduce_ms,
                 params=params, valid_loss=tr.valid_metrics.result()["valid_loss"],
                 resume_start=start,
                 resumed_same=np.array_equal(flat_params(tr.state.model), params))
    finally:
        torch.distributed.destroy_process_group()


def phase_parallel(dev, card: str) -> dict:
    """Data parallelism at the NFS recipe's full width: (a) a 1-rank NCCL
    group in this process, its step against the single-device step bit for
    bit, with the group's broadcast of the state and host-side agreement;
    (b) two spawned ranks over gloo on this one card, each running the
    ``Trainer`` on the node batches, against the single-device ``Trainer``;
    (c) the engine's ``mesh=`` of two on this card, each shard against its
    stream's solo rollout bit for bit; (d) and (e), sharded serving
    (:func:`parallel_slots`, :func:`parallel_rows`); (f) tensor parallelism
    (:func:`parallel_model`).  Returns each kernel's launches in (a), (b)
    (both ranks), (c), (d), (e) and (f) (both ranks)."""
    import importlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from bmcnet_esr_torch.data import DatasetConfig
    from bmcnet_esr_torch.inference import InferenceEngine
    from bmcnet_esr_torch.inference.engine import DTYPES, INT8_DTYPES
    from bmcnet_esr_torch.models import BMCNet
    from bmcnet_esr_torch.ops.batch import compact_events
    from bmcnet_esr_torch.parallel import (
        any_rank,
        host_group,
        init_distributed,
        make_mesh,
        make_parallel_train_step,
        make_process_mesh,
        replicate_tree,
    )
    from bmcnet_esr_torch.parallel.step import all_reduce_sum
    from bmcnet_esr_torch.training import make_train_step
    from bmcnet_esr_torch.training.checkpoint import latest_checkpoint

    mods = {n: importlib.import_module(f"bmcnet_esr_torch.kernels.{n}") for n in KERNEL_MODULES}
    totals = {KERNEL_NAMES[n]: 0 for n in KERNEL_MODULES}
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    batches = parallel_batches(dev, PARALLEL_ITERS)

    mark, laps = [time.perf_counter()], {}

    def lap(name):  # seconds since the last lap, by name
        laps[name] = time.perf_counter() - mark[0]
        mark[0] = time.perf_counter()

    # (a) the single-device step, then a 1-rank NCCL group's, from one state;
    # (f) holds its tensor-parallel steps to the first TP_ITERS of these
    one_step = make_train_step(LR, GT, use_remat=False)
    plain, plain_ms, state = timed_steps(one_step, recipe_state(dev), batches[:1])
    tp_ref = {"grad": flat_grads(state.model)}
    more, more_ms, state = timed_steps(one_step, state, batches[1:TP_ITERS])
    tp_ref.update(metrics=plain + more, params=flat_params(state.model))
    plain, plain_ms = plain + more, plain_ms + more_ms
    more, more_ms, state = timed_steps(one_step, state, batches[TP_ITERS:])
    plain, plain_ms = plain + more, plain_ms + more_ms
    want = [p.detach().clone() for p in state.model.parameters()]
    del state
    torch.cuda.empty_cache()
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
    init_distributed(dev, init_method=f"tcp://localhost:{free_port()}")
    try:
        mesh = make_process_mesh()
        state = recipe_state(dev)
        replicate_tree(state)  # NCCL broadcasts of the channels-last parameters
        host = host_group()    # under NCCL a gloo group of its own
        check(host is not None and any_rank(True, host) and not any_rank(False, host),
              "1-rank NCCL group: the host-side agreement does not hold")
        pstep = make_parallel_train_step(LR, GT, mesh, use_remat=False)
        zero_counts(mods)
        par, par_ms, state = timed_steps(pstep, state, batches)
        got = counts(mods)
        check(got["rasterize_counts"] == 2 * PARALLEL_ITERS and sum(got.values()) == got[
            "rasterize_counts"], f"1-rank NCCL step: launches {got}, expected 2 rasterizer "
                                 "launches an iteration only")
        for k, v in got.items():
            totals[k] += v
        for key in ("train_loss", "train_mse_loss", "grad_norm"):
            check([m[key] for m in par] == [m[key] for m in plain],
                  f"1-rank NCCL {key} {[m[key] for m in par]} != {[m[key] for m in plain]}")
        same = all(torch.equal(p.detach(), q) for p, q in zip(state.model.parameters(), want))
        check(same, "1-rank NCCL step: parameters differ from the single-device step's")
        bucket = torch.zeros(sum(p.numel() for p in state.model.parameters()) + 2, device=dev)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profile_edge()
            for _ in range(10):
                all_reduce_sum(bucket, mesh)
            profile_edge()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower()]
        nccl_ms = sum(e.self_device_time_total for e in rows) / 1e3 / 10
        nccl_n = sum(e.count for e in rows) / 10
        host_ms = cuda_ms(lambda: all_reduce_sum(bucket, mesh), iters=20)
        print(f"parallel (a) 1-rank NCCL step, NFS recipe full width, batch {TRAIN_B}: losses, "
              f"MSEs, grad norms and all {len(want)} parameters bit-exact against the "
              f"single-device step over {PARALLEL_ITERS} iterations; ms/iteration "
              f"{float(np.median(par_ms[1:])):.3f} (single-device "
              f"{float(np.median(plain_ms[1:])):.3f}; medians of {PARALLEL_ITERS - 1} after one "
              f"warm-up, NCCL {par_ms}, single {plain_ms}); all-reduce of the "
              f"{bucket.numel() * 4 / 2**20:.2f} MiB bucket: device {nccl_ms:.4f} ms in "
              f"{nccl_n:.0f} NCCL kernels a call, {host_ms:.4f} ms a call by CUDA events; "
              f"state broadcast and host-side agreement over a gloo group beside NCCL; "
              f"rasterizer launches {got['rasterize_counts']}; on {card}")
        del state, bucket
    finally:
        dist.destroy_process_group()
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            os.environ.pop(k, None)

    lap("a")
    # (b) two ranks over gloo on this card, each a Trainer on one row of
    # each node batch, against the single-device Trainer on the same loader
    torch.cuda.empty_cache()
    work = os.path.join(ROOT, "outputs", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        zero_counts(mods)
        one, rec = dp_trainer(tmp, "one", dev)
        one.train()
        torch.cuda.synchronize()
        check(rec["launches"] == [2] * DP_ITERS,
              f"single-device Trainer: rasterizer launches a step {rec['launches']}")
        totals["rasterize_counts"] += mods["rasterize"].launches
        ref = np.asarray([float(m["train_loss"]) for m in rec["metrics"]])
        ref_valid = one.valid_metrics.result()["valid_loss"]
        ref_params = flat_params(one.state.model)
        ev = rec["events"]
        ref_ms = [a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])]
        del one, rec, ev
        torch.cuda.empty_cache()

        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(2)]
        sizes = dict(LR=LR, GT=GT, SCALE=SCALE, N_LR=N_LR, TRAIN_B=TRAIN_B, TRAIN_L=TRAIN_L,
                     DEVICE=str(dev), WORK=tmp)
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_gloo_rank, args=(r, os.path.join(tmp, "store"), outs[r],
                                                      sizes)) for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(max(GLOO_JOIN_S - (time.perf_counter() - t0), 1))
            check(not any(p.is_alive() for p in procs),
                  f"gloo ranks still running after {GLOO_JOIN_S} s")
            check(all(p.exitcode == 0 for p in procs),
                  f"gloo ranks exited {[p.exitcode for p in procs]}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        wall = time.perf_counter() - t0
        ranks = []
        for out in outs:
            with np.load(out) as z:
                ranks.append({k: z[k] for k in z.files})
        save_dir = os.path.join(tmp, "models", "BMCNet_nfs", "dp")
        saved = sorted(os.listdir(save_dir))
        ckpt = latest_checkpoint(save_dir)
        with open(os.path.join(ckpt, "trainer_meta.json")) as f:
            ckpt_iter = json.load(f)["iteration"]
    a, b = ranks
    check(np.array_equal(a["params"], b["params"]), "the gloo ranks' parameters differ")
    check(np.array_equal(a["losses"], b["losses"]), "the gloo ranks' losses differ")
    check(a["valid_loss"] == b["valid_loss"], "the gloo ranks' valid losses differ")
    rel = float(np.max(np.abs(a["losses"] / ref - 1)))
    rel_valid = abs(float(a["valid_loss"]) / ref_valid - 1)
    dparam = float(np.abs(a["params"] - ref_params).max())
    check(rel <= 1e-5, f"gloo ranks' losses {a['losses']} vs the single-device Trainer's "
                       f"{ref}: rel {rel}")
    check(rel_valid <= 1e-5, f"gloo ranks' valid loss {a['valid_loss']} vs {ref_valid}")
    check(saved == ["best", "config.yml", "iteration_2"] and ckpt_iter == 2,
          f"rank 0's checkpoints {saved}, the latest of iteration {ckpt_iter}")
    n_valid = 2  # validation batches, one row each a rank
    for r, z in enumerate(ranks):
        check(z["step_launches"].tolist() == [2] * DP_ITERS,
              f"gloo rank {r}: rasterizer launches a step {z['step_launches'].tolist()}")
        check(int(z["launches"]) == 2 * (DP_ITERS + n_valid),
              f"gloo rank {r}: {int(z['launches'])} rasterizer launches, expected "
              f"{2 * (DP_ITERS + n_valid)}")
        check(int(z["resume_start"]) == DP_ITERS and bool(z["resumed_same"]),
              f"gloo rank {r}: resumed at {int(z['resume_start'])}, same parameters "
              f"{bool(z['resumed_same'])}")
        totals["rasterize_counts"] += int(z["launches"])
        print(f"parallel (b) gloo rank {r} of 2 on one card, Trainer on 1 row of each node "
              f"batch: {DP_ITERS} iterations, ms between their ends "
              f"{', '.join(f'{v:.3f}' for v in z['ms'])}, peak memory "
              f"{float(z['peak']) / 2**30:.2f} GiB, rasterizer launches {int(z['launches'])} "
              f"(2 a step, 2 a validation batch), all-reduce of the bucket through the host "
              f"{', '.join(f'{v:.3f}' for v in z['reduce_ms'])} ms; resumed from rank 0's "
              f"checkpoint at iteration {int(z['resume_start'])}")
    print(f"parallel (b): ranks' parameters, losses and valid loss identical; losses "
          f"{a['losses'].tolist()} against the single-device Trainer's {ref.tolist()} on the "
          f"whole batches, max rel |d| {rel:.2e} (rtol 1e-5); valid loss {float(a['valid_loss'])}"
          f" against {ref_valid}, rel |d| {rel_valid:.2e} (rtol 1e-5); parameters max |d| "
          f"{dparam:.3e}; single-device Trainer ms between iterations' ends "
          f"{', '.join(f'{v:.3f}' for v in ref_ms)}; rank 0's checkpoints {saved}; "
          f"{wall:.1f} s from spawn to join; on {card}")

    lap("b")
    # (c) the engine's mesh of two on this card, 2 streams
    rng = np.random.default_rng(PARALLEL_SEED + 1)
    n = MESH_WINDOWS
    inp = compact_events(random_windows(rng, 2 * (n + 1), N_LR, LR).reshape(n + 1, 2, 4, N_LR))
    gt = compact_events(random_windows(rng, 2 * n, SCALE**2 * N_LR, GT).reshape(
        n, 2, 4, SCALE**2 * N_LR))

    def load_chunk(pos, steps):
        return ((inp[0][pos : pos + steps + 1], inp[1][pos : pos + steps + 1]),
                (gt[0][pos : pos + steps], gt[1][pos : pos + steps]))

    def lane(j):
        def one(pos, steps):
            return tuple(tuple(a[:, j : j + 1] for a in part) for part in load_chunk(pos, steps))
        return one

    full_sd = seeded_full_weights(BMCNet(scale=SCALE))
    mesh = make_mesh(2, devices=[dev, dev])
    for dtype in ("float32", "int8_pall", "int8_chainq"):
        m = BMCNet(scale=SCALE, n_c=128, n_b=5, dtype=DTYPES.get(dtype, torch.bfloat16),
                   quant=INT8_DTYPES.get(dtype, False))
        m.load_state_dict(full_sd)
        sharded = InferenceEngine(m, DatasetConfig(scale=SCALE), chunk_size=CHUNK,
                                  visualize=False, mesh=mesh, device=dev)
        single = InferenceEngine(m, DatasetConfig(scale=SCALE), chunk_size=CHUNK,
                                 visualize=False, device=dev)
        sharded.infer_windows_batch(load_chunk, [2, 2], LR, GT)  # warm-ups, outside the counts
        single.infer_windows_batch(load_chunk, [2, 2], LR, GT)
        single.infer_windows(lane(0), 2, LR, GT)
        torch.cuda.synchronize()
        zero_counts(mods)
        t0 = time.perf_counter()
        rs = sharded.infer_windows_batch(load_chunk, [n, n], LR, GT, return_per_window=True)
        wall = time.perf_counter() - t0
        got = counts(mods)
        per_stream = expected_launches("full", dtype, n, min(CALIB_STEPS, CHUNK, n))
        check(got["rasterize_counts"] > 0, f"mesh {dtype}: the rasterizer never launched")
        for k, v in per_stream.items():
            check(got[k] == 2 * v, f"mesh {dtype}: {got[k]} {k} launches, the model gives "
                                   f"{2 * v} for two batch-1 shards")
        for k, v in got.items():
            totals[k] += v
        solo = [single.infer_windows(lane(j), n, LR, GT, return_per_window=True) for j in (0, 1)]
        for j in (0, 1):
            for key in ("esr_mse", "bicubic_mse"):
                check(np.array_equal(rs[j]["per_window"][key], solo[j]["per_window"][key]),
                      f"mesh {dtype}: shard {j}'s {key} differs from its solo rollout")
        t1 = time.perf_counter()
        batched = single.infer_windows_batch(load_chunk, [n, n], LR, GT, return_per_window=True)
        wall_batched = time.perf_counter() - t1
        got_pw = np.stack([r["per_window"]["esr_mse"] for r in rs])
        want_pw = np.stack([r["per_window"]["esr_mse"] for r in batched])
        d_max = float(np.abs(got_pw - want_pw).max() / np.abs(want_pw).max())
        rmse = float(np.sqrt(np.mean((got_pw - want_pw) ** 2)) / max(np.abs(want_pw).max(), 1.0))
        if dtype == "float32":
            check(d_max <= 1e-5, f"mesh float32 against the batch-2 rollout: {d_max}")
        else:
            check(rmse <= INT8_BOUND, f"mesh {dtype} against the batch-2 rollout: {rmse}")
        print(f"parallel (c) engine mesh of 2 on one card, full {dtype}, 2 streams x {n} "
              f"windows: each shard's per-window esr_mse and bicubic_mse bit-exact against "
              f"its solo rollout; against the unsharded batch-2 rollout max|d|/max|x| "
              f"{d_max:.3e}, rel-RMSE {rmse:.3e}; {wall / n * 1e3:.3f} ms a window of both "
              f"streams sharded, {wall_batched / n * 1e3:.3f} unsharded (wall, calibration "
              f"included); launches {got}; on {card}")
        del sharded, single, m
        torch.cuda.empty_cache()
    lap("c")
    parallel_slots(dev, mods, totals, card)
    lap("d")
    parallel_rows(dev, mods, totals, card)
    lap("e")
    parallel_model(dev, mods, totals, card, tp_ref)
    lap("f")
    print("parallel phase, s: " + ", ".join(f"({k}) {v:.1f}" for k, v in laps.items()))
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    return totals


def tp_trainer(work: str, runid: str, dev, iterations: int, start: int = 0,
               make_dirs: bool = True, **trainer):
    """(f)'s ``Trainer``: the NFS recipe for ``iterations`` iterations on
    in-memory batches, the first ``TP_ITERS`` of them (a)'s, from batch
    ``start`` (a resumed run picks up where the uninterrupted one was), no
    validation, a checkpoint at the end.  Returns the trainer and its steps'
    device metrics."""
    import numpy as np

    from bmcnet_esr_torch.training import Trainer
    from bmcnet_esr_torch.training.config import RunConfig

    cfg = _recipe(work, iterations, 1000)
    del cfg["valid_dataloader"]
    cfg["trainer"].update(trainer)
    data = train_batches(np.random.default_rng(PARALLEL_SEED), TP_ITERS + 1)
    tr = Trainer(RunConfig(cfg, runid=runid, make_dirs=make_dirs),
                 train_loader=MemoryLoader(data, start), seed=0, device=dev)
    return tr, _recorded(tr)


def _tp_rank(rank: int, store: str, out: str, sizes: dict) -> None:
    """One of (f)'s two ranks, a spawned process: gloo on ``cuda:0``, the
    ``Trainer`` with ``model_parallel: 2`` (a ``(data 1, model 2)`` mesh).
    ``TP_ITERS`` iterations from (a)'s starting state on (a)'s batches, each
    timed, the first one's collectives counted and its gradient gathered,
    peak memory, the state gathered back, rank 0's checkpoint; then a run
    that resumes the one-device checkpoint ``sizes["ONE_CKPT"]`` of
    iteration ``TP_ITERS - 1`` for one more.  ``sizes`` carries the
    parent's module constants into the child."""
    globals().update(sizes)
    import numpy as np
    import torch
    from torch.distributed.tensor import Shard

    from bmcnet_esr_torch.kernels import rasterize
    from bmcnet_esr_torch.parallel import channel_sharding, gather_tree, init_distributed, tensor

    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2")
    dev = init_distributed(sizes["DEVICE"], backend="gloo", init_method=f"file://{store}",
                           timeout_s=GLOO_JOIN_S)
    try:
        tr, metrics = tp_trainer(WORK, "tp_first", dev, TP_ITERS, make_dirs=rank == 0,
                                 model_parallel=2)
        placements = channel_sharding(tr.state.model, 2)
        rows = {n: p.shape[0] for n, p in tr.state.model.named_parameters()
                if isinstance(placements[n], Shard) and n.endswith("weight")}
        step, rec = tr.train_step, {"launches": [], "events": []}

        def counted(state, batch):
            before = rasterize.launches
            state, m = step(state, batch)
            rec["launches"].append(rasterize.launches - before)
            rec["events"].append(torch.cuda.Event(enable_timing=True))
            rec["events"][-1].record()
            if "grad" not in rec:  # the first iteration's collectives and gradient
                rec["coll"] = dict(tensor.collectives)
                rec["bytes"] = dict(tensor.collective_bytes)
                rec["grad"] = flat_grads(state.model, tr.mesh)
            return state, m

        tr.train_step = counted
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        rasterize.launches = 0
        tensor.collectives.clear()
        tensor.collective_bytes.clear()
        rec["events"].append(torch.cuda.Event(enable_timing=True))
        rec["events"][-1].record()
        tr.train()
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        ev = rec["events"]
        params = flat_params(gather_tree(tr.state, tr.mesh).model)
        del tr
        torch.cuda.empty_cache()
        tr, second = tp_trainer(WORK, "tp_second", dev, TP_ITERS + 1, start=TP_ITERS,
                                make_dirs=rank == 0, model_parallel=2)
        start = tr.resume(ONE_CKPT)
        tr.train(start_iteration=start)
        torch.cuda.synchronize(dev)
        kinds = sorted(rec["coll"])
        np.savez(out, losses=[float(m["train_loss"]) for m in metrics],
                 gnorms=[float(m["grad_norm"]) for m in metrics], peak=peak, params=params,
                 ms=[a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])], grad=rec["grad"],
                 names=list(rows), rows=list(rows.values()), step_launches=rec["launches"],
                 launches=rasterize.launches, kinds=kinds,
                 coll=[rec["coll"][k] for k in kinds], coll_bytes=[rec["bytes"][k] for k in kinds],
                 second=[float(m["train_loss"]) for m in second], start=start)
    finally:
        torch.distributed.destroy_process_group()


def float64_grad(dev):
    """The first one-device step's gradient (remat off) in float64: the NFS
    recipe's seeded model copied into a float64 one, on (a)'s first batch;
    the parameters' names and sizes in that order, the step's peak memory
    and seconds."""
    import torch

    from bmcnet_esr_torch.training.train_step import sequence_loss

    model = recipe_state(dev).model
    m64 = type(model)(scale=model.scale, n_c=model.n_c, n_b=model.n_b, dtype=torch.float64)
    m64.load_state_dict(model.state_dict())
    m64 = m64.double().to(dev, memory_format=torch.channels_last)
    del model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    batch = parallel_batches(dev, 1)[0]
    total, _ = sequence_loss(m64, batch, LR, GT, use_remat=False)
    total.backward()
    grad = torch.cat([p.grad.reshape(-1) for p in m64.parameters()]).cpu().numpy()
    sizes = [(n, p.numel()) for n, p in m64.named_parameters()]
    torch.cuda.synchronize()
    out = grad, sizes, torch.cuda.max_memory_allocated(dev), time.perf_counter() - t
    del m64, total
    torch.cuda.empty_cache()
    return out


def parallel_model(dev, mods, totals: dict, card: str, ref: dict) -> None:
    """(f) ``model_parallel``: two spawned ranks over gloo on this card (a
    ``(data 1, model 2)`` mesh, the NFS recipe at full width, each
    convolution's output channels split in two), :func:`_tp_rank`.  Their
    steps against (a)'s one-device steps (``ref``): loss rel 1e-5 and
    ``grad_norm`` rel 1e-4 (the JAX tensor-parallel test's bounds); the
    gathered parameters at its atol 1e-5 on all but ``TP_PARAM_SHARE`` of
    them, with beside it the same comparison for the one-device step with
    cuDNN off (PyTorch's own convolutions), the spread of two valid float32
    implementations of one step; the first step's gathered gradient against
    the same step in float64 on one device, within ``TP_GRAD_FACTOR`` times
    the one-device float32 gradient's distance.  Then the ``Trainer`` with
    ``model_parallel: 2``
    checkpointing for one device to resume and resuming one device's, both
    against the uninterrupted one-device ``Trainer`` (rel 1e-5)."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.training import make_train_step
    from bmcnet_esr_torch.training.checkpoint import latest_checkpoint

    grad64, sizes64, peak64, s64 = float64_grad(dev)
    torch.backends.cudnn.enabled = False
    try:
        batches, step = parallel_batches(dev, TP_ITERS), make_train_step(LR, GT, use_remat=False)
        _, _, state = timed_steps(step, recipe_state(dev), batches[:1])
        native_grad = flat_grads(state.model)
        _, _, state = timed_steps(step, state, batches[1:])
        native = flat_params(state.model)
    finally:
        torch.backends.cudnn.enabled = True
    del state, batches
    work = os.path.join(ROOT, "outputs", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        zero_counts(mods)
        whole, whole_m = tp_trainer(tmp, "one_whole", dev, TP_ITERS + 1)
        whole.train()
        one_first, _ = tp_trainer(tmp, "one_first", dev, TP_ITERS)
        one_first.train()
        one_ckpt = latest_checkpoint(one_first.run.save_dir)
        del whole, one_first
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        outs = [os.path.join(tmp, f"tp{r}.npz") for r in range(2)]
        sizes = dict(LR=LR, GT=GT, SCALE=SCALE, N_LR=N_LR, TRAIN_B=TRAIN_B, TRAIN_L=TRAIN_L,
                     TP_ITERS=TP_ITERS, DEVICE=str(dev), WORK=tmp, ONE_CKPT=one_ckpt)
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_tp_rank, args=(r, os.path.join(tmp, "store"), outs[r],
                                                    sizes)) for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(max(GLOO_JOIN_S - (time.perf_counter() - t0), 1))
            check(not any(p.is_alive() for p in procs),
                  f"tensor-parallel ranks still running after {GLOO_JOIN_S} s")
            check(all(p.exitcode == 0 for p in procs),
                  f"tensor-parallel ranks exited {[p.exitcode for p in procs]}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        wall = time.perf_counter() - t0
        ranks = []
        for out in outs:
            with np.load(out) as z:
                ranks.append({k: z[k] for k in z.files})
        tp_dir = os.path.join(tmp, "models", "BMCNet_nfs", "tp_first")
        saved = sorted(os.listdir(tp_dir))
        resumed, resumed_m = tp_trainer(tmp, "one_second", dev, TP_ITERS + 1, start=TP_ITERS)
        check(resumed.resume(latest_checkpoint(tp_dir)) == TP_ITERS,
              f"the one-device Trainer does not resume the model_parallel checkpoint at "
              f"{TP_ITERS}")
        resumed.train(start_iteration=TP_ITERS)
        torch.cuda.synchronize()
        del resumed
        torch.cuda.empty_cache()
        parent = counts(mods)
    whole_loss = np.asarray([float(m["train_loss"]) for m in whole_m])
    want_loss = np.asarray([m["train_loss"] for m in ref["metrics"]])
    want_gnorm = np.asarray([m["grad_norm"] for m in ref["metrics"]])
    a, b = ranks
    check(np.array_equal(a["losses"], b["losses"]) and np.array_equal(a["params"], b["params"]),
          "the tensor-parallel ranks' losses or gathered parameters differ")
    rel = float(np.max(np.abs(a["losses"] / want_loss - 1)))
    rel_g = float(np.max(np.abs(a["gnorms"] / want_gnorm - 1)))
    d_tp, d_native = (np.abs(p - ref["params"]) for p in (a["params"], native))
    beyond, beyond_native = int(np.sum(d_tp > 1e-5)), int(np.sum(d_native > 1e-5))
    d_grad = a["grad"] - ref["grad"]
    rel_grad = float(np.linalg.norm(d_grad) / np.linalg.norm(ref["grad"]))
    rel_grad_native = float(np.linalg.norm(native_grad - ref["grad"]) / np.linalg.norm(ref["grad"]))
    norm64 = np.linalg.norm(grad64)
    to64 = {name: float(np.linalg.norm(g - grad64) / norm64)
            for name, g in (("tensor-parallel", a["grad"]), ("one-device", ref["grad"]),
                            ("one-device cuDNN off", native_grad))}
    worst64 = {name: float(np.max(np.abs(g - grad64)))
               for name, g in (("tensor-parallel", a["grad"]), ("one-device", ref["grad"]))}
    bounds = np.cumsum([0] + [n for _, n in sizes64])

    def worst_params(g):  # the parameters farthest from float64, ||d||/||g64|| each
        rel = [(float(np.linalg.norm(g[a:b] - grad64[a:b]) / max(np.linalg.norm(grad64[a:b]),
                                                                   1e-30)), name)
               for (name, _), a, b in zip(sizes64, bounds[:-1], bounds[1:])]
        return ", ".join(f"{name} {r:.2e}" for r, name in sorted(rel, reverse=True)[:4])

    print(f"parallel (f) float64 reference, the parameters farthest from it: tensor-parallel "
          f"{worst_params(a['grad'])}; one-device {worst_params(ref['grad'])}")
    print(f"parallel (f) float64 reference: the first step's gradient in float64 on one device "
          f"({s64:.1f} s, peak memory {peak64 / 2**30:.2f} GiB); ||d||/||g64|| of "
          + ", ".join(f"{k} {v:.3e}" for k, v in to64.items())
          + f"; max |d| tensor-parallel {worst64['tensor-parallel']:.3e}, one-device "
          f"{worst64['one-device']:.3e} of max |g64| {np.abs(grad64).max():.3e}; the "
          f"tensor-parallel gradient at {to64['tensor-parallel'] / to64['one-device']:.2f}x "
          f"the one-device one's distance (bound {TP_GRAD_FACTOR}x)")

    check(rel <= 1e-5, f"tensor-parallel losses {a['losses']} vs one device's {want_loss}")
    check(rel_g <= 1e-4, f"tensor-parallel grad norms {a['gnorms']} vs {want_gnorm}")
    check(beyond <= TP_PARAM_SHARE * d_tp.size,
          f"tensor-parallel parameters: {beyond} of {d_tp.size} beyond atol 1e-5 of one "
          f"device's (max |d| {d_tp.max():.3e}); the one-device step with cuDNN off: "
          f"{beyond_native} (max |d| {d_native.max():.3e})")
    n_c = nfs_recipe()["model"]["args"]["n_c"]
    for r, z in enumerate(ranks):
        split = dict(zip(z["names"].tolist(), z["rows"].tolist()))
        n_c_rows = {v for k, v in split.items() if "conv_o" not in k}
        check(n_c_rows == {n_c // 2} and split["neuro.conv_o.weight"] == SCALE**2,
              f"rank {r}: split convolutions hold {sorted(set(split.values()))} output channels")
        check(z["step_launches"].tolist() == [2] * TP_ITERS,
              f"rank {r}: rasterizer launches a step {z['step_launches'].tolist()}")
        check(int(z["launches"]) == 2 * (TP_ITERS + 1),
              f"rank {r}: {int(z['launches'])} rasterizer launches, expected "
              f"{2 * (TP_ITERS + 1)}")
        totals["rasterize_counts"] += int(z["launches"])
    rel_back = abs(float(resumed_m[0]["train_loss"]) / whole_loss[TP_ITERS] - 1)
    rel_in = float(np.max(np.abs(a["second"] / whole_loss[TP_ITERS:] - 1)))
    check(saved == ["config.yml", f"iteration_{TP_ITERS - 1}"],
          f"rank 0's model_parallel checkpoints {saved}")
    check(int(a["start"]) == TP_ITERS and len(a["second"]) == 1,
          f"ranks resumed at {int(a['start'])}")
    check(max(rel_back, rel_in) <= 1e-5,
          f"Trainer losses against the uninterrupted one-device run {whole_loss}: one device "
          f"resuming model_parallel's checkpoint {float(resumed_m[0]['train_loss'])}, "
          f"model_parallel resuming one device's {a['second']}")
    check(parent["rasterize_counts"] == 2 * (2 * TP_ITERS + 2),
          f"(f) one-device Trainers: rasterizer launches {parent}")
    for k, v in parent.items():
        totals[k] += v
    per = ", ".join(f"{k} {c:.0f} ({by / 2**20:.1f} MiB)" for k, c, by in
                    zip(a["kinds"].tolist(), a["coll"], a["coll_bytes"]))
    for r, z in enumerate(ranks):
        print(f"parallel (f) tensor-parallel rank {r} of 2 on one card, (data 1, model 2), NFS "
              f"recipe full width, batch {TRAIN_B}: ms/iteration "
              f"{', '.join(f'{v:.3f}' for v in z['ms'])}; peak memory "
              f"{float(z['peak']) / 2**30:.2f} GiB; rasterizer launches a step "
              f"{z['step_launches'].tolist()}")
    print(f"parallel (f): model-axis collectives a rank an iteration: {per}; losses "
          f"{a['losses'].tolist()} against one device's {want_loss.tolist()}, max rel |d| "
          f"{rel:.2e} (rtol 1e-5); grad norms max rel |d| {rel_g:.2e} (rtol 1e-4); first "
          f"step's gathered gradient ||d||/||g|| {rel_grad:.3e}, max |d| "
          f"{np.abs(d_grad).max():.3e} of max |g| {np.abs(ref['grad']).max():.3e} (the "
          f"one-device step with cuDNN off: ||d||/||g|| {rel_grad_native:.3e}); gathered "
          f"parameters after {TP_ITERS} steps max |d| {d_tp.max():.3e}, {beyond} of "
          f"{d_tp.size} beyond atol 1e-5 (at most {TP_PARAM_SHARE:.0e} of them); the "
          f"one-device step with cuDNN off against it max |d| {d_native.max():.3e}, "
          f"{beyond_native} beyond; split convolutions hold {n_c // 2} of "
          f"{n_c} output channels (conv_o {SCALE**2} of {2 * SCALE**2}); one device resuming "
          f"model_parallel's checkpoint for iteration {TP_ITERS} rel {rel_back:.2e}, "
          f"model_parallel resuming one device's rel {rel_in:.2e}, against the uninterrupted "
          f"one-device run {whole_loss.tolist()} (rtol 1e-5); rank 0's checkpoints {saved}; "
          f"{wall:.1f} s from spawn to join; on {card}")
    check(to64["tensor-parallel"] <= TP_GRAD_FACTOR * to64["one-device"],
          f"the tensor-parallel gradient sits {to64['tensor-parallel']:.3e} from float64, more "
          f"than {TP_GRAD_FACTOR}x the one-device gradient's {to64['one-device']:.3e}: the "
          "tensor-parallel forward adds more than round-off")


def parallel_slots(dev, mods, totals: dict, card: str) -> None:
    """(d) ``StreamPool(mesh=)``: 8 slots of the full model in two groups of
    4 on this card, each group on its own replica and CUDA stream.  In
    float32, bfloat16, int8_pall and int8_chainq (static scales): every
    group's lanes bit-exact against an unsharded 4-slot pool fed the same
    lanes, a hot reload mid-stream included, its state too; every lane
    within the serving bounds of its solo stream; the rasterizer once a
    group a tick and the int8 kernels as the model gives.  In float32 and
    int8_pall: a deep tick (K=4) and a lane-compacted one bit-exact against
    shallow ticks of a twin pool.  In bfloat16 and int8_pall:
    ``EventSRServer(mesh=)`` with 8 client threads, every reply equal to
    the replay of a sharded pool, timed, and a profiled 8-lane tick."""
    import copy

    import numpy as np
    import torch

    from bmcnet_esr_torch.inference import EventSRServer, StreamingSR, StreamPool, assemble_fetch
    from bmcnet_esr_torch.parallel import make_mesh

    mesh = make_mesh(SLOT_MESH, devices=[dev] * SLOT_MESH)
    g = SERVE_SLOTS // SLOT_MESH
    rng = np.random.default_rng(PARALLEL_SEED + 2)

    def sharded(model, **kw):
        pool = StreamPool(model, None, LR, slots=SERVE_SLOTS, window_size=N_LR, mesh=mesh,
                          device=dev, **kw)
        check(len(pool._groups) == SLOT_MESH and len({id(x.model) for x in pool._groups}) ==
              SLOT_MESH, "the sharded pool does not hold a replica a group")
        return pool

    for dtype in ("float32", "bfloat16", "int8_pall", "int8_chainq"):
        model = serve_model(dtype, dev)
        v1 = host_state(model)
        v2 = host_state(serve_model(dtype, dev, seed=1, calib_seed=10))
        pool = sharded(model)
        refs = [StreamPool(copy.deepcopy(model), None, LR, slots=g, window_size=N_LR, device=dev)
                for _ in range(SLOT_MESH)]
        for p in (pool, *refs):
            for _ in range(p.slots):
                p.attach()
        wins = [serve_windows(rng, SLOT_TICKS) for _ in range(SERVE_SLOTS)]
        got = [[] for _ in range(SERVE_SLOTS)]
        launches = {k: 0 for k in KERNEL_NAMES.values()}
        tick_ms = []
        for t in range(SLOT_TICKS):
            if t == SLOT_RELOAD:
                for p in (pool, *refs):
                    p.reload(v2)
            zero_counts(mods)
            t0 = time.perf_counter()
            out = pool.push({s: wins[s][t] for s in range(SERVE_SLOTS)})
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            for k, v in counts(mods).items():
                launches[k] += v
            for i, r in enumerate(refs):
                ref = r.push({s: wins[i * g + s][t] for s in range(g)})
                for s in range(g):
                    a, b = out.get(i * g + s), ref.get(s)
                    check((a is None) == (b is None) and (a is None or np.array_equal(a, b)),
                          f"slots {dtype}: slot {i * g + s} at tick {t} differs from the "
                          f"unsharded {g}-slot pool's lane {s}")
            for s in range(SERVE_SLOTS):
                got[s].append(out.get(s))
        for i, r in enumerate(refs):
            grp = pool._groups[i]
            check(all(torch.equal(a, b) for a, b in zip(grp.carry + (grp.prev,),
                                                          r._carry + (r._prev,))),
                  f"slots {dtype}: group {i}'s state differs from the unsharded pool's")
        for k, v in launches.items():
            totals[k] += v
        want_l = expected_launches("full", dtype, SLOT_MESH * SLOT_TICKS, 0)
        check(launches["rasterize_counts"] == SLOT_MESH * SLOT_TICKS,
              f"slots {dtype}: {launches['rasterize_counts']} rasterizer launches in "
              f"{SLOT_TICKS} ticks of {SLOT_MESH} groups")
        for k, v in want_l.items():
            check(launches[k] == v, f"slots {dtype}: {launches[k]} {k} launches, the model "
                                    f"gives {v} for {SLOT_TICKS} ticks of {SLOT_MESH} groups")
        solo = StreamingSR(copy.deepcopy(model), v1, LR, window_size=N_LR, device=dev)
        worst = (0.0, 0.0)
        for s in range(SERVE_SLOTS):
            solo.reset()
            solo.reload(v1)
            want = []
            for t, w in enumerate(wins[s]):
                if t == SLOT_RELOAD:
                    solo.reload(v2)
                want.append(solo.push(w))
            check(got[s][0] is None and all(x is not None and np.isfinite(x).all()
                                            for x in got[s][1:]), f"slots {dtype}: lane {s}")
            d = lane_errors(got[s][1:], want[1:])
            worst = max(worst[0], d[0]), max(worst[1], d[1])
        if dtype == "float32":
            check(worst[0] <= SERVE_F32_BOUND, f"slots float32 lanes: max|d|/max|x| {worst[0]}")
        else:
            check(worst[1] <= SERVE_BOUND, f"slots {dtype} lanes: rel-RMSE {worst[1]}")
        per = {k: v / SLOT_TICKS / SLOT_MESH for k, v in launches.items()}
        print(f"parallel (d) slot-sharded pool, full {dtype}, 8 slots in {SLOT_MESH} groups on "
              f"one card, {SLOT_TICKS} ticks with a reload before tick {SLOT_RELOAD}: every "
              f"group's lanes and state bit-exact against an unsharded {g}-slot pool; lanes "
              f"against solo streams max|d|/max|x| {worst[0]:.3e}, rel-RMSE {worst[1]:.3e}; "
              f"launches a tick a group {per}; wall ms a tick "
              f"{', '.join(f'{v:.3f}' for v in tick_ms)}; on {card}")

        if dtype in ("float32", "int8_pall"):  # deep and compacted ticks on the mesh
            a, b = sharded(model, fetch_chunks=4), sharded(copy.deepcopy(model), fetch_chunks=4)
            first = {s: serve_windows(rng, 1)[0] for s in range(6)}
            for p in (a, b):
                for _ in range(SERVE_SLOTS):
                    p.attach()
                p.push(first)
            deep_w = {s: serve_windows(rng, 2 if s == 3 else 4) for s in range(7)}
            zero_counts(mods)
            _, fetch = a.push_async_deep(deep_w, 4)
            deep_l = counts(mods)
            deep = assemble_fetch(fetch.get(), deep=True)
            for j in range(4):
                _, f = b.push_async({s: w[j] for s, w in deep_w.items() if j < len(w)})
                check(np.array_equal(deep[j], assemble_fetch(f.get())),
                      f"slots deep {dtype}: step {j} differs from the shallow tick")
            comp_w = {s: serve_windows(rng, 2) for s in (1, 5, 6)}
            zero_counts(mods)
            out_map, fetch, lane_of = a.push_async_deep(comp_w, 2, compact=True)
            comp_l = counts(mods)
            comp = assemble_fetch(fetch.get(), deep=True)
            check(comp.shape[1] == 4, f"slots compact {dtype}: {comp.shape[1]} lanes fetched")
            for j in range(2):
                _, f = b.push_async({s: w[j] for s, w in comp_w.items()})
                shallow = assemble_fetch(f.get())
                for s in comp_w:
                    check(np.array_equal(comp[j, lane_of[s]], shallow[s]),
                          f"slots compact {dtype}: slot {s} step {j} differs")
            check(all(torch.equal(x, y) for x, y in zip(a._carry + (a._prev,),
                                                          b._carry + (b._prev,))),
                  f"slots deep {dtype}: the state after the deep ticks differs")
            check(deep_l["rasterize_counts"] == SLOT_MESH and comp_l["rasterize_counts"] ==
                  SLOT_MESH, f"slots deep {dtype}: rasterizer launches {deep_l}, {comp_l}")
            for c in (deep_l, comp_l):
                for k, v in c.items():
                    totals[k] += v
            print(f"parallel (d) {dtype}: a deep tick (K=4, ragged, fresh and idle slots) and "
                  f"a compacted one (3 slots of 2 groups) bit-exact against shallow ticks, "
                  f"state included; launches of the deep tick {deep_l}, compacted {comp_l}")
            del a, b

        if dtype in ("bfloat16", "int8_pall"):  # the daemon over the mesh
            server = EventSRServer(model, v1, LR, slots=SERVE_SLOTS, window_size=N_LR,
                                   batch_window_ms=2.0, scan_k=SERVE_K, wire_dtype="float16",
                                   fetch_chunks=4, mesh=mesh, device=dev)
            server.prewarm()
            depths, tick = [], server.pool._tick

            def recording(xy, *args, **kw):
                depths.append(xy.shape[0])
                return tick(xy, *args, **kw)

            server.pool._tick = recording
            server.start()
            errors = []
            try:
                zero_counts(mods)
                streams = {f"c{i}": serve_windows(rng, SLOT_CLIENT_WINDOWS)
                           for i in range(SERVE_SLOTS)}
                runs, wall = run_clients(server.address, streams, errors)
                st = server.stats()
            finally:
                server.shutdown()
            check(server._thread is None, f"slots daemon {dtype}: the daemon thread did not stop")
            got_l = counts(mods)
            for k, v in got_l.items():
                totals[k] += v
            check(st["mesh_devices"] == SLOT_MESH, f"slots daemon {dtype}: stats {st}")
            check(got_l["rasterize_counts"] == SLOT_MESH * len(depths),
                  f"slots daemon {dtype}: {got_l['rasterize_counts']} rasterizer launches in "
                  f"{len(depths)} ticks of {SLOT_MESH} groups")
            for k, v in expected_launches("full", dtype, SLOT_MESH * sum(depths), 0).items():
                check(got_l[k] == v, f"slots daemon {dtype}: {got_l[k]} {k} launches, the model "
                                     f"gives {v}")
            ref = StreamPool(model, v1, LR, slots=SERVE_SLOTS, window_size=N_LR, mesh=mesh,
                             device=dev, out_wire="f16", fetch_chunks=4)
            want = replay(ref, [(runs[n][0], streams[n]) for n in streams])
            n_eq = sum(same_replies(runs[n][1], want[runs[n][0]], f"slots daemon {dtype} {n}")
                       for n in streams)
            tick_wins = {s: w[0] for s, w in enumerate(streams.values())}
            ref.push(tick_wins)
            zero_counts(mods)
            prof = _profiled(lambda: [ref.push(tick_wins) for _ in range(4)], 4,
                             f"slot-sharded tick {dtype} at 8 lanes", "tick")
            per = {k: v / 4 / SLOT_MESH for k, v in counts(mods).items()}
            windows = sum(len(w) for w in streams.values())
            print(f"parallel (d) daemon over the mesh, {dtype}, {SERVE_SLOTS} client threads: "
                  f"{windows} windows in {wall:.3f} s, {windows / wall:.2f} windows/s, "
                  f"{len(depths) / wall:.2f} ticks/s, latency p50 {st['latency_ms_p50']} ms p99 "
                  f"{st['latency_ms_p99']} ms, tick depths {sorted(set(depths))}; {n_eq} replies "
                  f"equal the sharded pool's replay; profiled 8-lane tick wall "
                  f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms, idle "
                  f"{prof['idle']:.1%}, {prof['launches']:.0f} launches; kernel launches a tick "
                  f"a group {per}; on {card}")
            del server, ref
        del pool, refs, model
        torch.cuda.empty_cache()


def parallel_rows(dev, mods, totals: dict, card: str) -> None:
    """(e) ``StreamingSR(mesh=)``: one stream's 45 rows over a mesh of 3 on
    this card (bands of 15 rows, 17 with the halo), the full model, 16
    windows, against the unsharded stream: float32 within max|d|/max|x|
    1e-5, bfloat16 and int8_pall with static and with dynamic scales within
    rel-RMSE 5e-2; the rasterizer once a band a window, the int8 kernels 3
    times the model's count, the cross-band steps the model's count.
    Then ``quant_conv3x3`` at the band shapes against its plain version,
    and the released plain checkpoint's golden through the row-band
    forward on a mesh of 4: RMSE < 1e-3 against the reference."""
    import copy

    import numpy as np
    import torch

    from bmcnet_esr_torch.inference import StreamingSR
    from bmcnet_esr_torch.kernels import qconv, quantize
    from bmcnet_esr_torch.models import BMCNetPlain, load_checkpoint, set_act_scales
    from bmcnet_esr_torch.parallel import make_mesh, spatial_sharding
    from bmcnet_esr_torch.parallel.spatial import RowBandForward

    # quant_conv3x3 at this part's band shapes (not counted as launches)
    rng = np.random.default_rng(PARALLEL_SEED + 3)
    band = (1, LR[0] // ROW_MESH + 2, LR[1])
    n_cases = 0
    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(dtype)

    for cin, cout in sorted(FULL_CONV3):
        wq, sw = qconv.quantize_weights3x3(t(rng.normal(0, 0.05, (3, 3, cin, cout))))
        bias, sx, se = t(rng.normal(0, 0.5, cout)), t([5.0 / 127]), t([7.0 / 127])
        x = t(rng.normal(0, 2.0, (*band, cin)), torch.bfloat16)
        xq = quantize.quantize_plain(x, sx)
        for xin, kw in ((x, {}), (xq, {}), (xq, {"emit_scale": se, "emit_relu": True})):
            got = qconv.quant_conv3x3(xin, wq, sw, sx, bias, **kw)
            want = qconv.qconv3x3_plain(xin, wq, sw, sx, bias, **kw)
            torch.cuda.synchronize()
            check(got.dtype == want.dtype and torch.equal(got, want),
                  f"quant_conv3x3 at the band shape {band} {cin}->{cout} ({xin.dtype}, {kw}) "
                  "differs from its plain version")
            n_cases += 1
    print(f"parallel (e) quant_conv3x3 bit-exact against its plain version at the band shape "
          f"{band} in {n_cases} cases (bf16 and int8 inputs, an int8 emit)")

    mesh = make_mesh(ROW_MESH, devices=[dev] * ROW_MESH)
    wins = serve_windows(rng, ROW_WINDOWS + 1)
    n3, n1, _ = site_counts("full")
    for dtype, static in (("float32", False), ("bfloat16", False), ("int8_pall", True),
                          ("int8_pall", False)):
        name = dtype + (" static scales" if static else " dynamic scales" if "int8" in dtype
                        else "")
        model = serve_model(dtype, dev)
        if not static:
            set_act_scales(model, None)
        solo = StreamingSR(copy.deepcopy(model), None, LR, window_size=N_LR, device=dev)
        spat = StreamingSR(model, None, LR, window_size=N_LR, mesh=mesh, device=dev)
        solo_ms, rows_ms, want, got = [], [], [], []
        for w in wins:
            t0 = time.perf_counter()
            want.append(solo.push(w))
            solo_ms.append((time.perf_counter() - t0) * 1e3)
        zero_counts(mods)
        for w in wins:
            t0 = time.perf_counter()
            got.append(spat.push(w))
            rows_ms.append((time.perf_counter() - t0) * 1e3)
        got_l = counts(mods)
        for k, v in got_l.items():
            totals[k] += v
        check(got[0] is None and all(x is not None and x.shape == (*GT, 2) and np.isfinite(x).all()
                                     for x in got[1:]), f"rows {name}: bad predictions")
        d = lane_errors(got[1:], want[1:])
        if dtype == "float32":
            check(d[0] <= 1e-5, f"rows float32: max|d|/max|x| {d[0]} against the unsharded stream")
        else:
            check(d[1] <= SERVE_BOUND, f"rows {name}: rel-RMSE {d[1]} against the unsharded stream")
        check(got_l["rasterize_counts"] == ROW_MESH * len(wins),
              f"rows {name}: {got_l['rasterize_counts']} rasterizer launches for {len(wins)} "
              f"windows on {ROW_MESH} bands")
        for k, v in expected_launches("full", dtype, ROW_MESH * ROW_WINDOWS, 0).items():
            check(got_l[k] == v, f"rows {name}: {got_l[k]} {k} launches, the model gives {v}")
        ex = {k: v / ROW_WINDOWS for k, v in spat._forward.exchanges.items()}
        want_ex = {"conv_halo": n3, "skip_halo": 1, "logit_sum": 30}
        if "int8" in dtype and not static:
            want_ex["scale_max"] = n3 + n1
        check(ex == want_ex, f"rows {name}: exchanges a window {ex}, the model gives {want_ex}")
        print(f"parallel (e) spatial stream, full {name}, {LR[0]}x{LR[1]} in {ROW_MESH} bands "
              f"of {LR[0] // ROW_MESH} rows on one card, {ROW_WINDOWS} windows: against the "
              f"unsharded stream max|d|/max|x| {d[0]:.3e}, rel-RMSE {d[1]:.3e}; wall ms a window "
              f"median {float(np.median(rows_ms[2:])):.3f} sharded against "
              f"{float(np.median(solo_ms[2:])):.3f} unsharded; launches {got_l} in "
              f"{len(wins)} pushes ({ROW_WINDOWS} forwards); exchanges a window {ex}; on {card}")
        del solo, spat, model
        torch.cuda.empty_cache()

    # the released plain checkpoint's golden through the row-band forward
    path = os.path.join(ROOT, "tests", "goldens", "plain_nfs_x4_ckpt.npz")
    with np.load(path) as z:
        x = np.transpose(z["x"], (0, 1, 3, 4, 5, 2))  # [S, B, C, T, H, W] -> NHWC
        want = np.transpose(z["preds"], (0, 1, 3, 4, 2))
    m = BMCNetPlain(scale=4, n_c=128, n_b=5)
    m.load_state_dict(load_checkpoint(path))
    m = m.to(dev, memory_format=torch.channels_last).eval()
    rows = spatial_sharding(make_mesh(ROW_GOLDEN_MESH, devices=[dev] * ROW_GOLDEN_MESH))
    fwd = RowBandForward([m] + [copy.deepcopy(m) for _ in range(ROW_GOLDEN_MESH - 1)])
    st = [rows.shard(s, 1) for s in m.init_state(x.shape[1], x.shape[3], x.shape[4])]
    out = []
    with torch.inference_mode():
        for xi in x:
            st = fwd(rows.shard(torch.from_numpy(xi).to(dev), 2), *st)
            out.append(rows.gather(st[-1], 1).float().cpu().numpy())
    rmse = float(np.sqrt(np.mean((np.stack(out) - want) ** 2)))
    check(rmse < 1e-3, f"released checkpoint through {ROW_GOLDEN_MESH} bands: RMSE {rmse}")
    print(f"parallel (e) released plain checkpoint, {x.shape[3]}x{x.shape[4]} LR in "
          f"{ROW_GOLDEN_MESH} bands of {x.shape[3] // ROW_GOLDEN_MESH} rows, {len(x)} steps: "
          f"RMSE {rmse:.3e} against the reference (budget 1e-3)")


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


SERVE_SLOTS, SERVE_K, SERVE_CLIENT_WINDOWS = 8, 8, 64
SERVE_F32_BOUND = 1e-5  # max|d| / max|x| of a pool lane against its solo stream, float32
SERVE_BOUND = 5e-2  # rel-RMSE of a pool lane against its solo stream, bfloat16 and int8


def serve_windows(rng, n: int) -> list:
    """``n`` raw ``[4, 2048]`` windows at 45x80: sorted timestamps, the last
    64 events zero padding, coordinates a little past the sensor."""
    return list(random_windows(rng, n, N_LR, LR, pad=64))


def serve_model(dtype: str, dev, seed: int = 0, calib_seed: int = 9):
    """Full BMCNet (n_c=128, n_b=5, x4) with seeded weights on the card in
    ``dtype``; an int8 dtype gets static single-lane scales from the
    calibration helper on 16 seeded windows (the card's machine has no
    h5py, so the file read of ``calibrate_from_h5`` is skipped)."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.inference.engine import DTYPES, INT8_DTYPES
    from bmcnet_esr_torch.models import BMCNet
    from bmcnet_esr_torch.models.quant import _calibrate_from_events

    m = BMCNet(scale=SCALE, n_c=128, n_b=5, dtype=DTYPES.get(dtype, torch.bfloat16),
               quant=INT8_DTYPES.get(dtype, False))
    m.load_state_dict(seeded_full_weights(m, seed))
    m = m.to(dev, memory_format=torch.channels_last).eval()
    if m.quant:
        ev = random_windows(np.random.default_rng(calib_seed), CALIB_STEPS + 1, N_LR, LR)
        cols = [np.ascontiguousarray(ev[:, i].reshape(-1)) for i in range(4)]
        scales = _calibrate_from_events(m, cols[0], cols[1], cols[2].astype(np.float64),
                                        cols[3], LR, N_LR)
        check(scales and all(s.shape == (1,) for s in scales.values()), "calibration scales")
    return m


def host_state(model) -> dict:
    """The model's serving state as host copies (what a weight loader hands over)."""
    from bmcnet_esr_torch.inference import serving_state

    return {col: {k: v.detach().cpu().clone() for k, v in leaves.items()}
            for col, leaves in serving_state(model).items()}


def counts(mods) -> dict:
    return {KERNEL_NAMES[n]: mod.launches for n, mod in mods.items()}


def zero_counts(mods) -> None:
    for mod in mods.values():
        mod.launches = 0


def lane_errors(got, want):
    """(max|d| / max|x|, rel-RMSE) over a stream's predictions."""
    import numpy as np

    g, w = np.stack(got), np.stack(want)
    scale = max(float(np.abs(w).max()), 1.0)
    return (float(np.abs(g - w).max()) / float(np.abs(w).max()),
            float(np.sqrt(np.mean((g - w) ** 2))) / scale)


def serve_parity(dev, mods, totals: dict) -> dict:
    """8-slot pools of the full model with churn (attach and detach mid-stream,
    idle slots, a slot re-attached) in float32, bfloat16, int8_pall and
    int8_chainq, each lane against a solo ``StreamingSR`` of the same weights;
    each int8 kernel's launches per tick against the model's count, and the
    rasterizer's at one a tick.  Returns the profiles of an 8-lane tick."""
    import numpy as np

    from bmcnet_esr_torch.inference import StreamingSR, StreamPool

    rng = np.random.default_rng(21)
    names = "abcdefgh"
    schedule = [("attach", "abc"), "abc", ("attach", "d"), "abd", "acd",
                ("detach", "b"), ("attach", "e"), "ace", ("attach", "fgh"), "acdefgh",
                "aeh", "acdefgh"]
    need = {n: sum(n in step for step in schedule if isinstance(step, str)) for n in names}
    wins = {n: serve_windows(rng, need[n]) for n in names if need[n]}
    profiles = {}
    for dtype in ("float32", "bfloat16", "int8_pall", "int8_chainq"):
        model = serve_model(dtype, dev)
        pool = StreamPool(model, None, LR, slots=SERVE_SLOTS, window_size=N_LR, device=dev)
        slot_of, used, got, ticks = {}, {n: 0 for n in wins}, {n: [] for n in wins}, 0
        zero_counts(mods)
        for step in schedule:
            if isinstance(step, tuple):
                for n in step[1]:
                    if step[0] == "attach":
                        slot_of[n] = pool.attach()
                    else:
                        pool.detach(slot_of.pop(n))
                continue
            out = pool.push({slot_of[n]: wins[n][used[n]] for n in step})
            ticks += 1
            for n in step:
                got[n].append(out.get(slot_of[n]))
                used[n] += 1
        got_launches = counts(mods)
        check(slot_of["e"] == 1, f"stream e took slot {slot_of['e']}, not b's slot 1")
        want_l = expected_launches("full", dtype, ticks, 0)
        check(got_launches["rasterize_counts"] == ticks,
              f"serve {dtype}: {got_launches['rasterize_counts']} rasterizer launches in {ticks} ticks")
        for k, v in want_l.items():
            check(got_launches[k] == v, f"serve {dtype}: {got_launches[k]} {k} launches in {ticks} "
                                        f"ticks, the model gives {v}")
        for k, v in got_launches.items():
            totals[k] += v
        worst = (0.0, 0.0)
        for n, ws in wins.items():
            solo = StreamingSR(model, None, LR, window_size=N_LR, device=dev)
            want = [solo.push(w) for w in ws]
            check(got[n][0] is None and want[0] is None, f"serve {dtype}: first window of {n}")
            check(all(g is not None and g.shape == (*GT, 2) and np.isfinite(g).all()
                      for g in got[n][1:]), f"serve {dtype}: bad predictions of {n}")
            d = lane_errors(got[n][1:], want[1:])
            worst = max(worst[0], d[0]), max(worst[1], d[1])
        if dtype == "float32":
            check(worst[0] <= SERVE_F32_BOUND, f"serve float32 lanes: max|d|/max|x| {worst[0]}")
        else:
            check(worst[1] <= SERVE_BOUND, f"serve {dtype} lanes: rel-RMSE {worst[1]}")
        print(f"serve parity {dtype}: 8-slot pool, {ticks} ticks with churn (8 streams, attach and "
              f"detach mid-stream, idle slots, slot 1 re-attached), every lane against a solo "
              f"StreamingSR: max|d|/max|x| {worst[0]:.3e}, rel-RMSE {worst[1]:.3e} (bound "
              f"{'max|d|/max|x| %g' % SERVE_F32_BOUND if dtype == 'float32' else 'rel-RMSE %g' % SERVE_BOUND}"
              f"); launches in the pool's ticks {got_launches} (model {want_l}, rasterizer 1 a tick)")
        if dtype != "float32":  # a profiled tick with every slot pushing
            while pool.free_slots:
                pool.attach()
            full = {s: wins["a"][0] for s in range(SERVE_SLOTS)}
            pool.push(full)
            profiles[dtype] = _profiled(lambda: [pool.push(full) for _ in range(3)], 3,
                                        f"serve tick {dtype} at 8 lanes", "tick")
        del pool, model
    return profiles


def serve_deep(dev, mods, totals: dict) -> None:
    """A deep tick of K=4 bit-exact against 4 shallow ticks of the same 8-slot
    width (float32 and int8_pall): encodings and every slot's state; one
    rasterizer launch for the deep tick."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.inference import StreamPool, assemble_fetch

    rng = np.random.default_rng(22)
    for dtype in ("float32", "int8_pall"):
        model = serve_model(dtype, dev)
        pools = [StreamPool(model, None, LR, slots=SERVE_SLOTS, window_size=N_LR, device=dev,
                            fetch_chunks=4) for _ in range(2)]
        first = {s: serve_windows(rng, 1)[0] for s in range(6)}
        for p in pools:
            for _ in range(SERVE_SLOTS):
                p.attach()
            p.push(first)
        # slots 0-5 live (slot 3 ragged: 2 windows), slot 6 fresh, slot 7 idle
        wins = {s: serve_windows(rng, 2 if s == 3 else 4) for s in range(7)}
        zero_counts(mods)
        out_map, deep = pools[0].push_async_deep(wins, 4)
        deep_launch = counts(mods)
        deep = assemble_fetch(deep.get(), deep=True)
        for j in range(4):
            _, f = pools[1].push_async({s: w[j] for s, w in wins.items() if j < len(w)})
            shallow = assemble_fetch(f.get())
            check(np.array_equal(deep[j], shallow),
                  f"serve deep {dtype}: step {j} differs from the shallow tick")
        for k, v in counts(mods).items():
            totals[k] += v
        same = all(torch.equal(a, b) for a, b in
                   zip(pools[0]._carry + (pools[0]._prev,), pools[1]._carry + (pools[1]._prev,)))
        check(same, f"serve deep {dtype}: the state after the deep tick differs")
        check(deep_launch["rasterize_counts"] == 1, f"serve deep {dtype}: {deep_launch}")
        print(f"serve deep tick {dtype}: K=4 at 8 slots (ragged, fresh and idle slots) bit-exact "
              f"against 4 shallow ticks, state included; launches of the deep tick {deep_launch}")
        del pools, model


def serve_released(dev, mods, totals: dict) -> None:
    """The released plain checkpoint through one lane of an 8-slot pool
    against ``InferenceEngine.infer_windows`` on the same windows: per-window
    esr_mse from the pool's predictions against the engine's."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.data import DatasetConfig
    from bmcnet_esr_torch.inference import InferenceEngine, StreamPool
    from bmcnet_esr_torch.kernels import rasterize
    from bmcnet_esr_torch.models import BMCNetPlain, load_checkpoint
    from bmcnet_esr_torch.ops.batch import compact_events

    n = 16
    rng = np.random.default_rng(23)
    inp = random_windows(rng, n + 1, N_LR, LR, pad=64)
    gt = random_windows(rng, n, SCALE**2 * N_LR, GT, pad=512)
    inp_c, gt_c = compact_events(inp[:, None]), compact_events(gt[:, None])

    def load_chunk(pos, steps):
        return ((inp_c[0][pos : pos + steps + 1], inp_c[1][pos : pos + steps + 1]),
                (gt_c[0][pos : pos + steps], gt_c[1][pos : pos + steps]))

    m = BMCNetPlain(scale=SCALE, n_c=128, n_b=5)
    m.load_state_dict(load_checkpoint(os.path.join(ROOT, "tests", "goldens",
                                                   "plain_nfs_x4_ckpt.npz")))
    eng = InferenceEngine(m, DatasetConfig(scale=SCALE), chunk_size=CHUNK, visualize=False,
                          device=dev)
    ref = eng.infer_windows(load_chunk, n, LR, GT, return_per_window=True)["per_window"]
    pool = StreamPool(eng.model, None, LR, slots=SERVE_SLOTS, window_size=N_LR, device=dev)
    lane = pool.attach()
    zero_counts(mods)
    preds = [pool.push({lane: w}).get(lane) for w in inp]
    for k, v in counts(mods).items():
        totals[k] += v
    gxy, gp = torch.from_numpy(gt_c[0][:, 0]).to(dev), torch.from_numpy(gt_c[1][:, 0]).to(dev)
    gt_img = rasterize.counts_plain(gxy[:, 0], gxy[:, 1], gp, GT).cpu().numpy()
    mse = np.asarray([np.mean((p - g) ** 2, dtype=np.float64) for p, g in zip(preds[1:], gt_img)])
    rel = float(np.abs(mse / ref["esr_mse"] - 1).max())
    check(preds[0] is None and rel <= 1e-4,
          f"released checkpoint through the pool: esr_mse rel |d| {rel} against the engine")
    print(f"serve released plain checkpoint: one lane of an 8-slot float32 pool over {n} window "
          f"pairs, per-window esr_mse against InferenceEngine.infer_windows max rel |d| "
          f"{rel:.2e} (rtol 1e-4)")


def run_clients(address, streams: dict, errors: list):
    """One blocking ``EventSRClient`` thread per stream, each attaching a
    slot and pushing its windows; returns ``({name: (slot, replies)},
    wall s)``.  Any client error or a thread still alive fails the run."""
    import threading

    from bmcnet_esr_torch.inference import EventSRClient

    out = {}

    def run(name, wins):
        try:
            c = EventSRClient(*address)
            c._sock.settimeout(120.0)
            slot = c.attach()
            out[name] = (slot, [c.push(w) for w in wins])
            c.detach()
            c.close()
        except Exception as exc:  # noqa: BLE001 — relayed into the check below
            errors.append((name, repr(exc)))

    threads = [threading.Thread(target=run, args=kv, daemon=True) for kv in streams.items()]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in threads), f"serve clients: {errors}")
    return out, wall


def replay(pool, streams, reload=None) -> dict:
    """The reference for a daemon run: the same windows pushed through a
    pool of the same width, every stream in its daemon slot (re-attached
    there, so its first window starts it), shallow ticks of every stream's
    next window; ``reload=(j, state)`` swaps the weights before window j.
    Returns ``{slot: [decoded prediction or None, ...]}``."""
    from bmcnet_esr_torch.inference import assemble_fetch, wire_decode

    for _ in range(pool.free_slots):
        pool.attach()
    for slot, _ in streams:
        pool.detach(slot)
        check(pool.attach() == slot, "replay: slot order")
    out = {slot: [] for slot, _ in streams}
    for j in range(max(len(w) for _, w in streams)):
        if reload is not None and j == reload[0]:
            pool.reload(reload[1])
        ticked = {slot: w[j] for slot, w in streams if j < len(w)}
        out_slots, preds = pool.push_async(ticked)
        host = wire_decode(assemble_fetch(preds.get()), pool.out_wire)
        for slot in ticked:
            out[slot].append(host[slot] if slot in out_slots else None)
    return out


def same_replies(got, want, what: str) -> int:
    import numpy as np

    check(len(got) == len(want), f"{what}: {len(got)} replies, {len(want)} pushes")
    for i, (g, w) in enumerate(zip(got, want)):
        check((g is None) == (w is None), f"{what}: reply {i} PENDING mismatch")
        if w is not None:
            check(np.array_equal(g, w), f"{what}: reply {i} differs from the pool's, max |d| "
                                        f"{float(np.abs(g - w).max())}")
    return len(got)


def time_deep_tick(pool, slots, rng) -> dict:
    """Wall ms per window (host clock to the last fetched result) of one
    deep tick of depth ``SERVE_K`` against ``SERVE_K`` shallow ticks
    dispatched back to back, every slot pushing, in turns (shallow, deep,
    deep, shallow, ...), medians of four each."""
    wins = {s: serve_windows(rng, SERVE_K) for s in slots}

    def shallow():
        fetches = [pool.push_async({s: w[j] for s, w in wins.items()})[1]
                   for j in range(SERVE_K)]
        for f in fetches:
            f.get()

    def deep():
        pool.push_async_deep(wins, SERVE_K)[1].get()

    shallow(), deep()
    runs = {"shallow": [], "deep": []}
    for order in (("shallow", "deep"), ("deep", "shallow")) * 2:
        for kind in order:
            t0 = time.perf_counter()
            (shallow if kind == "shallow" else deep)()
            runs[kind].append((time.perf_counter() - t0) * 1e3 / SERVE_K)
    return {k: sorted(v)[len(v) // 2] for k, v in runs.items()}


def serve_daemon(dev, mods, totals: dict, card: str) -> dict:
    """``EventSRServer`` on 127.0.0.1 with ``prewarm()``, ``scan_k=8`` and
    the CLI's defaults (float16 wire, 4 fetch chunks), in bfloat16 and
    int8_pall: 1 client and then 8 client threads of 64 windows each, timed;
    on the 1-lane daemon also a pipelining client (``push_nowait``, deep
    ticks) with a RELOAD after its 16th window.  Every PRED must equal what
    a pool of the same width returns for the same pushes; each int8 kernel's
    launches per forward and the rasterizer's per tick are checked."""
    import numpy as np

    from bmcnet_esr_torch.inference import EventSRClient, EventSRServer, StreamPool

    rng = np.random.default_rng(24)
    stats = {}
    for dtype in ("bfloat16", "int8_pall"):
        model = serve_model(dtype, dev)
        v1 = host_state(model)
        v2 = host_state(serve_model(dtype, dev, seed=1, calib_seed=10))
        for lanes in (1, 8):
            name = f"{dtype} {lanes} lane{'s' if lanes > 1 else ''}"
            server = EventSRServer(model, v1, LR, slots=SERVE_SLOTS, window_size=N_LR,
                                   batch_window_ms=2.0, weight_loader=lambda: v2,
                                   scan_k=SERVE_K, wire_dtype="float16", fetch_chunks=4,
                                   device=dev)
            server.prewarm()
            depths, tick = [], server.pool._tick

            def recording(xy, *args, **kw):
                depths.append(xy.shape[0])
                return tick(xy, *args, **kw)

            server.pool._tick = recording
            server.start()
            errors = []
            try:
                zero_counts(mods)
                streams = {f"c{i}": serve_windows(rng, SERVE_CLIENT_WINDOWS) for i in range(lanes)}
                ticks0 = server.ticks
                runs, wall = run_clients(server.address, streams, errors)
                st = server.stats()
                n_ticks = server.ticks - ticks0
                timed_depths = list(depths)
                pipelined = None
                if lanes == 1:
                    wins = serve_windows(rng, 48)
                    c = EventSRClient(*server.address)
                    c._sock.settimeout(120.0)
                    slot = c.attach()
                    replies = [c.push(w) for w in wins[:16]]
                    check(c.reload() == 2, "RELOAD did not bump the weights version")
                    k0 = len(depths)
                    for w in wins[16:]:
                        c.push_nowait(w)
                    replies += [c.read_reply() for _ in wins[16:]]
                    c.detach()
                    c.close()
                    pipelined = (slot, wins, replies, depths[k0:])
            finally:
                server.shutdown()
            check(server._thread is None, f"serve {name}: the daemon thread did not stop")
            got_l = counts(mods)
            for k, v in got_l.items():
                totals[k] += v
            forwards = sum(depths)
            want_l = expected_launches("full", dtype, forwards, 0)
            check(got_l["rasterize_counts"] == len(depths),
                  f"serve {name}: {got_l['rasterize_counts']} rasterizer launches, {len(depths)} ticks")
            for k, v in want_l.items():
                check(got_l[k] == v, f"serve {name}: {got_l[k]} {k} launches for {forwards} "
                                     f"forwards, the model gives {v}")
            # the reference: a pool of the same width, shallow ticks
            ref = StreamPool(model, v1, LR, slots=SERVE_SLOTS, window_size=N_LR, device=dev,
                             out_wire="f16", fetch_chunks=4)
            want = replay(ref, [(runs[n][0], streams[n]) for n in streams])
            n_eq = sum(same_replies(runs[n][1], want[runs[n][0]], f"serve {name} client {n}")
                       for n in streams)
            windows = sum(len(w) for w in streams.values())
            row = {"wall_s": wall, "ticks": n_ticks, "windows": windows,
                   "ticks_per_s": n_ticks / wall, "windows_per_s": windows / wall,
                   "p50_ms": st["latency_ms_p50"], "p99_ms": st["latency_ms_p99"],
                   "occupancy": st["batch_occupancy_mean"],
                   "depths": sorted(set(timed_depths))}
            print(f"serve daemon {name}: {windows} windows from {lanes} client thread(s) in "
                  f"{wall:.3f} s: {row['ticks_per_s']:.2f} ticks/s, {row['windows_per_s']:.2f} "
                  f"windows/s, latency p50 {row['p50_ms']} ms p99 {row['p99_ms']} ms, mean "
                  f"windows a tick {row['occupancy']}, tick depths {row['depths']}; {n_eq} "
                  f"replies equal the pool's; on {card}")
            if pipelined is not None:
                slot, wins, replies, pdepths = pipelined
                ref = StreamPool(model, v1, LR, slots=SERVE_SLOTS, window_size=N_LR, device=dev,
                                 out_wire="f16", fetch_chunks=4)
                want = replay(ref, [(slot, wins)], reload=(16, v2))
                same_replies(replies, want[slot], f"serve {name} pipelined client")
                check(max(pdepths) > 1, f"serve {name}: no deep tick ran ({pdepths})")
                print(f"serve daemon {name}: pipelining client, 16 blocking pushes, RELOAD "
                      f"(weights version 2), 32 push_nowait: tick depths {pdepths}; 48 replies "
                      f"equal a pool's that reloads at the same window")
            # one profiled tick of the reference pool at this width
            ref = StreamPool(model, v1, LR, slots=SERVE_SLOTS, window_size=N_LR, device=dev,
                             out_wire="f16", fetch_chunks=4)
            slots = [ref.attach() for _ in range(lanes)]
            tick_wins = {s: w for s, w in zip(slots, serve_windows(rng, lanes))}
            ref.push(tick_wins)
            zero_counts(mods)
            row["profile"] = _profiled(lambda: [ref.push(tick_wins) for _ in range(4)], 4,
                                       f"serve tick {name}", "tick")
            row["launches_per_tick"] = {k: v / 4 for k, v in counts(mods).items()}
            if lanes == SERVE_SLOTS:
                row["deep_ms"] = time_deep_tick(ref, slots, rng)
            stats[name] = row
            del ref, server
    return stats


def phase_serve(dev, card: str) -> dict:
    """The serving path at full width: parity of pool lanes with solo
    streams, the deep tick against shallow ticks, the released checkpoint
    through the pool against the engine, then the daemon on loopback, timed.
    Returns each kernel's launches on this path."""
    import importlib

    mods = {n: importlib.import_module(f"bmcnet_esr_torch.kernels.{n}") for n in KERNEL_MODULES}
    totals = {KERNEL_NAMES[n]: 0 for n in KERNEL_MODULES}
    t0 = time.perf_counter()
    profiles = serve_parity(dev, mods, totals)
    serve_deep(dev, mods, totals)
    serve_released(dev, mods, totals)
    stats = serve_daemon(dev, mods, totals, card)
    check(all(v > 0 for v in totals.values()), f"a kernel never launched on the serving path: {totals}")
    for dtype, p in profiles.items():
        print(f"serve kernels per 8-lane tick {dtype}: "
              + ", ".join(f"{k} {ms:.5f} ms x{n:.0f}" for k, (ms, n) in p["kernels"].items()))
    for name, row in stats.items():
        if "deep_ms" in row:
            d = row["deep_ms"]
            print(f"serve deep tick {name}: a tick of depth {SERVE_K} {d['deep']:.3f} ms a window, "
                  f"{SERVE_K} shallow ticks back to back {d['shallow']:.3f} ms a window "
                  f"({d['shallow'] / d['deep']:.2f}x)")
        p = row["profile"]
        print(f"serve summary {name}: {row['ticks_per_s']:.2f} ticks/s, {row['windows_per_s']:.2f} "
              f"windows/s, p50 {row['p50_ms']} ms, p99 {row['p99_ms']} ms; profiled tick wall "
              f"{p['wall_ms']:.3f} ms, device busy {p['busy_ms']:.3f} ms, idle {p['idle']:.1%}, "
              f"{p['launches']:.0f} launches; kernel launches a tick {row['launches_per_tick']}; "
              "kernels per tick: " + ", ".join(f"{k} {ms:.5f} ms x{n:.0f}"
                                              for k, (ms, n) in p["kernels"].items()))
    print(f"serve phase: {time.perf_counter() - t0:.1f} s, kernel launches on the serving path "
          f"{totals}")
    return totals


EXPORT_WINDOWS, EXPORT_LANES, EXPORT_LANE_WINDOWS = 16, 8, 6
# the tick of the int8_pall pool: operator calls per forward (3x3 convs and
# 1x1 convs of the full model, site_counts) and the one rasterizer call
TICK_OP_CALLS = sum(site_counts("full")[:2]) + 1


def host_us(fn, args, n: int = 2000) -> float:
    """Host microseconds per call of ``fn(*args)``, ``n`` calls back to back
    after a warm-up, the card synchronized before and after.  At the tiny
    shapes given here each call's kernel takes a few microseconds, less than
    the host spends on the call, so this is the host's cost."""
    import torch

    for _ in range(50):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def dispatch_cost(dev) -> dict:
    """Host cost per call of each operator, ``torch.ops.bmcnet.X``, against a
    direct call of the CUDA implementation it registers, and against the
    same implementation registered with ``torch.library.custom_op`` (the
    registration that the port does not use), at tiny shapes, under
    inference mode as the serving paths run; medians of three repeats in
    turns.  Returns ``{op: {"op_us", "direct_us", "custom_op_us"}}``."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.kernels import qconv, qmm, quantize, rasterize
    from bmcnet_esr_torch.ops.batch import compact_events

    rng = np.random.default_rng(5)
    ev = random_windows(rng, 1, 64, (4, 8))
    xy, p = (torch.from_numpy(a).to(dev) for a in compact_events(ev))
    x = torch.from_numpy(rng.normal(0, 1, (1, 4, 8, 32)).astype(np.float32)).to(dev).bfloat16()
    sx = torch.full((1,), 0.02, device=dev)
    wq3, sw3 = qconv.quantize_weights3x3(torch.from_numpy(
        rng.normal(0, 0.1, (3, 3, 32, 32)).astype(np.float32)).to(dev))
    wq1, sw1 = qmm.quantize_weights(torch.from_numpy(
        rng.normal(0, 0.1, (32, 32)).astype(np.float32)).to(dev))
    bias = torch.zeros(32, device=dev)
    ops = torch.ops.bmcnet
    cases = {
        "rasterize_counts_compact": (ops.rasterize_counts_compact.default,
                                     rasterize._compact_cuda, (xy, p, 4, 8)),
        "rasterize_counts_f32": (ops.rasterize_counts_f32.default, rasterize._events_cuda,
                                 (torch.from_numpy(ev).to(dev), 4, 8)),
        "quantize_act": (ops.quantize_act.default, quantize._quantize_cuda, (x, sx, False)),
        "quant_matmul": (ops.quant_matmul.default, qmm._qmm_cuda,
                         (x.view(1, 32, 32), wq1, sw1, sx, bias, torch.bfloat16,
                          qmm.pack_weights(wq1))),
        "quant_conv3x3": (ops.quant_conv3x3.default, qconv._qconv_cuda,
                          (x, wq3, sw3, sx, bias, torch.bfloat16, None, False,
                           qconv.pack_weights3x3(wq3))),
    }
    out = {}
    with torch.inference_mode():
        for name, (op, impl, args) in cases.items():
            schema = "(" + str(op._schema).split("(", 1)[1]
            twin = torch.library.custom_op(f"bmcnet_probe::{name}", impl, mutates_args=(),
                                           schema=schema)
            check(torch.equal(op(*args), twin(*args)), f"dispatch {name}: the twin differs")
            runs = {"op_us": [], "direct_us": [], "custom_op_us": []}
            for order in ((op, impl, twin), (twin, impl, op), (op, impl, twin)):
                for fn in order:
                    key = "op_us" if fn is op else "direct_us" if fn is impl else "custom_op_us"
                    runs[key].append(host_us(fn, args))
            out[name] = {k: sorted(v)[1] for k, v in runs.items()}
    return out


def consumer_process(path: str, wins, wants, tmp: str) -> None:
    """The float32 bundle served in a fresh process that imports no model
    code and starts with TF32 on: ``ExportedStream`` sets the float32 policy
    itself, so its predictions equal ``StreamingSR``'s (``wants``, from the
    second window) bit for bit."""
    import numpy as np

    np.save(os.path.join(tmp, "consumer_windows.npy"), np.stack(wins))
    out = os.path.join(tmp, "consumer_preds.npy")
    code = (
        "import sys, numpy as np, torch\n"
        "torch.backends.cudnn.allow_tf32 = True\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "from bmcnet_esr_torch.inference.export import ExportedStream\n"
        f"s = ExportedStream({path!r}, device='cuda')\n"
        "tf32 = torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32\n"
        f"preds = [s.push(w) for w in np.load({os.path.join(tmp, 'consumer_windows.npy')!r})]\n"
        f"np.save({out!r}, np.stack([p[0] for p in preds[1:]]))\n"
        "models = sorted(m for m in sys.modules if m.startswith('bmcnet_esr_torch.models')\n"
        "                or m.split('.')[0] in ('jax', 'bmcnet_esr_tpu'))\n"
        "print('TF32', tf32, 'MODELS', models)\n"
    )
    t = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    check(run.returncode == 0, f"export consumer process failed: {run.stderr[-2000:]}")
    check("TF32 False MODELS []" in run.stdout, f"export consumer process: {run.stdout}")
    got = np.load(out)
    check(np.array_equal(got, np.stack(wants)),
          f"export float32 in a fresh process with TF32 on differs from StreamingSR: max |d| "
          f"{np.abs(got - np.stack(wants)).max():.3e}")
    print(f"export float32 consumer process: a fresh process that imports no model code, TF32 "
          f"on at its start, serves the bundle bit-exact against StreamingSR over {len(wants)} "
          f"predictions ({time.perf_counter() - t:.1f} s)")


def phase_export(dev, card: str) -> dict:
    """Serving bundles of the full model (n_c=128, n_b=5, x4, 45x80, windows
    of 2048 events): a float32 and an int8_pall (static scales) bundle
    exported and loaded in this process, each equal to ``StreamingSR`` bit
    for bit over 16 windows, launches counted per push; an int8_pall batch-8
    bundle's lanes against the batch-1 bundle on each stream; ms/window of
    the bundle against ``StreamingSR``; the operators' dispatch cost.
    Returns each kernel's launches made by the bundles."""
    import importlib

    import numpy as np
    import torch

    from bmcnet_esr_torch.inference import ExportedStream, StreamingSR, export_serving_bundle

    mods = {n: importlib.import_module(f"bmcnet_esr_torch.kernels.{n}") for n in KERNEL_MODULES}
    totals = {KERNEL_NAMES[n]: 0 for n in KERNEL_MODULES}
    t0 = time.perf_counter()
    rng = np.random.default_rng(24)
    wins = serve_windows(rng, EXPORT_WINDOWS)
    served = {}
    with tempfile.TemporaryDirectory(prefix="bundles-") as tmp:
        for dtype in ("float32", "int8_pall"):
            model = serve_model(dtype, dev)
            t = time.perf_counter()
            path = export_serving_bundle(model, None, os.path.join(tmp, dtype), LR, N_LR,
                                         device=dev)
            t_export = time.perf_counter() - t
            t = time.perf_counter()
            bundle = ExportedStream(path, device=dev)
            t_load = time.perf_counter() - t
            live = StreamingSR(model, None, LR, N_LR, device=dev)
            per_push = {"rasterize_counts": 1, **expected_launches("full", dtype, 1, 0)}
            wants = []
            for i, ev in enumerate(wins):
                want = live.push(ev)
                wants.append(want)
                zero_counts(mods)
                got = bundle.push(ev)
                pushed = counts(mods)
                for k, v in pushed.items():
                    totals[k] += v
                check(pushed == per_push, f"export {dtype}: push {i} launched {pushed}, the model "
                                          f"gives {per_push}")
                if want is None:
                    check(got is None, f"export {dtype}: the first window gave a prediction")
                    continue
                check(got.shape == (1, *GT, 2) and np.array_equal(got[0], want),
                      f"export {dtype}: window {i} differs from StreamingSR")
            same = all(torch.equal(a, b) for a, b in zip(bundle._carry, live._carry))
            check(same and torch.equal(bundle._prev_frame, live._prev_frame),
                  f"export {dtype}: the carry differs from StreamingSR's")
            if dtype == "float32":
                consumer_process(path, wins, wants[1:], tmp)
            size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
            print(f"export {dtype}: bundle of {size / 2**20:.1f} MiB exported in {t_export:.1f} s, "
                  f"loaded in {t_load:.1f} s; {EXPORT_WINDOWS} windows bit-exact against "
                  f"StreamingSR, carry included; launches a push {per_push}")
            # ms/window in turns (live, bundle, bundle, live), the first window
            # of each stream outside the clock
            walls = {"live": [], "bundle": []}
            for who in ("live", "bundle", "bundle", "live"):
                stream = live if who == "live" else bundle
                stream.reset()
                stream.push(wins[0])
                t = time.perf_counter()
                for ev in wins[1:]:
                    stream.push(ev)
                walls[who].append((time.perf_counter() - t) * 1e3 / (EXPORT_WINDOWS - 1))

            def rollout(stream):
                for ev in wins[1:5]:
                    stream.push(ev)

            prof = {}
            for who, stream in (("StreamingSR", live), ("ExportedStream", bundle)):
                stream.reset()
                stream.push(wins[0])  # the first window runs no forward in StreamingSR
                prof[who] = _profiled(lambda: rollout(stream), 4, f"export {dtype} {who}",
                                      "window")
            print(f"export timing {dtype}: ExportedStream {min(walls['bundle']):.3f} / "
                  f"{max(walls['bundle']):.3f} ms/window, StreamingSR {min(walls['live']):.3f} / "
                  f"{max(walls['live']):.3f} ms/window (two runs each, in turns); profiled: "
                  + "; ".join(f"{who} wall {p['wall_ms']:.3f}, device busy {p['busy_ms']:.3f} "
                              f"ms/window, {p['launches']:.0f} launches/window"
                              for who, p in prof.items()) + f" on {card}")
            served[dtype] = bundle
            del live, model

        # lanes of a batch-8 int8_pall bundle against the batch-1 bundle
        model = serve_model("int8_pall", dev)
        b8 = ExportedStream(export_serving_bundle(model, None, os.path.join(tmp, "int8_pall_b8"),
                                                  LR, N_LR, batch=EXPORT_LANES, device=dev),
                            device=dev)
        streams = [serve_windows(rng, EXPORT_LANE_WINDOWS) for _ in range(EXPORT_LANES)]
        batched = []
        for j in range(EXPORT_LANE_WINDOWS):
            zero_counts(mods)
            batched.append(b8.push(np.stack([s[j] for s in streams])))
            pushed = counts(mods)
            for k, v in pushed.items():
                totals[k] += v
            check(pushed == {"rasterize_counts": 1, **expected_launches("full", "int8_pall", 1, 0)},
                  f"export int8_pall batch {EXPORT_LANES}: push {j} launched {pushed}")
        b1, worst = served["int8_pall"], (0.0, 0.0)
        for lane, ws in enumerate(streams):
            b1.reset()
            solo = [b1.push(w) for w in ws]
            d = lane_errors([b[lane] for b in batched[1:]], [s[0] for s in solo[1:]])
            worst = max(worst[0], d[0]), max(worst[1], d[1])
        check(worst[1] <= SERVE_BOUND, f"export int8_pall batch {EXPORT_LANES}: lane rel-RMSE "
                                       f"{worst[1]} against the batch-1 bundle")
        print(f"export int8_pall batch {EXPORT_LANES}: each lane over {EXPORT_LANE_WINDOWS} "
              f"windows against the batch-1 bundle on its stream: max|d|/max|x| {worst[0]:.3e}, "
              f"rel-RMSE {worst[1]:.3e} (bound {SERVE_BOUND})")
        del b8, model, served

    cost = dispatch_cost(dev)
    for name, c in cost.items():
        print(f"export dispatch {name}: torch.ops.bmcnet {c['op_us']:.2f} us a call, the CUDA "
              f"implementation called directly {c['direct_us']:.2f} us, as a custom_op "
              f"{c['custom_op_us']:.2f} us: the operator adds {c['op_us'] - c['direct_us']:.2f} "
              f"us (custom_op would add {c['custom_op_us'] - c['direct_us']:.2f})")
    per_call = {k: cost[k]["op_us"] - cost[k]["direct_us"] for k in cost}
    n3, n1, _ = site_counts("full")
    tick = (n3 * per_call["quant_conv3x3"] + n1 * per_call["quant_matmul"]
            + per_call["rasterize_counts_compact"]) / 1e3
    print(f"export dispatch per int8_pall tick ({TICK_OP_CALLS} operator calls: {n3} "
          f"quant_conv3x3, {n1} quant_matmul, 1 rasterizer): {tick:.3f} ms on {card}")
    print(f"export phase: {time.perf_counter() - t0:.1f} s, kernel launches of the bundles {totals}")
    return totals


# The losses phase: configs/train_RGB_percep.yml's shapes.  The sensor is
# 720x760; down4 inputs are 180x190 and the x4 GT 720x760; an input window
# holds 16384 events and its GT window scale**2 times as many.
RGB_LR, RGB_GT, RGB_N = (180, 190), (720, 760), 16384
RGB_B, RGB_L = 2, 9  # the recipe's batch 2 (two micro-batches of 1), sequence_length 9
PERCEP_ITERS = 3  # iteration 0 warms up; a second Trainer resumes after 1 and repeats 2
LOSS_VALUE_RTOL, LOSS_GRAD_RTOL = 1e-5, 1e-4  # the card's float32 against the CPU's float64
# the card's float64 against the CPU's float64, where float32 cannot be
# held to float64 (TERM_CASES)
LOSS64_VALUE_RTOL, LOSS64_GRAD_RTOL = 1e-9, 1e-7
# where float32 is ill-conditioned (TERM_CASES), the card's float32 distance
# from the CPU's float64 is held to this many times the CPU float32's own
# distance, measured in the run (or to the strict bounds, if larger)
TERM_F32_FACTOR = 3.0
RAW_FLOW_SCALE = 0.01  # the raw case's flow: the LR-pooled prediction times this


def percep_recipe() -> dict:
    """``configs/train_RGB_percep.yml`` as ``yaml.safe_load`` reads it: the
    NFS recipe (:func:`nfs_recipe`) at the RGB windows, with the ``loss:``
    block, remat and ``grad_accum: 2``; ``tests/test_torch_losses.py`` holds
    the two equal."""
    cfg = nfs_recipe()
    cfg.update(experiment="BMCNet_rgb_percep", ORI_SCALE="down4", WINDOW=16384,
               SLIDING_WINDOW=8192, PATH_TO_TRAIN="datalist/train_rgb.txt",
               PATH_TO_VALID="datalist/valid_rgb.txt")
    cfg["model"]["name"] = "BMCNet_syn_4x_percep"
    cfg["loss"] = {"recon": {"weight": 0.5, "norm": "l1"},
                   "lpips": {"weight": 1.0, "weights": "weights/lpips_alex.npz"},
                   "temporal_consistency": {"weight": 0.1}}
    cfg["trainer"].update(remat=True, grad_accum=2)
    for split in ("train", "valid"):
        block = cfg[f"{split}_dataloader"]
        block["path_to_datalist_txt"] = f"datalist/{split}_rgb.txt"
        block["dataset"].update(ori_scale="down4", window=16384, sliding_window=8192)
    return cfg


def lpips_bundle(path: str) -> str:
    """An LPIPS alex v0.1 bundle written by the port's ``LPIPS.to_npz``: the
    seeded torchvision-layout backbone of ``tools/lpips_fixture_nets.py`` and
    seeded non-negative heads (the released weights are not in the repo)."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import lpips_fixture_nets as nets

    from bmcnet_esr_torch.losses.lpips import LPIPS, convert_backbone_state_dict

    state = {k: v.numpy() for k, v in nets.make_alex_features().state_dict().items()}
    rng = np.random.default_rng(11)
    lins = [rng.random((1, c)).astype(np.float32) * 0.1 for c in (64, 192, 384, 256, 256)]
    return LPIPS(convert_backbone_state_dict(state, "alex"), lins, "alex").to_npz(path)


def pooled_event_warping(cfg, ctx):
    """``event_warping`` fed the prediction mean-pooled to the LR grid (times
    ``RAW_FLOW_SCALE``) as its flow: a ``needs_events`` term for the BMCNet
    recipes, attached through ``fn: chip_smoke:pooled_event_warping``."""
    from bmcnet_esr_torch.training.losses import REGISTRY

    warp = REGISTRY["event_warping"]({"flow_key": "flow", **cfg}, ctx)

    def fn(pred, gt, aux):
        b, kh, kw, c = aux["pred"].shape
        h, w = ctx.inp_resolution
        flow = aux["pred"].reshape(b, h, kh // h, w, kw // w, c).mean(dim=(2, 4))
        return warp(pred, gt, dict(aux, flow=flow * RAW_FLOW_SCALE))

    fn.needs_events = fn.batch_sum = True
    return fn


def rgb_batches(rng, n: int) -> list:
    """``n`` compact batches at the RGB recipe's shapes."""
    from bmcnet_esr_torch.ops.batch import compact_events

    out = []
    for _ in range(n):
        batch = {}
        for prefix, n_ev, hw in (("inp", RGB_N, RGB_LR), ("gt", SCALE**2 * RGB_N, RGB_GT)):
            ev = random_windows(rng, RGB_B * RGB_L, n_ev, hw, pad=n_ev // 32)
            batch[f"{prefix}_xy"], batch[f"{prefix}_p"] = compact_events(
                ev.reshape(RGB_B, RGB_L, 4, n_ev))
        out.append(batch)
    return out


def raw_batches(rng, n: int) -> list:
    """``n`` raw float32 batches at the NFS recipe's shapes, with the input
    windows' valid counts (``inp_len``).  The input events lie on the sensor,
    as a dataset's do: the event terms read each one's source pixel (one
    off the sensor reads a NaN flow, as in the JAX package)."""
    import numpy as np

    out = []
    for _ in range(n):
        batch = {}
        for prefix, n_ev, hw in (("inp", N_LR, LR), ("gt", SCALE**2 * N_LR, GT)):
            pad = n_ev // 32
            ev = random_windows(rng, TRAIN_B * TRAIN_L, n_ev, hw, pad=pad)
            if prefix == "inp":
                ev[:, 0] = np.clip(ev[:, 0], 0, hw[1] - 1)
                ev[:, 1] = np.clip(ev[:, 1], 0, hw[0] - 1)
            batch[f"{prefix}_events"] = ev.reshape(TRAIN_B, TRAIN_L, 4, n_ev)
            batch[f"{prefix}_len"] = np.full((TRAIN_B, TRAIN_L), n_ev - pad, np.int32)
        out.append(batch)
    return out


def loss_goldens(dev) -> None:
    """``tests/goldens/loss_goldens.npz`` and the plain / resnet entries of
    ``lpips_goldens.npz`` reproduced on the card at the CPU tests' bounds."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.losses import flow, lpips, reconstruction

    with np.load(os.path.join(ROOT, "tests", "goldens", "loss_goldens.npz")) as z:
        g = {k: z[k] for k in z.files}
    res = tuple(int(v) for v in g["res"])
    t = {k: torch.from_numpy(v).to(dev) for k, v in g.items() if v.dtype == np.float32}
    fl, ev, pm = t["flow"], t["event_list"], t["pol_mask"]
    got = {
        "ew_loss": float(flow.event_warping_loss([fl], ev, pm, res, 0.01)),
        "gm": float(reconstruction.generative_model_loss(fl, t["img"], t["cnt"], ev, pm, res)),
        "tc": float(reconstruction.temporal_consistency_loss(fl, t["prev_img"], t["img"], res,
                                                             0.2)),
        "tv": float(reconstruction.total_variation_loss(t["img"], 0.1)),
    }
    rels = {k: abs(v / float(g[k]) - 1) for k, v in got.items()}
    bounds = {"ew_loss": 1e-4, "gm": 1e-3, "tc": 1e-4, "tv": 1e-5}
    aiwe = float(np.abs(flow.averaged_iwe(fl, ev, pm, res).cpu().numpy() - g["aiwe"]).max())
    check(all(rels[k] <= bounds[k] for k in bounds) and aiwe <= 1e-4,
          f"loss goldens on the card: rel {rels} (bounds {bounds}), averaged IWE |d| {aiwe}")

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import lpips_fixture_nets as nets

    with np.load(os.path.join(ROOT, "tests", "goldens", "lpips_goldens.npz")) as z:
        lg = {k: z[k] for k in z.files}
    worst = {}
    for net, build in (("alex", nets.make_alex_features), ("squeeze", nets.make_squeeze_features)):
        state = {k: v.numpy() for k, v in build().state_dict().items()}
        for spatial in (False, True):
            lp = lpips.LPIPS(lpips.convert_backbone_state_dict(state, net), None, net,
                             spatial=spatial, lpips=False).to(dev)
            a, b = (lg["in0_sq"], lg["in1_sq"]) if spatial else (lg["in0"], lg["in1"])
            with torch.no_grad():
                d = lp(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)).cpu().numpy()
            want = lg[f"{net}/plain/{'spatial' if spatial else 'scalar'}"]
            worst[f"{net}/plain/{spatial}"] = float(np.max(np.abs(d - want)
                                                           / (5e-5 + 1e-4 * np.abs(want))))
    for num in (18, 50):
        net = nets.make_resnet(num)
        params = lpips.convert_resnet_state_dict({k: v.numpy() for k, v in
                                                  net.state_dict().items()})
        with torch.no_grad():
            taps = lpips.resnet_features(params, torch.from_numpy(lg["in0"]).to(dev), num)
        wants = [lg[f"resnet{num}/tap{i}"] for i in range(len(taps))]
        worst[f"resnet{num}"] = max(
            float(np.max(np.abs(tap.cpu().numpy() - want) / (1e-4 + 1e-4 * np.abs(want))))
            for tap, want in zip(taps, wants))
    check(max(worst.values()) <= 1.0, f"LPIPS goldens on the card, share of the bound: {worst}")
    print("losses goldens: loss_goldens.npz rel "
          + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
          + f", averaged IWE max |d| {aiwe:.2e}; lpips_goldens.npz plain and resnet taps at "
          f"{max(worst.values()):.3f} of their bounds (worst {max(worst, key=worst.get)})")


def term_inputs(rng):
    """Seeded inputs of the terms at the RGB recipe's shapes: predictions
    and GT ``[2, 720, 760, 2]``, input windows ``[2, 2, 180, 190, 2]``, an
    HR and an LR flow, an LR image, raw windows of 16384 events (the second
    zero-padded after 12000, with ``events_len``)."""
    import numpy as np

    b = RGB_B
    ev = random_windows(rng, b, RGB_N, RGB_LR)
    ev[:, 0] = np.clip(ev[:, 0], 0, RGB_LR[1] - 1)  # event lists hold on-sensor pixels
    ev[:, 1] = np.clip(ev[:, 1], 0, RGB_LR[0] - 1)
    ev[1, :, 12000:] = 0.0
    return {
        "pred": rng.gamma(1.0, 1.0, (b, *RGB_GT, 2)).astype(np.float32),
        "gt": rng.poisson(1.0, (b, *RGB_GT, 2)).astype(np.float32),
        "prev_pred": rng.gamma(1.0, 1.0, (b, *RGB_GT, 2)).astype(np.float32),
        "inp": rng.poisson(1.0, (b, 2, *RGB_LR, 2)).astype(np.float32),
        "hrflow": (rng.standard_normal((b, *RGB_GT, 2)) * 0.002).astype(np.float32),
        "flow": (rng.standard_normal((b, *RGB_LR, 2)) * 0.005).astype(np.float32),
        "lrimg": rng.random((b, *RGB_LR, 2)).astype(np.float32),
        "events": ev,
        "events_len": np.asarray([RGB_N, 12000], np.int32),
    }


# (name, the term's spec, the inputs its gradient is taken of, how the card
# is held to the CPU).  "float64": the card's float32 value and gradients
# against the CPU's float64.  "piecewise": the value so; the gradients within
# TERM_F32_FACTOR times the CPU float32's distance from float64, and in
# float64 on both within LOSS64_GRAD_RTOL: they jump where a coordinate
# crosses a pixel edge, an L1 difference or a ReLU's input changes sign or a
# max-pool's maximum moves,
# and float32 round-off puts a few of a million points on the other side
# (a coordinate of hundreds of pixels moves by its spacing, 6e-5 at 760,
# with the order of rounding: the card divides by a scalar as a product
# with its reciprocal, the CPU divides; LPIPS's float32 gradient sits
# 1.5e-3 from float64 on the CPU alone at 256x256).  Brightness constancy's
# gradient jumps too, but at these inputs its float32 gradient sits 1.15e-05
# from float64 on an H100, so it is held to the float32 bound.  "ill":
# the event warping loss, whose float32 value is ill-conditioned too (its
# averaged timestamps divide by counts plus 1e-9,
# bmcnet_esr_torch/losses/flow.py): value and gradients as "piecewise"'s
# gradients.
TERM_CASES = [
    ("recon", {"norm": "l1"}, ("pred",), "float64"),
    ("lr_consistency", {"norm": "l2"}, ("pred",), "float64"),
    ("temporal_consistency", {}, ("pred",), "float64"),
    ("temporal_consistency", {"flow_key": "hrflow"}, ("pred", "hrflow"), "piecewise"),
    ("total_variation", {}, ("pred",), "float64"),
    ("ssim", {}, ("pred",), "float64"),
    ("lpips", {}, ("pred",), "piecewise"),
    ("event_warping", {"flow_key": "flow"}, ("flow",), "ill"),
    ("brightness_constancy", {"flow_key": "flow", "img_key": "lrimg"}, ("flow", "lrimg"),
     "float64"),
]


def term_inputs_on(dev, dtype, wrt=()):
    """:func:`term_inputs` on ``dev`` in ``dtype``, those named in ``wrt``
    asking for gradients; and the ``aux`` a term reads."""
    import numpy as np
    import torch

    x = term_inputs(np.random.default_rng(31))
    args = {k: torch.from_numpy(v).to(dev) for k, v in x.items()}
    for k, v in args.items():
        if v.is_floating_point():
            args[k] = v.to(dtype).requires_grad_(k in wrt)
    aux = {k: args[k] for k in ("pred", "prev_pred", "inp", "events", "events_len", "flow",
                                "hrflow", "lrimg")}
    return args, dict(aux, step=1)


def split_convolutions(dev, card: str) -> None:
    """The first split convolutions of (f) at a rank's shapes (64 of 128
    output channels, batch ``TRAIN_B`` on the NFS recipe's LR grid) on an
    input whose hidden channels are zero, as at the first step, weights
    laid out as the model's.  Through ``parallel.tensor.own_conv2d``, the
    channel-parallel forward's route, every output over an all-zero 3x3
    patch is exactly the bias (0) and the rest within rel 1e-5 of cuDNN's
    ``F.conv2d``; printed beside it, how many of cuDNN's outputs there are
    not zero (its FFT convolutions), and the device ms of forward and
    backward by either route: the cost of keeping cuDNN off them."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from bmcnet_esr_torch.parallel.tensor import own_conv2d

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    rng = np.random.default_rng(0)
    for cin, cout in ((131, 64), (150, 64), (128, 64)):
        x = np.zeros((TRAIN_B, cin, *LR), np.float32)
        x[:, :3] = rng.poisson(0.3, (TRAIN_B, 3, *LR))  # counts; the hidden state zero
        x = torch.from_numpy(x).to(dev).contiguous(memory_format=torch.channels_last)
        conv = torch.nn.Conv2d(cin, cout, 3, padding=1).to(dev, memory_format=torch.channels_last)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(
                rng.standard_normal((cout, cin, 3, 3)).astype(np.float32) * 0.02))
            conv.bias.zero_()
        w, b = conv.weight, conv.bias
        zero = F.max_pool2d(x.abs().sum(1, keepdim=True), 3, 1, 1) == 0
        own, cudnn = own_conv2d(x, w, b, padding=(1, 1)), F.conv2d(x, w, b, padding=1)
        off_own, off_cudnn = (int(((y != 0) & zero).sum()) for y in (own, cudnn))
        rel = float((own - cudnn).abs().max() / cudnn.abs().max())
        xg = x.clone().requires_grad_()
        gy = torch.randn(own.shape, device=dev)

        def both(route):
            def call():
                y = route(xg)
                torch.autograd.grad(y, (xg, w, b), gy)
            return call

        ms_own = device_ms(both(lambda t: own_conv2d(t, w, b, padding=(1, 1))), iters=10)
        ms_cudnn = device_ms(both(lambda t: F.conv2d(t, w, b, padding=1)), iters=10)
        print(f"split convolution {cin}->{cout} at {LR[0]}x{LR[1]}, batch {TRAIN_B}: outputs over "
              f"all-zero patches not zero: own kernels {off_own}, cuDNN {off_cudnn} of "
              f"{int(zero.sum()) * cout}; own against cuDNN max rel |d| {rel:.2e} (bound 1e-5); "
              f"forward + backward device {ms_own:.3f} ms own kernels, {ms_cudnn:.3f} ms cuDNN; "
              f"on {card}")
        check(off_own == 0, f"split convolution {cin}->{cout}: {off_own} outputs over all-zero "
              "patches not zero through own_conv2d")
        check(rel <= 1e-5, f"split convolution {cin}->{cout}: own kernels {rel:.2e} from cuDNN")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def time_terms(dev, card: str) -> dict:
    """Each term's device ms a call at the RGB recipe's shapes in float32,
    forward alone and forward + backward (run early: late in a long process
    the profiler drops the records of short loops).  Returns them by term."""
    import torch

    from bmcnet_esr_torch.losses.terms import LossContext
    from bmcnet_esr_torch.training.losses import REGISTRY

    ctx = LossContext(RGB_LR, RGB_GT, SCALE)
    out = {}
    with tempfile.TemporaryDirectory(prefix="lpips-") as tmp:
        bundle = lpips_bundle(os.path.join(tmp, "lpips_alex.npz"))
        for name, spec, wrt, _ in TERM_CASES:
            spec = dict(spec, weights=bundle) if name == "lpips" else dict(spec)
            fn = REGISTRY[name](spec, ctx)
            args, aux = term_inputs_on(dev, torch.float32, wrt)

            def call(backward=True):
                val = fn(args["pred"], args["gt"], aux)
                if backward:
                    val.backward()

            fwd = device_ms(lambda: call(False), iters=5, warmup=1, exact=False)
            both = device_ms(call, iters=5, warmup=1, exact=False)
            label = name + (" (flow_key)" if name == "temporal_consistency" and "flow_key" in spec
                            else "")
            out[label] = {"fwd_ms": fwd, "ms": both}
            print(f"losses term timing {label}: device {fwd:.3f} ms forward, {both:.3f} ms "
                  f"forward + backward a call in float32 at batch {RGB_B}, on {card}")
    return out


def term_checks(dev, bundle: str, card: str) -> None:
    """Each term and its gradients on the card against the same seeded call
    on the CPU, as ``TERM_CASES`` says: float32 against float64 (rel
    ``LOSS_VALUE_RTOL`` for the value, ``||d|| / ||g||`` within
    ``LOSS_GRAD_RTOL`` for each gradient), or float64 against float64
    (``LOSS64_*``)."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.losses.terms import LossContext
    from bmcnet_esr_torch.training.losses import REGISTRY

    ctx = LossContext(RGB_LR, RGB_GT, SCALE)
    for name, spec, wrt, mode in TERM_CASES:
        spec = dict(spec, weights=bundle) if name == "lpips" else dict(spec)
        fn = REGISTRY[name](spec, ctx)
        runs = {}

        def evaluate(device, dtype):
            key = (str(device), dtype)
            if key not in runs:
                args, aux = term_inputs_on(device, dtype, wrt)
                val = fn(args["pred"], args["gt"], aux)
                val.backward()
                runs[key] = (float(val.detach()),
                             [args[k].grad.detach().cpu().double().numpy() for k in wrt])
            return runs[key]

        def distance(device, dtype, cpu_dtype=torch.float64):
            (got, got_g), (ref, ref_g) = evaluate(device, dtype), evaluate("cpu", cpu_dtype)
            return abs(got / ref - 1), [float(np.linalg.norm(a - b) / np.linalg.norm(b))
                                        for a, b in zip(got_g, ref_g)]

        def grads(said_g):
            return ", ".join(f"d/d{k} {g:.2e}" for k, g in zip(wrt, said_g))

        f64, f32 = torch.float64, torch.float32
        label = name + (" (flow_key)" if name == "temporal_consistency" and "flow_key" in spec
                        else "")
        said = [f"value {evaluate(dev, f32)[0]:.9g} on the card in float32, "
                f"{evaluate('cpu', f64)[0]:.9g} on the CPU in float64"]
        # (card dtype, value bound, gradient bounds), each against the CPU in float64
        strict = (f32, LOSS_VALUE_RTOL, [LOSS_GRAD_RTOL] * len(wrt))
        if mode == "float64":
            held = [strict]
        else:  # the card's float32 within TERM_F32_FACTOR of the CPU float32's distance
            v32, g32 = distance("cpu", f32)
            said.append(f"CPU float32 against CPU float64: value rel {v32:.2e}, gradient "
                        f"||d||/||g|| {grads(g32)}")
            loose_v = max(LOSS_VALUE_RTOL, TERM_F32_FACTOR * v32)
            loose_g = [max(LOSS_GRAD_RTOL, TERM_F32_FACTOR * g) for g in g32]
            held = [(f32, LOSS_VALUE_RTOL if mode == "piecewise" else loose_v, loose_g),
                    (f64, LOSS64_VALUE_RTOL, [LOSS64_GRAD_RTOL] * len(wrt))]
        for card_dtype, vtol, gtol in held:
            rel, grel = distance(dev, card_dtype)
            said.append(f"card {str(card_dtype)[6:]} against CPU float64: value rel {rel:.2e} "
                        f"(bound {vtol:.2e}), gradient ||d||/||g|| {grads(grel)} (bounds "
                        + ", ".join(f"{t:.2e}" for t in gtol) + ")")
            check(rel <= vtol, f"term {label}: value rel {rel} (card {card_dtype})")
            check(all(g <= t for g, t in zip(grel, gtol)),
                  f"term {label}: gradient rel {grel} above {gtol} (card {card_dtype})")
        print(f"losses term {label}: " + "; ".join(said) + f"; on {card}")


def _per_term_losses(tr, batch, dev) -> dict:
    """Each extra term's mean over the steps of ``batch``'s first clip, with
    the trained model, without gradients."""
    import torch

    from bmcnet_esr_torch.ops.batch import counts_from_batch
    from bmcnet_esr_torch.training.train_step import _rollout_losses

    seen = {n: [] for n, _, _ in tr.extra_losses}

    def recording(name, fn):
        def wrapped(pred, gt, aux):
            val = fn(pred, gt, aux)
            seen[name].append(float(val))
            return val
        return wrapped

    terms = tuple((n, w, recording(n, fn)) for n, w, fn in tr.extra_losses)
    one = {k: torch.from_numpy(v[:1]).to(dev) for k, v in batch.items()}
    with torch.no_grad():
        _rollout_losses(tr.state.model, counts_from_batch(one, "inp", RGB_LR),
                        counts_from_batch(one, "gt", RGB_GT), 2, RGB_GT, False, terms)
    return {n: sum(v) / len(v) for n, v in seen.items()}


def percep_run(dev, mods, card: str, bundle: str, work: str, terms_ms: dict) -> int:
    """The RGB perceptual recipe at full width through ``Trainer``; a resume;
    timing and profile.  Returns the rasterizer's launches."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.training import Trainer
    from bmcnet_esr_torch.training.config import RunConfig

    def recipe(iterations):
        cfg = percep_recipe()
        cfg["loss"]["lpips"]["weights"] = bundle
        cfg["trainer"].update(output_path=work)
        cfg["trainer"]["iteration_based_train"].update(iterations=iterations, save_period=1,
                                                        valid_step=10**6)
        del cfg["valid_dataloader"]  # no validation here
        return cfg

    data = rgb_batches(np.random.default_rng(41), PERCEP_ITERS)
    loader = dict(res=(RGB_LR, RGB_GT))
    launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tr = Trainer(RunConfig(recipe(PERCEP_ITERS), runid="percep"),
                 train_loader=MemoryLoader(data, **loader), seed=0, device=dev)
    check([n for n, _, _ in tr.extra_losses] == ["recon", "lpips", "temporal_consistency"]
          and tr.grad_accum == 2 and tr.use_remat, "the percep recipe's trainer settings")
    events = []
    metrics = _recorded(tr, events)
    zero_counts(mods)
    t = time.perf_counter()
    tr.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(dev)
    got = counts(mods)
    per_iter = 2 * tr.grad_accum  # one input and one GT call a micro-step
    check(got["rasterize_counts"] == per_iter * PERCEP_ITERS and sum(got.values()) == got[
        "rasterize_counts"], f"percep recipe launches {got}, expected {per_iter} rasterizer "
                             f"launches an iteration")
    launches += got["rasterize_counts"]
    losses = [float(m["train_loss"]) for m in metrics]
    check(np.all(np.isfinite(losses)), f"percep recipe: non-finite loss {losses}")
    steps = [events[i - 1].elapsed_time(events[i]) for i in range(1, len(events))]
    want = {n: p.detach().clone() for n, p in tr.state.model.named_parameters()}
    term_losses = _per_term_losses(tr, data[0], dev)
    saved = os.path.join(tr.run.save_dir, "iteration_1")
    del tr
    torch.cuda.empty_cache()

    res = Trainer(RunConfig(recipe(PERCEP_ITERS), runid="percep_resumed"),
                  train_loader=MemoryLoader(data, start=2, **loader), seed=1, device=dev)
    resumed = _recorded(res)
    check(res.resume(saved) == 2, "the percep recipe resumed elsewhere than iteration 2")
    zero_counts(mods)
    res.train(start_iteration=2)
    launches += counts(mods)["rasterize_counts"]
    again = float(resumed[0]["train_loss"])
    same = all(torch.equal(p, want[n]) for n, p in res.state.model.named_parameters())
    print(f"losses percep resume: iteration 2 after resuming from iteration 1: loss {again!r}, "
          f"uninterrupted {losses[2]!r}; parameters after it bit-identical: {same}")
    check(again == losses[2] and same, "the resumed percep recipe does not repeat iteration 2 "
                                       "bit for bit")
    zero_counts(mods)
    p = profile_training(res, PERCEP_ITERS, 1, bands=per_iter)
    launches += counts(mods)["rasterize_counts"]
    check(p["band"] == per_iter, f"percep recipe: the profiler counted {p['band']} rasterizer "
                                 f"kernels an iteration, {per_iter} launched")
    del res
    torch.cuda.empty_cache()
    calls = RGB_L - 1  # steps a clip; two micro-batches of one clip make one batch of two
    args = percep_recipe()["model"]["args"]
    print(f"losses percep recipe (configs/train_RGB_percep.yml: {args['variant']} BMCNet n_c="
          f"{args['n_c']}, n_b={args['n_b']}, x{SCALE}, "
          f"{RGB_LR[0]}x{RGB_LR[1]} -> {RGB_GT[0]}x{RGB_GT[1]}, batch {RGB_B} as grad_accum 2, "
          f"remat on, float32) through Trainer: {PERCEP_ITERS} iterations in {wall:.1f} s, "
          f"ms/iteration {', '.join(f'{v:.1f}' for v in steps)} (after the first); profiled "
          f"{p['span_ms']:.1f} ms/iteration, device busy {p['busy_ms']:.1f} ms, idle share "
          f"{p['idle']:.1%}, {p['launches']:.0f} kernel launches an iteration "
          f"({p['band']:.0f} rasterizer, {per_iter} launched); peak memory {peak / 2**30:.2f} GiB; "
          f"losses {losses}; per-term loss on the first clip "
          + ", ".join(f"{k} {v:.6f}" for k, v in term_losses.items())
          + "; term device ms an iteration, estimated from the timing phase's isolated calls ("
          f"{calls} steps x (2 forwards with remat + 1 backward) at batch {RGB_B}): "
          + ", ".join(f"{k} {calls * (terms_ms[k]['fwd_ms'] + terms_ms[k]['ms']):.1f}"
                      for k in ("recon", "lpips", "temporal_consistency"))
          + f"; top kernels: {p['top']}; on {card}")
    return launches


def raw_run(dev, mods, card: str, work: str) -> int:
    """The raw-transfer case at the NFS recipe's shapes: ``compact_transfer:
    False`` and one ``needs_events`` term attached through ``fn:``; two
    iterations and a bit-identical resume.  Returns the raw rasterizer's
    launches."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.training import Trainer
    from bmcnet_esr_torch.training.config import RunConfig

    def recipe():
        cfg = _recipe(work, 3, 1, valid_step=10**6)
        cfg["loss"] = {"warp": {"fn": "chip_smoke:pooled_event_warping", "weight": 0.1}}
        del cfg["valid_dataloader"]  # no validation here
        return cfg

    data = raw_batches(np.random.default_rng(43), 3)
    loader = dict(compact=False)
    tr = Trainer(RunConfig(recipe(), runid="raw"), train_loader=MemoryLoader(data, **loader),
                 seed=0, device=dev)
    check("inp_len" in tr._step_keys, "the raw case ships no inp_len")
    metrics = _recorded(tr)
    zero_counts(mods)
    tr.train()
    got = counts(mods)
    check(got["rasterize_counts"] == 2 * 3 and sum(got.values()) == 6,
          f"raw case launches {got}, expected 2 raw rasterizer launches an iteration")
    launches = got["rasterize_counts"]
    losses = [float(m["train_loss"]) for m in metrics]
    want = {n: p.detach().clone() for n, p in tr.state.model.named_parameters()}
    saved = os.path.join(tr.run.save_dir, "iteration_1")
    del tr
    res = Trainer(RunConfig(recipe(), runid="raw_resumed"),
                  train_loader=MemoryLoader(data, start=2, **loader), seed=1, device=dev)
    resumed = _recorded(res)
    check(res.resume(saved) == 2, "the raw case resumed elsewhere than iteration 2")
    zero_counts(mods)
    res.train(start_iteration=2)
    launches += counts(mods)["rasterize_counts"]
    same = all(torch.equal(p, want[n]) for n, p in res.state.model.named_parameters())
    again = float(resumed[0]["train_loss"])
    check(np.all(np.isfinite(losses)), f"raw case: non-finite loss {losses}")
    check(again == losses[2] and same, f"the raw case's resume differs: {again!r} vs "
                                       f"{losses[2]!r}, parameters equal {same}")
    print(f"losses raw transfer (NFS recipe, compact_transfer False, event_warping on the "
          f"LR-pooled prediction through fn:): losses {losses}; iteration 2 resumed {again!r}, "
          f"parameters bit-identical {same}; raw float32 rasterizer launches {launches} "
          f"(2 an iteration); on {card}")
    return launches


def raw_bound_ms(g: int, n: int, h: int, w: int) -> float:
    """The raw form's byte bound: float32 (x, y, ts, p) events read once (16
    bytes an event), the float32 image written once."""
    return (g * n * 16 + g * h * w * 2 * 4) / HBM_BYTES_PER_S * 1e3


def time_raw_rasterizer(dev, card: str) -> dict:
    """The raw float32 rasterizer at the training shapes, which an event
    term puts on the training path: the NFS recipe's input and GT calls (18
    windows each), the RGB recipe's of one micro-batch (9 windows each),
    and one RGB input window with every event on one pixel; device ms
    against the byte bound and ``index_put_`` (in the timing phase)."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.kernels import rasterize
    from bmcnet_esr_torch.ops.batch import compact_events

    rng = np.random.default_rng(47)
    shapes = [("nfs_inp", TRAIN_B * TRAIN_L, N_LR, LR), ("nfs_gt", TRAIN_B * TRAIN_L,
                                                          SCALE**2 * N_LR, GT),
              ("rgb_inp", RGB_L, RGB_N, RGB_LR), ("rgb_gt", RGB_L, SCALE**2 * RGB_N, RGB_GT),
              ("rgb_hot_pixel", 1, RGB_N, RGB_LR)]
    out = {}
    for name, g, n, hw in shapes:
        ev = random_windows(rng, g, n, hw, pad=n // 32)
        if name.endswith("hot_pixel"):
            ev[:, 0], ev[:, 1], ev[:, 3] = 7.0, 5.0, 1.0
        raw = torch.from_numpy(ev).to(dev)
        xy, p = (torch.from_numpy(a).to(dev) for a in compact_events(ev))
        want = rasterize.counts_plain(xy[:, 0], xy[:, 1], p, hw)
        check(torch.equal(rasterize.counts_from_events(raw, hw), want), f"raw form on {name}")
        ((ms, spread),) = median_ms((lambda: rasterize.counts_from_events(raw, hw), 1))
        lib, bound = index_put_ms(xy, p, hw), raw_bound_ms(g, n, *hw)
        out[name] = {"ms": ms, "bound_ms": bound, "library_ms": lib}
        print(f"rasterize timing raw {name} (G={g}, N={n}, {hw[0]}x{hw[1]}): {ms:.5f} ms "
              f"(spread {spread:.1%}), byte bound {bound:.5f} ms ({bound / ms:.1%} of the time), "
              f"index_put_ {lib:.5f} ms; on {card}")
    return out


def phase_losses(dev, card: str, terms_ms=None) -> dict:
    """The loss terms on the card: goldens, each term against the CPU in
    float64 at the RGB recipe's shapes, the percep recipe at full width
    through ``Trainer`` with a bit-identical resume, and the raw-transfer
    case with an event term.  ``terms_ms``: :func:`time_terms`, taken early
    (timed here when not given).  Returns the rasterizer's launches on
    these paths."""
    import importlib

    import torch

    mods = {n: importlib.import_module(f"bmcnet_esr_torch.kernels.{n}") for n in KERNEL_MODULES}
    t0 = time.perf_counter()
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    work = os.path.join(ROOT, "outputs", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    laps = {}
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        t = time.perf_counter()
        if terms_ms is None:
            terms_ms = time_terms(dev, card)
        loss_goldens(dev)
        bundle = lpips_bundle(os.path.join(tmp, "lpips_alex.npz"))
        term_checks(dev, bundle, card)
        laps["goldens and terms"] = time.perf_counter() - t
        t = time.perf_counter()
        launches = percep_run(dev, mods, card, bundle, tmp, terms_ms)
        laps["percep recipe"] = time.perf_counter() - t
        t = time.perf_counter()
        raw = raw_run(dev, mods, card, tmp)
        laps["raw transfer"] = time.perf_counter() - t
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    print(f"losses phase: {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in laps.items())
          + f"), rasterizer launches {launches} on the percep recipe, {raw} raw")
    return {"rasterize_counts": launches + raw}


# The generate phase (video -> events on the card): the NFS preset's grid
# (data/synthesis.py), the demo video rendered there at 240 frames a second,
# simulated at scales 1, 2, 4 and 8 (down8 = 45x80, the recipe's input).
GEN_FRAMES, GEN_FPS, GEN_SCALES = 65, 240.0, (1, 2, 4, 8)
GEN_WINDOWS = 32          # (c): window pairs through the engine (33 input windows)
GEN_ENC_BATCH = 8         # (d): windows through the encodings
GEN_TIME_BINS = 5         # (d): stack and voxel bins
# (a): if the card's event list is not bit-identical to the CPU's, the
# share of flipped crossings and the timestamp difference it is held to
GEN_FLIP_SHARE, GEN_T_ATOL = 1e-6, 1e-6
GEN_VOXEL_RTOL = 1e-5     # (d): relative to each grid's largest magnitude


def gen_config(**kw):
    """The phase's simulator: mismatch thresholds (drawn on the host),
    refractory and leak on, 16 crossings a pixel an interval, 8 intervals a
    chunk, noise off unless ``kw`` turns it on."""
    from bmcnet_esr_torch.data.simulator import SimulatorConfig

    return SimulatorConfig(**{**dict(threshold_sigma=0.1, refractory_s=5e-4, leak_rate_hz=1.0,
                                     max_events_per_pixel=16, chunk=8), **kw})


def interval_blocks(ev, per_interval, ts, hw):
    """``[T - 1, 2, H, W]`` counts of an event list whose rows come interval
    by interval, ``per_interval`` rows each; every row must lie in its
    interval's span."""
    import numpy as np

    h, w = hw
    which = np.repeat(np.arange(len(per_interval)), per_interval)
    t0, t1 = ts[which], ts[which + 1]
    check(np.all((ev[:, 2] >= t0) & (ev[:, 2] <= t1 + 1e-9)),
          "an event lies outside its interval's span")
    flat = ((which * 2 + (ev[:, 3] < 0)) * h + ev[:, 1].astype(np.int64)) * w + ev[:, 0].astype(
        np.int64)
    return np.bincount(flat, minlength=len(per_interval) * 2 * h * w).reshape(-1, 2, h, w)


def gen_exact(dev, pyramid, ts, card: str) -> dict:
    """(a) Per scale, thresholds drawn once on the host: the card's event
    list against the CPU's plain run of the same code.  Returns the card's
    streams by scale, the scale-1 run's wall time, events and peak memory."""
    import dataclasses

    import numpy as np
    import torch

    from bmcnet_esr_torch.data.simulator import EventSimulator, simulator_state_from_jax

    rng = np.random.default_rng(21)
    streams, stats = {}, {}
    for i, s in enumerate(GEN_SCALES):
        fs = pyramid[s]
        hw = fs.shape[1:]
        cfg = dataclasses.replace(gen_config(), seed=i)
        c = [np.maximum(np.float32(cfg.contrast_threshold) * (1 + np.float32(cfg.threshold_sigma)
                        * rng.standard_normal(hw).astype(np.float32)), cfg.threshold_min)
             for _ in range(2)]
        gain = np.ones(hw, np.float32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        got = EventSimulator(hw, cfg, device=dev,
                             state=simulator_state_from_jax(*c, gain, device=dev)).simulate(fs, ts)
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated(dev)
        t = time.perf_counter()
        want = EventSimulator(hw, cfg, device="cpu",
                              state=simulator_state_from_jax(*c, gain)).simulate(fs, ts)
        cpu_wall = time.perf_counter() - t
        check(len(want) > 1000, f"scale {s}: only {len(want)} events")
        same = got.shape == want.shape and np.array_equal(got, want)
        if same:
            verdict = "bit-identical (length, rows, order)"
        else:
            flipped = int(np.abs(_event_image(got, hw) - _event_image(want, hw)).sum())
            dt = (float(np.abs(np.sort(got[:, 2]) - np.sort(want[:, 2])).max())
                  if got.shape == want.shape else float("inf"))
            verdict = (f"NOT bit-identical: {len(got)} vs {len(want)} events, {flipped} flipped "
                       f"crossings (bound {GEN_FLIP_SHARE:g} of the events), largest timestamp "
                       f"difference {dt:.3e} s (bound {GEN_T_ATOL:g})")
            check(flipped <= GEN_FLIP_SHARE * len(want) and dt <= GEN_T_ATOL, verdict)
        print(f"generate (a) scale {s} ({hw[0]}x{hw[1]}): {len(got)} events over "
              f"{len(ts) - 1} intervals, card {wall:.3f} s, CPU {cpu_wall:.3f} s; card against "
              f"CPU: {verdict}; on {card}")
        streams[s] = got
        if s == 1:
            stats = {"wall": wall, "events": len(got), "peak": peak}
    return streams, stats


def _event_image(ev, hw):
    """``[2, H, W]`` counts of an event list (positive, negative)."""
    import numpy as np

    h, w = hw
    flat = ((ev[:, 3] < 0) * h + ev[:, 1].astype(np.int64)) * w + ev[:, 0].astype(np.int64)
    return np.bincount(flat, minlength=2 * h * w).reshape(2, h, w)


def gen_noise(dev, frames, ts, card: str) -> None:
    """(b) Noise and hot pixels on the card at 360x640: ``simulate_counts``
    of one simulator equals the per-interval counts of ``simulate`` of
    another of the same seed; on a static scene (leak off) the cold pixels'
    mean count lies within 4 sigma of the Poisson mean, their index of
    dispersion within 4 sigma of 1, and the hot pixels' rate ratio within 4
    sigma of ``hot_pixel_gain``."""
    import dataclasses

    import numpy as np

    from bmcnet_esr_torch.data.simulator import EventSimulator

    hw = frames.shape[1:]
    cfg = gen_config(noise_rate_hz=20.0, hot_pixel_fraction=0.01, hot_pixel_gain=10.0, seed=7)
    ev = EventSimulator(hw, cfg, device=dev).simulate(frames, ts)
    cnt = EventSimulator(hw, cfg, device=dev).simulate_counts(frames, ts)
    per = cnt.reshape(len(cnt), -1).sum(1).astype(np.int64)
    check(per.sum() == len(ev), f"simulate_counts holds {per.sum()} events, simulate {len(ev)}")
    blocks = interval_blocks(ev, per, ts, hw)
    check(np.array_equal(blocks, cnt), "simulate_counts differs from simulate's per-interval counts")
    print(f"generate (b) noise and hot pixels on the demo video: {len(ev)} events, "
          f"simulate_counts equal to simulate's per-interval counts in all {len(cnt)} intervals")

    static = np.full_like(frames, 0.5)
    sim = EventSimulator(hw, dataclasses.replace(cfg, leak_rate_hz=0.0), device=dev)
    total = sim.simulate_counts(static, ts).sum((0, 1))
    hot = sim.hot_pixels
    lam = cfg.noise_rate_hz * (ts[-1] - ts[0])
    cold = total[~hot]
    n_cold, n_hot = int((~hot).sum()), int(hot.sum())
    mean, disp = float(cold.mean()), float(cold.var() / cold.mean())
    ratio = float(total[hot].mean() / mean)
    s_mean = np.sqrt(lam / n_cold)
    s_disp = np.sqrt((lam + 2 * lam**2) / n_cold) / lam
    g = cfg.hot_pixel_gain
    s_ratio = g * np.sqrt(1 / (lam * g * n_hot) + 1 / (lam * n_cold))
    print(f"generate (b) static scene, noise {cfg.noise_rate_hz} Hz, {n_hot} hot pixels of "
          f"{hot.size} at gain {g}: cold mean {mean:.5f} events a pixel (Poisson mean "
          f"{lam:.5f}, {abs(mean - lam) / s_mean:.2f} sigma), index of dispersion {disp:.5f} "
          f"({abs(disp - 1) / s_disp:.2f} sigma from 1), hot/cold ratio {ratio:.4f} "
          f"({abs(ratio - g) / s_ratio:.2f} sigma from {g}); on {card}")
    check(abs(mean - lam) <= 4 * s_mean, "the noise rate is off its Poisson mean")
    check(abs(disp - 1) <= 4 * s_disp, "the noise counts are not Poisson-dispersed")
    check(abs(ratio - g) <= 4 * s_ratio, "the hot pixels' rate ratio is off the gain")


def gen_windows(down8, down2, n: int):
    """The NFS recipe's windows of the down8 stream (2048 events, sliding
    1024) and their GT windows of the down2 stream (16 x 2048 events from
    the first at or after the window's start, shifted back at the end), as
    ``[n, 1, 4, N]`` float32 events with timestamps normalized per window."""
    import numpy as np

    def window(ev, i0, i1):
        w = ev[i0:i1].T.astype(np.float32)
        w[2] = (w[2] - w[2, 0]) / (w[2, -1] - w[2, 0] + 1e-6)
        return w

    stride, size, gt_size = N_LR // 2, N_LR, SCALE**2 * N_LR
    check(stride * (n - 1) + size <= len(down8), f"{len(down8)} down8 events hold no {n} windows")
    inp = np.stack([window(down8, stride * i, stride * i + size) for i in range(n)])
    g0 = np.searchsorted(down2[:, 2], down8[stride * np.arange(n), 2], "left")
    g0 = np.minimum(g0, len(down2) - 1 - gt_size)
    gt = np.stack([window(down2, a, a + gt_size) for a in g0])
    return inp[:, None], gt[:, None]


def gen_engine(dev, mods, inp, gt, card: str) -> int:
    """(c) The down8 windows through ``InferenceEngine.infer_windows`` with
    the full BMCNet (n_c=128, n_b=5, x4, seeded weights): finite outputs;
    every window's counts from the rasterizer kernel equal to the plain
    ``events_to_channels``.  Returns the rasterizer's launches in the run."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.data import DatasetConfig
    from bmcnet_esr_torch.inference import InferenceEngine
    from bmcnet_esr_torch.models import BMCNet
    from bmcnet_esr_torch.ops.batch import batch_counts_from_compact, compact_events
    from bmcnet_esr_torch.ops.encodings import events_to_channels

    ci, cg = compact_events(inp), compact_events(gt)

    def load_chunk(pos, steps):
        return ((ci[0][pos : pos + steps + 1], ci[1][pos : pos + steps + 1]),
                (cg[0][pos : pos + steps], cg[1][pos : pos + steps]))

    m = BMCNet(scale=SCALE, n_c=128, n_b=5)
    m.load_state_dict(seeded_full_weights(m))
    eng = InferenceEngine(m, DatasetConfig(scale=SCALE), chunk_size=CHUNK, visualize=False,
                          device=dev)
    eng.infer_windows(load_chunk, 2, LR, GT)  # warm-up, outside the counts
    torch.cuda.synchronize()
    zero_counts(mods)
    t = time.perf_counter()
    r = eng.infer_windows(load_chunk, GEN_WINDOWS, LR, GT, return_per_window=True)
    wall = time.perf_counter() - t
    got = counts(mods)
    check(got["rasterize_counts"] > 0 and sum(got.values()) == got["rasterize_counts"],
          f"generate (c): launches {got}, expected rasterizer launches only")
    esr = np.asarray(r["per_window"]["esr_mse"])
    check(len(esr) == GEN_WINDOWS and np.all(np.isfinite(esr))
          and np.all(np.isfinite(r["per_window"]["bicubic_mse"])), "generate (c): bad outputs")
    bad = 0
    for (xy, p), ev, hw in ((ci, inp, LR), (cg, gt, GT)):
        cuda = batch_counts_from_compact(torch.from_numpy(xy).to(dev), torch.from_numpy(p).to(dev),
                                         hw).cpu().numpy()
        for k in range(len(ev)):
            e = torch.from_numpy(ev[k, 0])
            want = events_to_channels(e[0], e[1], e[3], hw).numpy().transpose(1, 2, 0)
            bad += int(not np.array_equal(cuda[k, 0], want))
    check(bad == 0, f"generate (c): {bad} windows' kernel counts differ from events_to_channels")
    print(f"generate (c) engine: {GEN_WINDOWS} simulated down8 window pairs {LR} -> {GT} "
          f"({N_LR} events, sliding {N_LR // 2}; GT {SCALE**2 * N_LR} down2 events) through "
          f"infer_windows, full "
          f"BMCNet n_c=128 n_b=5 x4 seeded, {wall / GEN_WINDOWS * 1e3:.3f} ms/window, mean "
          f"esr_mse {float(esr.mean()):.6f}, bicubic_mse "
          f"{float(np.mean(r['per_window']['bicubic_mse'])):.6f}; rasterizer launches "
          f"{got['rasterize_counts']}; kernel counts equal to events_to_channels in all "
          f"{len(inp) + len(gt)} windows; on {card}")
    return got["rasterize_counts"]


def gen_encodings(dev, inp, card: str) -> None:
    """(d) The auxiliary encodings of ``GEN_ENC_BATCH`` windows on the card
    against the CPU: counts, stacks, masks, ``stack_to_count`` and the hot
    mask exactly, voxels within ``GEN_VOXEL_RTOL`` of each grid's largest
    magnitude; then (e) the stack redistributed back to events on the host,
    native against numpy."""
    import numpy as np
    import torch

    from bmcnet_esr_torch import native
    from bmcnet_esr_torch.ops import batch, encodings

    lists = np.ascontiguousarray(inp[:GEN_ENC_BATCH, 0].transpose(0, 2, 1))  # [B, N, 4]

    def encode(device):
        ev = torch.from_numpy(lists).to(device)
        conv = encodings.event_conversion(ev, GEN_TIME_BINS, LR)
        out = {"e_cnt": conv["e_cnt"], "e_stack": conv["e_stack"],
               "stack_to_count": encodings.stack_to_count(conv["e_stack"])}
        out["stack_polarity"] = torch.stack([encodings.events_to_stack_polarity(
            e[:, 0], e[:, 1], e[:, 2], e[:, 3], GEN_TIME_BINS, LR) for e in ev])
        out["mask"] = torch.stack([encodings.events_to_mask(e[:, 0], e[:, 1], e[:, 3], LR)
                                   for e in ev])
        rate = (conv["e_cnt"].sum(1) > 0).to(torch.float32).mean(0)
        out["hot_mask"] = encodings.get_hot_event_mask(rate, GEN_ENC_BATCH, 100, 5, 0.5)
        out["restore"] = encodings.event_restore(ev / torch.tensor(
            [LR[1], LR[0], 1.0, 1.0], device=device), LR)
        voxels = {"e_voxel": conv["e_voxel"],
                  "batch_voxels": batch.batch_events_to_voxels(ev.transpose(1, 2),
                                                               GEN_TIME_BINS, LR)}
        return ({k: v.cpu().numpy() for k, v in out.items()},
                {k: v.cpu().numpy() for k, v in voxels.items()})

    (exact, vox), (exact_cpu, vox_cpu) = encode(dev), encode("cpu")
    for k in exact:
        check(np.array_equal(exact[k], exact_cpu[k]), f"generate (d): {k} differs card vs CPU")
    worst = max(float(np.abs(vox[k] - vox_cpu[k]).max() / np.abs(vox_cpu[k]).max())
                for k in vox)
    check(worst <= GEN_VOXEL_RTOL, f"generate (d): voxels differ by {worst:.3e}")
    check(exact["hot_mask"].min() == 0 and exact["e_cnt"].sum() > 0,
          "generate (d): the hot mask masks nothing or the counts are empty")
    print(f"generate (d) encodings of {GEN_ENC_BATCH} windows, card against CPU: "
          f"{', '.join(sorted(exact))} bit-identical; voxels (event_conversion, "
          f"batch_events_to_voxels) within {worst:.3e} of each grid's largest magnitude "
          f"(bound {GEN_VOXEL_RTOL:g}); hot mask zeroes {int((exact['hot_mask'] == 0).sum())} "
          f"pixels; on {card}")

    stack = exact_cpu["e_stack"]
    native.redistribute_stack(stack)  # builds and loads eventops.cpp
    t = time.perf_counter()
    ours = native.redistribute_stack(stack)
    native_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    plain = encodings.event_redistribute_stack(stack)
    numpy_ms = (time.perf_counter() - t) * 1e3
    check(np.array_equal(ours, plain), "generate (e): native redistribution differs from numpy")
    print(f"generate (e) redistribution of the {stack.shape} stacks ({int(np.abs(stack).sum())} "
          f"events) on the host: native {native_ms:.3f} ms, numpy {numpy_ms:.3f} ms "
          f"({numpy_ms / native_ms:.1f}x), equal; host of {card}")


def gen_timing(dev, frames, ts, stats: dict, card: str) -> None:
    """(e) ms an interval of the device step at 360x640 (CUDA events over
    three chunks after a warm-up), events/s of the whole scale-1 run of
    (a), its peak memory, and the idle share of one profiled chunk (step
    and compaction) framed by ``profile_edge``."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.data.simulator import EventSimulator, _log_intensity

    hw = frames.shape[1:]
    cfg = gen_config(seed=3)
    sim = EventSimulator(hw, cfg, device=dev)
    logl = torch.as_tensor(_log_intensity(frames, cfg.log_eps), device=dev)
    dts = torch.as_tensor(np.diff(ts).astype(np.float32), device=dev)
    state = (logl[0], logl[0], torch.full(hw, -torch.inf, device=dev))
    k = cfg.chunk
    check(len(frames) > 5 * k, f"{len(frames)} frames hold no 5 chunks of {k} intervals")

    def chunk(c, state):
        return sim._chunk_step(state, logl[1 + c * k : 1 + (c + 1) * k], dts[c * k : (c + 1) * k])

    state, _ = chunk(0, state)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for c in range(1, 4):
        state, outs = chunk(c, state)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (3 * k)
    p = _profiled(lambda: sim._compact(chunk(4, state)[1]), k, "generate chunk", "interval")
    print(f"generate (e) timing at {hw[0]}x{hw[1]}, M={cfg.max_events_per_pixel}, chunk {k}: "
          f"device step {ms:.4f} ms an interval (CUDA events, 3 chunks); the scale-1 run of "
          f"(a): {stats['events']} events in {stats['wall']:.3f} s, "
          f"{stats['events'] / stats['wall']:.4e} events/s end to end, peak memory "
          f"{stats['peak'] / 2**20:.1f} MiB; one profiled chunk with its compaction: "
          f"{p['wall_ms']:.4f} ms wall and {p['busy_ms']:.4f} ms device busy an interval, idle "
          f"share {p['idle']:.1%}, {p['launches']:.0f} launches an interval; on {card}")


def phase_generate(dev, card: str) -> dict:
    """Video -> events on the card (``data/simulator.py``) at the NFS preset's
    full grid, its down8 windows through the engine, and the encodings.
    Returns the rasterizer's launches on this path."""
    import importlib

    import numpy as np

    from bmcnet_esr_torch.data.demo import demo_video
    from bmcnet_esr_torch.data.simulator import downscale_frames
    from bmcnet_esr_torch.data.synthesis import PRESETS

    mods = {n: importlib.import_module(f"bmcnet_esr_torch.kernels.{n}") for n in KERNEL_MODULES}
    t0 = time.perf_counter()
    laps = {}
    mark = [t0]

    def lap(name):
        laps[name] = time.perf_counter() - mark[0]
        mark[0] = time.perf_counter()

    res = tuple(PRESETS["nfs"]["resolution"])
    frames, _ = demo_video(GEN_FRAMES, res, 0)
    ts = np.arange(GEN_FRAMES, dtype=np.float64) / GEN_FPS
    pyramid = {s: downscale_frames(frames, s) for s in GEN_SCALES}
    check(pyramid[8].shape[1:] == LR, f"down8 of {res} is {pyramid[8].shape[1:]}, not {LR}")
    try:
        import cv2  # noqa: F401
        route = "cv2.resize"
    except ImportError:
        route = "the F.interpolate fallback (no cv2 here)"
    print(f"generate: the demo video at {res[0]}x{res[1]}, {GEN_FRAMES} frames at {GEN_FPS:g} "
          f"frames/s, downscaled by {route}")
    lap("video")
    streams, stats = gen_exact(dev, pyramid, ts, card)
    lap("(a)")
    gen_noise(dev, frames, ts, card)
    lap("(b)")
    inp, gt = gen_windows(streams[8], streams[2], GEN_WINDOWS + 1)
    launches = gen_engine(dev, mods, inp, gt, card)
    lap("(c)")
    gen_encodings(dev, inp, card)
    lap("(d)")
    gen_timing(dev, frames, ts, stats, card)
    lap("(e)")
    print(f"generate phase: {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in laps.items()) + ")")
    return {"rasterize_counts": launches}


# -- upsample: Super SloMo, the renderers, the converters and profiling ---------

# The NFS preset's 360x640 cut by 8 rows: five pools need multiples of 32
SLOMO_SRC, SLOMO_HW = (360, 640), (352, 640)
SLOMO_TS = (0.25, 0.4, 0.75)
SLOMO_SEEDS = {"fc": 33, "at": 34}  # tools/slomo_fixture_weights.py
# The card's float32 against float64 within this many times the CPU
# float32's own distance from float64 at the same size (the TERM_F32_FACTOR
# pattern).  The size matters: the CPU float32's frames lie 1.0e-06 from
# float64 at 64x128 but 6.7e-06 at 352x640 (both printed by (a)), so a
# bound taken at 64x128 would fail any float32 at full size.  The float64
# reference is the card's (the CPU's float64 pass at full size takes 15.6 s
# there); at SLOMO_REF_HW the CPU's and the card's float64 must agree
# within SLOMO_F64_RTOL, so either is float64's answer.
SLOMO_F32_FACTOR = 3.0
SLOMO_REF_HW, SLOMO_F64_RTOL = (64, 128), 1e-12
# (c): the flow UNet's last bias raised on its four flow channels, so that
# the largest flow is a few pixels and the interpolation loop runs
SLOMO_RAISED_BIAS = 2.5
SLOMO_SEQ_FRAMES = 8  # (a): frames through upsample_sequence, timed
SLOMO_COUNT_PX = 1e-3  # (c): a max flow this near an integer may flip its ceil
# (b): tests/test_upsampling.py's bounds against the reference goldens
SLOMO_GOLDEN_TOL = {"fc_out": dict(atol=2e-5, rtol=1e-4), "warped": dict(atol=2e-5, rtol=0),
                    "ft": dict(atol=5e-5, rtol=1e-3)}
DEVICE_TIME_SHARE = 0.2  # (e): device_time against CUDA events


def slomo_state_dict(shapes: dict, seed: int) -> dict:
    """The fixture recipe of ``tools/slomo_fixture_weights.py``: fan-in
    scaled normals for the conv kernels, 0.05 normals otherwise, drawn in
    sorted key order from one seeded generator."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = {}
    for key in sorted(shapes):
        shape = tuple(int(s) for s in shapes[key])
        scale = (1.0 / np.sqrt(np.prod(shape[1:])) if key.endswith("weight") and len(shape) == 4
                 else 0.05)
        out[key] = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    return out


@functools.lru_cache(maxsize=1)
def slomo_cpu_nets() -> tuple:
    """The flow and refinement UNets with the seeded fixture weights, on the
    CPU in float32 (drawn once: 39.6 M normals take about a second)."""
    from bmcnet_esr_torch.data.upsampling import UNet

    nets = []
    for net, key in ((UNet(6, 4), "fc"), (UNet(20, 5), "at")):
        shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        net.load_state_dict(slomo_state_dict(shapes, SLOMO_SEEDS[key]), strict=True)
        nets.append(net.eval().requires_grad_(False))
    return tuple(nets)


def slomo_nets(device, dtype):
    """Copies of :func:`slomo_cpu_nets` on ``device`` in ``dtype``."""
    import copy

    return [copy.deepcopy(net).to(device, dtype) for net in slomo_cpu_nets()]


def slomo_frames(hw, n: int = 2):
    """``n`` consecutive demo frames as RGB ``[H, W, 3]`` with their
    timestamps: at ``SLOMO_HW``, the demo video at the NFS preset's 360x640
    cut to 352 rows; at another ``hw``, the demo video at ``hw``."""
    import numpy as np

    from bmcnet_esr_torch.data.demo import demo_video

    frames, ts = demo_video(n, SLOMO_SRC if tuple(hw) == SLOMO_HW else hw, 0)
    return [np.repeat(f[: hw[0], :, None], 3, axis=2) for f in frames], [float(t) for t in ts]


def slomo_outputs(nets, imgs, device, dtype) -> dict:
    """Both flows and the frames at ``SLOMO_TS`` of one pair, on the host in float64."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.data.upsampling import MEAN, compute_flows, interpolate_frame

    i0, i1 = (torch.from_numpy(np.ascontiguousarray(
        (im - MEAN).transpose(2, 0, 1)[None])).to(device, dtype) for im in imgs)
    out = {}
    with torch.no_grad():
        f01, f10 = compute_flows(nets[0], i0, i1)
        out["f01"], out["f10"] = f01, f10
        for t in SLOMO_TS:
            out[f"t={t}"] = interpolate_frame(nets[1], i0, i1, f01, f10, t)
    return {k: v.double().cpu().numpy() for k, v in out.items()}


def rel_distance(got, want) -> float:
    import numpy as np

    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def median_event_ms(fn, repeats: int = 3) -> float:
    """Median over ``repeats`` calls of CUDA-event time (one warm-up first)."""
    import numpy as np
    import torch

    fn()
    times = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def slomo_full_width(dev, card: str) -> tuple:
    """(a) Both UNets at 352x640 in float32 on the card against float64 on
    the card, within ``SLOMO_F32_FACTOR`` times the CPU float32's distance
    from the same float64; returns the bounds and the card's float32
    outputs."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.data.upsampling import MEAN, compute_flows, interpolate_frame

    cpu, f32, f64 = torch.device("cpu"), torch.float32, torch.float64
    small = slomo_frames(SLOMO_REF_HW)[0]
    ref = {(where, dt): slomo_outputs(slomo_nets(where, dt), small, where, dt)
           for where, dt in ((cpu, f64), (dev, f64), (cpu, f32))}
    agree = max(rel_distance(ref[cpu, f64][k], ref[dev, f64][k]) for k in ref[cpu, f64])
    check(agree <= SLOMO_F64_RTOL, f"upsample (a): float64 on the card {agree:.3e} from the CPU's")
    small_d = {k: rel_distance(ref[cpu, f32][k], ref[cpu, f64][k]) for k in ref[cpu, f64]}
    imgs = slomo_frames(SLOMO_HW)[0]
    nets = slomo_nets(dev, f32)
    n_params = sum(p.numel() for n in nets for p in n.parameters())
    check(n_params == 39_610_473, f"the two UNets hold {n_params} parameters")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    got = slomo_outputs(nets, imgs, dev, f32)
    peak = torch.cuda.max_memory_allocated(dev)
    want = slomo_outputs(slomo_nets(dev, f64), imgs, dev, f64)
    on_cpu = slomo_outputs(slomo_nets(cpu, f32), imgs, cpu, f32)
    bounds = {k: SLOMO_F32_FACTOR * rel_distance(on_cpu[k], want[k]) for k in want}
    said = []
    for k, bound in bounds.items():
        d = rel_distance(got[k], want[k])
        check(np.isfinite(got[k]).all() and got[k].shape[-2:] == SLOMO_HW, f"upsample (a) {k}")
        check(d <= bound, f"upsample (a) {k}: float32 {d:.3e} from float64, bound {bound:.3e}")
        said.append(f"{k} {d:.3e} (bound {bound:.3e})")
    i0, i1 = (torch.from_numpy(np.ascontiguousarray((im - MEAN).transpose(2, 0, 1)[None])).to(dev)
              for im in imgs)
    flows = []

    def flow_pass():
        flows[:] = compute_flows(nets[0], i0, i1)

    with torch.no_grad():
        flow_ms = median_event_ms(flow_pass)
        frame_ms = median_event_ms(lambda: interpolate_frame(nets[1], i0, i1, *flows, 0.4))
    gflop = {"flow": slomo_flops(6, 4) / 1e9, "frame": slomo_flops(20, 5) / 1e9}
    print(f"upsample (a) at {SLOMO_HW[0]}x{SLOMO_HW[1]}, {n_params} parameters, strict float32 "
          f"on the card against float64 on the card, ||d||/||x|| (bounds "
          f"{SLOMO_F32_FACTOR:g}x the CPU float32's distance): " + ", ".join(said)
          + f"; at {SLOMO_REF_HW[0]}x{SLOMO_REF_HW[1]} float64 card against CPU {agree:.3e}, "
          f"CPU float32 against float64 " + ", ".join(f"{k} {v:.3e}" for k, v in small_d.items())
          + "; max flow "
          f"{float(np.sqrt((got['f01'] ** 2).sum(1)).max()):.4f} px; a flow pass "
          f"{flow_ms:.4f} ms ({gflop['flow']:.1f} GFLOP, {gflop['flow'] / flow_ms:.2f} TFLOP/s), "
          f"an interpolated frame {frame_ms:.4f} ms ({gflop['frame']:.1f} GFLOP of convolution "
          f"and 4 backwarps) (CUDA events, median of 3); peak memory {peak / 2**20:.1f} MiB over "
          f"a flow pass and 3 frames; on {card}")
    return bounds, got


def slomo_flops(c_in: int, c_out: int) -> int:
    """Multiply-adds x 2 of one UNet's convolutions at ``SLOMO_HW``."""
    from bmcnet_esr_torch.data.upsampling import _UNET_CONVS

    total = 0
    for name, ci, co, k in _UNET_CONVS:
        level = int(name[4]) if name.startswith("down") else (
            5 - int(name[2]) if name.startswith("up") else 0)
        total += 2 * (ci or c_in) * (co or c_out) * k * k * (SLOMO_HW[0] >> level) * (
            SLOMO_HW[1] >> level)
    return total


def slomo_goldens(dev) -> None:
    """(b) ``tests/goldens/slomo_goldens.npz`` (32x64) on the card, within
    the JAX test's bounds."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.data.upsampling import backwarp, compute_flows, interpolate_frame

    with np.load(os.path.join(ROOT, "tests", "goldens", "slomo_goldens.npz")) as z:
        g = {k: z[k] for k in z.files}
    nets = slomo_nets(dev, torch.float32)
    for net, key in zip(nets, ("fc", "at")):
        manifest = {k[len(f"manifest/{key}/"):]: tuple(v.tolist()) for k, v in g.items()
                    if k.startswith(f"manifest/{key}/")}
        check(manifest == {k: tuple(v.shape) for k, v in net.state_dict().items()},
              f"upsample (b): the {key} UNet's shapes are not the goldens' manifest")
    i0, i1 = (torch.from_numpy(g[k]).to(dev) for k in ("i0", "i1"))
    with torch.no_grad():
        fc_out = nets[0](torch.cat([i0, i1], 1))
        warped = backwarp(i1, torch.from_numpy(g["flow"]).to(dev))
        ft = interpolate_frame(nets[1], i0, i1, *compute_flows(nets[0], i0, i1), 0.4)
    said = []
    for k, v in (("fc_out", fc_out), ("warped", warped), ("ft", ft)):
        v = v.cpu().numpy()
        np.testing.assert_allclose(v, g[k], **SLOMO_GOLDEN_TOL[k], err_msg=f"upsample (b) {k}")
        said.append(f"{k} max|d| {float(np.abs(v - g[k]).max()):.3e} "
                    f"(atol {SLOMO_GOLDEN_TOL[k]['atol']:g}, rtol {SLOMO_GOLDEN_TOL[k]['rtol']:g})")
    print("upsample (b) slomo_goldens.npz on the card: " + ", ".join(said))


def slomo_upsampler(dev, work: str, bounds: dict, card: str) -> None:
    """(c) ``SuperSloMoUpsampler`` from a written ``.ckpt`` with the raised
    bias, card against CPU: counts and timestamps, frames within (a)'s
    bound; then frames/s of ``upsample_sequence`` on the card."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.data.upsampling import SuperSloMoUpsampler, compute_flows, max_flow

    fc, at = (n.state_dict() for n in slomo_nets(torch.device("cpu"), torch.float32))
    fc["conv3.bias"] = fc["conv3.bias"] + SLOMO_RAISED_BIAS
    path = os.path.join(work, "slomo_raised.ckpt")
    torch.save({"state_dictFC": fc, "state_dictAT": at}, path)
    ups = {"card": SuperSloMoUpsampler(path, device=dev),
           "cpu": SuperSloMoUpsampler(path, device="cpu")}
    imgs, stamps = slomo_frames(SLOMO_HW, 3)
    frame_bound = max(v for k, v in bounds.items() if k.startswith("t="))
    said = []
    for a in range(len(imgs) - 1):
        runs = {}
        for where, up in ups.items():
            with torch.no_grad():
                mag = max_flow(*compute_flows(up.flow_net, up._frame(imgs[a]),
                                              up._frame(imgs[a + 1])))
            runs[where] = (mag, *up.upsample_pair(imgs[a], imgs[a + 1], stamps[a], stamps[a + 1]))
        (m_card, f_card, s_card), (m_cpu, f_cpu, s_cpu) = runs["card"], runs["cpu"]
        check(len(f_card) >= 2, f"upsample (c): pair {a} inserted no frame (max flow {m_card})")
        check(abs(m_card - m_cpu) <= SLOMO_COUNT_PX, f"upsample (c): max flow {m_card} / {m_cpu}")
        if abs(m_cpu - round(m_cpu)) > SLOMO_COUNT_PX:
            check(len(f_card) == len(f_cpu) and s_card == s_cpu,
                  f"upsample (c) pair {a}: {len(f_card)} frames at {s_card} on the card, "
                  f"{len(f_cpu)} at {s_cpu} on the CPU")
            dists = [rel_distance(x.astype(np.float64), y.astype(np.float64))
                     for x, y in zip(f_card[1:], f_cpu[1:])]
            check(max(dists) <= frame_bound,
                  f"upsample (c) pair {a}: frames {max(dists):.3e} apart, bound {frame_bound:.3e}")
            said.append(f"pair {a}: max flow {m_card:.4f} px, {len(f_card)} frames at the CPU's "
                        f"timestamps, frames within {max(dists):.3e} of the CPU's")
        else:  # the ceil may flip: hold the card to its own flows
            check(len(f_card) == int(np.ceil(m_card)), f"upsample (c) pair {a}: count")
            said.append(f"pair {a}: max flow {m_card:.6f} px within {SLOMO_COUNT_PX} of an "
                        f"integer, {len(f_card)} frames from the card's own flows")
    seq, seq_stamps = slomo_frames(SLOMO_HW, SLOMO_SEQ_FRAMES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames, out_stamps = ups["card"].upsample_sequence(seq, seq_stamps)
    wall = time.perf_counter() - t0
    check(out_stamps == sorted(out_stamps) and len(frames) == len(out_stamps),
          "upsample (c): the sequence's timestamps")
    print(f"upsample (c) SuperSloMoUpsampler from a .ckpt (flow bias +{SLOMO_RAISED_BIAS:g}), "
          f"card against CPU at {SLOMO_HW[0]}x{SLOMO_HW[1]}: " + "; ".join(said)
          + f" (frame bound {frame_bound:.3e}); upsample_sequence of {SLOMO_SEQ_FRAMES} frames "
          f"-> {len(frames)} in {wall:.3f} s: {len(frames) / wall:.2f} frames/s out, "
          f"{(SLOMO_SEQ_FRAMES - 1) / wall:.2f} pairs/s; on {card}")


def slomo_renders_and_convert(dev, mods, work: str, flows: dict, card: str):
    """(d) (a)'s flows through ``flow_to_image`` and ``FlowVisualizer``;
    ``cli.convert --pth`` of a seeded reference-layout ``.pth`` to an
    ``.npz`` and a directory, each loaded on the card and rolled out one
    window, bit-equal to the ``.pth``.  Returns the stream of the ``.pth``."""
    import cv2
    import numpy as np
    import torch

    from bmcnet_esr_torch.cli.convert import main as convert
    from bmcnet_esr_torch.inference import StreamingSR
    from bmcnet_esr_torch.inference.engine import load_model_for_inference
    from bmcnet_esr_torch.models import BMCNet
    from bmcnet_esr_torch.models.convert import export_torch_state_dict
    from bmcnet_esr_torch.vis import FlowVisualizer, flow_to_image

    f01 = flows["f01"][0].astype(np.float32)
    img = flow_to_image(f01[0], f01[1])
    check(img.shape == SLOMO_HW + (3,) and img.dtype == np.uint8 and img.std() > 0,
          "upsample (d): flow_to_image")
    written = FlowVisualizer(os.path.join(work, "vis")).store(
        flow=f01, brightness=slomo_frames(SLOMO_HW)[0][0][..., 0], sequence="demo")
    back = cv2.cvtColor(cv2.imread(written["flow"]), cv2.COLOR_BGR2RGB)
    check(np.array_equal(back, img) and os.path.getsize(written["frames"]) > 0,
          "upsample (d): the stored flow PNG")

    model = BMCNet(scale=SCALE, n_c=128, n_b=5)
    pth = os.path.join(work, "seeded_full.pth")
    torch.save(export_torch_state_dict(seeded_full_weights(model, 3), "full", n_b=5), pth)
    sizes = ["--variant", "full", "--scale", str(SCALE), "--n_c", "128", "--n_b", "5"]
    convert(["--pth", pth, "--out", os.path.join(work, "conv"), "--npz"] + sizes)
    convert(["--pth", pth, "--out", os.path.join(work, "conv_dir")] + sizes)
    wins = serve_windows(np.random.default_rng(21), 2)
    preds, streams = {}, {}
    zero_counts(mods)
    for name in ("seeded_full.pth", "conv.npz", "conv_dir"):
        m = load_model_for_inference(os.path.join(work, name), SCALE, 128, 5, "full", device=dev)
        streams[name] = StreamingSR(m, None, LR, window_size=N_LR, device=dev)
        check(streams[name].push(wins[0]) is None, "upsample (d): the first window")
        preds[name] = streams[name].push(wins[1])
    launches = mods["rasterize"].launches
    check(launches == 6, f"upsample (d): {launches} rasterizer launches for 6 windows")
    same = [np.array_equal(preds[n], preds["seeded_full.pth"]) for n in preds]
    check(all(same), f"upsample (d): the converted checkpoints' windows differ ({same})")
    print(f"upsample (d) flow_to_image and FlowVisualizer.store of (a)'s F_0_1 "
          f"({SLOMO_HW[0]}x{SLOMO_HW[1]}, written and read back equal); cli.convert --pth of a "
          f"seeded full BMCNet .pth to .npz and to a directory, each loaded on the card: one "
          f"window bit-equal to the .pth's ({preds['conv.npz'].shape}); {launches} rasterizer "
          f"launches; on {card}")
    return streams["seeded_full.pth"], wins, launches


def slomo_profiling(dev, mods, work: str, stream, wins, card: str) -> int:
    """(e) ``utils/profiling``: ``trace`` around two ``annotate``d windows
    (framed by ``profile_edge``) holds both spans and the rasterizer's
    kernel record; ``device_time`` of a window within ``DEVICE_TIME_SHARE``
    of its CUDA-event time.  Returns the rasterizer's launches."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.utils import annotate, device_time, trace

    log_dir = os.path.join(work, "trace")
    zero_counts(mods)
    with trace(log_dir):
        profile_edge()
        for i in range(2):
            with annotate(f"upsample_window_{i}"):
                stream.push(wins[i % 2])
        profile_edge()
    launches = mods["rasterize"].launches
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    check(len(files) == 1, f"upsample (e): trace files {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if str(e.get("name", "")).startswith("upsample_window_")
             and e.get("cat") == "user_annotation"]
    raster = [e for e in events if e.get("cat") == "kernel"
              and ("band_kernel" in e.get("name", "") or "event_kernel" in e.get("name", ""))]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    check(len(spans) == 2, f"upsample (e): {len(spans)} annotated spans in the trace")
    check(len(raster) == launches == 2,
          f"upsample (e): {len(raster)} rasterizer kernel records for {launches} launches")
    # both clocks read the same calls: on an H100 a window's host time
    # moved by a fifth between two back-to-back loops of it
    calls = []

    def push(w):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        stream.push(w)
        end.record()
        calls.append((start, end))

    sec, rate = device_time(push, wins[0], iters=7, warmup=1)
    event_ms = float(np.median([a.elapsed_time(b) for a, b in calls[1:]]))
    share = abs(sec * 1e3 / event_ms - 1)
    check(share <= DEVICE_TIME_SHARE,
          f"upsample (e): device_time {sec * 1e3:.3f} ms against CUDA events {event_ms:.3f} ms")
    print(f"upsample (e) trace(): {os.path.basename(files[0])}, {len(events)} records, "
          f"{len(kernels)} kernel records, both spans and {len(raster)} rasterizer kernel "
          f"records; device_time of a full-model float32 window {sec * 1e3:.4f} ms "
          f"({rate:.2f} windows/s), CUDA events {event_ms:.4f} ms (the same 7 calls' median), "
          f"{share:.1%} apart (bound {DEVICE_TIME_SHARE:.0%}); on {card}")
    return launches


def phase_upsample(dev, card: str) -> dict:
    """Super SloMo on the card at 352x640, the goldens, the upsampler from a
    checkpoint, the renderers and converters, and the profiling helpers.
    Returns the rasterizer's launches on the windows of (d) and (e)."""
    import importlib

    mods = {n: importlib.import_module(f"bmcnet_esr_torch.kernels.{n}") for n in KERNEL_MODULES}
    t0 = time.perf_counter()
    laps = {}
    mark = [t0]

    def lap(name):
        laps[name] = time.perf_counter() - mark[0]
        mark[0] = time.perf_counter()

    with tempfile.TemporaryDirectory() as work:
        bounds, flows = slomo_full_width(dev, card)
        lap("(a)")
        slomo_goldens(dev)
        lap("(b)")
        slomo_upsampler(dev, work, bounds, card)
        lap("(c)")
        stream, wins, launches = slomo_renders_and_convert(dev, mods, work, flows, card)
        lap("(d)")
        launches += slomo_profiling(dev, mods, work, stream, wins, card)
        lap("(e)")
    print(f"upsample phase: {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in laps.items()) + ")")
    return {"rasterize_counts": launches}


PHASES = ("int8_kernels", "checkpoint", "rollouts", "h5", "timing", "upsample", "generate", "serve",
          "export", "train", "losses", "parallel")


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

    t0 = time.perf_counter()

    def done(phase: str) -> None:
        print(f"phase {phase} done at {time.perf_counter() - t0:.1f} s")

    err, inputs = phase_kernels(dev)
    done("kernels")
    if "int8_kernels" in phases:
        errs8 = phase_int8_kernels(dev)
        done("int8_kernels")
    if "checkpoint" in phases:
        phase_checkpoint(dev)
        done("checkpoint")
    terms_ms = None
    if "timing" in phases:  # before the rollouts: the profiler loses records late in a long run
        t = time_rasterizer(inputs)
        time_raw_rasterizer(dev, card)
        terms_ms = time_terms(dev, card)
        split_convolutions(dev, card)
        t8 = time_int8(dev)
        done("timing")
    if "upsample" in phases:  # early: its trace must hold every kernel record
        upsample_launches = phase_upsample(dev, card)
        done("upsample")
    if "generate" in phases:  # early too: it profiles one chunk
        generate_launches = phase_generate(dev, card)
        done("generate")
    if "serve" in phases:  # early: the profiler loses records late in a long run
        serve_launches = phase_serve(dev, card)
        done("serve")
    if "export" in phases:
        export_launches = phase_export(dev, card)
        done("export")
    if "train" in phases:  # before the rollouts: its profile counts the rasterizer's kernels
        train_launches = phase_train(dev, card)
        done("train")
    if "losses" in phases:
        losses_launches = phase_losses(dev, card, terms_ms)
        done("losses")
    if "parallel" in phases:
        parallel_launches = phase_parallel(dev, card)
        done("parallel")
    if "rollouts" in phases:
        launches = phase_rollouts(dev, card)
        done("rollouts")
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
        "launches": (launches["rasterize_counts"] + train_launches["rasterize_counts"]
                     + losses_launches["rasterize_counts"]
                     + serve_launches["rasterize_counts"] + export_launches["rasterize_counts"]
                     + parallel_launches["rasterize_counts"]
                     + generate_launches["rasterize_counts"]
                     + upsample_launches["rasterize_counts"]),
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
            "launches": (launches[name] + serve_launches[name] + export_launches[name]
                         + parallel_launches[name]),
            "max_abs_err": errs8[name],
            "ms": o["ms"],
            "plain_ms": o["plain_ms"],
            "bound_ms": o["bound_ms"],
            "bound_by": o["bound_by"],
            "library_ms": o["library_ms"],
        })
    print(f"rasterizer launches: {launches['rasterize_counts']} on the inference path, "
          f"{train_launches['rasterize_counts']} on the training path, "
          f"{losses_launches['rasterize_counts']} with the loss terms, "
          f"{serve_launches['rasterize_counts']} on the serving path, "
          f"{export_launches['rasterize_counts']} through serving bundles, "
          f"{parallel_launches['rasterize_counts']} on the parallel paths (data and tensor "
          f"parallelism, sharded serving), {generate_launches['rasterize_counts']} on simulated "
          f"windows (generate), {upsample_launches['rasterize_counts']} on converted checkpoints "
          f"and traced windows (upsample); int8 kernels on "
          f"the serving path: "
          f"{ {k: v for k, v in serve_launches.items() if k != 'rasterize_counts'} }"
          f", through bundles: "
          f"{ {k: v for k, v in export_launches.items() if k != 'rasterize_counts'} }, through "
          f"the engine's mesh and sharded serving: "
          f"{ {k: v for k, v in parallel_launches.items() if k != 'rasterize_counts'} }")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
