"""The port's span recorder (``bmcnet_esr_torch/utils/timers.py``) and the
spans of the file rollout and the training loop, on the CPU; one test, on
the card, holds a kernel's device record inside its span.

The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py -q -s
"""

import logging
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bmcnet_esr_torch.data import DatasetConfig
from bmcnet_esr_torch.inference import InferenceEngine, load_model_for_inference
from bmcnet_esr_torch.ops.batch import compact_events
from bmcnet_esr_torch.training import Trainer
from bmcnet_esr_torch.training import trainer as trainer_mod
from bmcnet_esr_torch.training.config import RunConfig
from bmcnet_esr_torch.utils import annotate, timers
from bmcnet_esr_torch.utils.timers import Timer

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


@pytest.fixture(autouse=True)
def _empty_buffer():
    timers.clear()
    yield
    timers.clear()


def _by_name(kept):
    out = {}
    for s in kept:
        out.setdefault(s.name, []).append(s)
    return out


# -- the recorder ---------------------------------------------------------------


def test_nesting_and_parent_ids():
    with timers.record():
        with Timer("outer", windows=3) as outer:
            with Timer("a") as a:
                with Timer("a.inner") as inner:
                    pass
            with Timer("b", rows=2) as b:
                pass
    assert [s.name for s in timers.spans()] == ["a.inner", "a", "b", "outer"]
    assert outer.parent is None and a.parent == b.parent == outer.id and inner.parent == a.id
    assert len({outer.id, a.id, inner.id, b.id}) == 4
    assert outer.attrs == {"windows": 3} and b.attrs == {"rows": 2} and a.attrs == {}
    for s in (a, inner, b):
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns


def test_off_keeps_nothing_and_no_span_touches_the_device(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span touched the device")

    for name in ("synchronize", "Event", "current_stream", "Stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    with Timer("off", windows=1) as off:
        with Timer("off.inner"):
            pass
    assert timers.spans() == [] and off.start_ns is None
    with timers.record():
        with Timer("on"):
            with Timer("on.inner"):
                pass
    assert [s.name for s in timers.spans()] == ["on.inner", "on"]


def test_on_inside_record_and_under_a_cpu_profiler():
    with Timer("before"):
        pass
    with timers.record():
        with timers.record():  # blocks nest
            pass
        with Timer("recorded"):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        with Timer("profiled"):
            pass
    with Timer("after"):
        pass
    assert [s.name for s in timers.spans()] == ["recorded", "profiled"]


def test_a_span_brackets_its_record_function_on_the_profilers_clock():
    """Spans are stamped with ``time.time_ns()``; the profiler's event of the
    span's own ``record_function`` lies inside the span."""
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("clocked") as span:
            (x @ x).sum()
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "clocked"]
    assert len(events) == 1 and isinstance(span, Timer)
    start, end = events[0].start_ns(), events[0].start_ns() + events[0].duration_ns()
    assert span.start_ns <= start <= end <= span.end_ns
    assert abs(span.start_ns - time.time_ns()) < 60e9  # CLOCK_REALTIME, not a monotonic clock


def test_summary_counts_total_and_self_time(monkeypatch):
    ticks = iter([0, 10, 12, 20, 25, 40, 100, 107]).__next__  # ns
    monkeypatch.setattr(timers, "time", types.SimpleNamespace(time_ns=ticks))
    with timers.record():
        with Timer("outer"):          # 0 .. 40
            with Timer("child"):      # 10 .. 12
                pass
            with Timer("child"):      # 20 .. 25
                pass
        with Timer("child"):          # 100 .. 107, at the top
            pass
    got = timers.summary()
    assert got["outer"] == {"count": 1, "total_ms": pytest.approx(40e-6),
                            "self_ms": pytest.approx(33e-6)}
    assert got["child"] == {"count": 3, "total_ms": pytest.approx(14e-6),
                            "self_ms": pytest.approx(14e-6)}


def test_spans_are_per_thread_and_cancel_drops_one():
    seen = {}

    def work():
        with Timer("thread.span") as s:
            seen["span"] = s

    with timers.record():
        with Timer("main") as main:
            t = threading.Thread(target=work)
            t.start()
            t.join()
            with Timer("dropped") as dropped:
                dropped.cancel()
    assert seen["span"].parent is None and main.parent is None
    assert [s.name for s in timers.spans()] == ["thread.span", "main"]


def test_threads_recording_at_once_lose_no_span_and_no_count():
    """More threads than cores, each opening record() blocks and nested
    spans, with the interpreter switching threads often."""
    threads, turns = 2 * (os.cpu_count() or 1) + 1, 20
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(turns):
                with timers.record():
                    with Timer("outer") as outer:
                        with Timer("inner") as inner:
                            pass
                    assert inner.parent == outer.id

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    kept = timers.spans()
    assert len(kept) == 2 * threads * turns and len({s.id for s in kept}) == len(kept)
    assert timers._forced == 0
    with Timer("after"):  # no record() block left open
        pass
    assert len(timers.spans()) == len(kept)


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(timers, "_SPANS", timers.collections.deque(maxlen=3))
    with timers.record():
        for i in range(5):
            with Timer(f"s{i}"):
                pass
    assert [s.name for s in timers.spans()] == ["s2", "s3", "s4"]
    timers.clear()
    assert timers.spans() == []


# -- the file rollout -----------------------------------------------------------

H = W = 8


def _windows(seed, n, hw, events):
    h, w = hw
    rng = np.random.default_rng(seed)
    ev = np.zeros((n, 1, 4, events), np.float32)
    ev[:, :, 0] = rng.integers(0, w, (n, 1, events))
    ev[:, :, 1] = rng.integers(0, h, (n, 1, events))
    ev[:, :, 3] = rng.integers(0, 2, (n, 1, events)) * 2 - 1
    return compact_events(ev)


@pytest.mark.parametrize("dtype", ["float32", "int8_pall"])
def test_rollout_spans(dtype):
    """n_c 8, 6 window pairs in chunks of 4 and 2: the table's spans, their
    nesting and ``windows`` attributes; ``rollout.calibrate`` for int8 only."""
    inp = _windows(1, 7, (H, W), 96)
    gt = _windows(2, 6, (2 * H, 2 * W), 384)

    def load_chunk(pos, steps):
        return ((inp[0][pos:pos + steps + 1], inp[1][pos:pos + steps + 1]),
                (gt[0][pos:pos + steps], gt[1][pos:pos + steps]))

    model = load_model_for_inference(os.path.join(GOLDENS, "plain_small.npz"), 2, 8, 2,
                                     variant="plain", dtype=dtype, device="cpu")
    engine = InferenceEngine(model, DatasetConfig(scale=2), chunk_size=4, visualize=False,
                             device="cpu")
    engine.infer_windows(load_chunk, 6, (H, W), (2 * H, 2 * W))  # off: nothing kept
    assert timers.spans() == []
    with timers.record():
        result = engine.infer_windows(load_chunk, 6, (H, W), (2 * H, 2 * W))
    assert np.isfinite(result["esr_mse"])
    got = _by_name(timers.spans())
    want = {"rollout", "rollout.load_wait", "rollout.upload", "rollout.dispatch",
            "rollout.forward", "rollout.drain"}
    assert set(got) == want | ({"rollout.calibrate"} if dtype.startswith("int8") else set())
    (rollout,) = got["rollout"]
    assert rollout.attrs == {"windows": 6} and rollout.parent is None
    assert [d.attrs["windows"] for d in got["rollout.dispatch"]] == [4, 2]
    assert len(got["rollout.forward"]) == 6 and len(got["rollout.drain"]) == 2
    dispatch_ids = {d.id for d in got["rollout.dispatch"]}
    assert all(f.parent in dispatch_ids for f in got["rollout.forward"])
    for name in want - {"rollout", "rollout.forward"}:
        for s in got[name]:
            assert s.parent == rollout.id
            assert rollout.start_ns <= s.start_ns <= s.end_ns <= rollout.end_ns


# -- the training loop ----------------------------------------------------------


class _Batches:
    """Four seeded compact batches (2 clips of 3 windows at 16x16 -> 32x32),
    read as ``Trainer`` reads a loader."""

    inp_resolution, gt_resolution = (H * 2, W * 2), (H * 4, W * 4)
    seqn, compact, pad_last, batch_size = 2, True, False, 2

    def __init__(self):
        self.batches = []
        for k in range(4):
            ixy, ip = _windows(10 + k, 6, self.inp_resolution, 128)
            gxy, gp = _windows(20 + k, 6, self.gt_resolution, 512)
            self.batches.append({"inp_xy": ixy.reshape(2, 3, 2, -1), "inp_p": ip.reshape(2, 3, -1),
                                 "gt_xy": gxy.reshape(2, 3, 2, -1), "gt_p": gp.reshape(2, 3, -1)})

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _trainer(tmp_path, iterations, log_step):
    icfg = {"enabled": True, "iterations": iterations, "save_period": 50,
            "train_log_step": log_step, "valid_log_step": 10, "valid_step": 50,
            "lr_change_rate": 4}
    cfg = {"experiment": "spans", "model": {"args": {"n_c": 8, "n_b": 2, "variant": "plain"}},
           "optimizer": {"name": "Adam", "args": {"lr": 1e-3}},
           "lr_scheduler": {"name": "ExponentialLR", "args": {"gamma": 0.95}},
           "trainer": {"output_path": str(tmp_path), "monitor": "off", "tensorboard": False,
                       "remat": False, "iteration_based_train": icfg},
           "train_dataloader": {"dataset": {"scale": 2}}}
    return Trainer(RunConfig(cfg, runid="spans"), train_loader=_Batches(), seed=0, device="cpu")


def test_training_loop_spans(tmp_path):
    tr = _trainer(tmp_path, iterations=2, log_step=1)
    with timers.record():
        tr.train()
    got = _by_name(timers.spans())
    assert {"train.iteration", "train.input", "train.step", "train.wait"} <= set(got)
    iterations = got["train.iteration"]
    assert len(iterations) == 2 and all(i.parent is None for i in iterations)
    ids = {i.id for i in iterations}
    assert [s.attrs for s in got["train.step"]] == [{"rows": 2}, {"rows": 2}]
    for name in ("train.input", "train.step", "train.wait"):
        assert all(s.parent in ids for s in got[name]), name
    assert len(got["train.input"]) == 2 and len(got["train.wait"]) == 2  # a log line each


def test_log_line_counts_iterations_since_the_previous_one(tmp_path, monkeypatch):
    """The first iteration takes 100 s of a stubbed clock, each later one
    1 s: the log lines after the first read 1 iteration a second, not the
    average since ``train()`` began."""
    clock = {"t": 0.0}
    monkeypatch.setattr(trainer_mod, "time",
                        types.SimpleNamespace(perf_counter=lambda: clock["t"]))
    tr = _trainer(tmp_path, iterations=5, log_step=2)

    def step(state, batch):
        clock["t"] += 100.0 if clock["t"] == 0 else 1.0
        return state, {"train_mse_loss": 1.0, "train_loss": 1.0}

    lines = []

    class Log(logging.Logger):
        def info(self, msg, *args, **kwargs):
            lines.append(msg)

    tr.train_step, tr.logger, tr.save = step, Log("spans"), lambda *a, **k: None
    tr.train()
    rates = [line.split("iters/sec: ")[1] for line in lines if "iters/sec" in line]
    assert rates == ["0.01", "1.00", "1.00"]  # iterations 0, 2 and 4


# -- on the card ----------------------------------------------------------------


@pytest.mark.cuda
def test_a_kernels_device_record_lies_inside_its_span():
    """``torch.cuda._sleep`` then ``synchronize`` inside a span under a CUDA
    profiler: the kernel's device record, on the profiler's clock, lies
    inside the span.  Prints how far the span's end lies past the kernel's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    spans = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            with Timer("sleep") as span:
                torch.cuda._sleep(2_000_000)
                torch.cuda.synchronize()
            spans.append(span)
    records = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA)
    assert len(records) == len(spans) == 5  # the sleeps, the profiler's only device records
    for span, (start, end) in zip(spans, records):
        assert span.start_ns <= start <= end <= span.end_ns, (span.start_ns, start, end,
                                                             span.end_ns)
    tails = [(s.end_ns - end) * 1e-3 for s, (_, end) in zip(spans, records)]
    heads = [(start - s.start_ns) * 1e-3 for s, (start, _) in zip(spans, records)]
    print(f"span end after the kernel's end: {min(tails):.1f}-{max(tails):.1f} us; kernel start "
          f"after the span's start: {min(heads):.1f}-{max(heads):.1f} us "
          f"({torch.cuda.get_device_name()})")
