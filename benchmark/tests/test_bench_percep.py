"""The ``rgb_fp32_percep_train`` cell on the CPU at a size a test can hold:
the sound run is correct, the program without its LPIPS term is not (and
neither is the reference in TF32, on the card); the readers of the loss
terms' and remat's spans on hand-made spans and records, a rerun body's
spans without a parent on their thread among them.  Times are microseconds."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny
from bmcnet_esr_torch.utils import timers

CELL = "rgb_fp32_percep_train"
READERS = ["train.loss_terms_ms_per_iter", "train.recompute_ms_per_iter",
           "train.lpips_device_ms_per_iter"]
EDGE = 100_000  # devtrace.EDGE_S, us


def _run(extra=None, seed=2**31 + 17):
    torch.set_num_threads(2)
    over = tiny.overrides("train", {"mix": {"length": 3}, **(extra or {})})
    return harness.run_cell(CELL, seed, 1.0, False, device="cpu", overrides=over)


def test_the_cell_is_correct_when_sound():
    r = _run()
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert set(r["metrics"]) == {"train_ms_per_iter", "setup_s"}


def test_the_program_without_its_lpips_term_is_not_correct():
    r = _run({"settings": {"fault": "no_lpips"}})
    limits = harness.cell_files(CELL)["cell"]["limits"]
    assert not r["correct"]
    assert r["checks"]["loss_gap"]["value"] > 100 * limits["loss_gap"], r["checks"]


@pytest.mark.cuda
def test_the_tf32_control_is_not_correct():
    """TF32 exists on the card only."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on an NVIDIA GPU only")
    control = harness.cell_files(CELL)["cell"]["control"]
    r = harness.run_cell(CELL, 2**31 + 3, 1.0, False, overrides=control)
    assert not r["correct"], json.dumps(r["checks"])


def test_the_new_references_import_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.lpips, benchmark.reference.percep, "
            "benchmark.lpips_weights; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert "bmcnet_esr_torch" not in out and "'jax'" not in out


# -- the readers ---------------------------------------------------------------------


def S(id, parent, name, start, end, **attrs):
    return types.SimpleNamespace(id=id, parent=parent, name=name, start_ns=start * 1000,
                                 end_ns=end * 1000, attrs=attrs)


T = 30_000_000
RECORDS = [("k1", T, T + 100), ("k2", T + 150, T + 400), ("k3", T + 500, T + 900)]
SPANS = [
    # rerun by the iteration in which the profiler started: in no kept iteration
    S(30, None, "train.recompute", T - 100, T - 50),
    S(31, 30, "train.loss.lpips", T - 90, T - 60, recompute=1, images=4),
    # iteration A: a first pass inside its micro-batch, a rerun on another thread
    S(1, None, "train.iteration", T + 100, T + 600),
    S(3, 1, "train.step", T + 140, T + 300, rows=2),
    S(4, 3, "train.microbatch", T + 140, T + 220, rows=1),
    S(5, 4, "train.loss.lpips", T + 150, T + 160, recompute=0, images=4),
    S(6, 4, "train.loss.recon", T + 160, T + 165, recompute=0),
    S(7, None, "train.recompute", T + 200, T + 215),
    S(8, 7, "train.loss.lpips", T + 202, T + 210, recompute=1, images=4),
    # iteration B: a rerun alone
    S(10, None, "train.iteration", T + 600, T + 950),
    S(11, None, "train.recompute", T + 700, T + 720),
    S(12, 11, "train.loss.lpips", T + 705, T + 715, recompute=1, images=4),
    # the iteration that holds the closing edge: not kept, nor what lies in it
    S(20, None, "train.iteration", T + 950, T + 900 + EDGE + 60),
    S(21, None, "train.loss.lpips", T + 960, T + 970, recompute=1, images=4),
]
# (correlation, start) of the host's runtime calls; (correlation, start, end) of the kernels
LAUNCHES = [(1, T + 152), (2, T + 205), (3, T + 170), (4, T + 708), (5, T + 965), (6, T - 80)]
KERNELS = [(1, T + 200, T + 260), (2, T + 300, T + 340), (3, T + 400, T + 500),
           (4, T + 800, T + 830), (5, T + 980, T + 990), (6, T + 10, T + 20)]


def _trace(launches=LAUNCHES):
    return {"trace": {"records": RECORDS, "kernels": KERNELS, "launches": launches}}


def test_the_readers_place_rerun_spans_in_their_iteration_by_time(monkeypatch):
    monkeypatch.setattr(timers, "spans", lambda: SPANS)
    read = {name: harness.metric_reader(name)(_trace()) for name in READERS}
    assert read == {
        # lpips 10 + 8 + 10 us, recon 5 us, over the 2 kept iterations
        "train.loss_terms_ms_per_iter": pytest.approx((10 + 5 + 8 + 10) * 1e-3 / 2),
        "train.recompute_ms_per_iter": pytest.approx((15 + 20) * 1e-3 / 2),
        # the kernels of calls 1, 2 and 4: launched inside a kept lpips span
        "train.lpips_device_ms_per_iter": pytest.approx((60 + 40 + 30) * 1e-3 / 2),
    }


def test_the_readers_read_nothing_where_there_is_nothing(monkeypatch):
    """The parent's program keeps no such span (or no span at all); a trace
    without the runtime calls gives no device time of the term."""
    old = [s for s in SPANS if s.name in ("train.iteration", "train.step")]
    monkeypatch.setattr(timers, "spans", lambda: old)
    assert [harness.metric_reader(n)(_trace()) for n in READERS] == [None] * 3
    monkeypatch.setattr(timers, "spans", lambda: SPANS)
    assert harness.metric_reader("train.lpips_device_ms_per_iter")(_trace([])) is None
    monkeypatch.delattr(timers, "spans")
    assert [harness.metric_reader(n)(_trace()) for n in READERS] == [None] * 3
    assert [harness.metric_reader(n)({"window": {}}) for n in READERS] == [None] * 3


def test_the_cell_and_its_metrics_in_benchmark_json():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in READERS:
        m = per_layer[name]
        assert m["workloads"] == [CELL] and m["moves"] == "train_ms_per_iter"
        assert m["source"] == ("device_trace" if name.endswith("device_ms_per_iter")
                               else "program_span")
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert CELL in e2e["train_ms_per_iter"]["workloads"]
    assert [m["name"] for m in harness.spec_metrics(CELL, "per_layer")] == READERS
    for other in ("rgb_int8pall_infer", "nfs_fp32_train", "rgb_bf16_infer"):
        assert not set(READERS) & {m["name"] for m in harness.spec_metrics(other, "per_layer")}
