"""The ``program_span`` readers and ``benchmark/spans.py`` on hand-made device
records and spans: the CPU build cannot start ``devtrace.Span``'s CUDA-only
profiler, so the spans a traced run leaves in the program's buffer are made
here, two inference windows and a training window in one buffer as a process
holds them after three traced runs.  Times are microseconds."""

import json
import os
import types

import pytest

from bmcnet_esr_torch.utils import timers

from benchmark import harness, spans

INFER = ["infer.dispatch_ms_per_window", "infer.forward_ms_per_window",
         "infer.input_ms_per_window", "infer.host_blocked_pct", "infer.idle_in_dispatch_pct",
         "infer.calibrate_ms"]
TRAIN = ["train.dispatch_ms_per_iter", "train.input_ms_per_iter", "train.host_blocked_pct",
         "train.idle_in_dispatch_pct"]
EDGE = 100_000  # devtrace.EDGE_S, us


def S(id, parent, name, start, end, **attrs):
    return types.SimpleNamespace(id=id, parent=parent, name=name, start_ns=start * 1000,
                                 end_ns=end * 1000, attrs=attrs)


def infer_window(t, windows, calibrate, first_id):
    """Records and spans of a traced rollout starting at ``t``: the rollout
    opens 1 ms before the first record; a second rollout holds the closing
    edge, with a dispatch inside the window that must not count."""
    i = first_id
    records = [("k1", t + 1000, t + 1010), ("k2", t + 1020, t + 1050),
               ("k3", t + 1100, t + 1130)]
    kept = [S(i, None, "rollout", t, t + 1200, windows=windows),
            S(i + 1, i, "rollout.load_wait", t, t + 500),
            S(i + 2, i, "rollout.upload", t + 500, t + 600),
            S(i + 5, i, "rollout.dispatch", t + 1000, t + 1040, windows=windows),
            S(i + 6, i + 5, "rollout.forward", t + 1005, t + 1015),
            S(i + 7, i + 5, "rollout.forward", t + 1025, t + 1035),
            S(i + 8, i, "rollout.drain", t + 1040, t + 1150),
            S(i + 9, None, "rollout", t + 1200, t + 1130 + EDGE + 10, windows=2),
            S(i + 10, i + 9, "rollout.dispatch", t + 1300, t + 1320, windows=2)]
    if calibrate:
        kept.append(S(i + 4, i, "rollout.calibrate", t + 600, t + 1000))
    return records, kept


def train_window(t, first_id):
    """Two whole iterations; before them the step of the iteration in which
    the profiler started (its iteration never kept), after them one that
    holds the closing edge."""
    i = first_id
    records = [("k1", t, t + 100), ("k2", t + 150, t + 400), ("k3", t + 500, t + 900)]
    kept = [S(i, 999_999, "train.step", t - 100, t + 50, rows=2),
            S(i + 2, i + 1, "train.input", t + 100, t + 140),
            S(i + 3, i + 1, "train.step", t + 140, t + 300, rows=2),
            S(i + 4, i + 1, "train.wait", t + 300, t + 500),
            S(i + 1, None, "train.iteration", t + 100, t + 600),
            S(i + 6, i + 5, "train.input", t + 600, t + 620),
            S(i + 7, i + 5, "train.step", t + 620, t + 700, rows=2),
            S(i + 8, i + 5, "train.wait", t + 700, t + 900),
            S(i + 5, None, "train.iteration", t + 600, t + 950),
            S(i + 10, i + 9, "train.input", t + 950, t + 960),
            S(i + 11, i + 9, "train.step", t + 960, t + 900 + EDGE + 50, rows=2),
            S(i + 9, None, "train.iteration", t + 950, t + 900 + EDGE + 60)]
    return records, kept


A_RECORDS, A_SPANS = infer_window(100_000, 4, True, 1)
B_RECORDS, B_SPANS = infer_window(10_100_000, 8, False, 101)
T_RECORDS, T_SPANS = train_window(20_300_000, 201)


@pytest.fixture
def buffer(monkeypatch):
    monkeypatch.setattr(timers, "spans", lambda: A_SPANS + B_SPANS + T_SPANS)


def run(records):
    return {"trace": {"records": records}}


def reader(name):
    return harness.metric_reader(name)


def test_idle_time_inside_spans_is_exact():
    records = [("a", 2.0, 4.0), ("b", 3.0, 6.0), ("c", 8.0, 25.0)]
    assert spans.union([(20, 30), (0, 10), (5, 8)]) == [(0, 10), (20, 30)]
    assert spans.idle_us([(0, 10), (20, 30)], records) == 2 + 2 + 5  # 0-2, 6-8; 25-30
    assert spans.idle_us([(4.5, 5.5)], records) == 0
    assert spans.idle_us([(40, 41)], records) == 1


def test_the_window_keeps_the_outer_span_and_drops_the_edges(buffer):
    lo, hi = spans.window(A_RECORDS)
    assert (lo, hi) == (101_000 - 50_000, 101_130 + 50_000)
    k = spans.kept(run(A_RECORDS), "rollout")
    assert k.count("rollout") == 1  # opened 1 ms before the first record; the edge's is out
    assert k.count("rollout.dispatch") == 1  # the dispatch under the edge's rollout is out
    t = spans.kept(run(T_RECORDS), "train.iteration")
    assert t.count("train.iteration") == 2 and t.count("train.step") == 2
    assert t.count("train.input") == 2  # the edge iteration's input lies in the window: out


def test_the_window_opens_back_to_the_host_window(monkeypatch):
    """The first launch under a fresh profiler may lag the rollout's opening
    by more than the slack: the host window (``window_s``, from the opening
    edge to the drained device at the closing one) still holds the rollout,
    and a span that holds the opening edge stays out."""
    t0 = 5_000_000  # the opening edge's sleep ends, us
    records = [("k1", t0 + 80_000, t0 + 80_010), ("k2", t0 + 80_100, t0 + 80_130)]
    window_s = (80_130 + 20) * 1e-6  # the closing drain returns 20 us after the last record
    held = [S(1, None, "rollout", t0 + 10, t0 + 80_200, windows=4),
            S(2, 1, "rollout.dispatch", t0 + 79_990, t0 + 80_050, windows=4),
            S(3, None, "rollout", t0 - EDGE - 20, t0 + 5, windows=4),
            S(4, 3, "rollout.dispatch", t0 - 10, t0 + 1, windows=4)]
    monkeypatch.setattr(timers, "spans", lambda: held)
    k = spans.kept({"trace": {"records": records, "window_s": window_s}}, "rollout")
    assert k.count("rollout") == 1 and k.ms("rollout.dispatch") == pytest.approx(0.060)
    assert spans.kept({"trace": {"records": records}}, "rollout") is None  # slack alone
    assert spans.window(records, window_s) == (t0 - 20 - 50_000, t0 + 80_130 + 50_000)


@pytest.mark.parametrize("records,want", [
    (A_RECORDS, {"infer.dispatch_ms_per_window": 0.040 / 4,
                 "infer.forward_ms_per_window": 0.020 / 4,
                 "infer.input_ms_per_window": 0.600 / 4,
                 "infer.host_blocked_pct": 100 * 0.110 / 1.2,
                 "infer.idle_in_dispatch_pct": 100 * 0.010 / 1.2,
                 "infer.calibrate_ms": 0.400}),
    (B_RECORDS, {"infer.dispatch_ms_per_window": 0.040 / 8,
                 "infer.forward_ms_per_window": 0.020 / 8,
                 "infer.input_ms_per_window": 0.600 / 8,
                 "infer.host_blocked_pct": 100 * 0.110 / 1.2,
                 "infer.idle_in_dispatch_pct": 100 * 0.010 / 1.2,
                 "infer.calibrate_ms": None}),
    (T_RECORDS, {"train.dispatch_ms_per_iter": (0.160 + 0.080) / 2,
                 "train.input_ms_per_iter": (0.040 + 0.020) / 2,
                 "train.host_blocked_pct": 100 * 0.400 / 0.850,
                 "train.idle_in_dispatch_pct": 100 * 0.010 / 0.850}),
], ids=["infer_a", "infer_b", "train"])
def test_each_reader_reads_only_its_own_window(buffer, records, want):
    for name in INFER + TRAIN:
        got = reader(name)(run(records))
        expected = want.get(name)
        assert got == (None if expected is None else pytest.approx(expected, rel=1e-9)), name


def test_readers_read_nothing_without_the_programs_spans(monkeypatch):
    """The parent commit's program has no ``timers.spans()``; an untraced run
    has no records."""
    monkeypatch.delattr(timers, "spans")
    for name in INFER + TRAIN:
        assert reader(name)(run(A_RECORDS)) is None
        assert reader(name)(run(T_RECORDS)) is None
    monkeypatch.undo()
    for name in INFER + TRAIN:
        assert reader(name)({"window": {}}) is None


def test_the_span_metrics_in_benchmark_json():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    infer_cells = ["rgb_int8pall_infer", "rgb_bf16_infer"]
    for name in INFER + TRAIN:
        m = per_layer[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        if name.startswith("infer."):
            assert m["layer"] == "file rollout (InferenceEngine)"
            assert m["moves"] == "windows_per_s"
            assert m["workloads"] == (["rgb_int8pall_infer"] if name == "infer.calibrate_ms"
                                      else infer_cells)
        else:
            assert m["layer"] == "training loop (Trainer, train_step)"
            assert m["moves"] == "train_ms_per_iter" and m["workloads"] == ["nfs_fp32_train"]
