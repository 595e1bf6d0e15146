"""``infer.graph_window_pct`` on hand-made device records and spans, laid out
as ``test_bench_spans.py`` lays out a traced rollout.  Times are
microseconds."""

import json
import os

import pytest

from bmcnet_esr_torch.utils import timers

from benchmark import harness
from benchmark.tests.test_bench_spans import S, infer_window, reader, run


def test_the_graph_window_share(monkeypatch):
    """The windows of the ``rollout.replay`` spans over the rollout's, each
    replay inside a model call; a replay under the edge's rollout is out.
    Nothing is read where no replay was kept (a program without the graphs)
    or no span at all."""
    records, kept = infer_window(100_000, 4, False, 1)
    t = 100_000
    replays = [S(301, 7, "rollout.replay", t + 1006, t + 1014, windows=2),
               S(302, 8, "rollout.replay", t + 1026, t + 1034, windows=2),
               S(303, 11, "rollout.replay", t + 1305, t + 1315, windows=2)]
    share = reader("infer.graph_window_pct")
    monkeypatch.setattr(timers, "spans", lambda: kept + replays)
    assert share(run(records)) == pytest.approx(100.0, rel=1e-12)
    monkeypatch.setattr(timers, "spans", lambda: kept + replays[1:])
    assert share(run(records)) == pytest.approx(50.0, rel=1e-12)
    monkeypatch.setattr(timers, "spans", lambda: kept)
    assert share(run(records)) is None
    monkeypatch.delattr(timers, "spans")
    assert share(run(records)) is None


def test_the_graph_window_share_in_benchmark_json():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        (m,) = [m for m in json.load(f)["per_layer"] if m["name"] == "infer.graph_window_pct"]
    assert m == {"name": "infer.graph_window_pct", "unit": "%", "better": "higher",
                 "source": "program_span", "layer": "file rollout (InferenceEngine)",
                 "moves": "windows_per_s", "workloads": ["rgb_int8pall_infer", "rgb_bf16_infer"]}
