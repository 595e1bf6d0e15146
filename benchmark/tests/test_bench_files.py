"""The benchmark's data files: every file parses, every name and unit keeps to
the allowed characters, every cell's parts and every metric's reader exist,
and a cell, configuration or metric added as a file is found without an edit."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

HERE = harness.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _files(folder):
    return sorted(f[:-5] for f in os.listdir(os.path.join(HERE, folder)) if f.endswith(".json"))


@pytest.mark.parametrize("folder", ["configs", "workloads", "mixes"])
def test_every_file_parses_under_its_own_name(folder):
    names = _files(folder)
    assert names
    for name in names:
        data = harness.load_json(folder, f"{name}.json")
        assert data["name"] == name and NAME.match(name)


def test_benchmark_json_keeps_to_the_contract():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51 and spec["paths"] == ["benchmark"]
    configs = {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(harness.ROOT, c["file"])) and NAME.match(c["name"])
        assert harness.load_json("configs", f"{c['name']}.json")["reduced"] == c["reduced"]
    assert len({c["file"] for c in spec["configs"]}) == len(configs) == len(spec["configs"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(set(pairs)) == len(pairs), "a pair of config and traffic is given twice"
    assert configs == {w["config"] for w in spec["workloads"]}
    cells = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        cell = harness.cell_files(w["name"])
        assert cell["cell"]["config"] == w["config"] and w["config"] in configs
        assert cell["cell"]["traffic"] == w["traffic"] and cell["cell"]["chips"] == w["chips"]
        assert len(w["why"]) <= 200 and NAME.match(w["name"]) and NAME.match(w["traffic"])
        cells.add(w["name"])
    assert "setup_s" in e2e
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        assert os.path.exists(os.path.join(HERE, "metrics", f"{m['name']}.py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:  # every cell reports setup_s, one more end-to-end and one per-layer metric
        assert len(harness.spec_metrics(cell, "end_to_end")) >= 2
        assert harness.spec_metrics(cell, "per_layer")


def test_forbidden_modules_compares_top_level_names_whole():
    loaded = {"bmcnet_esr_torch.models": 1, "jaxtyping": 1, "flaxen": 1, "jax.numpy": 1,
              "bmcnet_esr_tpu": 1, "bmcnet_esr_tpu_x": 1}
    assert harness.forbidden_modules(loaded) == ["bmcnet_esr_tpu", "jax.numpy"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            for mod in _imports(os.path.join(ref, name)):
                assert mod.split(".")[0] not in ("bmcnet_esr_torch", "bmcnet_esr_tpu", "jax",
                                                 "jaxlib", "flax"), (name, mod)
    code = ("import sys; import benchmark.reference.model, benchmark.reference.quant, "
            "benchmark.reference.raster, benchmark.reference.train, benchmark.reference.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert "bmcnet_esr_torch" not in out and "'jax'" not in out


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path, monkeypatch):
    """A later change adds a cell, its configuration, its traffic mix and a
    per-layer metric as files and entries of ``BENCHMARK.json``: the harness
    finds them with no edit of its code."""
    from benchmark.tests import tiny

    copy = tmp_path / "benchmark"
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cell = json.load(open(copy / "workloads" / "rgb_bf16_infer.json"))
    cell.update(name="new_cell", config="new_config", traffic="new_mix")
    (copy / "workloads" / "new_cell.json").write_text(json.dumps(cell))
    config = json.load(open(copy / "configs" / "bmcnet_full_rgb_x4_bf16.json"))
    (copy / "configs" / "new_config.json").write_text(json.dumps({**config, "name": "new_config"}))
    mix = json.load(open(copy / "mixes" / "recordings_128.json"))
    (copy / "mixes" / "new_mix.json").write_text(json.dumps({**mix, "name": "new_mix"}))
    (copy / "metrics" / "new.metric.py").write_text(
        "def read(run):\n    return run['window']['windows'] / 2\n")
    spec = _spec()
    spec["workloads"].append({"name": "new_cell", "config": "new_config", "traffic": "new_mix",
                              "chips": 1, "why": "a cell added as files"})
    for m in spec["end_to_end"]:
        if m["name"] == "windows_per_s":
            m["workloads"].append("new_cell")
    spec["per_layer"].append({"name": "new.metric", "unit": "windows", "better": "higher",
                              "source": "program_counter", "layer": "file rollout",
                              "moves": "windows_per_s", "workloads": ["new_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "HERE", str(copy))
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    result = tiny.run(harness, "new_cell")
    run = result.pop("_run")
    assert result["correct"] and result["failed"] == 0
    assert set(result["metrics"]) == {"windows_per_s", "setup_s"}
    assert [m["name"] for m in harness.spec_metrics("new_cell", "per_layer")] == ["new.metric"]
    assert harness.metric_reader("new.metric")(run) == run["window"]["windows"] / 2


def test_a_cell_that_benchmark_json_does_not_list_is_refused():
    with pytest.raises(harness.Refused):
        harness.spec_metrics("no_such_cell", "end_to_end")
