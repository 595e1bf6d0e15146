"""Port parity for the inference path: bmcnet_esr_torch's h5 dataset,
InferenceEngine and cli.infer against the reference goldens and the JAX
engine on the same regenerated fixture.

Tolerances: the reference goldens' own (rtol 1e-4, atol 2e-5); the JAX
engine at small width, float32 on the CPU, differs only by summation order
(rtol 1e-5, atol 1e-7 on MSEs of order 1).  The GPU side is in
tests/test_torch_cuda.py.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from bmcnet_esr_tpu.data import DatasetConfig as JDatasetConfig
from bmcnet_esr_tpu.data import EventH5Dataset as JEventH5Dataset
from bmcnet_esr_tpu.inference import InferenceEngine as JInferenceEngine
from bmcnet_esr_tpu.models import BMCNetPlain as JBMCNetPlain

from bmcnet_esr_torch.cli import infer as cli_infer
from bmcnet_esr_torch.data import (
    DatasetConfig,
    EventH5Dataset,
    SequenceConfig,
    write_synthetic_fixture,
)
from bmcnet_esr_torch.inference import InferenceEngine, load_model_for_inference
from bmcnet_esr_torch.models import BMCNetPlain, params_from_jax
from bmcnet_esr_torch.utils import DeviceTimer, YamlResultLogger

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
CKPT = os.path.join(GOLDENS, "plain_nfs_x4_ckpt.npz")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once: torch's default
    of one thread per core oversubscribes the CPU and slows small ops by
    orders of magnitude, so these tests use two."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def g():
    return dict(np.load(os.path.join(GOLDENS, "infer_goldens.npz")))


def _fixture(path, g, seed=None, scale_events=1.0):
    h, w = (int(v) for v in g["sensor"])
    write_synthetic_fixture(
        str(path), (h, w), ("ori", "down4"),
        {"ori": int(g["events_ori"] * scale_events), "down4": int(g["events_down4"] * scale_events)},
        seed=int(g["meta"][6]) if seed is None else seed,
    )
    return str(path)


@pytest.fixture(scope="module")
def files(g, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_infer")
    return _fixture(d / "fixture.h5", g), _fixture(d / "short.h5", g, seed=5, scale_events=0.7)


def _cfg(g, cls=DatasetConfig):
    scale, window, sliding, seqn, seql, step, _ = (int(v) for v in g["meta"])
    seq = SequenceConfig(seql, seqn, step)
    return cls(scale=scale, ori_scale="down4", window=window, sliding_window=sliding,
               **({"sequence": seq} if cls is DatasetConfig else {}))


@pytest.fixture(scope="module")
def small(g):
    """A small random plain model (n_c=8, n_b=2, x4) in both frameworks."""
    jm = JBMCNetPlain(scale=4, n_c=8, n_b=2)
    v = jm.init(jax.random.key(3), np.zeros((1, 2, 16, 24, 2), np.float32), *jm.init_state(1, 16, 24))
    tm = BMCNetPlain(scale=4, n_c=8, n_b=2)
    tm.load_state_dict(params_from_jax(v), strict=True)
    return jm, v, tm


def _engine(model, g, **kw):
    kw.setdefault("chunk_size", 16)
    kw.setdefault("visualize", False)
    return InferenceEngine(model, _cfg(g), device="cpu", **kw)


def _pw(result):
    return result["per_window"]["esr_mse"], result["per_window"]["bicubic_mse"]


def test_dataset_windows_match_jax(g, files):
    for mode, need_gt in (("events", True), ("time", True), ("events", False)):
        kw = dict(scale=4, ori_scale="down4", window=256, sliding_window=128, mode=mode,
                  need_gt_events=need_gt)
        if mode == "time":
            kw.update(window=0.05, sliding_window=0.02)
        ours, ref = EventH5Dataset(files[0], DatasetConfig(**kw)), JEventH5Dataset(files[0], JDatasetConfig(**kw))
        try:
            assert len(ours) == len(ref)
            assert dataclasses.astuple(ours.layout) == dataclasses.astuple(ref.layout)
            np.testing.assert_array_equal(ours.event_indices, ref.event_indices)
            assert (ours.padded_window, ours.gt_window) == (ref.padded_window, ref.gt_window)
            for i in (0, len(ours) // 2, len(ours) - 1):
                a, b = ours.get_window(i), ref.get_window(i, seed=0)
                for k in ("inp_events", "gt_events", "inp_len", "gt_len"):
                    np.testing.assert_array_equal(a[k], b[k])
        finally:
            ours.close()
            ref.close()


def test_dataset_unported_options_raise(files):
    cfg = DatasetConfig.from_dict({"scale": 4, "ori_scale": "down4", "add_noise": {"enabled": True}})
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        EventH5Dataset(files[0], cfg)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        EventH5Dataset(files[0], DatasetConfig(scale=4, ori_scale="down4", need_gt_frame=True))


def test_infer_file_reproduces_reference_goldens(g, files):
    """The released checkpoint through the port's engine reproduces the
    reference's per-window MSEs (tests/test_infer_parity.py tolerances)."""
    model = load_model_for_inference(CKPT, 4, variant="plain", device="cpu")
    r = _engine(model, g).infer_file(files[0], return_per_window=True)
    esr, bic = _pw(r)
    assert len(esr) == len(g["esr_mse"]) + 2  # the reference stops seql-seqn pairs early
    np.testing.assert_allclose(esr[: len(g["esr_mse"])], g["esr_mse"], rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(bic[: len(g["bicubic_mse"])], g["bicubic_mse"], rtol=1e-4, atol=2e-5)
    assert r["gt_available"] is True and r["h2d_overlap_skips"] >= 0
    assert r["params"] == pytest.approx(1.003296)
    assert r["macs"] > 0


def test_infer_file_matches_jax_engine_and_chunking(g, files, small):
    """Same fixture, same small random weights: per-window arrays equal the
    JAX engine's; chunk size and h2d overlap change nothing (bit-exact)."""
    jm, v, tm = small
    want = JInferenceEngine(jm, v, _cfg(g, JDatasetConfig), chunk_size=32, visualize=False).infer_file(
        files[0], return_per_window=True)
    base = _engine(tm, g, chunk_size=32).infer_file(files[0], return_per_window=True)
    for ours, ref in zip(_pw(base), _pw(want)):
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)
    for kw in ({"chunk_size": 3}, {"chunk_size": 7, "h2d_overlap": False}):
        other = _engine(tm, g, **kw).infer_file(files[0], return_per_window=True)
        for a, b in zip(_pw(other), _pw(base)):
            np.testing.assert_array_equal(a, b)


def test_batched_equals_solo(g, files, small):
    """Two streams of different lengths rolled out as one batch equal their
    solo rollouts exactly (the padded tail of the shorter one is masked)."""
    _, _, tm = small
    eng = _engine(tm, g, chunk_size=8, extra_metrics=("psnr",))
    solo = [eng.infer_file(f) for f in files]
    batched = eng.infer_file_batch(list(files))
    for s, b in zip(solo, batched):
        for k in ("esr_mse", "bicubic_mse", "esr_psnr"):
            assert b[k] == s[k], k
        assert b["gt_available"] and "h2d_overlap_skips" in b


def test_batched_rejects_mixed_resolutions(g, files, tmp_path, small):
    other = str(tmp_path / "wide.h5")
    write_synthetic_fixture(other, (64, 112), ("ori", "down4"), {"ori": 48000, "down4": 3000}, seed=1)
    with pytest.raises(ValueError, match="equal resolutions"):
        _engine(small[2], g).infer_file_batch([files[0], other])


def test_extra_metrics_follow_the_users_order(g, files, small):
    _, _, tm = small
    a = _engine(tm, g, extra_metrics=("psnr", "ssim")).infer_file(files[1])
    b = _engine(tm, g, extra_metrics=("ssim", "psnr")).infer_file(files[1])
    assert a["esr_psnr"] == b["esr_psnr"] and a["esr_ssim"] == b["esr_ssim"]
    assert a["esr_psnr"] != a["esr_ssim"]


def test_augment_is_forced_off(g, files, small, caplog):
    _, _, tm = small
    cfg = _cfg(g)
    cfg = dataclasses.replace(cfg, augment=dataclasses.replace(cfg.augment, enabled=True))
    eng = InferenceEngine(tm, cfg, chunk_size=16, visualize=False, device="cpu")
    assert not eng.config.augment.enabled
    assert "augment" in caplog.text
    assert eng.infer_file(files[1])["esr_mse"] == _engine(tm, g).infer_file(files[1])["esr_mse"]


def test_cli_writes_results_and_pngs(tmp_path):
    """plain_small.npz (x2, n_c=8) through the CLI on the CPU, PNG streams on."""
    data = write_synthetic_fixture(
        str(tmp_path / "x2.h5"), (64, 96), ("ori", "down2", "down4"),
        {"ori": 16000, "down2": 4000, "down4": 1000}, seed=2,
    )
    out = tmp_path / "out"
    res = cli_infer.main([
        "--model_path", os.path.join(GOLDENS, "plain_small.npz"), "--variant", "plain",
        "--n_c", "8", "--n_b", "2", "--scale", "2", "--ori_scale", "down4", "--window", "128",
        "--sliding_window", "64", "--need_gt_events", "--data_path", data,
        "--output_path", str(out), "--device", "cpu", "--chunk_size", "8", "--psnr",
    ])
    assert np.isfinite(res["mean"]["esr_mse"]) and "esr_psnr" in res["mean"]
    assert (out / "inference_all.yml").is_file()
    root = out / "x2.h5"
    assert (root / "inference.yml").is_file()
    for stream in ("lr_event_img", "hr_esr_event_img", "hr_bicubic_event_img", "hr_gt_event_img"):
        assert len(os.listdir(root / "event_img" / stream)) == 14  # 15 windows, 14 pairs


@pytest.mark.parametrize("dtype", ["int8", "int8_pall"])
def test_cli_int8_dtypes_run(dtype, files, g, tmp_path):
    """``cli.infer --dtype int8*`` on the CPU with the released checkpoint:
    the int8 model calibrates on the file's first windows, and its mean
    esr_mse stays within 5 % of the float32 run's."""
    scale, window, sliding, _, seql, _, _ = (int(v) for v in g["meta"])
    common = ["--model_path", CKPT, "--variant", "plain", "--scale", str(scale),
              "--ori_scale", "down4", "--window", str(window), "--sliding_window", str(sliding),
              "--seql", str(seql), "--need_gt_events", "--no_images", "--device", "cpu",
              "--chunk_size", "8", "--data_path", files[1]]
    f32 = cli_infer.main(common + ["--output_path", str(tmp_path / "f32")])["mean"]["esr_mse"]
    q = cli_infer.main(common + ["--output_path", str(tmp_path / dtype), "--dtype", dtype])
    assert np.isfinite(q["mean"]["esr_mse"]) and q["mean"]["esr_mse"] == pytest.approx(f32, rel=5e-2)
    assert (tmp_path / dtype / "inference_all.yml").is_file()


@pytest.mark.parametrize("argv,item", [
    (["--mesh_devices", "2"], "item 8"),
    (["--ema"], "item 7"),
])
def test_cli_unported_options_exit_naming_roadmap(argv, item, files):
    with pytest.raises(SystemExit, match=item):
        cli_infer.main(["--model_path", CKPT, "--data_path", files[0], "--output_path", "x",
                        "--device", "cpu"] + argv)


def test_cuda_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model_for_inference(CKPT, 4, variant="plain")


def test_cli_int8_on_cuda_raises_without_cuda(files):
    """``--dtype int8_pall --device cuda`` never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_infer.main(["--model_path", CKPT, "--variant", "plain", "--data_path", files[0],
                        "--output_path", "x", "--dtype", "int8_pall", "--device", "cuda"])


def test_yaml_logger_writes_plain_types(tmp_path):
    import yaml

    with YamlResultLogger(str(tmp_path / "r.yml")) as lg:
        lg.log_info("run")
        lg.log_dict({"a": np.float32(1.5), "b": np.arange(2), "c": torch.tensor(2.0)}, "results")
    assert yaml.safe_load(open(tmp_path / "r.yml")) == {
        "info": ["run"], "results": {"a": 1.5, "b": [0, 1], "c": 2.0}}


def test_device_timer_on_cpu():
    with DeviceTimer("t", device="cpu") as t:
        sum(range(1000))
    assert t.interval_ms >= 0
