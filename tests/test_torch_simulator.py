"""Port parity for the event simulator: bmcnet_esr_torch's
``data/simulator.py`` against the JAX package's on the same frames.

``jax.random`` cannot be reproduced in torch, so the per-pixel thresholds
and noise gains of the JAX simulator are carried across with
``simulator_state_from_jax``.  With the noise off the event lists are then
identical, row for row (lengths, values and order), over several chunks
with a padded last chunk, mismatch, leak and refractory on: the port rounds
the model's three multiply-adds once, as the JAX program's fused ones do.
With the noise on, the draws are held by their distribution: Poisson counts
per pixel within 4 sigma of their rate.
"""

import os
import sys

import numpy as np
import pytest
import torch

from bmcnet_esr_tpu.data import simulator as jsim
from bmcnet_esr_tpu.data.demo import demo_video as jdemo_video

from bmcnet_esr_torch.data import simulator as sim
from bmcnet_esr_torch.data.demo import demo_video


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several worker processes run the suite at once: two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


HW = (20, 28)


@pytest.fixture(scope="module")
def video():
    frames, ts = demo_video(19, HW, 3)
    return frames, ts


def _pair(cfg_kwargs, hw=HW):
    """A JAX simulator and the port's with its state carried across."""
    j = jsim.EventSimulator(hw, jsim.SimulatorConfig(**cfg_kwargs))
    state = sim.simulator_state_from_jax(j._c_pos, j._c_neg, j._noise_gain)
    return j, sim.EventSimulator(hw, sim.SimulatorConfig(**cfg_kwargs), device="cpu", state=state)


CONFIGS = {
    "default": {},
    "mismatch_leak_refractory": dict(threshold_sigma=0.2, leak_rate_hz=3.0, refractory_s=2e-4,
                                     chunk=4, seed=5),
    "capped": dict(threshold_sigma=0.1, leak_rate_hz=0.5, refractory_s=1e-3, chunk=5,
                   max_events_per_pixel=3, contrast_threshold=0.05, seed=2),
}


def test_demo_video_matches_jax():
    for a, b in zip(demo_video(5, (12, 16), 4), jdemo_video(5, (12, 16), 4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_noise_free_event_list_matches_jax(video, name):
    frames, ts = video
    j, t = _pair(CONFIGS[name])
    want = j.simulate(frames, ts)
    got = t.simulate(frames, ts)
    assert got.dtype == want.dtype == np.float64 and len(want) > 1000
    np.testing.assert_array_equal(got, want)
    # the per-interval count images of the same kernel, exactly
    j, t = _pair(CONFIGS[name])
    np.testing.assert_array_equal(t.simulate_counts(frames, ts), j.simulate_counts(frames, ts))


def test_uint8_frames_and_a_second_call_match_jax(video):
    """uint8 frames; a second ``simulate`` call on the same simulator starts
    from the first frame again, as the JAX one does."""
    frames, ts = video
    u8 = np.clip(frames * 255, 0, 255).astype(np.uint8)
    j, t = _pair(CONFIGS["mismatch_leak_refractory"])
    for _ in range(2):
        np.testing.assert_array_equal(t.simulate(u8, ts), j.simulate(u8, ts))


@pytest.mark.parametrize("n", [0, 3000])
def test_arrival_stable_order(n):
    """Events sorted by (interval, t), ties (``-0.0`` equal to ``0.0``) in
    arrival order; no events give an empty permutation."""
    rng = np.random.default_rng(0)
    interval = np.sort(rng.integers(0, 5, n))
    rng.shuffle(interval[2 * n // 3:])  # noise events come after every interval's signal
    t = rng.choice(np.array([0.0, -0.0, 1e-3, 2.5e-3, 4e-3], np.float32), n)
    t[::7] = rng.random(len(t[::7])).astype(np.float32) * 4e-3
    want = np.lexsort((np.arange(n), t.astype(np.float64), interval))
    got = sim._arrival_stable_order(torch.from_numpy(interval), torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got, want)


def test_state_replaces_the_sampled_thresholds():
    state = sim.simulator_state_from_jax(np.full((3, 4), 0.2), np.full((3, 4), 0.3),
                                         np.where(np.eye(3, 4) > 0, 50.0, 1.0))
    assert all(v.dtype == torch.float32 and v.shape == (3, 4) for v in state.values())
    s = sim.EventSimulator((3, 4), device="cpu", state=state)
    assert torch.equal(s._c_pos, state["c_pos"]) and s._inv_c is None
    np.testing.assert_array_equal(s.hot_pixels, np.eye(3, 4) > 0)
    with pytest.raises(ValueError, match="resolution"):
        sim.EventSimulator((4, 4), device="cpu", state=state)


def test_sampled_thresholds_follow_the_config():
    cfg = sim.SimulatorConfig(contrast_threshold=0.2, threshold_sigma=0.25, threshold_min=0.1,
                              hot_pixel_fraction=0.1, seed=1)
    s = sim.EventSimulator((64, 64), cfg, device="cpu")
    c = s._c_pos.numpy()
    assert c.min() >= 0.1 and abs(c.mean() - 0.2) < 0.01 and abs(c.std() - 0.05) < 0.01
    assert not np.array_equal(c, s._c_neg.numpy())
    assert abs(s.hot_pixels.mean() - 0.1) < 0.02
    again = sim.EventSimulator((64, 64), cfg, device="cpu")
    assert torch.equal(again._c_pos, s._c_pos)
    uniform = sim.EventSimulator((8, 8), sim.SimulatorConfig(), device="cpu")
    assert uniform._inv_c is not None and not uniform.hot_pixels.any()


def test_constant_video_and_argument_checks():
    s = sim.EventSimulator((8, 12), device="cpu")
    frames = np.full((6, 8, 12), 0.5, np.float32)
    ts = np.arange(6) / 100.0
    assert s.simulate(frames, ts).shape == (0, 4)
    assert s.simulate(frames[:1], ts[:1]).shape == (0, 4)
    with pytest.raises(ValueError, match="resolution"):
        s.simulate(np.zeros((3, 4, 4), np.float32), ts[:3])
    with pytest.raises(ValueError, match="one timestamp"):
        s.simulate(frames, ts[:3])
    with pytest.raises(ValueError, match="non-decreasing"):
        s.simulate(frames, ts[::-1])


def _noise_run(cfg, hw=(32, 32), n=41):
    frames = np.full((n, *hw), 0.5, np.float32)
    ts = np.arange(n) / 100.0
    s = sim.EventSimulator(hw, cfg, device="cpu")
    return s, frames, ts


def test_noise_rate_is_poisson():
    """Background noise on a static scene: events per pixel within 4 sigma of
    the Poisson mean ``rate * T`` over all pixels, ON and OFF in about equal
    shares, every timestamp inside the video."""
    cfg = sim.SimulatorConfig(noise_rate_hz=10.0, seed=3)
    s, frames, ts = _noise_run(cfg)
    ev = s.simulate(frames, ts)
    lam = cfg.noise_rate_hz * (ts[-1] - ts[0]) * 32 * 32
    assert abs(len(ev) - lam) < 4 * np.sqrt(lam)
    assert abs((ev[:, 3] > 0).mean() - 0.5) < 4 * 0.5 / np.sqrt(len(ev))
    assert ev[:, 2].min() >= ts[0] and ev[:, 2].max() <= ts[-1]
    # the generator is carried across calls: a second call draws anew
    assert not np.array_equal(s.simulate(frames, ts), ev)


def test_hot_pixels_rate_ratio():
    """Hot pixels fire at ``hot_pixel_gain`` times the others' rate: the
    ratio of the two mean counts within 4 sigma of the gain."""
    cfg = sim.SimulatorConfig(noise_rate_hz=20.0, hot_pixel_fraction=0.05, hot_pixel_gain=10.0,
                              max_noise_per_pixel=8, seed=4)
    s, frames, ts = _noise_run(cfg)
    counts = s.simulate_counts(frames, ts).sum((0, 1))
    hot = s.hot_pixels
    assert hot.sum() > 10
    lam = cfg.noise_rate_hz * (ts[-1] - ts[0])
    mh, mc = counts[hot].mean(), counts[~hot].mean()
    assert abs(mc - lam) < 4 * np.sqrt(lam / (~hot).sum())
    ratio_sigma = cfg.hot_pixel_gain * np.sqrt(1 / (lam * cfg.hot_pixel_gain * hot.sum())
                                               + 1 / (lam * (~hot).sum()))
    assert abs(mh / mc - cfg.hot_pixel_gain) < 4 * ratio_sigma


def test_counts_equal_the_event_list_with_noise(video):
    """Two simulators of one seed: ``simulate_counts`` equals the
    per-interval counts of ``simulate``'s events (signal and noise).  The
    event list holds the intervals one after the other, so its rows split
    into blocks of the counts' per-interval totals; each block lies in its
    interval's span and counts exactly as that interval's image."""
    frames, ts = video
    cfg = sim.SimulatorConfig(threshold_sigma=0.1, noise_rate_hz=30.0, hot_pixel_fraction=0.05,
                              refractory_s=1e-4, chunk=4, seed=5)
    ev = sim.EventSimulator(HW, cfg, device="cpu").simulate(frames, ts)
    counts = sim.EventSimulator(HW, cfg, device="cpu").simulate_counts(frames, ts)
    per = counts.reshape(len(counts), -1).sum(1).astype(np.int64)
    assert per.sum() == len(ev)
    which = np.repeat(np.arange(len(per)), per)
    assert np.all((ev[:, 2] >= ts[which]) & (ev[:, 2] <= ts[which + 1] + 1e-9))
    want = np.zeros_like(counts)
    np.add.at(want, (which, (ev[:, 3] < 0).astype(int), ev[:, 1].astype(int),
                     ev[:, 0].astype(int)), 1)
    np.testing.assert_array_equal(counts, want)


@pytest.mark.parametrize("factor", [2, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_downscale_matches_jax_and_the_fallback(video, factor, dtype, monkeypatch):
    """``downscale_frames`` is the JAX package's (``cv2``); without ``cv2``
    the fallback gives the same frames at integer factors (float32 within
    1e-6, uint8 within one step)."""
    frames = video[0] if dtype == np.float32 else (video[0] * 255).astype(np.uint8)
    got = sim.downscale_frames(frames, factor)
    np.testing.assert_array_equal(got, jsim.downscale_frames(frames, factor))
    monkeypatch.setitem(sys.modules, "cv2", None)
    fallback = sim.downscale_frames(frames, factor)
    assert fallback.dtype == got.dtype and fallback.shape == got.shape
    np.testing.assert_allclose(fallback.astype(np.float64), got.astype(np.float64), rtol=0,
                               atol=1e-6 if dtype == np.float32 else 1)


def test_multiscale_h5_and_txt_match_jax(video, tmp_path):
    import h5py

    frames, ts = video
    frames = np.concatenate([frames] * 2, 2)[:, :16, :32]
    kw = dict(scales=(1, 2, 4), config=dict(contrast_threshold=0.2, seed=9), store_frames=True)
    want = jsim.simulate_multiscale(frames, ts, **{**kw, "config": jsim.SimulatorConfig(
        **kw["config"])}, out_h5=str(tmp_path / "j.h5"), txt_dir=str(tmp_path / "jtxt"))
    got = sim.simulate_multiscale(frames, ts, **{**kw, "config": sim.SimulatorConfig(
        **kw["config"])}, out_h5=str(tmp_path / "t.h5"), txt_dir=str(tmp_path / "ttxt"),
        device="cpu")
    assert list(got) == list(want) == ["ori", "down2", "down4"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        with open(tmp_path / "jtxt" / f"{k}.txt") as a, open(tmp_path / "ttxt" / f"{k}.txt") as b:
            assert a.read() == b.read()
    with h5py.File(tmp_path / "j.h5") as a, h5py.File(tmp_path / "t.h5") as b:
        np.testing.assert_array_equal(a.attrs["sensor_resolution"], b.attrs["sensor_resolution"])
        names = []
        a.visit(names.append)
        other = []
        b.visit(other.append)
        assert names == other
        for n in names:
            if isinstance(a[n], h5py.Dataset):
                np.testing.assert_array_equal(a[n][()], b[n][()], err_msg=n)
            assert dict(a[n].attrs).keys() == dict(b[n].attrs).keys()
            for key in a[n].attrs:
                np.testing.assert_array_equal(a[n].attrs[key], b[n].attrs[key])
    with pytest.raises(ValueError, match="inconsistent"):
        sim.simulate_multiscale(frames, ts, scales=(1, 3), prefixes=("ori", "down2"),
                                out_h5=str(tmp_path / "bad.h5"), device="cpu")


def test_cli_simulate_on_the_cpu(tmp_path, video):
    """``cli.simulate --device cpu`` on a ``.npy`` video writes the h5 and
    dumps the JAX CLI writes for the same arguments."""
    from bmcnet_esr_tpu.cli import simulate as jcli

    from bmcnet_esr_torch.cli import simulate as cli

    npy = str(tmp_path / "video.npy")
    np.save(npy, np.clip(video[0] * 255, 0, 255).astype(np.uint8)[:, :16, :24])
    args = ["--frames", npy, "--fps", "120", "--scales", "1,2", "--contrast", "0.2",
            "--refractory_us", "100", "--leak_rate", "1.0"]
    cli.main(args + ["--txt_dir", str(tmp_path / "t"), "--out_h5", str(tmp_path / "t.h5"),
                     "--device", "cpu"])
    jcli.main(args + ["--txt_dir", str(tmp_path / "j")])
    for k in ("ori", "down2"):
        with open(tmp_path / "j" / f"{k}.txt") as a, open(tmp_path / "t" / f"{k}.txt") as b:
            assert a.read() == b.read()
    assert os.path.getsize(tmp_path / "t.h5") > 0
    with pytest.raises(SystemExit):
        cli.main(["--frames", npy, "--device", "cpu"])  # neither --out_h5 nor --txt_dir
