"""Port parity for the auxiliary event encodings and the native event ops:
bmcnet_esr_torch's ``ops/encodings.py``, ``ops/batch.py::
batch_events_to_voxels`` and ``native`` against the JAX package on the same
numpy inputs.

Counts, masks, stacks, ``stack_to_count`` and ``event_restore`` sum or
copy integers, so they are compared bit for bit.  Voxels weigh events by
fractional temporal weights, accumulated in another order: within atol
1e-6.  The native ops are held to the JAX package's numpy
``event_redistribute_stack`` and ``events_to_channels``: exactly in linear
mode, and in random mode each event within its cell's bin.
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bmcnet_esr_tpu.ops import batch as jbatch
from bmcnet_esr_tpu.ops import encodings as jenc

from bmcnet_esr_torch import native
from bmcnet_esr_torch.kernels import _build
from bmcnet_esr_torch.ops import batch, encodings

VOXEL_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several worker processes run the suite at once: two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _window(seed, n, hw, pad=0, on_boundaries=False):
    """``[4, n]`` float32 events: coordinates a little past the sensor,
    sorted timestamps in [0, 1] (with ``on_boundaries``, some exactly on
    stack bin edges), polarity +-1, the last ``pad`` zero padding."""
    h, w = hw
    rng = np.random.default_rng(seed)
    ev = np.zeros((4, n), np.float32)
    ev[0] = rng.integers(-2, w + 2, n)
    ev[1] = rng.integers(-2, h + 2, n)
    ts = rng.random(n)
    if on_boundaries:
        ts[: n // 4] = rng.integers(0, 9, n // 4) / 8
    ev[2] = np.sort(ts)
    ev[3] = rng.integers(0, 2, n) * 2 - 1
    if pad:
        ev[:, -pad:] = 0
    return ev


HW = [(16, 16), (9, 13)]


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("flip_y", [True, False])
@pytest.mark.parametrize("num_bins", [1, 3, 5])
def test_voxel_matches_jax(hw, flip_y, num_bins):
    ev = _window(0, 700, hw, pad=30)
    want = np.asarray(jenc.events_to_voxel(*map(jnp.asarray, ev), num_bins, hw, flip_y=flip_y))
    got = encodings.events_to_voxel(*map(_t, ev), num_bins, hw, flip_y=flip_y).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=VOXEL_ATOL)
    assert np.abs(want).sum() > 0


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("flip_y", [False, True])
def test_mask_matches_jax(hw, flip_y):
    ev = _window(1, 300, hw, pad=20)
    ev[3, :50] *= 0.5  # |p| other than 0 and 1: the larger per pixel wins
    want = np.asarray(jenc.events_to_mask(jnp.asarray(ev[0]), jnp.asarray(ev[1]),
                                          jnp.asarray(ev[3]), hw, flip_y=flip_y))
    got = encodings.events_to_mask(_t(ev[0]), _t(ev[1]), _t(ev[3]), hw, flip_y=flip_y).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_bins", [1, 4, 8])
@pytest.mark.parametrize("n", [3, 4, 400])
def test_stack_bin_weights_match_jax(num_bins, n):
    """Inclusive bins (an event on an edge is in both bins) and the validity
    rule ``sum(ts) == 0 | n <= 3``."""
    ts = _window(2, n, (8, 8), on_boundaries=True)[2]
    jm, jv = jenc._stack_bin_weights(jnp.asarray(ts), num_bins, jnp.float32)
    m, v = encodings._stack_bin_weights(_t(ts), num_bins, torch.float32)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert float(v) == float(jv) == (0.0 if n <= 3 else 1.0)
    zm, zv = encodings._stack_bin_weights(torch.zeros(n), num_bins, torch.float32)
    assert float(zv) == float(jenc._stack_bin_weights(jnp.zeros(n), num_bins, jnp.float32)[1]) == 0


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("num_bins", [1, 4, 8])
@pytest.mark.parametrize("polarity", [False, True])
def test_stacks_match_jax(hw, num_bins, polarity):
    ev = _window(3, 500, hw, pad=25, on_boundaries=True)
    jfn = jenc.events_to_stack_polarity if polarity else jenc.events_to_stack_no_polarity
    fn = encodings.events_to_stack_polarity if polarity else encodings.events_to_stack_no_polarity
    want = np.asarray(jfn(*map(jnp.asarray, ev), num_bins, hw))
    got = fn(*map(_t, ev), num_bins, hw).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == ((2,) if polarity else ()) + (num_bins,) + hw
    # a degenerate window gives zeros of the same shape
    short = fn(*map(_t, ev[:, :3]), num_bins, hw)
    assert short.shape == got.shape and not short.any()


def test_hot_event_mask_matches_jax():
    rng = np.random.default_rng(4)
    rate = rng.random((12, 10)).astype(np.float32)
    for idx, max_px, max_rate in ((7, 20, 0.8), (3, 20, 0.8), (6, 200, 0.5), (9, 1, 0.0)):
        want = np.asarray(jenc.get_hot_event_mask(jnp.asarray(rate), idx, max_px, 5, max_rate))
        got = encodings.get_hot_event_mask(_t(rate), idx, max_px, 5, max_rate).numpy()
        np.testing.assert_array_equal(got, want)


def test_hot_event_mask_ties_take_the_lower_index():
    """Tied rates above ``max_rate`` that straddle ``max_px``: the port takes
    the lower flat indices first (a stable descending sort), which is how
    ``lax.top_k`` orders ties, so the two masks agree (``torch.topk``
    leaves the order of ties open)."""
    rate = np.full((6, 5), 0.1, np.float32)
    tied = [3, 7, 11, 19, 23, 28]
    rate.reshape(-1)[tied] = 0.9
    rate.reshape(-1)[[1, 2]] = 0.95
    got = encodings.get_hot_event_mask(_t(rate), 10, max_px=5, min_obvs=5).numpy()
    want = np.asarray(jenc.get_hot_event_mask(jnp.asarray(rate), 10, max_px=5, min_obvs=5))
    np.testing.assert_array_equal(got, want)
    masked = np.flatnonzero(got.reshape(-1) == 0).tolist()
    assert masked == [1, 2] + tied[:3]


def test_stack_to_count_matches_jax():
    rng = np.random.default_rng(5)
    stack = (rng.integers(-6, 7, (3, 4, 5, 7)) / 2).astype(np.float32)  # halves round to even
    want = np.asarray(jenc.stack_to_count(jnp.asarray(stack)))
    np.testing.assert_array_equal(encodings.stack_to_count(_t(stack)).numpy(), want)


@pytest.mark.parametrize("voxel_bins", [None, 3])
def test_event_conversion_matches_jax(voxel_bins):
    hw = (9, 13)
    lists = np.stack([_window(6 + i, 256, hw, pad=16).T for i in range(3)])
    rng = np.random.default_rng(6)
    for item in lists:  # unsorted lists with repeated timestamps
        rng.shuffle(item[:200])
        item[:10, 2] = item[10, 2]
    want = jenc.event_conversion(jnp.asarray(lists), 5, hw, voxel_bins)
    got = encodings.event_conversion(_t(lists), 5, hw, voxel_bins)
    assert set(got) == set(want) == {"e_cnt", "e_voxel", "e_stack"}
    np.testing.assert_array_equal(got["e_cnt"].numpy(), np.asarray(want["e_cnt"]))
    np.testing.assert_array_equal(got["e_stack"].numpy(), np.asarray(want["e_stack"]))
    np.testing.assert_allclose(got["e_voxel"].numpy(), np.asarray(want["e_voxel"]),
                               rtol=0, atol=VOXEL_ATOL)


def test_event_restore_matches_jax():
    rng = np.random.default_rng(7)
    ev = rng.random((2, 50, 4)).astype(np.float32)
    ev[..., 3] = rng.choice([-1.0, -0.3, 0.0, 0.4, 1.0], (2, 50))
    want = np.asarray(jenc.event_restore(jnp.asarray(ev), (9, 13)))
    np.testing.assert_array_equal(encodings.event_restore(_t(ev), (9, 13)).numpy(), want)


def test_batch_events_to_voxels_matches_jax():
    hw = (9, 13)
    ev = np.stack([_window(8 + i, 200, hw, pad=10) for i in range(6)]).reshape(2, 3, 4, 200)
    want = np.asarray(jbatch.batch_events_to_voxels(jnp.asarray(ev), 4, hw))
    got = batch.batch_events_to_voxels(_t(ev), 4, hw).numpy()
    assert got.shape == (2, 3) + hw + (4,)
    np.testing.assert_allclose(got, want, rtol=0, atol=VOXEL_ATOL)


def _stack(seed, shape):
    rng = np.random.default_rng(seed)
    s = rng.integers(-3, 4, shape).astype(np.float32)
    s[rng.random(shape) < 0.6] = 0
    return s


STACK_SHAPES = [(2, 3, 5, 6), (3, 2, 4, 3, 5)]


@pytest.mark.parametrize("shape", STACK_SHAPES)
@pytest.mark.parametrize("mode", ["linear", "random"])
def test_numpy_redistribution_matches_jax(shape, mode):
    """The port's numpy ``event_redistribute_stack`` is the JAX package's:
    the same events, and in random mode the same draws from the same rng."""
    s = _stack(9, shape)
    got = encodings.event_redistribute_stack(s, mode, rng=np.random.default_rng(1))
    want = jenc.event_redistribute_stack(s, mode, rng=np.random.default_rng(1))
    np.testing.assert_array_equal(got, want)
    empty = encodings.event_redistribute_stack(np.zeros(shape, np.float32))
    np.testing.assert_array_equal(empty, jenc.event_redistribute_stack(np.zeros(shape, np.float32)))


@pytest.mark.parametrize("shape", STACK_SHAPES)
def test_native_redistribution_linear_matches_jax_numpy(shape):
    s = _stack(10, shape)
    np.testing.assert_array_equal(native.redistribute_stack(s, "linear"),
                                  jenc.event_redistribute_stack(s, "linear"))


@pytest.mark.parametrize("shape", STACK_SHAPES)
def test_native_redistribution_random_stays_in_bins(shape):
    """Random mode draws from the library's own generator: every item has
    the numpy version's events per cell (x, y, p), each with a timestamp
    inside its cell's bin ``[c/C + 1/(100C), (c+1)/C]``."""
    s = _stack(11, shape)
    got = native.redistribute_stack(s, "random", seed=3)
    want = jenc.event_redistribute_stack(s, "linear")
    assert got.shape == want.shape
    num_bins = shape[-3]
    for g, w in zip(got, want):
        n = int(np.count_nonzero(w[:, 3]))
        assert np.count_nonzero(g[:, 3]) == n
        assert np.all(np.diff(g[:n, 2]) >= 0)
        key = lambda e: sorted(map(tuple, e[:n, [0, 1, 3]].tolist()))  # noqa: E731
        assert key(g) == key(w)
        # the bin of each event: the linear version's timestamps give the cells
        lo_w = np.floor((w[:n, 2] - 1e-6) * num_bins)
        lo_g = np.floor((g[:n, 2] - 1 / (100 * num_bins) + 1e-7) * num_bins)
        assert sorted(zip(lo_w, w[:n, 0], w[:n, 1])) == sorted(zip(lo_g, g[:n, 0], g[:n, 1]))
    assert not np.array_equal(got, native.redistribute_stack(s, "random", seed=4))


@pytest.mark.parametrize("hw", HW)
def test_native_counts_match_jax(hw):
    ev = _window(12, 600, hw, pad=40)
    ev[0, :5] = [-0.5, 0.5, hw[1] - 0.5, 1e5, -1e5]
    want = np.asarray(jenc.events_to_channels(jnp.asarray(ev[0]), jnp.asarray(ev[1]),
                                              jnp.asarray(ev[3]), hw))
    np.testing.assert_array_equal(native.rasterize_counts(ev[0], ev[1], ev[3], hw), want)


def test_native_modes_are_refused_by_name():
    with pytest.raises(ValueError, match="unsupported mode"):
        native.redistribute_stack(np.ones((1, 2, 3, 3), np.float32), "nearest")


def _build_in_fresh_dir(build_dir, out):
    _build.BUILD_DIR = build_dir
    native._prepare(_build.load_host_library(native.SOURCE))
    out.put(os.getpid())


def test_host_build_is_atomic_and_keyed(tmp_path, monkeypatch):
    """Builds of ``eventops.cpp`` from several processes at once into one
    empty build directory all load a working library, and leave one
    library under one hash key and no temporary file."""
    build_dir = str(tmp_path / "_build")
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_build_in_fresh_dir, args=(build_dir, out)) for _ in range(3)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    assert [p.exitcode for p in procs] == [0, 0, 0]
    assert len({out.get(timeout=5) for _ in procs}) == 3
    (key,) = os.listdir(build_dir)
    assert sorted(os.listdir(os.path.join(build_dir, key))) == ["eventops.log", "eventops.so"]
    # the same build in this process, twice: the key is found, nothing rebuilt
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "_LOADED", {})
    first = _build.load_host_library(native.SOURCE)
    monkeypatch.setattr(_build, "_LOADED", {})
    second = _build.load_host_library(native.SOURCE)
    native._prepare(first)
    native._prepare(second)
    assert os.listdir(build_dir) == [key]


def test_host_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("extern \"C\" int f( { return 0; }\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="broken.cpp") as e:
        _build.load_host_library("broken.cpp")
    assert "error" in str(e.value)
