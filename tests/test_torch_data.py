"""Port parity for the training data layer: bmcnet_esr_torch's
EventSequenceDataset, SequenceLoader and counts_from_batch against the JAX
package on the same packager-built h5 fixture.

Every comparison is exact: both packages read the same file and make the
same numpy random draws (augmentation, noise, pause, clip and batch seeds),
so every array must be bit-identical.
"""

import gc
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bmcnet_esr_tpu.data import EventSequenceDataset as JEventSequenceDataset
from bmcnet_esr_tpu.data import SequenceLoader as JSequenceLoader
from bmcnet_esr_tpu.data.h5dataset import DatasetConfig as JDatasetConfig
from bmcnet_esr_tpu.ops.batch import counts_from_batch as jcounts_from_batch

from bmcnet_esr_torch.data import (
    DatasetConfig,
    EventH5Dataset,
    EventSequenceDataset,
    SequenceLoader,
    write_synthetic_fixture,
)
from bmcnet_esr_torch.ops.batch import counts_from_batch

# every dataset option of the NFS recipe and the ones beside it, as the
# YAML dataset block spells them
OPTIONS = {
    "plain": {},
    "augment": {"data_augment": {"enabled": True, "augment_prob": [0.5, 0.5, 0.5]}},
    "noise": {"add_noise": {"enabled": True, "noise_level": 0.25}},
    "pause": {"sequence": {"sequence_length": 4, "seqn": 2, "step_size": 2,
                           "pause": {"enabled": True, "proba_pause_when_running": 0.4,
                                     "proba_pause_when_paused": 0.6}}},
    "hot_filter": {"hot_filter": {"enabled": True, "max_px": 40, "min_obvs": 2,
                                  "max_rate": 0.3}},
    "all": {"data_augment": {"enabled": True}, "add_noise": {"enabled": True},
            "hot_filter": {"enabled": True, "max_px": 40, "min_obvs": 2, "max_rate": 0.3},
            "sequence": {"sequence_length": 4, "seqn": 2, "step_size": 2,
                         "pause": {"enabled": True, "proba_pause_when_running": 0.4,
                                   "proba_pause_when_paused": 0.6}}},
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def h5(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_data")
    # down4 input (16x24) with x4 GT at ori (64x96)
    return [
        write_synthetic_fixture(
            str(d / f"seq{s}.h5"), (64, 96), ("ori", "down2", "down4"),
            {"ori": 60000, "down2": 16000, "down4": 4000}, seed=s,
        )
        for s in (3, 4)
    ]


def block(**opts):
    base = {"scale": 4, "ori_scale": "down4", "window": 256, "sliding_window": 128,
            "need_gt_events": True,
            "sequence": {"sequence_length": 4, "seqn": 2, "step_size": 2}}
    base.update(opts)
    return base


def configs(**opts):
    return DatasetConfig.from_dict(block(**opts)), JDatasetConfig.from_dict(block(**opts))


def assert_items_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_get_clip_matches_jax(h5, name):
    cfg, jcfg = configs(**OPTIONS[name])
    ours, theirs = EventSequenceDataset(h5[0], cfg), JEventSequenceDataset(h5[0], jcfg)
    assert len(ours) == len(theirs) and ours.L == theirs.L
    # in order: the hot filter's running rate depends on every window read before
    for i in range(len(ours)):
        assert_items_equal(ours.get_clip(i, seed=100 + i), theirs.get_clip(i, seed=100 + i))
    if name in ("hot_filter", "all"):  # the filter zeroed real events, not only padding
        item = ours.dataset.get_window(len(ours.dataset) - 1, seed=1)
        assert (item["inp_events"][3, : item["inp_len"]] == 0).any()
    if name in ("pause", "all"):
        clips = [ours.get_clip(i, seed=7) for i in range(len(ours))]
        assert any(w["inp_len"] == 0 for c in clips for w in c[1:])


def test_options_change_the_windows(h5):
    """Each option does something on this fixture (so the parity above is
    not a comparison of untouched windows)."""
    plain = EventH5Dataset(h5[0], configs()[0]).get_window(2, seed=11)
    flips = EventH5Dataset(h5[0], configs(data_augment={
        "enabled": True, "augment": ["Horizontal", "Polarity"], "augment_prob": [1.0, 1.0]})[0])
    a = flips.get_window(2, seed=11)
    n, w = plain["inp_len"], flips.layout.inp_resolution[1]
    np.testing.assert_array_equal(a["inp_events"][0, :n], w - 1 - plain["inp_events"][0, :n])
    np.testing.assert_array_equal(a["gt_events"][3], -plain["gt_events"][3])
    noisy = EventH5Dataset(h5[0], configs(add_noise={"enabled": True, "noise_level": 0.25})[0])
    item = noisy.get_window(2, seed=11)
    assert noisy.padded_window == 256 + 64 and item["inp_len"] == 256 + 64
    noise = item["inp_events"][:, 256:]
    assert set(np.unique(noise[3])) <= {-1.0, 1.0} and (noise[2] == 1.0).all()


def test_augment_frame_matches_jax(h5):
    """The image form of the flips (for GT frames) draws as the events do."""
    from bmcnet_esr_tpu.data import EventH5Dataset as JEventH5Dataset

    cfg, jcfg = configs(data_augment={"enabled": True, "augment_prob": [0.7, 0.7, 0.7]})
    ours, theirs = EventH5Dataset(h5[0], cfg), JEventH5Dataset(h5[0], jcfg)
    img = np.random.default_rng(0).random((16, 24, 3)).astype(np.float32)
    flips = set()
    for seed in range(8):
        got = ours.augment_frame(img, seed)
        np.testing.assert_array_equal(got, theirs.augment_frame(img, seed))
        flips.add(tuple(bool(np.array_equal(got, f(img))) for f in (
            lambda a: a[:, ::-1], lambda a: a[::-1], lambda a: a[::-1, ::-1])))
    assert len(flips) > 1  # the seeds draw different flips


def test_hot_filter_count_image_keeps_the_y_flip(h5):
    """The filter's count image lives in y-flipped raster coordinates, as
    the JAX package's native counter makes it."""
    from bmcnet_esr_tpu.native import rasterize_counts

    ds = EventH5Dataset(h5[0], configs()[0])
    ev = ds._read_events(ds.layout.inp_prefix, 0, 256)
    ev[0, :3], ev[1, :3] = [0, 23, -1], [0, 15, 3]  # corners and one out of range
    np.testing.assert_array_equal(
        ds.create_cnt_encoding(ev, ds.layout.inp_resolution),
        rasterize_counts(ev[0], ev[1], ev[3], ds.layout.inp_resolution))


LOADERS = {
    "shuffle": dict(batch_size=2, shuffle=True),
    "drop_last": dict(batch_size=3, shuffle=True, drop_last=True),
    "pad_last": dict(batch_size=3, pad_last=True),
    "pad_last_compact": dict(batch_size=3, pad_last=True, compact=True),
    "shard_1_of_2": dict(batch_size=2, shuffle=True, shard_index=1, shard_count=2),
    "shard_0_of_3_compact": dict(batch_size=2, shuffle=True, shard_index=0, shard_count=3,
                                 compact=True),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_batches_match_jax(h5, name):
    kw = LOADERS[name]
    cfg, jcfg = configs(data_augment={"enabled": True})
    ours = SequenceLoader(h5, cfg, num_workers=2, seed=5, **kw)
    theirs = JSequenceLoader(h5, jcfg, num_workers=2, seed=5, **kw)
    assert len(ours) == len(theirs)
    for _ in range(2):  # two epochs: the shuffle and the seeds move with the epoch
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        assert_items_equal(got, want)
    if kw.get("compact"):
        assert got[0]["inp_xy"].dtype == np.int16 and "inp_events" not in got[0]
    if kw.get("pad_last"):
        assert all("clip_mask" in b for b in got) and got[-1]["clip_mask"].min() == 0.0


@pytest.mark.parametrize("compact", [False, True])
def test_counts_from_batch_matches_jax(h5, compact):
    cfg, jcfg = configs(data_augment={"enabled": True})
    batch = next(iter(SequenceLoader(h5, cfg, batch_size=2, compact=compact, num_workers=1)))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for prefix, res in (("inp", (16, 24)), ("gt", (64, 96))):
        got = counts_from_batch(tb, prefix, res)
        assert tuple(got.shape) == (2, 4, *res, 2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jcounts_from_batch(jb, prefix, res)))


def test_worker_error_raises_not_truncates(h5, monkeypatch):
    """A worker's exception reaches the consumer: never a short epoch."""
    ld = SequenceLoader(h5, configs()[0], batch_size=1, num_workers=2)

    def boom(self, local, batch, rng):
        raise OSError("corrupt h5 chunk")

    monkeypatch.setattr(SequenceLoader, "_load_batch", boom)
    with pytest.raises(RuntimeError, match="loader worker failed") as info:
        for _ in ld:
            pass
    assert isinstance(info.value.__cause__, OSError)


@pytest.mark.parametrize("shard_count,drop_last", [(1, True), (1, False), (2, True), (3, False)])
def test_len_is_arithmetic(h5, shard_count, drop_last):
    cfg = configs()[0]
    ld = SequenceLoader(h5, cfg, batch_size=2, shuffle=True, drop_last=drop_last,
                        num_workers=1, shard_index=shard_count - 1, shard_count=shard_count)
    n = len(ld)
    assert n == sum(1 for _ in ld)
    jld = JSequenceLoader(h5, configs()[1], batch_size=2, shuffle=True, drop_last=drop_last,
                          num_workers=1, shard_index=shard_count - 1, shard_count=shard_count)
    assert n == len(jld)


def test_abandoned_iterator_releases_workers(h5):
    ld = SequenceLoader(h5, configs()[0], batch_size=1, num_workers=2, prefetch=1)
    before = threading.active_count()
    it = iter(ld)
    next(it)
    it.close()
    del it
    gc.collect()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_frame_options_still_raise(h5):
    """``frame`` mode and ``need_gt_frame`` are ported: they no longer raise.
    On a file without stored frames, ``frame`` mode has no window (the JAX
    package's error) and ``need_gt_frame`` adds no GT frame.  The name dates
    from when the port refused both options."""
    with pytest.raises(ValueError, match="empty dataset"):
        EventH5Dataset(h5[0], configs(mode="frame")[0])
    item = EventH5Dataset(h5[0], configs(need_gt_frame=True)[0]).get_window(0, seed=1)
    assert "gt_frame" not in item


# -- frame mode, GT frames and the auxiliary encodings ------------------------


def _frames_fixture(path, names=None, color=False, n_frames=12, seed=5):
    """The fixture's events plus ``ori_images``: uint8 frames spread over the
    events' time span, named ``image{i:09d}`` as the packager names them, or
    ``names``."""
    import h5py

    write_synthetic_fixture(path, (64, 96), ("ori", "down2", "down4"),
                            {"ori": 60000, "down2": 16000, "down4": 4000}, seed=seed)
    rng = np.random.default_rng(seed)
    with h5py.File(path, "a") as f:
        grp = f.create_group("ori_images")
        for i in range(n_frames):
            img = rng.integers(0, 256, (64, 96, 3) if color else (64, 96)).astype(np.uint8)
            d = grp.create_dataset(names[i] if names else f"image{i:09d}", data=img)
            d.attrs["timestamp"] = 0.01 + 0.98 * i / (n_frames - 1)
    return path


@pytest.fixture(scope="module")
def framed(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_frames")
    return {"grey": _frames_fixture(str(d / "grey.h5")),
            "color": _frames_fixture(str(d / "color.h5"), color=True, seed=6)}


MODES = {
    "events": {},
    "time": {"mode": "time", "window": 0.1, "sliding_window": 0.05},
    "frame": {"mode": "frame"},
}


@pytest.mark.parametrize("gt_frame", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kind", ["grey", "color"])
def test_dataset_modes_match_jax(framed, mode, gt_frame, kind):
    """Every window of ``events``, ``time`` and ``frame`` mode, with and
    without GT frames (flipped by the augmentation's draws), item by item
    against the JAX dataset on the same file."""
    from bmcnet_esr_tpu.data import EventH5Dataset as JEventH5Dataset

    opts = dict(MODES[mode], need_gt_frame=gt_frame,
                data_augment={"enabled": True, "augment_prob": [0.5, 0.5, 0.5]})
    cfg, jcfg = configs(**opts)
    ours, theirs = EventH5Dataset(framed[kind], cfg), JEventH5Dataset(framed[kind], jcfg)
    assert len(ours) == len(theirs) > 1
    np.testing.assert_array_equal(ours.event_indices, theirs.event_indices)
    if gt_frame or mode == "frame":
        np.testing.assert_array_equal(ours.frame_ts, theirs.frame_ts)
        assert ours.frame_names == theirs.frame_names
    for i in range(len(ours)):
        a, b = ours.get_window(i, seed=30 + i), theirs.get_window(i, seed=30 + i)
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    if gt_frame:
        frame = ours.get_window(0, seed=30)["gt_frame"]
        assert frame.shape == ((3,) if kind == "color" else (1,)) + ours.layout.gt_resolution
        assert frame.dtype == np.float32 and 0 <= frame.min() and frame.max() <= 1


def test_create_encodings_match_jax(framed):
    """Each host-side encoding of a window against the JAX dataset's: counts,
    stacks, scaled and unsupervised counts, custom-resolution streams and
    the polarity mask exactly, voxels within atol 1e-6."""
    from bmcnet_esr_tpu.data import EventH5Dataset as JEventH5Dataset

    cfg, jcfg = configs(time_bins=3, custom_resolution=[12, 20])
    ours, theirs = EventH5Dataset(framed["grey"], cfg), JEventH5Dataset(framed["grey"], jcfg)
    lay = ours.layout
    for i in (0, len(ours) - 1):
        item = ours.get_window(i, seed=3)
        ev, gt = item["inp_events"], item["gt_events"]
        exact = {
            "cnt": (ours.create_cnt_encoding(ev, lay.inp_resolution),
                    theirs.create_cnt_encoding(ev, lay.inp_resolution)),
            "stack": (ours.create_stack_encoding(ev, lay.inp_resolution),
                      theirs.create_stack_encoding(ev, lay.inp_resolution)),
            "normalized": (ours.normalize_events(ev, lay.inp_resolution),
                           theirs.normalize_events(ev, lay.inp_resolution)),
            "polarity_mask": (ours.create_polarity_mask(ev[3]), theirs.create_polarity_mask(ev[3])),
        }
        norm = exact["normalized"][0]
        for mode in ("cnt", "stack", "events"):
            exact[f"scaled {mode}"] = (
                ours.create_scaled_encoding(norm, lay.gt_resolution, mode),
                theirs.create_scaled_encoding(norm, lay.gt_resolution, mode))
        for k, (a, b) in enumerate(zip(ours.create_unsupervised_data(norm),
                                       theirs.create_unsupervised_data(norm))):
            exact[f"unsupervised {k}"] = (a, b)
        streams = [exact["cnt"][0], exact["scaled cnt"][0], exact["unsupervised 0"][0],
                   exact["unsupervised 1"][0],
                   ours.create_cnt_encoding(gt, lay.gt_resolution)]
        for k, (a, b) in enumerate(zip(ours.create_custom_data(*streams),
                                       theirs.create_custom_data(*streams))):
            exact[f"custom {k}"] = (a, b)
        for name, (a, b) in exact.items():
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
        np.testing.assert_allclose(ours.create_voxel_encoding(ev, lay.inp_resolution),
                                   theirs.create_voxel_encoding(ev, lay.inp_resolution),
                                   rtol=0, atol=1e-6)
        assert exact["stack"][0].shape == (3,) + lay.inp_resolution
        assert exact["unsupervised 0"][0].shape == (2,) + lay.inp_down_resolution
        assert exact["scaled cnt"][0].any() and exact["custom 4"][0].any()


def test_frame_ts_is_ascending_for_unpadded_names(tmp_path):
    """Frames named ``image1`` .. ``image12`` (no zero padding): the port
    orders them by timestamp (then by the number in the name), so
    ``frame_ts`` ascends and ``frame`` mode's windows follow time.  The JAX
    package sorts the names as text (``image1, image10, image11, image12,
    image2, ...``), which gives a ``frame_ts`` that falls back in time and
    windows that run backwards; this is the divergence, pinned here."""
    from bmcnet_esr_tpu.data import EventH5Dataset as JEventH5Dataset

    names = [f"image{i + 1}" for i in range(12)]
    path = _frames_fixture(str(tmp_path / "unpadded.h5"), names=names)
    cfg, jcfg = configs(mode="frame", need_gt_frame=True)
    ours, theirs = EventH5Dataset(path, cfg), JEventH5Dataset(path, jcfg)
    assert ours.frame_names == names
    assert np.all(np.diff(ours.frame_ts) > 0)
    assert np.all(ours.event_indices[:, 1] >= ours.event_indices[:, 0])
    assert len(ours) == 11
    assert theirs.frame_names == sorted(names)
    assert not np.all(np.diff(theirs.frame_ts) > 0)
    assert (theirs.event_indices[:, 1] < theirs.event_indices[:, 0]).any()
    # with padded names both orders agree (test_dataset_modes_match_jax)
