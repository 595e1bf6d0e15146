"""Port parity for dataset generation: bmcnet_esr_torch's ``data/demo.py``,
``data/synthesis.py``, ``data/rosbag.py`` and ``cli.generate`` against the
JAX package's, on the CPU.

``generate_demo`` at its default (noise-free) configuration writes h5 files
whose event datasets equal the JAX package's bit for bit; the port's own
loader pulls an NFS-recipe batch from them.  The synthesis tools and the
ROS bag packager write the same files from the same inputs.  Generated
datalists go to temporary directories, never to the shipped ``datalist/``.
"""

import json
import os
import sys
import types

import h5py
import numpy as np
import pytest
import torch

from bmcnet_esr_tpu.data import synthesis as jsynthesis

from bmcnet_esr_torch.data import synthesis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several worker processes run the suite at once: two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _h5_tree(path):
    """Every dataset's values and every attribute of an h5 file."""
    out = {}
    with h5py.File(path, "r") as f:
        out["/attrs"] = {k: np.asarray(v).tolist() for k, v in f.attrs.items()}

        def visit(name, obj):
            out[name + "/attrs"] = {k: np.asarray(v).tolist() for k, v in obj.attrs.items()}
            if isinstance(obj, h5py.Dataset):
                out[name] = obj[()]

        f.visititems(visit)
    return out


def assert_same_h5(a, b):
    ta, tb = _h5_tree(a), _h5_tree(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        if isinstance(ta[k], np.ndarray):
            assert ta[k].dtype == tb[k].dtype, k
            np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
        else:
            assert ta[k] == tb[k], k


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    """Both packages' ``generate_demo`` at its defaults (2 train files and 1
    validation file of 40 frames on a 96x128 grid, noise off)."""
    from bmcnet_esr_tpu.data.demo import generate_demo as jgenerate_demo

    from bmcnet_esr_torch.data.demo import generate_demo

    root = tmp_path_factory.mktemp("demos")
    ours = generate_demo(str(root / "t"), str(root / "tdl"), device="cpu")
    theirs = jgenerate_demo(str(root / "j"), str(root / "jdl"))
    return root, ours, theirs


def test_port_exports_every_jax_name():
    """Every name the JAX package's ``ops`` and ``data`` export has a
    counterpart of the same name in the port (each held to it by a test of
    its module), and ``SCALE_PREFIXES`` is the same."""
    import bmcnet_esr_tpu.data as jdata
    import bmcnet_esr_tpu.ops as jops

    import bmcnet_esr_torch.data as data
    import bmcnet_esr_torch.ops as ops

    assert set(jops.__all__) <= set(ops.__all__)
    assert set(jdata.__all__) <= set(data.__all__)
    assert all(hasattr(ops, n) for n in ops.__all__) and all(hasattr(data, n) for n in data.__all__)
    assert data.SCALE_PREFIXES == jdata.SCALE_PREFIXES


def test_generate_demo_matches_jax(demos):
    root, ours, theirs = demos
    assert ours["files"] == theirs["files"] and len(ours["files"]) == 3
    for name in ours["files"]:
        assert_same_h5(str(root / "t" / name), str(root / "j" / name))
    for key in ("train_datalist", "valid_datalist"):
        assert ours[key].startswith(str(root / "tdl"))
        paths = open(ours[key]).read().split()
        assert [os.path.basename(p) for p in paths] == [
            os.path.basename(p) for p in open(theirs[key]).read().split()]
        assert all(os.path.isabs(p) and os.path.exists(p) for p in paths)


def test_port_loader_pulls_a_demo_batch(demos):
    """The NFS recipe's training dataloader block, as shipped, gives a full
    batch from the demo files through the port's loader."""
    import yaml

    from bmcnet_esr_torch.data import DatasetConfig, SequenceLoader

    root, ours, _ = demos
    with open(os.path.join(REPO, "configs", "train_nfs.yml")) as f:
        dl = yaml.safe_load(f)["train_dataloader"]
    files = open(ours["train_datalist"]).read().split()
    loader = SequenceLoader(files, DatasetConfig.from_dict(dl["dataset"]),
                            batch_size=dl["batch_size"], shuffle=True, drop_last=True,
                            num_workers=1, seed=0, compact=True)
    it = iter(loader)
    batch = next(it)
    it.close()
    seql = dl["dataset"]["sequence"]["sequence_length"]
    assert batch["inp_xy"].shape == (dl["batch_size"], seql, 2, 2048)
    assert batch["gt_xy"].shape[:2] == (dl["batch_size"], seql)
    assert (batch["inp_p"] != 0).all()


def test_generate_demo_refuses_empty_splits(tmp_path):
    from bmcnet_esr_torch.data.demo import generate_demo

    for kwargs in ({"n_train": 0}, {"n_valid": 0}):
        with pytest.raises(RuntimeError, match="n_train >= 1"):
            generate_demo(str(tmp_path / "h5"), str(tmp_path / "dl"), device="cpu", **kwargs)
    assert not os.path.exists(tmp_path / "h5")


def test_cli_generate_demo_on_the_cpu(demos, tmp_path, capsys):
    """``cli.generate demo --device cpu`` writes the first demo file as
    ``generate_demo`` does, and its datalists where it is told."""
    from bmcnet_esr_torch.cli import generate

    root = demos[0]
    generate.main(["demo", "--out_dir", str(tmp_path / "h5"), "--datalist_dir",
                   str(tmp_path / "dl"), "--train_files", "1", "--valid_files", "1",
                   "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out)
    assert summary["train_datalist"] == str(tmp_path / "dl" / "train_nfs.txt")
    assert_same_h5(str(tmp_path / "h5" / "demo_train_0.h5"), str(root / "t" / "demo_train_0.h5"))


def _write_sim_txt(path, n, h, w, seed, t_span=1.0):
    rng = np.random.default_rng(seed)
    rows = zip(np.sort(rng.random(n)) * t_span, rng.integers(0, w, n), rng.integers(0, h, n),
               rng.integers(0, 2, n))
    with open(path, "w") as f:
        f.write("# t x y p\n")
        for row in rows:
            f.write("{:.6f} {} {} {}\n".format(*row))


def test_synthesize_dataset_matches_jax(tmp_path):
    root = tmp_path / "sim"
    for scale_dir, n in [("down2", 4000), ("down4", 1000), ("down8", 250), ("down16", 64)]:
        (root / scale_dir).mkdir(parents=True)
        for k, seq in enumerate(("s0", "s1")):
            _write_sim_txt(str(root / scale_dir / f"{seq}.txt"), n, 180, 320, 10 * k + n)
    ours = synthesis.synthesize_dataset(str(root), str(tmp_path / "t"), "nfs")
    theirs = jsynthesis.synthesize_dataset(str(root), str(tmp_path / "j"), "nfs")
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    for a, b in zip(ours, theirs):
        assert_same_h5(a, b)
    with h5py.File(ours[0]) as f:
        assert list(f.attrs["sensor_resolution"]) == [360, 640]
        assert f["ori_events/ts"].shape[0] == 4000 and f["down8_events/ts"].shape[0] == 64
    (root / "down4" / "s1.txt").unlink()
    with pytest.raises(ValueError, match="unaligned"):
        synthesis.synthesize_dataset(str(root), str(tmp_path / "o"), "nfs")
    with pytest.raises(KeyError, match="unknown preset"):
        synthesis.synthesize_dataset(str(root), str(tmp_path / "o"), "dvs")


def test_txt_tools_match_jax(tmp_path):
    txt = str(tmp_path / "x.txt")
    _write_sim_txt(txt, 500, 16, 24, 1)
    np.testing.assert_array_equal(synthesis.read_simulator_txt(txt),
                                  jsynthesis.read_simulator_txt(txt))
    ours = synthesis.txt_to_h5(txt, str(tmp_path / "t.h5"), [16, 24])
    theirs = jsynthesis.txt_to_h5(txt, str(tmp_path / "j.h5"), [16, 24])
    assert_same_h5(ours, theirs)
    mm = synthesis.h5_to_memmap(ours, str(tmp_path / "mm"))
    jmm = jsynthesis.h5_to_memmap(theirs, str(tmp_path / "jmm"))
    for k in mm:
        assert np.array_equal(np.fromfile(mm[k], np.int16 if k in "xsys" else np.float64),
                              np.fromfile(jmm[k], np.int16 if k in "xsys" else np.float64))
    synthesis.add_hdf5_attribute(ours, "note", "hello")
    jsynthesis.add_hdf5_attribute(theirs, "note", "hello")
    assert synthesis.read_events_summary(ours) == jsynthesis.read_events_summary(theirs)
    assert synthesis.read_events_summary(ours)["attrs"]["note"] == "hello"


def test_cli_generate_tools(tmp_path, capsys):
    from bmcnet_esr_torch.cli import generate

    txt = str(tmp_path / "x.txt")
    _write_sim_txt(txt, 80, 8, 8, 2)
    h5p = str(tmp_path / "x.h5")
    generate.main(["txt", "--txt", txt, "--out", h5p, "--resolution", "8", "8"])
    generate.main(["attr", "--h5", h5p, "--key", "sensor_resolution", "--value", "[8, 8]"])
    generate.main(["memmap", "--h5", h5p, "--out_dir", str(tmp_path / "mm")])
    capsys.readouterr()
    generate.main(["inspect", "--h5", h5p])
    summary = json.loads(capsys.readouterr().out)
    assert summary["ori_events"]["num_events"] == 80
    assert summary["attrs"]["sensor_resolution"] == [8, 8]
    assert os.path.exists(tmp_path / "mm" / "ori_ts.dat")


class _Time:
    def __init__(self, s):
        self.s = s

    def to_sec(self):
        return self.s


def _fake_ros(monkeypatch):
    """A stand-in for the ``rosbag`` and ``cv_bridge`` modules: a bag of
    two event messages and two image messages."""
    rng = np.random.default_rng(3)

    def events(t0, n):
        return [types.SimpleNamespace(x=int(x), y=int(y), ts=_Time(t0 + k * 1e-3), polarity=bool(p))
                for k, (x, y, p) in enumerate(zip(rng.integers(0, 20, n), rng.integers(0, 12, n),
                                                  rng.integers(0, 2, n)))]

    msgs = {"/events": [types.SimpleNamespace(height=12, width=20, events=events(0.0, 30)),
                        types.SimpleNamespace(height=12, width=20, events=events(0.05, 25))],
            "/image": [types.SimpleNamespace(
                header=types.SimpleNamespace(stamp=_Time(0.01 + 0.03 * k)),
                img=rng.integers(0, 256, (12, 20)).astype(np.uint8)) for k in range(2)]}

    class Bag:
        def __init__(self, path, mode):
            pass

        def read_messages(self, topics):
            return [(topics[0], m, None) for m in msgs[topics[0]]]

        def close(self):
            pass

    class CvBridge:
        def imgmsg_to_cv2(self, msg):
            return msg.img

    monkeypatch.setitem(sys.modules, "rosbag", types.SimpleNamespace(Bag=Bag))
    monkeypatch.setitem(sys.modules, "cv_bridge", types.SimpleNamespace(CvBridge=CvBridge))


def test_rosbag_refusal_and_packager_path(tmp_path, monkeypatch):
    """Without ROS the conversion refuses with a clear ImportError; with a
    stand-in bag both packages write the same h5 (events, frames, event
    indices), in chunks smaller than a message."""
    from bmcnet_esr_tpu.data.rosbag import rosbag_to_h5 as jrosbag_to_h5

    from bmcnet_esr_torch.data.rosbag import rosbag_to_h5

    monkeypatch.setitem(sys.modules, "rosbag", None)
    with pytest.raises(ImportError, match="ROS python stack"):
        rosbag_to_h5("x.bag", str(tmp_path / "x.h5"), "/events")
    _fake_ros(monkeypatch)
    ours = rosbag_to_h5("x.bag", str(tmp_path / "t.h5"), "/events", "/image", chunk=20)
    theirs = jrosbag_to_h5("x.bag", str(tmp_path / "j.h5"), "/events", "/image", chunk=20)
    assert_same_h5(ours, theirs)
    with h5py.File(ours) as f:
        assert f["ori_events/ts"].shape == (55,) and len(f["ori_images"]) == 2
        assert list(f.attrs["sensor_resolution"]) == [12, 20]
