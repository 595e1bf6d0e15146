"""The RGB perceptual recipe (``configs/train_RGB_percep.yml``) on the CPU
against the benchmark's plain reference (``benchmark/reference/lpips.py``,
``benchmark/reference/percep.py``), on the benchmark's seeded weights: the
port's LPIPS, each of the recipe's terms, and the whole step through
``Trainer`` with remat on and off and ``grad_accum`` 1 and 2; then the
step's spans (``train.loss.<term>``, ``train.recompute``,
``train.microbatch``).  Tiny shapes: BMCNet full at ``n_c`` 8, ``n_b`` 1,
8x10 -> 32x40, clips of 3 windows.

Every comparison is float32 against float32 on the CPU.  The two sides run
the same operations in other orders (the port's heads are an ``einsum``,
the reference's a broadcast sum; the port's terms reduce NHWC tensors, the
reference's the same values after a permute), so they agree to float32
rounding, a few units in the sixth digit, grown through the unroll's
products in the gradients; each tolerance below says how far."""

import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark.lpips_weights import seeded_lpips, write_bundle
from benchmark.reference import lpips as ref_lpips
from benchmark.reference import percep as ref_percep
from benchmark.weights import model_dims, seeded_params
from bmcnet_esr_torch.losses.lpips import LPIPS
from bmcnet_esr_torch.losses.terms import LossContext
from bmcnet_esr_torch.training.config import RunConfig
from bmcnet_esr_torch.training.losses import REGISTRY
from bmcnet_esr_torch.training.trainer import Trainer
from bmcnet_esr_torch.utils import timers

HW, GT_HW, LENGTH = (8, 10), (32, 40), 3
CONFIG = {
    "model": {"variant": "full", "n_c": 8, "n_b": 1, "repeat": 3, "scale": 4},
    "lr_resolution": list(HW), "hr_resolution": list(GT_HW),
    "init": {"gain": 0.1, "head_gain": 4.0, "state_gain": 1.0, "bias_std": 0.01,
             "norm_std": 0.1},
    "lpips": {"net": "alex", "version": "0.1", "taps": [64, 192, 384, 256, 256],
              "head_high": 0.1},
}
WEIGHTS = {"recon": 0.5, "lpips": 1.0, "temporal_consistency": 0.1}
LR, WD = 1e-4, 1e-5
SEED = 2**31 + 5
EVENTS = {"edges": 3, "background_share": 0.2, "edge_width_px": 0.8, "speed_px_per_window": 0.6}


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    return write_bundle(CONFIG, SEED, str(tmp_path_factory.mktemp("lpips") / "alex.npz"))


def _images(seed, shape, counts=False):
    g = torch.Generator().manual_seed(seed)
    if counts:
        return torch.poisson(torch.full(shape, 0.7), generator=g)
    return torch.rand(shape, generator=g) * 2.0


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


# -- LPIPS and the terms ----------------------------------------------------------


def test_lpips_distance_and_gradient_match_the_reference():
    p = seeded_lpips(CONFIG, SEED)
    port = LPIPS({k: v for k, v in p.items() if not k.startswith("lin")},
                 [p[f"lin{l}"] for l in range(5)], "alex")
    x0 = _images(1, (3, 3, *GT_HW)) - 1.0
    x1 = _images(2, (3, 3, *GT_HW)) - 1.0
    a, b = x0.clone().requires_grad_(True), x0.clone().requires_grad_(True)
    got = port(a, x1).reshape(-1)
    want = ref_lpips.distance(p, b, x1)
    # float32 rounding of five layers' sums in two orders: a few 1e-7
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
    got.sum().backward()
    want.sum().backward()
    # the gradient passes back through the same five layers; the image's
    # gradient norm agrees to a few 1e-6
    assert _rel(a.grad, b.grad) < 1e-5


def _term(name, bundle):
    ctx = LossContext(HW, GT_HW, 4)
    cfg = {"recon": {"norm": "l1"}, "lpips": {"weights": bundle},
           "temporal_consistency": {}}[name]
    return REGISTRY[name](cfg, ctx)


@pytest.mark.parametrize("name,step", [("recon", 0), ("lpips", 0), ("temporal_consistency", 0),
                                       ("temporal_consistency", 1)])
def test_each_term_and_its_gradient_match_the_reference(name, step, bundle):
    fn = _term(name, bundle)
    pred = _images(3, (2, *GT_HW, 2))
    gt = _images(4, (2, *GT_HW, 2), counts=True)
    prev = _images(5, (2, *GT_HW, 2))
    pair = _images(6, (2, 2, *HW, 2), counts=True)
    a, b = pred.clone().requires_grad_(True), pred.clone().requires_grad_(True)
    got = fn(a, gt, {"pred": a, "prev_pred": prev, "inp": pair, "step": step})
    if name == "recon":
        want = ref_percep.recon(b, pair[:, 1])
    elif name == "lpips":
        want = ref_lpips.perceptual(seeded_lpips(CONFIG, SEED), b, gt)
    else:
        want = ref_percep.temporal_consistency(b, prev, step)
    # a mean of float32 values summed in two orders
    assert float(got.detach()) == pytest.approx(float(want.detach()), rel=1e-6, abs=0.0)
    if step == 0 and name == "temporal_consistency":
        assert float(got.detach()) == 0.0
        return
    got.backward()
    want.backward()
    # one term's gradient through at most the LPIPS backbone, as above
    assert _rel(a.grad, b.grad) < 1e-5


# -- the whole step through Trainer ----------------------------------------------


class _Loader:
    """One compact batch of 2 clips of ``LENGTH`` windows, as ``Trainer`` reads a loader."""

    inp_resolution, gt_resolution = HW, GT_HW
    seqn, compact, pad_last, batch_size = 2, True, False, 2

    def __init__(self, inp, gt):
        ixy, ip = traffic.compact(inp)
        gxy, gp = traffic.compact(gt)
        self.batches = [{"inp_xy": ixy, "inp_p": ip, "gt_xy": gxy, "gt_p": gp}]

    def __len__(self):
        return 1

    def __iter__(self):
        return iter(self.batches)


def _windows():
    inp = np.stack([traffic.stream_windows(SEED, 2 * c, 0, LENGTH, HW, 96, EVENTS)
                    for c in range(2)])
    gt = np.stack([traffic.stream_windows(SEED, 2 * c + 1, 0, LENGTH, GT_HW, 1536, EVENTS)
                   for c in range(2)])
    return inp, gt


def _trainer(tmp_path, bundle, remat, accum, loader):
    icfg = {"enabled": True, "iterations": 1, "save_period": 100, "train_log_step": 100,
            "valid_log_step": 100, "valid_step": 100, "lr_change_rate": 4000}
    cfg = {
        "experiment": "percep",
        "model": {"args": {"variant": "full", "n_c": 8, "n_b": 1}},
        "loss": {"recon": {"weight": 0.5, "norm": "l1"},
                 "lpips": {"weight": 1.0, "weights": bundle},
                 "temporal_consistency": {"weight": 0.1}},
        "optimizer": {"name": "Adam", "args": {"lr": LR, "weight_decay": WD, "amsgrad": True}},
        "lr_scheduler": {"name": "ExponentialLR", "args": {"gamma": 0.95}},
        "trainer": {"output_path": str(tmp_path), "remat": remat, "grad_accum": accum,
                    "monitor": "off", "tensorboard": False, "iteration_based_train": icfg},
        "train_dataloader": {"batch_size": 2, "dataset": {"scale": 4, "ori_scale": "down4"}},
    }
    tr = Trainer(RunConfig(cfg, runid="percep"), train_loader=loader, seed=0, device="cpu")
    tr.state.model.load_state_dict(seeded_params(CONFIG, SEED, "cpu"), strict=True)
    return tr


@pytest.mark.parametrize("remat,accum", [(True, 2), (True, 1), (False, 2), (False, 1)])
def test_the_percep_step_matches_the_reference(remat, accum, bundle, tmp_path):
    inp, gt = _windows()
    loader = _Loader(inp, gt)
    tr = _trainer(tmp_path, bundle, remat, accum, loader)
    batch = next(iter(tr._device_prefetched(loader)))
    p0 = {n: p.detach().clone() for n, p in tr.state.model.named_parameters()}
    tr.state, metrics = tr.train_step(tr.state, batch)
    ref = ref_percep.steps(seeded_params(CONFIG, SEED, "cpu"), seeded_lpips(CONFIG, SEED),
                           model_dims(CONFIG), WEIGHTS,
                           [(torch.from_numpy(inp), torch.from_numpy(gt))], HW, GT_HW, LR, WD,
                           accum=accum, remat=remat)
    # a sum over steps of float32 means: a few 1e-7 relative
    assert float(metrics["train_loss"]) == pytest.approx(ref["losses"][0], rel=2e-6)
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in ref["first_grad"].items()}
    floor = sorted(norms.values())[len(norms) // 2]
    for n, p in tr.state.model.named_parameters():
        g = p.grad + WD * p0[n]  # the gradient as the optimizer took it
        # each leaf against the larger of its own and the median leaf's norm:
        # rounding through the BPTT unroll reads 1.1-1.5e-7 of that
        err = float(torch.linalg.vector_norm(g - ref["first_grad"][n]))
        assert err <= 2e-6 * max(norms[n], floor), (n, err, norms[n], floor)
        # Adam's first step moves each parameter by lr * g / (|g| + eps): the
        # parameters agree to their own rounding (an ulp of a LayerNorm scale
        # near 1 is 1.2e-7) beside a thousandth of one step
        torch.testing.assert_close(p.detach(), ref["params"][n], rtol=1e-6, atol=1e-3 * LR)


# -- the spans ---------------------------------------------------------------------


def test_the_percep_step_spans(bundle, tmp_path):
    inp, gt = _windows()
    loader = _Loader(inp, gt)
    tr = _trainer(tmp_path, bundle, True, 2, loader)
    batch = next(iter(tr._device_prefetched(loader)))
    timers.clear()
    tr.state, _ = tr.train_step(tr.state, batch)  # off: nothing is kept
    assert timers.spans() == []
    with timers.record():
        tr.state, _ = tr.train_step(tr.state, batch)
    got = {}
    for s in timers.spans():
        got.setdefault(s.name, []).append(s)
    timers.clear()
    steps = LENGTH - 1
    micro = got["train.microbatch"]
    assert [s.attrs for s in micro] == [{"rows": 1}, {"rows": 1}]
    assert len(got["train.recompute"]) == 2 * steps  # each step's body, rerun in each backward
    for name in ("train.loss.recon", "train.loss.lpips", "train.loss.temporal_consistency"):
        spans = got[name]
        assert sorted(s.attrs["recompute"] for s in spans) == [0] * 2 * steps + [1] * 2 * steps
    assert all(s.attrs["images"] == 4 for s in got["train.loss.lpips"])  # 1 clip x 2 channels x 2
    # the first pass sits in its micro-batch; a rerun term in its rerun body,
    # and each lies in time inside a micro-batch
    ids = {s.id: s for v in got.values() for s in v}
    for s in got["train.loss.lpips"]:
        outer = ids[s.parent].name if s.parent in ids else None
        assert outer == ("train.recompute" if s.attrs["recompute"] else "train.microbatch")
        assert any(m.start_ns <= s.start_ns <= s.end_ns <= m.end_ns for m in micro)
