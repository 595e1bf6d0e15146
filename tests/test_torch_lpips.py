"""The port's LPIPS and its calibration trainer against the JAX package.

Backbones are the seeded torchvision-layout nets of
``tools/lpips_fixture_nets.py``; heads are seeded with numpy and are
non-negative (the reference's released heads are not in the repository).

* every net x version x scalar/spatial against JAX ``LPIPS`` on the same
  arrays: atol 2e-5, rtol 1e-4;
* the plain mode and the resnet taps against ``tests/goldens/lpips_goldens.npz``
  at ``tests/test_lpips.py``'s bounds (they need no heads);
* bundles written by either package's ``to_npz`` load in the other exactly;
* ``perceptual_loss`` on 2-channel counts, the distance models;
* ``LPIPSTrainer`` without dropout from the JAX trainer's parameters: 5
  steps at rtol 1e-5, ``pnet_tune`` too; with dropout, training steps vary
  and evaluation does not.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bmcnet_esr_tpu.losses import lpips as jl
from bmcnet_esr_tpu.losses import lpips_train as jlt

from bmcnet_esr_torch.losses import lpips as pl
from bmcnet_esr_torch.losses import lpips_train as plt
from bmcnet_esr_torch.models import lpips_params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
sys.path.insert(0, os.path.join(REPO, "tools"))

import lpips_fixture_nets as nets  # noqa: E402

BUILDERS = {"alex": nets.make_alex_features, "vgg": nets.make_vgg16_features,
            "squeeze": nets.make_squeeze_features}
CHNS = {"alex": [64, 192, 384, 256, 256], "vgg": [64, 128, 256, 512, 512],
        "squeeze": [64, 128, 256, 384, 384, 512, 512]}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def g():
    return np.load(os.path.join(GOLDENS, "lpips_goldens.npz"))


@pytest.fixture(scope="module")
def states():
    return {net: {k: v.numpy() for k, v in b().state_dict().items()}
            for net, b in BUILDERS.items()}


def heads(net, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random((1, c)).astype(np.float32) * 0.2 for c in CHNS[net]]


def both(states, net, version="0.1", spatial=False, lpips=True):
    lins = heads(net) if lpips else None
    kw = dict(version=version, spatial=spatial, lpips=lpips)
    return (pl.LPIPS(pl.convert_backbone_state_dict(states[net], net), lins, net, **kw),
            jl.LPIPS(jl.convert_backbone_state_dict(states[net], net),
                     None if lins is None else [jnp.asarray(w) for w in lins], net, **kw))


def inputs(g, spatial):
    return (g["in0_sq"], g["in1_sq"]) if spatial else (g["in0"], g["in1"])


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
@pytest.mark.parametrize("version", ["0.0", "0.1"])
@pytest.mark.parametrize("spatial", [False, True], ids=["scalar", "spatial"])
def test_net_lin_matches_jax(g, states, net, version, spatial):
    lp, jlp = both(states, net, version, spatial)
    in0, in1 = inputs(g, spatial)
    want = np.asarray(jlp(jnp.asarray(in0), jnp.asarray(in1)))
    with torch.no_grad():
        got = lp(torch.from_numpy(in0), torch.from_numpy(in1)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("net", ["alex", "squeeze"])
@pytest.mark.parametrize("spatial", [False, True], ids=["scalar", "spatial"])
def test_plain_net_matches_goldens(g, states, net, spatial):
    lp, _ = both(states, net, spatial=spatial, lpips=False)
    in0, in1 = inputs(g, spatial)
    with torch.no_grad():
        got = lp(torch.from_numpy(in0), torch.from_numpy(in1)).numpy()
    want = g[f"{net}/plain/{'spatial' if spatial else 'scalar'}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


def test_ret_per_layer_and_identity(g, states):
    lp, _ = both(states, "squeeze")
    x0, x1 = torch.from_numpy(g["in0"]), torch.from_numpy(g["in1"])
    with torch.no_grad():
        val, res = lp(x0, x1, ret_per_layer=True)
        assert len(res) == 7
        np.testing.assert_allclose(sum(res[1:], res[0]).numpy(), val.numpy(), rtol=1e-6)
        np.testing.assert_allclose(lp(x0, x0).numpy(), 0.0, atol=1e-6)


@pytest.mark.parametrize("num", [18, 50])
def test_resnet_taps_match_goldens(g, num):
    net = nets.make_resnet(num)
    params = pl.convert_resnet_state_dict({k: v.numpy() for k, v in net.state_dict().items()})
    with torch.no_grad():
        taps = pl.resnet_features(params, torch.from_numpy(g["in0"]), num)
    assert len(taps) == 5
    for i, tap in enumerate(taps):
        want = g[f"resnet{num}/tap{i}"]
        assert tap.shape == want.shape
        np.testing.assert_allclose(tap.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("num", [34, 101, 152])
def test_deep_resnets_have_torchvision_names(num):
    """34/101/152 share the block code: the same state-dict names and shapes
    as torchvision's (the fixture's) net."""
    want = {k: tuple(v.shape) for k, v in nets.make_resnet(num).state_dict().items()}
    got = {k: tuple(v.shape) for k, v in pl.ResNetFeatures(num).state_dict().items()}
    assert got == want


def test_bundles_cross_between_the_packages(states, tmp_path):
    lp, jlp = both(states, "squeeze", version="0.0")
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    lp.to_npz(ours)
    jlp.to_npz(theirs)
    back = jl.LPIPS.from_npz(ours)
    assert (back.net, back.version, back.lpips) == ("squeeze", "0.0", True)
    for k, v in jlp.backbone.items():
        np.testing.assert_array_equal(np.asarray(back.backbone[k]), np.asarray(v), err_msg=k)
    for a, b in zip(back.lins, jlp.lins):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    mine = pl.LPIPS.from_npz(theirs)
    assert (mine.net_name, mine.version, mine.lpips) == ("squeeze", "0.0", True)
    for k, v in lp.backbone.items():
        assert torch.equal(mine.backbone[k], v), k
    for a, b in zip(mine.lins, lp.lins):
        assert torch.equal(a, b)
    plain = pl.LPIPS(pl.convert_backbone_state_dict(states["alex"], "alex"), None, "alex",
                     lpips=False)
    plain.to_npz(ours)
    assert jl.LPIPS.from_npz(ours).lins is None and pl.LPIPS.from_npz(ours).lins is None
    # frozen: nothing asks for a gradient
    assert not any(p.requires_grad for p in mine.parameters())


def test_perceptual_loss_on_counts_matches_jax(states):
    lp, jlp = both(states, "alex")
    rng = np.random.default_rng(3)
    pred = rng.random((2, 2, 33, 37)).astype(np.float32)
    gt = rng.random((2, 2, 33, 37)).astype(np.float32)
    for c in (1, 2, 3):
        p, t_ = pred[:, :1].repeat(c, 1), gt[:, :1].repeat(c, 1)
        if c == 2:
            p, t_ = pred, gt
        want = float(jl.perceptual_loss(jlp, jnp.asarray(p), jnp.asarray(t_)))
        x = torch.from_numpy(p).requires_grad_(True)
        got = pl.perceptual_loss(lp, x, torch.from_numpy(t_))
        got.backward()
        assert float(got.detach()) == pytest.approx(want, rel=1e-5), c
        if c == 2:  # count images: the gradient the training term takes
            jgrad = jax.grad(lambda a: jl.perceptual_loss(jlp, a, jnp.asarray(t_)))(
                jnp.asarray(p))
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-7)
    # bf16 predictions meet the term in float32
    got = pl.perceptual_loss(lp, torch.from_numpy(pred).bfloat16(), torch.from_numpy(gt))
    assert got.dtype == torch.float32


def test_distance_models_match_jax(g, states, tmp_path):
    lin = str(tmp_path / "alex.pth")
    torch.save({f"lin{k}.model.1.weight": torch.from_numpy(w[:, :, None, None])
                for k, w in enumerate(heads("alex"))}, lin)
    in0, in1 = g["in0"], g["in1"]
    x0, x1 = torch.from_numpy(in0), torch.from_numpy(in1)
    for model in ("net-lin", "net", "L2", "ssim"):
        d = pl.DistanceModel(model, "alex", backbone_state_dict=states["alex"],
                             lin_weights_path=lin)
        jd = jl.DistanceModel(model, "alex", backbone_state_dict=states["alex"],
                              lin_weights_path=lin)
        with torch.no_grad():
            np.testing.assert_allclose(d(x0, x1).numpy(), np.asarray(jd(in0, in1)),
                                       atol=2e-5, rtol=1e-4, err_msg=model)
        assert d.name == jd.name
    with pytest.raises(ValueError, match="not recognized"):
        pl.DistanceModel("nope")
    for a, b in zip(pl.load_lin_weights(lin, "alex"), jl.load_lin_weights(lin, "alex")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- LPIPSTrainer ---------------------------------------------------------------


def triplets(seed, n=4, hw=(32, 32)):
    rng = np.random.default_rng(seed)
    img = lambda: (rng.random((n, 3, *hw)) * 2 - 1).astype(np.float32)  # noqa: E731
    return {"ref": img(), "p0": img(), "p1": img(), "judge": rng.random(n).astype(np.float32)}


@pytest.mark.parametrize("pnet_tune", [False, True], ids=["heads", "pnet_tune"])
def test_trainer_matches_jax_for_five_steps(states, pnet_tune):
    lp, jlp = both(states, "alex")
    kw = dict(lr=1e-3, beta1=0.5, seed=11, use_dropout=False, pnet_tune=pnet_tune)
    jtr = jlt.LPIPSTrainer(jlp, **kw)
    tr = plt.LPIPSTrainer(lp, device="cpu", **kw)
    tr.load_params(lpips_params_from_jax(jax.tree.map(np.asarray, jtr.params)))
    for i in range(5):
        batch = triplets(i)
        want = {k: float(v) for k, v in jtr.optimize_parameters(batch).items()}
        got = {k: float(v) for k, v in tr.optimize_parameters(batch).items()}
        assert got["loss_total"] == pytest.approx(want["loss_total"], rel=1e-5), i
        assert got["acc_r"] == want["acc_r"]
        if i == 2:
            assert tr.update_learning_rate(10) == pytest.approx(jtr.update_learning_rate(10))
    # with the backbone training too, a weight whose gradient is near zero
    # takes Adam steps (m / sqrt(v), about lr each) whose size the two
    # frameworks' float32 round-off moves: one weight of 256 lands 2e-5 off
    # after 5 steps, so there the bound is a tenth of one step (lr = 1e-3)
    atol = 0.1 * kw["lr"] if pnet_tune else 1e-8
    for a, b in zip(tr.lin_weights(), jtr.lin_weights()):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol)
        assert (a >= 0).all()
    if pnet_tune:
        moved = tr.params["backbone"]["0.weight"].detach().numpy()
        np.testing.assert_allclose(moved, np.asarray(jtr.params["backbone"]["0.weight"]),
                                   rtol=1e-5, atol=atol)
        assert not np.array_equal(moved, states["alex"]["0.weight"])
    batch = triplets(9)
    np.testing.assert_allclose(tr.distance(batch["ref"], batch["p0"]),
                               jtr.distance(batch["ref"], batch["p0"]), rtol=1e-5)
    assert tr.get_current_errors().keys() == {"loss_total", "acc_r"}


def test_trainer_dropout_varies_training_not_evaluation(states, tmp_path):
    lp, _ = both(states, "alex")
    tr = plt.LPIPSTrainer(lp, seed=9, use_dropout=True, device="cpu")
    batch = triplets(1)
    d0 = tr.distance(batch["ref"], batch["p0"])
    np.testing.assert_array_equal(d0, tr.distance(batch["ref"], batch["p0"]))
    d0s, d1s = tr._distances(*(torch.from_numpy(batch[k]) for k in ("ref", "p0", "p1")), True)
    e0s, _ = tr._distances(*(torch.from_numpy(batch[k]) for k in ("ref", "p0", "p1")), True)
    assert not torch.equal(d0s, e0s)
    assert np.isfinite(tr.get_current_errors().get("loss_total", 0.0))
    tr.optimize_parameters(batch)
    path = tr.save_lin_weights(str(tmp_path / "lin.pth"))
    for a, b in zip(pl.load_lin_weights(path, "alex"), tr.lin_weights()):
        np.testing.assert_array_equal(a.numpy(), b)


def test_logit_net_and_scores_match_jax():
    rng = np.random.default_rng(5)
    d0, d1 = (rng.random((6, 1, 1, 1)).astype(np.float32) for _ in range(2))
    judge = rng.random(6).astype(np.float32)
    params = plt.init_dist2logit(3, 16)
    jparams = jlt.init_dist2logit(3, 16)
    for k in params:
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(jparams[k]))
    td0, td1 = torch.from_numpy(d0), torch.from_numpy(d1)
    np.testing.assert_allclose(plt.dist2logit(params, td0, td1).numpy(),
                               np.asarray(jlt.dist2logit(jparams, d0, d1)), rtol=1e-6)
    j = judge.reshape(6, 1, 1, 1) * 2 - 1
    assert float(plt.bce_ranking_loss(params, td0, td1, torch.from_numpy(j))) == pytest.approx(
        float(jlt.bce_ranking_loss(jparams, d0, d1, j)), rel=1e-6)
    np.testing.assert_array_equal(plt.compute_accuracy(td0, td1, torch.from_numpy(judge)).numpy(),
                                  np.asarray(jlt.compute_accuracy(d0, d1, judge)))
    rec, prec = np.sort(rng.random(9)), rng.random(9)
    for use_07 in (False, True):
        assert plt.voc_ap(rec, prec, use_07) == jlt.voc_ap(rec, prec, use_07)
    data = [{"ref": rng.random((3, 2)), "p0": rng.random((3, 2)), "p1": rng.random((3, 2)),
             "judge": rng.random(3), "same": rng.integers(0, 2, 3)} for _ in range(3)]
    dist = lambda a, b: np.abs(a - b).sum(-1)  # noqa: E731
    for fn, jfn in ((plt.score_2afc_dataset, jlt.score_2afc_dataset),
                    (plt.score_jnd_dataset, jlt.score_jnd_dataset)):
        assert fn(data, dist)[0] == jfn(data, dist)[0]
