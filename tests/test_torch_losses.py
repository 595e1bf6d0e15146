"""The port's loss terms against the JAX package and the loss goldens.

The same seeded numpy inputs go through ``bmcnet_esr_tpu`` and
``bmcnet_esr_torch``:

* the count-image terms (``lr_consistency`` / ``recon``,
  ``temporal_consistency``, ``total_variation``, ``ssim``) and their
  gradients with respect to the prediction: rtol 1e-5, atol 1e-6;
* ``grid_sample_bilinear`` (grid points out of range too) and ``sobel``:
  atol 1e-6;
* the IWE functions, ``averaged_iwe`` (tied triples), the event-warping,
  generative-model, temporal-consistency and TV losses: rtol 1e-5 against
  JAX, and ``tests/goldens/loss_goldens.npz`` at the JAX tests' own bounds
  (``tests/test_flow_losses.py``);
* the event terms through ``build_extra_losses`` with ``events_len``;
* the RGB perceptual recipe (recon + LPIPS + temporal consistency, remat,
  ``grad_accum: 2``) through both packages' ``Trainer`` at small width, and
  the raw-transfer path with ``event_warping`` attached: per-iteration losses
  at rtol 1e-5, and a resume that repeats the uninterrupted run bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from bmcnet_esr_tpu.data import SequenceLoader as JSequenceLoader
from bmcnet_esr_tpu.data.h5dataset import DatasetConfig as JDatasetConfig
from bmcnet_esr_tpu.losses import flow as jflow
from bmcnet_esr_tpu.losses import iwe as jiwe
from bmcnet_esr_tpu.losses import reconstruction as jrec
from bmcnet_esr_tpu.losses import terms as jterms
from bmcnet_esr_tpu.losses.gradients import sobel as jsobel
from bmcnet_esr_tpu.ops import encodings as jenc
from bmcnet_esr_tpu.ops.warp import grid_sample_bilinear as jgrid_sample
from bmcnet_esr_tpu.training.losses import REGISTRY as JREGISTRY
from bmcnet_esr_tpu.training.losses import build_extra_losses as jbuild_extra_losses
from bmcnet_esr_tpu.training.trainer import Trainer as JTrainer
from bmcnet_esr_tpu.training.config import RunConfig as JRunConfig

from bmcnet_esr_torch.data import DatasetConfig, SequenceLoader, write_synthetic_fixture
from bmcnet_esr_torch.losses import flow, iwe, reconstruction
from bmcnet_esr_torch.losses.gradients import sobel
from bmcnet_esr_torch.losses.lpips import LPIPS, convert_backbone_state_dict
from bmcnet_esr_torch.losses.terms import LossContext
from bmcnet_esr_torch.models import params_from_jax
from bmcnet_esr_torch.ops import encodings
from bmcnet_esr_torch.ops.warp import grid_sample_bilinear
from bmcnet_esr_torch.training import Trainer
from bmcnet_esr_torch.training import losses as tlosses
from bmcnet_esr_torch.training.config import RunConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
sys.path.insert(0, os.path.join(REPO, "tools"))

import lpips_fixture_nets as nets  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
LR, GT, K = (6, 8), (12, 16), 2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


# -- the count-image terms ------------------------------------------------------


def term_inputs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    pred = rng.gamma(1.0, 1.0, (b, *GT, 2)).astype(np.float32)
    return {
        "pred": pred,
        "gt": rng.poisson(1.0, (b, *GT, 2)).astype(np.float32),
        "inp": rng.poisson(1.0, (b, 2, *LR, 2)).astype(np.float32),
        "prev_pred": rng.gamma(1.0, 1.0, (b, *GT, 2)).astype(np.float32),
    }


COUNT_TERMS = [
    ("recon", {}), ("lr_consistency", {"norm": "l2"}), ("temporal_consistency", {}),
    ("total_variation", {}), ("ssim", {}), ("ssim", {"data_range": 4.0, "win_size": 5}),
]


@pytest.mark.parametrize("name,cfg", COUNT_TERMS, ids=lambda v: str(v))
@pytest.mark.parametrize("step", [0, 3])
def test_count_image_term_and_its_gradient_match_jax(name, cfg, step):
    x = term_inputs(seed=step)
    ctx = LossContext(LR, GT, K)
    jfn = JREGISTRY[name](dict(cfg), jterms.LossContext(LR, GT, K))
    fn = tlosses.REGISTRY[name](dict(cfg), ctx)

    def jloss(pred):
        aux = {"pred": pred, "prev_pred": jnp.asarray(x["prev_pred"]),
               "inp": jnp.asarray(x["inp"]), "step": jnp.int32(step)}
        return jfn(pred, jnp.asarray(x["gt"]), aux)

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(x["pred"]))
    pred = t(x["pred"]).requires_grad_(True)
    aux = {"pred": pred, "prev_pred": t(x["prev_pred"]), "inp": t(x["inp"]), "step": step}
    val = fn(pred, t(x["gt"]), aux)
    val.backward()
    close(val, jval, what=f"{name} value")
    close(pred.grad, jgrad, what=f"{name} gradient")


def test_registry_holds_every_jax_name_and_none_raises():
    assert set(tlosses.REGISTRY) == set(JREGISTRY)
    assert not hasattr(tlosses, "TERMS_TODO") and not hasattr(tlosses, "_unported")
    ctx = LossContext(LR, GT, K)
    for name, builder in tlosses.REGISTRY.items():
        if name != "lpips":  # needs its weights: built in the recipe tests below
            assert callable(builder({}, ctx)), name


def test_flow_key_branch_of_temporal_consistency_matches_jax():
    x = term_inputs(seed=4)
    rng = np.random.default_rng(5)
    flow_map = (rng.standard_normal((2, *GT, 2)) * 0.05).astype(np.float32)
    jfn = jterms.temporal_consistency({"flow_key": "flow"}, None)
    fn = tlosses.REGISTRY["temporal_consistency"]({"flow_key": "flow"}, None)

    def jloss(pred, fl):
        return jfn(pred, None, {"pred": pred, "prev_pred": jnp.asarray(x["prev_pred"]),
                                "step": jnp.int32(1), "flow": fl})

    jval, (jgp, jgf) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x["pred"]),
                                                                  jnp.asarray(flow_map))
    pred, fl = t(x["pred"]).requires_grad_(True), t(flow_map).requires_grad_(True)
    val = fn(pred, None, {"pred": pred, "prev_pred": t(x["prev_pred"]), "step": 1, "flow": fl})
    val.backward()
    close(val, jval)
    close(pred.grad, jgp)
    close(fl.grad, jgf, rtol=1e-4, atol=1e-5)


# -- warp, sobel, encodings -------------------------------------------------------


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_jax_and_torch_out_of_range_too(align_corners):
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 3, 9, 11)).astype(np.float32)
    grid = (rng.random((2, 5, 7, 2)).astype(np.float32) * 2.6) - 1.3  # incl. out of range
    got = grid_sample_bilinear(t(img), t(grid), align_corners=align_corners)
    close(got, jgrid_sample(jnp.asarray(img), jnp.asarray(grid), align_corners=align_corners),
          rtol=0, atol=1e-6)
    want = F.grid_sample(t(img), t(grid), mode="bilinear", padding_mode="zeros",
                         align_corners=align_corners)
    close(got, want, rtol=0, atol=1e-6)


def test_sobel_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 3, 8, 10)).astype(np.float32)
    for got, want in zip(sobel(t(x)), jsobel(jnp.asarray(x))):
        close(got, want, rtol=0, atol=1e-6)


def test_event_time_normalization_and_polarity_mask_match_jax():
    rng = np.random.default_rng(2)
    ts = np.sort(rng.random((3, 20)).astype(np.float32) * 5.0, axis=1)
    ts[1, 12:] = 0.0  # a zero-padded window
    n_valid = np.array([20, 12, 0], np.int32)
    ps = rng.choice([-1.0, 0.0, 1.0], (3, 20)).astype(np.float32)
    want = jax.vmap(jenc.normalize_event_times)(jnp.asarray(ts), jnp.asarray(n_valid))
    close(encodings.normalize_event_times(t(ts), t(n_valid)), want)
    close(encodings.normalize_event_times(t(ts)), jax.vmap(jenc.normalize_event_times)(ts))
    close(encodings.normalize_event_times(t(ts[1]), 12), jenc.normalize_event_times(ts[1], 12))
    close(encodings.events_polarity_mask(t(ps)), jax.vmap(jenc.events_polarity_mask)(ps),
          rtol=0, atol=0)


# -- the IWE functions and the flow / reconstruction losses -----------------------


RES = (12, 16)


def event_inputs(seed=0, b=2, n=96, ties=24):
    """Events at integer pixels with ts in [0, 1], some repeated (tied
    (pol, src, dst) triples), a flow map of a few pixels' reach, an image
    pair and count images."""
    rng = np.random.default_rng(seed)
    ev = np.zeros((b, n, 4), np.float32)
    ev[:, :, 0] = np.sort(rng.random((b, n)), axis=1)
    ev[:, :, 1] = rng.integers(0, RES[0], (b, n))
    ev[:, :, 2] = rng.integers(0, RES[1], (b, n))
    ev[:, :, 3] = rng.choice([-1.0, 1.0], (b, n))
    ev[:, n - ties:, 1:] = ev[:, :ties, 1:]  # ties: same pixel and polarity
    ev[:, -4:, 1:] = 0.0  # padding: pixel (0, 0), polarity 0
    pol_mask = np.stack([np.maximum(ev[..., 3], 0), -np.minimum(ev[..., 3], 0)], -1)
    return {
        "event_list": ev, "pol_mask": pol_mask.astype(np.float32),
        "flow": (rng.standard_normal((b, 2, *RES)) * 0.03).astype(np.float32),
        "img": rng.random((b, 1, *RES)).astype(np.float32),
        "prev_img": rng.random((b, 1, *RES)).astype(np.float32),
        "cnt": rng.poisson(0.5, (b, 2, *RES)).astype(np.float32),
    }


@pytest.mark.parametrize("round_idx", [False, True])
def test_iwe_functions_match_jax(round_idx):
    x = event_inputs(1)
    ev, fl, pm = (jnp.asarray(x[k]) for k in ("event_list", "flow", "pol_mask"))
    per = jiwe.event_flow_lookup(fl, ev, RES)
    close(iwe.event_flow_lookup(t(x["flow"]), t(x["event_list"]), RES), per)
    for tref in (0.0, 1.0):
        jidx, jw = jiwe.get_interpolation(ev, per, tref, RES, 16.0, round_idx=round_idx)
        idx, w = iwe.get_interpolation(t(x["event_list"]), t(np.asarray(per)), tref, RES, 16.0,
                                       round_idx=round_idx)
        close(idx, jidx, rtol=0, atol=0)
        close(w, jw)
        pmask = jnp.concatenate([pm] * (1 if round_idx else 4), axis=1)[:, :, :1]
        close(iwe.interpolate(idx, w, RES, t(np.asarray(pmask))),
              jiwe.interpolate(jidx, jw, RES, pmask))
    close(iwe.deblur_events(t(x["flow"]), t(x["event_list"]), RES, 16.0, round_idx,
                            t(x["pol_mask"][..., :1])),
          jiwe.deblur_events(fl, ev, RES, 16.0, round_idx, pm[..., :1]))
    close(iwe.compute_pol_iwe(t(x["flow"]), t(x["event_list"]), RES, t(x["pol_mask"][..., :1]),
                              t(x["pol_mask"][..., 1:]), 16.0, round_idx),
          jiwe.compute_pol_iwe(fl, ev, RES, pm[..., :1], pm[..., 1:], 16.0, round_idx))
    idx = np.array([[[-1.0, 3.0], [2.0, 20.0], [5.0, 5.0]]], np.float32)
    close(iwe.purge_unfeasible(t(idx), RES)[0], jiwe.purge_unfeasible(jnp.asarray(idx), RES)[0])
    xytp = np.random.default_rng(2).random((2, 3, 4, 9)).astype(np.float32)
    close(iwe.events_to_iwe_order(t(xytp)), jiwe.events_to_iwe_order(jnp.asarray(xytp)),
          rtol=0, atol=0)


def test_flow_lookup_reads_out_of_range_sources_as_jax_does():
    fm = np.random.default_rng(3).random((1, 2, *RES)).astype(np.float32)
    ev = np.zeros((1, 3, 4), np.float32)
    ev[0, :, 1:3] = [[0, -1], [RES[0], 0], [-RES[0], 0]]  # wraps once; past the end; twice
    got = iwe.event_flow_lookup(t(fm), t(ev), RES).numpy()
    want = np.asarray(jiwe.event_flow_lookup(jnp.asarray(fm), jnp.asarray(ev), RES))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    close(np.nan_to_num(got), np.nan_to_num(want))


def test_averaged_iwe_with_tied_triples_matches_jax():
    x = event_inputs(2, ties=40)
    args = [x[k] for k in ("flow", "event_list", "pol_mask")]
    want = jflow.averaged_iwe(*(jnp.asarray(a) for a in args), RES)
    close(flow.averaged_iwe(*(t(a) for a in args), RES), want)
    zero = np.zeros_like(x["flow"])  # every event lands on its own pixel: maximal ties
    want = jflow.averaged_iwe(jnp.asarray(zero), *(jnp.asarray(a) for a in args[1:]), RES)
    close(flow.averaged_iwe(t(zero), *(t(a) for a in args[1:]), RES), want)


def _with_grads(jfn, fn, arrays, argnums):
    """Value and gradients of the same loss in both packages."""
    jval, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=argnums))(
        *(jnp.asarray(a) for a in arrays))
    ts = [t(a).requires_grad_(i in argnums) for i, a in enumerate(arrays)]
    val = fn(*ts)
    val.backward()
    return (val, [ts[i].grad for i in argnums]), (jval, jgrads)


def test_event_warping_loss_and_its_flow_gradient_match_jax():
    """The value in float32; the flow gradient in float64, because the
    averaged-timestamp images divide by counts plus 1e-9, so float32
    round-off of the warp's corner weights moves a few gradient entries by
    up to 1e-4 in either package alike, while in float64 the two agree to
    1e-12."""
    x = event_inputs(3)
    args = [x["flow"], x["event_list"], x["pol_mask"]]
    (val, _), (jval, _) = _with_grads(
        lambda f, e, p: jflow.event_warping_loss([f], e, p, RES, 0.01),
        lambda f, e, p: flow.event_warping_loss([f], e, p, RES, 0.01), args, (0,))
    close(val, jval)
    with jax.enable_x64(True):
        (_, grads), (_, jgrads) = _with_grads(
            lambda f, e, p: jflow.event_warping_loss([f], e, p, RES, 0.01),
            lambda f, e, p: flow.event_warping_loss([f], e, p, RES, 0.01),
            [a.astype(np.float64) for a in args], (0,))
    assert grads[0].dtype == torch.float64 and jgrads[0].dtype == jnp.float64
    close(grads[0], jgrads[0], rtol=1e-9, atol=1e-12)


def test_reconstruction_losses_and_gradients_match_jax():
    x = event_inputs(4)
    (val, grads), (jval, jgrads) = _with_grads(
        lambda f, i, c, e, p: jrec.generative_model_loss(f, i, c, e, p, RES),
        lambda f, i, c, e, p: reconstruction.generative_model_loss(f, i, c, e, p, RES),
        [x[k] for k in ("flow", "img", "cnt", "event_list", "pol_mask")], (0, 1))
    close(val, jval)
    for g, jg in zip(grads, jgrads):
        close(g, jg, rtol=1e-4, atol=1e-5)
    (val, grads), (jval, jgrads) = _with_grads(
        lambda f, p, i: jrec.temporal_consistency_loss(f, p, i, RES, 0.2),
        lambda f, p, i: reconstruction.temporal_consistency_loss(f, p, i, RES, 0.2),
        [x[k] for k in ("flow", "prev_img", "img")], (0, 1, 2))
    close(val, jval)
    for g, jg in zip(grads, jgrads):
        close(g, jg, rtol=1e-4, atol=1e-5)
    close(reconstruction.total_variation_loss(t(x["img"]), 0.1),
          jrec.total_variation_loss(jnp.asarray(x["img"]), 0.1))
    bc = reconstruction.BrightnessConstancy(RES)
    inputs = {"inp_cnt": t(x["cnt"]), "inp_list": t(x["event_list"]),
              "inp_pol_mask": t(x["pol_mask"])}
    jbc = jrec.BrightnessConstancy(RES)
    jinputs = {k: jnp.asarray(np.asarray(v)) for k, v in inputs.items()}
    close(bc.generative_model(t(x["flow"]), t(x["img"]), inputs),
          jbc.generative_model(jnp.asarray(x["flow"]), jnp.asarray(x["img"]), jinputs))
    close(bc.regularization(t(x["img"])), jbc.regularization(jnp.asarray(x["img"])))


@pytest.fixture(scope="module")
def g():
    return np.load(os.path.join(GOLDENS, "loss_goldens.npz"))


def test_loss_goldens(g):
    """``tests/goldens/loss_goldens.npz`` at ``tests/test_flow_losses.py``'s bounds."""
    res = tuple(int(v) for v in g["res"])
    fl, ev, pm = t(g["flow"]), t(g["event_list"]), t(g["pol_mask"])
    assert float(flow.event_warping_loss([fl], ev, pm, res, 0.01)) == pytest.approx(
        float(g["ew_loss"]), rel=1e-4)
    close(flow.averaged_iwe(fl, ev, pm, res), g["aiwe"], rtol=0, atol=1e-4)
    assert float(reconstruction.generative_model_loss(fl, t(g["img"]), t(g["cnt"]), ev, pm, res)
                 ) == pytest.approx(float(g["gm"]), rel=1e-3)
    assert float(reconstruction.temporal_consistency_loss(
        fl, t(g["prev_img"]), t(g["img"]), res, 0.2)) == pytest.approx(float(g["tc"]), rel=1e-4)
    assert float(reconstruction.total_variation_loss(t(g["img"]), 0.1)) == pytest.approx(
        float(g["tv"]), rel=1e-5)


def test_unique_contrib_key_counts_ties_as_jax():
    rng = np.random.default_rng(7)
    pol = rng.integers(0, 3, (2, 200))
    src = rng.integers(-5, 40, (2, 200)).astype(np.int32)  # negative sources too
    dst = rng.integers(0, 30, (2, 200)).astype(np.int32)
    src[:, 100:] = src[:, :100]
    dst[:, 100:] = dst[:, :100]
    pol[:, 100:] = pol[:, :100]
    pos, neg = flow._unique_contrib(t(pol), t(src), t(dst), 30)
    for b in range(2):
        jpos, jneg = jflow._unique_contrib(jnp.asarray(pol[b]), jnp.asarray(src[b]),
                                           jnp.asarray(dst[b]), 30)
        close(pos[b], jpos, rtol=0, atol=0)
        close(neg[b], jneg, rtol=0, atol=0)
    with pytest.raises(ValueError, match="overflows"):
        flow._unique_contrib(t(pol), t(src), t(dst), 1 << 30)


# -- the event terms through build_extra_losses -----------------------------------


def raw_windows(seed, b, n, hw, n_valid):
    """``[B, 4, N]`` (x, y, ts, p) zero-padded after ``n_valid`` events."""
    rng = np.random.default_rng(seed)
    ev = np.zeros((b, 4, n), np.float32)
    for i, m in enumerate(n_valid):
        ev[i, 0, :m] = rng.integers(0, hw[1], m)
        ev[i, 1, :m] = rng.integers(0, hw[0], m)
        ev[i, 2, :m] = np.sort(rng.random(m)) * 3.0 + 1.0
        ev[i, 3, :m] = rng.choice([-1.0, 1.0], m)
    return ev


@pytest.mark.parametrize("name", ["event_warping", "brightness_constancy"])
def test_event_terms_through_build_extra_losses_match_jax(name):
    """``event_warping``: both packages' terms in float64 (value and
    gradients at 1e-9) and in float32 (value at rtol 1e-5; its float32
    gradient is ill-conditioned, ``losses/flow.py``); ``brightness_constancy``
    in float32.  ``events_len`` anchors the timestamps' normalization on the
    padded window."""
    lens = np.array([50, 64], np.int32)
    ev = raw_windows(8, 2, 64, LR, lens)
    rng = np.random.default_rng(9)
    flow_lr = (rng.standard_normal((2, *LR, 2)) * 0.05).astype(np.float32)
    pred = rng.gamma(1.0, 1.0, (2, *LR, 2)).astype(np.float32)
    spec = {name: {"weight": 0.5, "flow_key": "flow"}}
    if name == "brightness_constancy":
        spec[name]["img_key"] = "pred"
    (jname, jw, jfn), = jbuild_extra_losses(spec, jterms.LossContext(LR, GT, K))
    (pname, w, fn), = tlosses.build_extra_losses(spec, LossContext(LR, GT, K))
    assert (pname, w) == (jname, jw) and fn.needs_events and tlosses.needs_events(((pname, w, fn),))

    def jloss(fl, p):
        return jfn(p, None, {"pred": p, "flow": fl, "events": jnp.asarray(ev, fl.dtype),
                             "events_len": jnp.asarray(lens)})

    def loss(dtype, aux_len=True):
        fl = t(flow_lr).to(dtype).requires_grad_(True)
        p = t(pred).to(dtype).requires_grad_(True)
        aux = {"pred": p, "flow": fl, "events": t(ev).to(dtype)}
        if aux_len:
            aux["events_len"] = t(lens)
        val = fn(p, None, aux)
        val.backward()
        grads = [torch.zeros_like(a) if a.grad is None else a.grad for a in (fl, p)]
        return val.detach(), grads

    if name == "brightness_constancy":
        # float32 in both (the JAX Sobel kernels are float32 constants, so its
        # float64 run does not build); well conditioned: the rounded warp
        jval, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
            jnp.asarray(flow_lr), jnp.asarray(pred))
        val, grads = loss(torch.float32)
        close(val, jval)
        for g, jg in zip(grads, jgrads):
            close(g, jg, rtol=1e-4, atol=1e-6)
    else:
        with jax.enable_x64(True):
            jval, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
                jnp.asarray(flow_lr, jnp.float64), jnp.asarray(pred, jnp.float64))
        val, grads = loss(torch.float64)
        close(val, jval, rtol=1e-9, atol=0)
        for g, jg in zip(grads, jgrads):
            close(g, jg, rtol=1e-9, atol=1e-12)
        jval32 = jax.jit(jloss)(jnp.asarray(flow_lr), jnp.asarray(pred))
        val32, _ = loss(torch.float32)
        assert val32.dtype == torch.float32
        close(val32, jval32)
    # without events_len the padded window's timestamps normalize otherwise
    assert float(loss(val.dtype, aux_len=False)[0]) != float(val)


# -- the recipes through both Trainers --------------------------------------------


@pytest.fixture(scope="module")
def h5(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_losses")
    return write_synthetic_fixture(str(d / "clip.h5"), (32, 32), ("ori", "down2"),
                                   {"ori": 30000, "down2": 7500}, seed=3)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """An LPIPS alex bundle written by the port: the fixture backbone and
    seeded non-negative heads."""
    state = {k: v.numpy() for k, v in nets.make_alex_features().state_dict().items()}
    rng = np.random.default_rng(11)
    lins = [rng.random((1, c)).astype(np.float32) * 0.1 for c in (64, 192, 384, 256, 256)]
    path = str(tmp_path_factory.mktemp("lpips") / "alex.npz")
    LPIPS(convert_backbone_state_dict(state, "alex"), lins, "alex").to_npz(path)
    return path


DS = {"scale": 2, "ori_scale": "down2", "window": 128, "sliding_window": 64,
      "data_augment": {"enabled": False},
      "sequence": {"sequence_length": 4, "seqn": 2, "step_size": 4}}


def recipe(tmp_path, loss, **trainer):
    icfg = {"enabled": True, "iterations": 3, "save_period": 100, "train_log_step": 1,
            "valid_log_step": 10, "valid_step": 100, "lr_change_rate": 4000}
    return {
        "experiment": "percep_small",
        "model": {"args": {"n_c": 8, "n_b": 1, "variant": "full"}},
        "loss": loss,
        "optimizer": {"name": "Adam", "args": {"lr": 1e-3, "weight_decay": 1e-5,
                                               "amsgrad": True}},
        "lr_scheduler": {"name": "ExponentialLR", "args": {"gamma": 0.95}},
        # one device in both packages, so the JAX Trainer accumulates too
        "trainer": {"output_path": str(tmp_path), "monitor": "off", "tensorboard": False,
                    "data_parallel": False, "iteration_based_train": icfg, **trainer},
        "train_dataloader": {"dataset": {"scale": 2}},
    }


def loaders(h5, compact):
    kw = {"batch_size": 2, "shuffle": True, "drop_last": True, "num_workers": 1, "seed": 0}
    return (SequenceLoader([h5], DatasetConfig.from_dict(DS), compact=compact, **kw),
            JSequenceLoader([h5], JDatasetConfig.from_dict(DS), compact=compact, **kw))


def run_both(cfg, h5, compact, extra=(), jextra=(), iters=3, runid="a"):
    """``iters`` iterations of the port's and the JAX Trainer from the JAX
    initial parameters: each one's per-iteration metrics, and the port's
    Trainer."""
    ours, theirs = loaders(h5, compact)
    jtr = JTrainer(JRunConfig(cfg, runid=runid), train_loader=theirs, seed=0,
                   extra_losses=jextra)
    tr = Trainer(RunConfig(cfg, runid=runid), train_loader=ours, seed=0, extra_losses=extra,
                 device="cpu")
    tr.state.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jtr.state.params)))
    jm, m = [], []
    for _, jb in zip(range(iters), jtr._device_prefetched(jtr.train_loader)):
        jtr.state, out = jtr.train_step(jtr.state, jb)
        jm.append({k: float(v) for k, v in out.items()})
    for _, b in zip(range(iters), tr._device_prefetched(tr.train_loader)):
        tr.state, out = tr.train_step(tr.state, b)
        m.append({k: float(v) for k, v in out.items()})
    return m, jm, tr


def check_losses(m, jm):
    for i, (a, b) in enumerate(zip(m, jm)):
        for k in ("train_loss", "train_mse_loss"):
            assert a[k] == pytest.approx(b[k], rel=1e-5), (i, k, a[k], b[k])


def check_resume(tr, cfg, h5, compact, extra):
    """Save after iteration 2, resume in a new Trainer, repeat iteration 3.

    One intra-op thread: on two, the CPU's first parallel call of a process
    can split a reduction otherwise than the later ones do (the LPIPS
    backward moved by 1e-10 between its first and second call), and the
    resumed Trainer's step is its first."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _check_resume(tr, cfg, h5, compact, extra)
    finally:
        torch.set_num_threads(threads)


def _check_resume(tr, cfg, h5, compact, extra):
    ours, _ = loaders(h5, compact)
    batches = [b for _, b in zip(range(3), tr._device_prefetched(ours))]
    fresh = Trainer(RunConfig(cfg, runid="full"), train_loader=ours, seed=0, extra_losses=extra,
                    device="cpu")
    fresh.state.model.load_state_dict(tr.state.model.state_dict())  # any start will do
    first = []
    for b in batches[:2]:
        fresh.state, out = fresh.train_step(fresh.state, b)
        first.append(float(out["train_loss"]))
    fresh.save(1)
    _, want = fresh.train_step(fresh.state, batches[2])
    resumed = Trainer(RunConfig(cfg, runid="resumed"), train_loader=ours, seed=1,
                      extra_losses=extra, device="cpu")
    assert resumed.resume(os.path.join(fresh.run.save_dir, "iteration_1")) == 2
    _, got = resumed.train_step(resumed.state, batches[2])
    assert float(got["train_loss"]) == float(want["train_loss"])
    for (n, p), q in zip(fresh.state.model.named_parameters(), resumed.state.model.parameters()):
        assert torch.equal(p, q), n


def test_percep_recipe_through_both_trainers(h5, bundle, tmp_path):
    """``configs/train_RGB_percep.yml``'s terms at n_c=8, n_b=1: recon 0.5
    (l1), LPIPS 1.0 (a seeded bundle), temporal consistency 0.1, with remat
    and ``grad_accum: 2``."""
    loss = {"recon": {"weight": 0.5, "norm": "l1"}, "lpips": {"weight": 1.0, "weights": bundle},
            "temporal_consistency": {"weight": 0.1}}
    cfg = recipe(tmp_path, loss, remat=True, grad_accum=2)
    m, jm, tr = run_both(cfg, h5, compact=True)
    check_losses(m, jm)
    names = [n for n, _, _ in tr.extra_losses]
    assert names == ["recon", "lpips", "temporal_consistency"]
    # the LPIPS weights are frozen and outside the model's state
    assert not any("lin" in k or "net." in k for k in tr.state.state_dict()["model"])
    check_resume(tr, cfg, h5, True, ())


def pooled_flow_terms(ctx_t, ctx_j):
    """``event_warping`` fed the prediction mean-pooled to the LR grid as
    its flow, in each package."""
    jew = jterms.event_warping({"flow_key": "flow"}, ctx_j)
    ew = tlosses.REGISTRY["event_warping"]({"flow_key": "flow"}, ctx_t)

    def jfn(pred, gt, aux):
        b, kh, kw, c = aux["pred"].shape
        h, w = ctx_j.inp_resolution
        pooled = aux["pred"].reshape(b, h, kh // h, w, kw // w, c).mean(axis=(2, 4))
        return jew(pred, gt, dict(aux, flow=pooled * 0.01))

    def fn(pred, gt, aux):
        b, kh, kw, c = aux["pred"].shape
        h, w = ctx_t.inp_resolution
        pooled = aux["pred"].reshape(b, h, kh // h, w, kw // w, c).mean(dim=(2, 4))
        return ew(pred, gt, dict(aux, flow=pooled * 0.01))

    jfn.needs_events = fn.needs_events = True
    return (("ew", 0.1, fn),), (("ew", 0.1, jfn),)


def test_raw_transfer_with_event_warping_through_both_trainers(h5, tmp_path):
    """An event-consuming term puts the raw float32 windows, ``events_len``
    and the IWE scatter on the training path."""
    cfg = recipe(tmp_path, {}, remat=False)
    extra, jextra = pooled_flow_terms(LossContext((16, 16), (32, 32), 2),
                                      jterms.LossContext((16, 16), (32, 32), 2))
    m, jm, tr = run_both(cfg, h5, compact=False, extra=extra, jextra=jextra, runid="raw")
    check_losses(m, jm)
    assert "inp_len" in tr._step_keys
    check_resume(tr, cfg, h5, False, extra)


def test_chip_smoke_percep_recipe_is_the_yaml():
    import chip_smoke

    from bmcnet_esr_torch.training.config import load_yaml

    assert chip_smoke.percep_recipe() == load_yaml(
        os.path.join(REPO, "configs", "train_RGB_percep.yml"))
