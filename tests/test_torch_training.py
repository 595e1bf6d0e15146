"""Port parity for training: bmcnet_esr_torch's BPTT train step, optimizer,
schedule, checkpoints, Trainer and cli.train against the JAX package and the
torch goldens, at a small size (n_c=8, n_b=2, x2) on the CPU.

Tolerances: BPTT gradients against ``grad_goldens.npz`` (reference torch
models) rtol 1e-4 / atol 1e-6, as ``tests/test_grad_parity.py``; the
trajectory rtol 1e-5 to 25 iterations and 2e-4 to 50 (measured by the JAX
package against the same goldens: coupled float32 iterations drift apart
past about 50); one Adam update rtol 1e-6; three train steps against the
JAX steps rtol 1e-5 (float32 summation order of two frameworks).  Parameters
cross between the packages through ``params_from_jax`` /
``train_state_from_jax``.
"""

import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bmcnet_esr_tpu.models import BMCNet as JBMCNet
from bmcnet_esr_tpu.models import BMCNetPlain as JBMCNetPlain
from bmcnet_esr_tpu.models import convert_torch_state_dict as jconvert
from bmcnet_esr_tpu.models.convert import export_torch_state_dict as jexport
from bmcnet_esr_tpu.training.optim import adam_torch
from bmcnet_esr_tpu.training.optim import build_optimizer as jbuild_optimizer
from bmcnet_esr_tpu.training.optim import exponential_decay_with_floor as jschedule
from bmcnet_esr_tpu.training.train_step import _rollout_losses as j_rollout_losses
from bmcnet_esr_tpu.training.train_step import init_train_state as jinit_train_state
from bmcnet_esr_tpu.training.train_step import make_eval_step as jmake_eval_step
from bmcnet_esr_tpu.training.train_step import make_train_step as jmake_train_step

from bmcnet_esr_torch.cli import infer as cli_infer
from bmcnet_esr_torch.cli import train as cli_train
from bmcnet_esr_torch.data import DatasetConfig, SequenceConfig, SequenceLoader
from bmcnet_esr_torch.data import write_synthetic_fixture
from bmcnet_esr_torch.inference import InferenceEngine, load_model_for_inference
from bmcnet_esr_torch.models import BMCNet, BMCNetPlain, convert_torch_state_dict
from bmcnet_esr_torch.models import load_checkpoint, params_from_jax
from bmcnet_esr_torch.models.convert import (
    export_torch_state_dict,
    torch_key_manifest,
    train_state_from_jax,
)
from bmcnet_esr_torch.training import (
    Trainer,
    build_optimizer,
    exponential_decay_with_floor,
    init_train_state,
    make_eval_step,
    make_train_step,
    sequence_loss,
)
from bmcnet_esr_torch.training.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from bmcnet_esr_torch.training.config import RunConfig, load_yaml
from bmcnet_esr_torch.training.train_step import _rollout_losses
from bmcnet_esr_torch.training.trainer import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
# the NFS recipe's Adam
OPT = {"name": "Adam", "args": {"lr": 1e-4, "weight_decay": 1e-5, "amsgrad": True}}
# a decay of 0.5 after every update: each of the three steps below runs at
# its own learning rate, so a schedule one update off changes the parameters
SCHED, TCFG = {"name": "ExponentialLR", "args": {"gamma": 0.5}}, {"lr_change_rate": 1}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def goldens():
    return dict(np.load(os.path.join(GOLDENS, "grad_goldens.npz")))


def unpack(z, variant, prefix):
    n = len(f"{variant}/{prefix}/")
    return {k[n:]: z[k] for k in z if k.startswith(f"{variant}/{prefix}/")}


def frames(z):
    """[L, B, 2, H, W] torch layout -> [B, L, H, W, 2]."""
    return tuple(np.ascontiguousarray(np.transpose(z[k], (1, 0, 3, 4, 2)))
                 for k in ("frames", "gt_frames"))


@pytest.fixture(scope="module")
def h5(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_train")
    return [write_synthetic_fixture(str(d / f"{s}.h5"), (32, 32), ("ori", "down2"),
                                    {"ori": 30000, "down2": 7500}, seed=s) for s in (0, 1)]


DS = dict(scale=2, ori_scale="down2", window=128, sliding_window=64,
          sequence=SequenceConfig(sequence_length=3, seqn=2, step_size=3))


def loader(path, **kw):
    kw = {"batch_size": 2, "shuffle": True, "drop_last": True, "num_workers": 1, "seed": 0, **kw}
    return SequenceLoader([path], DatasetConfig(**DS), **kw)


@pytest.fixture(scope="module")
def batches(h5):
    """Two batches of the train fixture, compact and raw."""
    it = zip(loader(h5[0], compact=True), loader(h5[0]))
    return [next(it) for _ in range(2)]


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def jax_model_and_params(variant, seed=0, n_b=2):
    cls = JBMCNetPlain if variant == "plain" else JBMCNet
    jm = cls(scale=2, n_c=8, n_b=n_b)
    v = jm.init(jax.random.key(seed), jnp.zeros((1, 2, 16, 16, 2)), *jm.init_state(1, 16, 16))
    return jm, v


def torch_model(variant, variables, n_b=2):
    cls = BMCNetPlain if variant == "plain" else BMCNet
    m = cls(scale=2, n_c=8, n_b=n_b)
    m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables)), strict=True)
    return m


def assert_params_close(model, jparams, rtol, atol=0.0, what=""):
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


# -- BPTT gradients ----------------------------------------------------------


@pytest.mark.parametrize("variant", ["plain", "full"])
def test_bptt_gradient_matches_goldens(goldens, variant):
    meta = goldens["meta"]
    cls = BMCNetPlain if variant == "plain" else BMCNet
    model = cls(scale=int(meta[0]), n_c=int(meta[1]), n_b=int(meta[2]))
    model.load_state_dict(convert_torch_state_dict(unpack(goldens, variant, "sd")))
    inp, gt = (torch.from_numpy(a) for a in frames(goldens))
    _, totals = _rollout_losses(model, inp, gt, 2, tuple(gt.shape[2:4]), use_remat=False)
    loss = totals.mean(1).sum()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(goldens[f"{variant}/loss"]), rel=1e-6)
    # torch grads of tied aliases share storage: the loader's alias check
    # and dedupe map them onto the port's parameters
    want = convert_torch_state_dict(unpack(goldens, variant, "grad"))
    assert sorted(want) == sorted(n for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=f"gradient mismatch at {name}")
    assert sum(float(g.abs().sum()) for g in want.values()) > 1.0  # not a vacuous comparison


@pytest.mark.parametrize("variant", ["plain", "full"])
def test_bptt_gradient_matches_jax_grad(goldens, variant):
    """At JAX-initialized parameters, the port's gradient (with remat)
    equals jax.grad of the JAX package's ``_rollout_losses``."""
    jm, v = jax_model_and_params(variant, seed=4)
    inp, gt = frames(goldens)
    gt_res = gt.shape[2:4]

    def jloss(p):
        _, totals = j_rollout_losses(jm, p, jnp.asarray(inp), jnp.asarray(gt), 2, gt_res, False)
        return jnp.sum(jnp.mean(totals, axis=1))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(v)
    model = torch_model(variant, v)
    _, totals = _rollout_losses(model, torch.from_numpy(inp), torch.from_numpy(gt), 2, gt_res,
                                use_remat=True)
    loss = totals.mean(1).sum()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def _trajectory(goldens, n):
    meta = goldens["meta"]
    model = BMCNetPlain(scale=int(meta[0]), n_c=int(meta[1]), n_b=int(meta[2]))
    model.load_state_dict(convert_torch_state_dict(unpack(goldens, "plain", "sd")))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, weight_decay=1e-5, amsgrad=True)
    inp, gt = (torch.from_numpy(a) for a in frames(goldens))
    losses = []
    for _ in range(n):
        opt.zero_grad()
        _, totals = _rollout_losses(model, inp, gt, 2, tuple(gt.shape[2:4]), use_remat=False)
        loss = totals.mean(1).sum()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return np.asarray(losses)


def test_trajectory_tracks_goldens_50_iterations(goldens):
    losses, want = _trajectory(goldens, 50), goldens["traj_losses"]
    np.testing.assert_allclose(losses[:25], want[:25], rtol=1e-5)
    np.testing.assert_allclose(losses, want[:50], rtol=2e-4)


@pytest.mark.slow
def test_trajectory_tracks_goldens_200_iterations(goldens):
    losses, want = _trajectory(goldens, 200), goldens["traj_losses"]
    np.testing.assert_allclose(losses[:25], want[:25], rtol=1e-5)
    np.testing.assert_allclose(losses[:50], want[:50], rtol=2e-4)
    np.testing.assert_allclose(losses, want, rtol=8e-2)
    assert losses[-1] == pytest.approx(want[-1], rel=3e-2)
    assert losses[-1] < losses[0] * 0.6


# -- optimizer and schedule ------------------------------------------------------


def test_adam_update_matches_adam_torch():
    """The recipe's Adam(lr 1e-4, amsgrad, L2 weight decay 1e-5) equals the
    JAX package's ``adam_torch`` chain (written to be torch.optim.Adam) over
    ten coupled updates.  The JAX chain takes its bias corrections in
    float32 (``1 - 0.999f**t`` is 1.3e-5 off at t = 1), torch in float64, so
    an update differs by up to about 6e-6 of itself: far under rtol 1e-6 of
    the parameters at this learning rate."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    tgt = rng.standard_normal((5, 3)).astype(np.float32)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    args = {"lr": 1e-4, "weight_decay": 1e-5, "amsgrad": True}
    opt, _ = build_optimizer([w], {"name": "Adam", "args": args}, {}, {})
    tx = adam_torch(1e-4, weight_decay=1e-5, amsgrad=True)
    p = jnp.asarray(w0)
    state = tx.init(p)
    for _ in range(10):
        opt.zero_grad()
        ((w - torch.from_numpy(tgt)) ** 2).mean().backward()
        opt.step()
        g = jax.grad(lambda q: jnp.mean((q - tgt) ** 2))(p)
        upd, state = tx.update(g, state, p)
        p = optax.apply_updates(p, upd)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(p), rtol=1e-6, atol=0)
    assert float(np.abs(np.asarray(p) - w0).max()) > 5e-4  # the updates moved the weights


@pytest.mark.parametrize("name,args", [
    ("AdamW", {"lr": 1e-4, "weight_decay": 1e-2}),
    ("SGD", {"lr": 1e-2, "momentum": 0.9, "weight_decay": 1e-3}),
])
def test_other_optimizers_match_jax(name, args):
    """The registry's AdamW (decoupled decay, optax.adamw's defaults) and SGD
    (L2 decay, heavy-ball momentum) give the JAX registry's updates."""
    rng = np.random.default_rng(1)
    w0, tgt = (rng.standard_normal((4, 6)).astype(np.float32) for _ in range(2))
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt, _ = build_optimizer([w], {"name": name, "args": dict(args)}, {}, {})
    tx, _ = jbuild_optimizer({"name": name, "args": dict(args)}, {}, {})
    p = jnp.asarray(w0)
    state = tx.init(p)
    for _ in range(5):
        opt.zero_grad()
        ((w - torch.from_numpy(tgt)) ** 2).mean().backward()
        opt.step()
        upd, state = tx.update(jax.grad(lambda q: jnp.mean((q - tgt) ** 2))(p), state, p)
        p = optax.apply_updates(p, upd)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(p), rtol=1e-5, atol=1e-7)


def test_schedule_matches_jax_across_decays_and_floor():
    kw = dict(gamma=0.5, step_every=3, floor=1e-5)
    ours, theirs = exponential_decay_with_floor(1e-4, **kw), jschedule(1e-4, **kw)
    # the JAX schedule takes gamma**k in float32 (0.95f**45 is 2e-6 off), the port in float64
    lrs = [ours(i) for i in range(40)]
    np.testing.assert_allclose(lrs, [float(theirs(i)) for i in range(40)], rtol=1e-5)
    # two decays, then the floor: one decay fires from the last lr >= 1e-5
    assert lrs[2] == lrs[0] and lrs[3] == pytest.approx(5e-5) and lrs[6] == pytest.approx(2.5e-5)
    assert lrs[-1] == pytest.approx(1e-4 * 0.5**4) and lrs[-1] < 1e-5 <= lrs[-1] / 0.5
    # build_optimizer: the reference's ExponentialLR block, the yaml's lr_change_rate
    _, sched = build_optimizer([torch.nn.Parameter(torch.zeros(1))], OPT,
                               {"name": "ExponentialLR", "args": {"gamma": 0.95}},
                               {"lr_change_rate": 4000})
    _, jsched = jbuild_optimizer(OPT, {"name": "ExponentialLR", "args": {"gamma": 0.95}},
                                 {"lr_change_rate": 4000})
    for count in (0, 3999, 4000, 8000, 10_000_000):
        assert sched(count) == pytest.approx(float(jsched(count)), rel=1e-5)
    with pytest.raises(KeyError, match="registry"):
        build_optimizer([torch.nn.Parameter(torch.zeros(1))], {"name": "Eval"}, {}, {})


def test_train_step_applies_the_schedule_before_each_update(batches):
    """Update i runs at schedule(i) (optax's count before the update),
    across decay boundaries and at the floor."""
    _, v = jax_model_and_params("plain")
    model = torch_model("plain", v)
    opt, sched = build_optimizer(model.parameters(), OPT, SCHED, TCFG)
    state = init_train_state(model, opt, sched)
    step = make_train_step((16, 16), (32, 32), use_remat=False)
    used = []
    orig = opt.step

    def recording_step(*a, **k):
        used.append(opt.param_groups[0]["lr"])
        return orig(*a, **k)

    opt.step = recording_step
    for _ in range(9):
        state, _ = step(state, torch_batch(batches[0][0]))
    assert used == [sched(i) for i in range(9)]
    assert used[:3] == pytest.approx([1e-4, 5e-5, 2.5e-5]) and used[-1] == used[-2] < 1e-5
    assert state.updates == state.step == 9


# -- train steps against the JAX steps ------------------------------------------


@pytest.fixture(scope="module", params=[("plain", 0), ("full", 1)], ids=["plain-compact",
                                                                         "full-raw"])
def three_steps(request, batches):
    """Three JAX train steps (with an EMA of 0.9) on one batch, and the same
    three in the port from the same parameters; plus the port run again from
    the JAX state after step 1 (``train_state_from_jax``)."""
    variant, form = request.param
    batch = batches[0][form]
    jm, v = jax_model_and_params(variant)
    tx, _ = jbuild_optimizer(OPT, SCHED, TCFG)
    jstep = jmake_train_step(jm, tx, (16, 16), (32, 32), use_remat=False, donate=False,
                             ema_decay=0.9)
    jstate = jinit_train_state(v, tx, ema=True)
    jruns = []
    for _ in range(3):
        jstate, m = jstep(jstate, batch)
        jruns.append((jax.tree.map(np.asarray, jstate), {k: float(x) for k, x in m.items()}))

    def port_state():
        model = torch_model(variant, v)
        opt, sched = build_optimizer(model.parameters(), OPT, SCHED, TCFG)
        return init_train_state(model, opt, sched, ema=True)

    step = make_train_step((16, 16), (32, 32), use_remat=False, ema_decay=0.9)
    state, metrics = port_state(), []
    for _ in range(3):
        state, m = step(state, torch_batch(batch))
        metrics.append({k: float(x) for k, x in m.items()})
    carried = port_state()
    train_state_from_jax(jruns[0][0], carried)
    for _ in range(2):
        carried, _ = step(carried, torch_batch(batch))
    return jruns, state, metrics, carried


def test_three_train_steps_match_jax(three_steps):
    jruns, state, metrics, _ = three_steps
    for (_, jm), m in zip(jruns, metrics):
        assert m["train_loss"] == pytest.approx(jm["train_loss"], rel=1e-5)
        assert m["train_mse_loss"] == pytest.approx(jm["train_mse_loss"], rel=1e-5)
        assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-5)
    assert state.step == state.updates == 3
    assert_params_close(state.model, jruns[-1][0].params, rtol=1e-5, atol=1e-7, what="params")


def test_ema_trajectory_matches_jax(three_steps):
    jruns, state, _, _ = three_steps
    want = params_from_jax(jruns[-1][0].ema_params)
    for name, e in state.ema.items():
        np.testing.assert_allclose(e.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    # the EMA lags the parameters
    assert max(float((e - dict(state.model.named_parameters())[n].detach()).abs().max())
               for n, e in state.ema.items()) > 0


def test_train_state_from_jax_continues_the_jax_run(three_steps):
    """Parameters, Adam moments and counts, the schedule's count and the EMA
    carried over after JAX step 1: two more port steps land where JAX step 3 did."""
    jruns, _, _, carried = three_steps
    assert carried.step == carried.updates == 3
    assert_params_close(carried.model, jruns[-1][0].params, rtol=1e-5, atol=1e-7, what="params")
    want = params_from_jax(jruns[-1][0].ema_params)
    for name, e in carried.ema.items():
        np.testing.assert_allclose(e.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-7)


def test_eval_step_clip_mask_matches_jax(h5):
    """A wrap-padded final batch: the clip_mask weighting of the port's eval
    step equals the JAX eval step's, batch for batch."""
    ld = loader(h5[1], batch_size=2, shuffle=False, drop_last=False, pad_last=True, compact=True)
    jm, v = jax_model_and_params("plain", seed=2)
    model = torch_model("plain", v)
    jeval = jmake_eval_step(jm, (16, 16), (32, 32))
    ev = make_eval_step((16, 16), (32, 32))
    masks = []
    for b in ld:
        got, want = ev(model, torch_batch(b)), jeval(v, b)
        for k in ("valid_loss", "valid_mse_loss", "valid_clips"):
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
        masks.append(b["clip_mask"])
    assert masks[-1].tolist() == [1.0, 0.0]  # 39 clips, batch 2


# -- port-only step behaviour -------------------------------------------------


def _port_state(variant="plain", ema=False, seed=0):
    _, v = jax_model_and_params(variant, seed=seed)
    model = torch_model(variant, v)
    opt, sched = build_optimizer(model.parameters(), OPT, {}, {})
    return init_train_state(model, opt, sched, ema=ema)


def test_remat_matches_no_remat(batches):
    b = torch_batch(batches[0][0])
    grads = []
    for remat in (True, False):
        state = _port_state()
        loss, _ = sequence_loss(state.model, b, (16, 16), (32, 32), use_remat=remat)
        loss.backward()
        grads.append((float(loss.detach()), [p.grad.clone() for p in state.model.parameters()]))
    assert grads[0][0] == grads[1][0]
    for a, c in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-9)


def test_grad_accum_matches_full_batch(batches):
    b = torch_batch(batches[0][0])
    runs = []
    for accum in (1, 2):
        state = _port_state()
        state, m = make_train_step((16, 16), (32, 32), use_remat=False, grad_accum=accum)(state, b)
        runs.append((state, m))
    (s1, m1), (s2, m2) = runs
    assert float(m2["train_loss"]) == pytest.approx(float(m1["train_loss"]), rel=1e-6)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]), rel=1e-5)
    for a, c in zip(s1.model.parameters(), s2.model.parameters()):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        make_train_step((16, 16), (32, 32), grad_accum=3)(_port_state(), b)


def test_nonfinite_step_leaves_state_bit_identical(batches):
    b = torch_batch(batches[0][0])
    nan_term = ("nan", 1.0, lambda pred, gt, aux: torch.tensor(float("nan")))
    state = _port_state(ema=True)
    good = make_train_step((16, 16), (32, 32), use_remat=False, skip_nonfinite=True,
                           ema_decay=0.9)
    bad = make_train_step((16, 16), (32, 32), use_remat=False, skip_nonfinite=True,
                          ema_decay=0.9, extra_losses=(nan_term,))
    state, m = good(state, b)
    assert m["train_skipped"] == 0
    params = [p.detach().clone() for p in state.model.parameters()]
    moments = {i: {k: v.clone() for k, v in s.items()}
               for i, s in state.optimizer.state_dict()["state"].items()}
    state, m = bad(state, b)
    assert m["train_skipped"] == 1 and not np.isfinite(float(m["train_loss"]))
    assert (state.step, state.updates) == (2, 1)
    for p, q in zip(state.model.parameters(), params):
        assert torch.equal(p.detach(), q)
    after = state.optimizer.state_dict()["state"]
    assert sorted(after) == sorted(moments)
    for i, s in moments.items():
        assert sorted(after[i]) == sorted(s) and "max_exp_avg_sq" in s
        for k, v in s.items():
            assert torch.equal(after[i][k], v), (i, k)


# -- checkpoints, resume and the trainer ------------------------------------------


def test_save_resume_continues_identically(batches, tmp_path):
    bs = [torch_batch(b[0]) for b in batches] * 3
    step = make_train_step((16, 16), (32, 32), use_remat=False, ema_decay=0.5)
    state = _port_state(ema=True)
    full = [float(step(state, b)[1]["train_loss"]) for b in bs]

    state = _port_state(ema=True)
    for b in bs[:3]:
        step(state, b)
    path = save_checkpoint(str(tmp_path), state, iteration=2, meta={"experiment": "t"})
    save_checkpoint(str(tmp_path), state, iteration=2)  # over an existing one
    assert latest_checkpoint(str(tmp_path)) == path and sorted(os.listdir(tmp_path)) == [
        "iteration_2"]
    fresh = _port_state(ema=True, seed=9)
    restored, meta = restore_checkpoint(path, fresh)
    assert meta["iteration"] == 2 and restored.step == restored.updates == 3
    resumed = [float(step(restored, b)[1]["train_loss"]) for b in bs[3:]]
    assert resumed == full[3:]
    with pytest.raises(ValueError, match="EMA"):
        restore_checkpoint(path, _port_state(ema=False))


def _cfg(tmp_path, **trainer_over):
    icfg = {"enabled": True, "iterations": 8, "save_period": 50, "train_log_step": 2,
            "valid_log_step": 10, "valid_step": 50, "lr_change_rate": 4}
    trainer = {"output_path": str(tmp_path), "monitor": "min valid_loss", "early_stop": 100,
               "tensorboard": False, "remat": False, "iteration_based_train": icfg}
    trainer.update(trainer_over)
    return {
        "experiment": "torch_train",
        "model": {"args": {"n_c": 8, "n_b": 2, "variant": "plain"}},
        "optimizer": {"name": "Adam", "args": {"lr": 1e-3}},
        "lr_scheduler": {"name": "ExponentialLR", "args": {"gamma": 0.95}},
        "trainer": trainer,
        "train_dataloader": {"dataset": {"scale": 2}},
    }


def _trainer(h5, tmp_path, runid, valid=True, **trainer_over):
    return Trainer(RunConfig(_cfg(tmp_path, **trainer_over), runid=runid),
                   train_loader=loader(h5[0], compact=True),
                   valid_loader=loader(h5[1], shuffle=False, drop_last=False, pad_last=True,
                                       compact=True) if valid else None,
                   seed=0, device="cpu")


def test_early_stop_checkpoint_label_counts_the_finished_iteration(h5, tmp_path):
    tr = _trainer(h5, tmp_path, "es", iteration_based_train={
        "enabled": True, "iterations": 20, "save_period": 50, "train_log_step": 2,
        "valid_log_step": 10, "valid_step": 2, "lr_change_rate": 10})
    steps = {"n": 0}
    orig = tr.train_step

    def counting(state, batch):
        steps["n"] += 1
        return orig(state, batch)

    tr.train_step = counting
    tr._eval_monitor = lambda log: (True, False)  # stop at the first validation
    tr.train()
    assert steps["n"] == 3  # iterations 0, 1, 2; validation after 2
    assert tr.resume(latest_checkpoint(tr.run.save_dir)) == steps["n"]


def test_sigterm_drains_to_a_checkpoint(h5, tmp_path):
    """SIGTERM lets the running iteration finish, checkpoints it and ends the
    loop; a second SIGTERM exits at once.  (The handler is driven directly:
    a real signal would end a test worker that has none installed.)"""
    tr = _trainer(h5, tmp_path, "term", valid=False)
    before = signal.getsignal(signal.SIGTERM)
    steps = {"n": 0}
    orig = tr.train_step

    def step(state, batch):
        steps["n"] += 1
        if steps["n"] == 2:
            tr._on_sigterm(signal.SIGTERM, None)
        return orig(state, batch)

    tr.train_step = step
    tr.train()
    assert steps["n"] == 2 and tr.state.step == 2
    latest = latest_checkpoint(tr.run.save_dir)
    assert latest.endswith("iteration_1")
    assert tr.resume(latest) == 2
    assert signal.getsignal(signal.SIGTERM) == before  # the handler is put back
    exits = []
    tr._exit_now = lambda: exits.append(True)
    tr._on_sigterm(signal.SIGTERM, None)
    assert exits == [True]


def test_trainer_end_to_end_with_validation_and_ema(h5, tmp_path):
    tr = _trainer(h5, tmp_path, "e2e", ema=0.95, iteration_based_train={
        "enabled": True, "iterations": 6, "save_period": 3, "train_log_step": 2,
        "valid_log_step": 10, "valid_step": 3, "lr_change_rate": 2})
    result = tr.train()
    assert np.isfinite(result["train_loss"]) and tr.state.step == 6
    assert os.path.isdir(os.path.join(tr.run.save_dir, "best"))
    assert latest_checkpoint(tr.run.save_dir).endswith("iteration_5")
    assert tr.resume(latest_checkpoint(tr.run.save_dir)) == 6


def test_trainer_sets_deterministic_cudnn(h5, tmp_path, monkeypatch):
    """Trainer turns cuDNN's deterministic algorithms on and its autotuner
    off, as the reference's init_seeds does, so a resumed run repeats an
    uninterrupted one on the card with no caller setting the flags."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    _trainer(h5, tmp_path, "det", valid=False)
    assert torch.backends.cudnn.deterministic is True
    assert torch.backends.cudnn.benchmark is False


def test_trainer_refuses_what_it_cannot_run(h5, tmp_path):
    # outside a group the one rank does not divide the degree (the JAX
    # trainer's "does not divide the 1 available devices")
    with pytest.raises(ValueError, match="model_parallel"):
        _trainer(h5, tmp_path, "model_parallel", model_parallel=2)
    # one process: a multi-slice recipe never silently trains on one device
    with pytest.raises(ValueError, match="requires data parallelism"):
        _trainer(h5, tmp_path, "dcn_slices", dcn_slices=2)
    with pytest.raises(ValueError, match="serving-only"):
        build_model({"model": {"args": {"quant": "pconv"}}}, scale=2)
    assert build_model({"model": {"args": {"variant": "plain", "quant": "qat"}}}, 2).quant == "qat"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(RunConfig(_cfg(tmp_path), runid="dev"), train_loader=loader(h5[0]), seed=0)


def test_trainer_raises_on_an_epoch_without_a_batch(h5, tmp_path):
    """A loader that yields no batch (fewer clips than batch_size under
    drop_last, as a node's shard of a small datalist can) raises instead of
    looping forever."""
    tr = Trainer(RunConfig(_cfg(tmp_path), runid="empty"),
                 train_loader=loader(h5[0], batch_size=1000), seed=0, device="cpu")
    with pytest.raises(ValueError, match="no batch in an epoch"):
        tr.train()


def test_inp_len_ships_only_for_event_terms(h5, tmp_path):
    def fn(pred, gt, aux):
        assert "events_len" in aux and aux["events"].shape[-2] == 4
        return torch.zeros(())

    fn.needs_events = True
    plain = _trainer(h5, tmp_path, "lean", valid=False)
    assert "inp_len" not in plain._step_keys
    with pytest.raises(ValueError, match="compact_transfer"):
        Trainer(RunConfig(_cfg(tmp_path), runid="ev0"), train_loader=loader(h5[0], compact=True),
                seed=0, extra_losses=(("ev", 1.0, fn),), device="cpu")
    tr = Trainer(RunConfig(_cfg(tmp_path), runid="ev1"), train_loader=loader(h5[0]), seed=0,
                 extra_losses=(("ev", 1.0, fn),), device="cpu")
    assert "inp_len" in tr._step_keys
    batch = next(tr._device_prefetched(tr.train_loader))
    assert "inp_len" in batch and "gt_len" not in batch
    tr.train_step(tr.state, batch)  # fn's asserts run inside the step


def _zero_term(spec, ctx):
    """A custom term's builder, reached by its dotted path."""
    return lambda pred, gt: torch.zeros(())  # the two-argument form, adapted


def test_extra_loss_terms(batches):
    from bmcnet_esr_torch.training.losses import build_extra_losses

    b = torch_batch(batches[0][0])
    model = _port_state().model
    base, _ = sequence_loss(model, b, (16, 16), (32, 32))
    extra = build_extra_losses({"l1": 0.5, "charbonnier": 0.25,
                                "mine": {"fn": f"{__name__}:_zero_term", "weight": 2.0}})
    assert [(n, w) for n, w, _ in extra] == [("l1", 0.5), ("charbonnier", 0.25), ("mine", 2.0)]
    tot, _ = sequence_loss(model, b, (16, 16), (32, 32), extra_losses=extra)
    assert float(tot) > float(base)
    zero, _ = sequence_loss(model, b, (16, 16), (32, 32), extra_losses=extra[2:])
    assert float(zero) == float(base)
    with pytest.raises(KeyError, match="unknown loss term"):
        build_extra_losses({"nope": 1.0})
    with pytest.raises(ValueError, match="lpips term needs its weights"):
        build_extra_losses({"lpips": 1.0})  # ported: it needs an LPIPS bundle


# -- the CLI and the recipe ---------------------------------------------------------


def test_cli_train_on_the_cpu(h5, tmp_path):
    """``cli.train --device cpu`` for 5 iterations on a fixture datalist: one
    clip per file, so every iteration sees the same batch and the loss falls."""
    import yaml

    lst = tmp_path / "train.txt"
    lst.write_text(f"{h5[0]}\n")
    cfg = load_yaml(os.path.join(REPO, "configs", "train_nfs.yml"))
    ds = {"scale": 2, "ori_scale": "down2", "window": 128, "sliding_window": 64,
          "dataset_length": 3, "data_augment": {"enabled": False},
          "sequence": {"sequence_length": 3, "seqn": 2, "step_size": None}}
    for key in ("train_dataloader", "valid_dataloader"):
        cfg[key].update(path_to_datalist_txt=str(lst), batch_size=1, num_workers=1,
                        dataset={**cfg[key]["dataset"], **ds})
    cfg["model"]["args"].update(n_c=8, n_b=2, variant="plain")
    cfg["trainer"].update(output_path=str(tmp_path / "runs"), tensorboard=False)
    cfg["trainer"]["iteration_based_train"].update(
        iterations=5, save_period=100, train_log_step=1, valid_step=4)
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(cfg))
    cli_train.main(["-c", str(path), "-id", "cpu", "-lr", "1e-3", "--device", "cpu"])
    log = (tmp_path / "runs" / "logs" / "BMCNet_nfs" / "cpu" / "info.txt").read_text()
    losses = [float(line.split("train_loss: ")[1].split()[0])
              for line in log.splitlines() if "train_loss: " in line]
    assert len(losses) == 5 and np.all(np.isfinite(losses)), log
    assert losses[-1] < losses[0], losses
    assert "valid_loss" in log
    ckpt = latest_checkpoint(str(tmp_path / "runs" / "models" / "BMCNet_nfs" / "cpu"))
    assert ckpt.endswith("iteration_4")
    # --distributed outside a torchrun launch: the missing environment is named
    with pytest.raises(RuntimeError, match="lacks RANK, WORLD_SIZE.*torchrun"):
        cli_train.main(["-c", str(path), "--distributed", "--device", "cpu"])


def test_chip_smoke_recipe_is_the_yaml():
    import chip_smoke

    assert chip_smoke.nfs_recipe() == load_yaml(os.path.join(REPO, "configs", "train_nfs.yml"))


# -- export and serving a training checkpoint ----------------------------------


def test_export_torch_state_dict_round_trip():
    z = np.load(os.path.join(GOLDENS, "plain_nfs_x4_ckpt.npz"))
    ref = {k[3:]: z[k] for k in z.files if k.startswith("sd/")}
    sd = load_checkpoint(os.path.join(GOLDENS, "plain_nfs_x4_ckpt.npz"))
    out = export_torch_state_dict(sd, "plain", 5)
    assert sorted(out) == sorted(ref) and len(out) == 120
    for k, v in ref.items():
        assert np.array_equal(out[k].numpy(), v), k
    back = convert_torch_state_dict(out)
    assert all(torch.equal(back[k], sd[k]) for k in sd) and sorted(back) == sorted(sd)

    full = BMCNet(scale=4, n_c=16, n_b=2, generator=torch.Generator().manual_seed(5))
    sd = full.state_dict()
    out = export_torch_state_dict(sd, "full", 2)
    assert sorted(out) == sorted(torch_key_manifest("full", 2))
    back = convert_torch_state_dict(out)
    assert all(torch.equal(back[k], sd[k]) for k in sd) and sorted(back) == sorted(sd)
    # the same layout as the JAX package's exporter
    want = jexport(jconvert({k: v.numpy() for k, v in out.items()}), "full", 2)
    assert all(np.array_equal(out[k].numpy(), want[k]) for k in want)


@pytest.fixture(scope="module")
def trained(h5, tmp_path_factory):
    """A port training checkpoint with an EMA and one without."""
    d = tmp_path_factory.mktemp("served")
    out = {}
    for ema in (0.9, 0.0):
        state = _port_state(ema=ema > 0)
        step = make_train_step((16, 16), (32, 32), use_remat=False, ema_decay=ema)
        for b in loader(h5[0], compact=True):
            step(state, torch_batch(b))
            if state.step == 2:
                break
        out[ema] = (save_checkpoint(str(d / str(ema)), state, iteration=1), state)
    return out


def test_engine_serves_a_training_checkpoint_and_its_ema(trained):
    path, state = trained[0.9]
    for use_ema, want in ((True, state.ema), (False, dict(state.model.named_parameters()))):
        m = load_model_for_inference(path, 2, n_c=8, n_b=2, variant="plain", device="cpu",
                                     use_ema=use_ema)
        for name, p in m.named_parameters():
            assert torch.equal(p.detach(), want[name].detach()), name
    with pytest.raises(ValueError, match="no EMA"):
        load_model_for_inference(trained[0.0][0], 2, n_c=8, n_b=2, variant="plain",
                                 device="cpu", use_ema=True)
    with pytest.raises(ValueError, match="params only"):
        load_model_for_inference(os.path.join(GOLDENS, "plain_nfs_x4_ckpt.npz"), 4,
                                 variant="plain", device="cpu", use_ema=True)
    with pytest.raises(NotImplementedError, match="train_state_from_jax"):
        load_checkpoint(os.path.dirname(path))  # no state file: an Orbax directory


def test_cli_infer_ema_serves_the_ema(trained, tmp_path):
    data = write_synthetic_fixture(str(tmp_path / "v.h5"), (32, 32), ("ori", "down2"),
                                   {"ori": 8000, "down2": 2000}, seed=6)
    path, _ = trained[0.9]
    argv = ["--model_path", path, "--variant", "plain", "--n_c", "8", "--n_b", "2",
            "--scale", "2", "--ori_scale", "down2", "--window", "128", "--sliding_window",
            "64", "--data_path", data, "--need_gt_events", "--no_images", "--device", "cpu"]
    got = cli_infer.main(argv + ["--output_path", str(tmp_path / "ema"), "--ema"])
    raw = cli_infer.main(argv + ["--output_path", str(tmp_path / "raw")])
    model = load_model_for_inference(path, 2, n_c=8, n_b=2, variant="plain", device="cpu",
                                     use_ema=True)
    cfg = DatasetConfig(scale=2, ori_scale="down2", window=128, sliding_window=64,
                        sequence=SequenceConfig(9, 2, 1))
    want = InferenceEngine(model, cfg, visualize=False, device="cpu").infer_file(data)
    assert got["mean"]["esr_mse"] == pytest.approx(want["esr_mse"], rel=1e-6)
    assert got["mean"]["esr_mse"] != raw["mean"]["esr_mse"]
    with pytest.raises(ValueError, match="no EMA"):
        cli_infer.main(argv[:1] + [trained[0.0][0]] + argv[2:]
                       + ["--output_path", str(tmp_path / "x"), "--ema"])

