"""Tensor parallelism of bmcnet_esr_torch on the CPU: ``model_parallel`` over
gloo ranks against one process and against the JAX package's channel-sharded
step, with BMCNet_plain and BMCNet at n_c=8, n_b=2, x2.

Ranks run as spawned processes (``tests/torch_parallel_worker.py``, as in
``tests/test_torch_parallel.py``); the JAX references run here, on the
suite's 8 virtual CPU devices.  Three spawns serve every test: 2 ranks on a
``(1, 2)`` mesh (the steps, QAT, bf16, the crossings' gradient checks, the
resume across layouts), 4 on ``(1, 4)`` (the steps) and 4 on ``(2, 2)`` (the
steps and the ``Trainer``).

Tolerances are ``tests/test_parallel.py``'s for its tensor-parallel step:
loss and eval rel 1e-5, ``grad_norm`` rel 1e-4, parameters (and Adam's
moments and the EMA) atol 1e-5 after two Adam steps; the crossings' float64
central differences atol 1e-7 against values of order 1; the bf16 forward
rel-RMSE 1e-2 (about three bf16 roundings) against the one-process bf16
forward.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bmcnet_esr_tpu.models import BMCNet as JBMCNet
from bmcnet_esr_tpu.models import BMCNetPlain as JBMCNetPlain
from bmcnet_esr_tpu.parallel import channel_sharding as jchannel_sharding
from bmcnet_esr_tpu.parallel import make_mesh_2d as jmake_mesh_2d
from bmcnet_esr_tpu.parallel import make_parallel_eval_step as jmake_parallel_eval_step
from bmcnet_esr_tpu.parallel import make_parallel_train_step as jmake_parallel_train_step
from bmcnet_esr_tpu.parallel import shard_batch as jshard_batch
from bmcnet_esr_tpu.parallel import shard_tree_channels as jshard_tree_channels
from bmcnet_esr_tpu.training.optim import build_optimizer as jbuild_optimizer
from bmcnet_esr_tpu.training.train_step import init_train_state as jinit_train_state

import torch_parallel_worker as worker
from test_torch_parallel import join, launch, save_batches
from bmcnet_esr_torch.models import params_from_jax
from bmcnet_esr_torch.models.convert import export_torch_state_dict, train_state_from_jax
from bmcnet_esr_torch.ops.batch import compact_events
from bmcnet_esr_torch.parallel import ChannelGroup, ChannelParallelForward, channel_sharding
from bmcnet_esr_torch.training import build_optimizer, init_train_state, make_eval_step
from bmcnet_esr_torch.training import make_train_step
from bmcnet_esr_torch.training.checkpoint import latest_checkpoint
from bmcnet_esr_torch.training.config import RunConfig

B, L = 4, 4  # the global batch: 4 clips of 4 windows, 3 BPTT steps
VARIANTS = ("plain", "full")
# world, n_model, train steps (one on the 4-way model axis, whose gloo
# collectives cost the most here)
MESHES = {"1x2": (2, 2, 2), "1x4": (4, 4, 1), "2x2": (4, 2, 2)}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def clip_batch(rng, empty_gt_clip=None, hot_gt_clip=None):
    """A compact batch of B clips x L windows at 16x16 (64 events) and
    32x32 (256); ``empty_gt_clip``'s GT windows hold no event,
    ``hot_gt_clip``'s a wider range of counts than the other clips'."""
    out = {}
    for prefix, hw, n in (("inp", worker.LR, 64), ("gt", worker.GT, 256)):
        ev = np.zeros((B, L, 4, n), np.float32)
        ev[:, :, 0] = rng.integers(0, hw[1], (B, L, n))
        ev[:, :, 1] = rng.integers(0, hw[0], (B, L, n))
        ev[:, :, 3] = rng.integers(0, 2, (B, L, n)) * 2 - 1
        if prefix == "gt" and empty_gt_clip is not None:
            ev[empty_gt_clip, :, 3] = 0
        if prefix == "gt" and hot_gt_clip is not None:  # a quarter of its events on one pixel
            ev[hot_gt_clip, :, :2, : n // 4] = 0
        out[f"{prefix}_xy"], out[f"{prefix}_p"] = compact_events(ev)
    return out


def torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def jax_flat(params, variant):
    """A JAX parameter tree flattened in the port's parameter order."""
    named = params_from_jax(jax.tree.map(np.asarray, params))
    return np.concatenate([named[n].reshape(-1).numpy()
                           for n, _ in worker.tp_model(variant).named_parameters()])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The batches and, per variant, the JAX-initialized state carried into
    the port (``tp-<variant>.pt``, an EMA of 0.9); the one-device Trainer's
    first half of the resume case; then, while every mesh's ranks run
    (launched here, joined by ``ranks``), the JAX tensor-parallel steps and
    eval step on ``make_mesh_2d(2, 4)`` and the one-device Trainer's
    uninterrupted run."""
    work = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(1)
    train = [clip_batch(rng) for _ in range(2)]
    poisoned = clip_batch(rng, empty_gt_clip=B - 1)
    valid = dict(clip_batch(rng), clip_mask=np.asarray([1, 1, 1, 0], np.float32))
    for name, bs in (("train", train), ("poisoned", [poisoned]), ("valid", [valid])):
        save_batches(work / f"{name}.npz", bs)
    np.save(work / "tp_window.npy", rng.poisson(0.3, (2, 2, *worker.LR, 2)).astype(np.float32))
    ranged = clip_batch(rng, hot_gt_clip=B - 1)
    save_batches(work / "ranged.npz", [ranged])
    jax_states = {}
    for variant in VARIANTS:
        jm = (JBMCNet if variant == "full" else JBMCNetPlain)(scale=2, n_c=8, n_b=2)
        v = jm.init(jax.random.key(3), jnp.zeros((1, 2, *worker.LR, 2)),
                    *jm.init_state(1, *worker.LR))
        tx, _ = jbuild_optimizer(worker.OPT, worker.SCHED, worker.TCFG)
        jax_states[variant] = jm, v, tx, jinit_train_state(v, tx, ema=True)
        model = worker.tp_model(variant)
        opt, sched = build_optimizer(model.parameters(), worker.OPT, worker.SCHED, worker.TCFG)
        state = init_train_state(model, opt, sched, ema=True)
        train_state_from_jax(jax.tree.map(np.asarray, jax_states[variant][3]), state)
        torch.save(state.state_dict(), work / f"tp-{variant}.pt")
    one_first, first = worker.resume_trainer(str(work), "one_first", 2)
    one_first.train()
    parts = {"1x2": ("guard", "extras", "resume", "float64"), "1x4": ("float64",),
             "2x2": ("guard", "trainer")}
    launched = {name: launch("tp", world, work, tag=name, n_model=n_model, steps=steps,
                             parts=parts[name])
                for name, (world, n_model, steps) in MESHES.items()}

    mesh = jmake_mesh_2d(2, 4)
    jax_runs = {}
    for variant, (jm, v, tx, jstate) in jax_states.items():
        shardings = jchannel_sharding(jstate, mesh)
        step = jmake_parallel_train_step(jm, tx, worker.LR, worker.GT, mesh, use_remat=False,
                                         state_shardings=shardings, ema_decay=0.9)
        params = jax.device_put(jstate.params, jchannel_sharding(jstate.params, mesh))
        tp_state, metrics, after = jax.device_put(jstate, shardings), [], []
        for b in train:
            tp_state, m = step(tp_state, jshard_batch(b, mesh))
            metrics.append([float(m[k]) for k in ("train_loss", "train_mse_loss", "grad_norm")])
            after.append({"params": jax_flat(tp_state.params, variant),
                          "ema": jax_flat(tp_state.ema_params, variant)})
        ev = jmake_parallel_eval_step(jm, worker.LR, worker.GT, mesh,
                                      params_shardings=jchannel_sharding(jstate.params, mesh))
        m = ev(params, jshard_batch(valid, mesh))
        jax_runs[variant] = {
            "metrics": np.asarray(metrics), "after": after,
            "eval": np.asarray([float(m[k]) for k in ("valid_loss", "valid_mse_loss",
                                                      "valid_clips")]),
            "v": v,
        }
    whole, losses = worker.resume_trainer(str(work), "one_whole", 4)
    whole.train()
    return {"work": work, "jax": jax_runs, "train": train, "valid": valid,
            "one_first": one_first, "first": first, "whole": whole, "whole_losses": losses,
            "launched": launched}


@pytest.fixture(scope="module")
def one_process(setup):
    """The port's one-process runs from the carried states: two train
    steps (the state after each) and the eval step a variant, two QAT
    steps, the bf16 forward."""
    work, out = str(setup["work"]), {}
    for variant in VARIANTS:
        state, metrics, after = worker.tp_state(work, variant), [], []
        step = make_train_step(worker.LR, worker.GT, use_remat=False, ema_decay=0.9)
        for b in setup["train"]:
            state, m = step(state, torch_batch(b))
            metrics.append([float(m[k]) for k in ("train_loss", "train_mse_loss", "grad_norm")])
            after.append(worker.flat_state(state))
        out[variant] = {"metrics": np.asarray(metrics), "after": after}
        m = make_eval_step(worker.LR, worker.GT)(worker.tp_state(work, variant).model,
                                                 torch_batch(setup["valid"]))
        out[variant]["eval"] = np.asarray([float(m[k]) for k in ("valid_loss", "valid_mse_loss",
                                                                 "valid_clips")])
    state = worker.tp_state(work, "plain")
    step = make_train_step(worker.LR, worker.GT, use_remat=False, extra_losses=worker.loss_terms())
    state, m = step(state, torch_batch(setup["train"][0]))
    out["terms"] = np.asarray([float(m[k]) for k in ("train_loss", "train_mse_loss",
                                                     "grad_norm")])
    out["terms/params"] = worker.flat_params(state.model)
    state = worker.tp_state(work, "plain")
    step = make_train_step(worker.LR, worker.GT, use_remat=False,
                           extra_losses=worker.loss_terms(worker.RANGE_TERMS))
    state, m = step(state, worker.batches(work, "ranged")[0])
    out["range"] = np.asarray([float(m[k]) for k in ("train_loss", "train_mse_loss",
                                                     "grad_norm")])
    out["range/params"] = worker.flat_params(state.model)
    state = worker.tp_state(work, "plain", quant="qat")
    step = make_train_step(worker.LR, worker.GT, use_remat=False)
    out["qat/losses"] = np.asarray([float(step(state, torch_batch(b))[1]["train_loss"])
                                    for b in setup["train"][:2]])
    out["qat/params"] = worker.flat_params(state.model)
    model = worker.tp_state(work, "full", dtype=torch.bfloat16).model
    with torch.no_grad():
        x = torch.from_numpy(np.load(setup["work"] / "tp_window.npy"))
        carry = model.init_state(x.shape[0], *worker.LR)
        for _ in range(2):
            carry = model(x, *carry)
    out["bf16/pred"] = carry[-1].float().numpy()
    return out


@pytest.fixture(scope="module")
def ranks(setup):
    """Each mesh's ranks' results."""
    return {name: join(launched) for name, launched in setup["launched"].items()}


# -- the sharding rule ------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_channel_sharding_matches_the_jax_rule(variant, setup, ranks):
    """``channel_sharding`` splits the parameters JAX's does, and each rank
    of a model axis of 4 holds the shard shapes ``shard_tree_channels``
    gives on ``make_mesh_2d(2, 4)`` (``test_params_actually_channel_sharded``)."""
    from torch.distributed.tensor import Replicate, Shard

    v = setup["jax"][variant]["v"]
    mesh = jmake_mesh_2d(2, 4)
    split = jax.tree.map(lambda leaf, sh: np.full(leaf.shape, float("model" in sh.spec)),
                         v, jchannel_sharding(v, mesh))
    want = {n: bool(t.reshape(-1)[0]) for n, t in params_from_jax(split).items()}
    placements = channel_sharding(worker.tp_model(variant), 4)
    assert {n: isinstance(p, Shard) for n, p in placements.items()} == want
    assert any(want.values()) and all(isinstance(p, (Shard, Replicate))
                                      for p in placements.values())
    placed = jshard_tree_channels(v, mesh)
    shards = params_from_jax(jax.tree.map(
        lambda leaf: np.zeros(leaf.addressable_shards[0].data.shape, np.float32), placed))
    rows = [shards[n].shape[0] for n, _ in worker.tp_model(variant).named_parameters()]
    for r in ranks["1x4"]:
        assert r[f"{variant}/shapes"].tolist() == rows
    # the output head's 2 * scale**2 = 8 channels split too, the LayerNorms with the convs
    assert isinstance(placements["neuro.conv_o.weight"], Shard)
    assert channel_sharding(worker.tp_model(variant), 3)["neuro.conv_o.weight"] == Replicate()


# -- the train and eval steps -------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mesh", MESHES)
def test_tp_train_step_matches_one_process_and_jax(mesh, variant, setup, one_process, ranks):
    """Steps of 3 BPTT steps from the carried state: every rank's metrics
    and the gathered parameters equal the port's one-process step and the
    JAX step on ``make_mesh_2d(2, 4)``."""
    steps = MESHES[mesh][2]
    one, jx = one_process[variant], setup["jax"][variant]
    want = one["after"][steps - 1]["params"]
    for r in ranks[mesh]:
        got = r[f"{variant}/metrics"]
        for ref in (one["metrics"][:steps], jx["metrics"][:steps]):
            np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=1e-5)
            np.testing.assert_allclose(got[:, 2], ref[:, 2], rtol=1e-4)
        np.testing.assert_allclose(r[f"{variant}/params"], want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(r[f"{variant}/params"], jx["after"][steps - 1]["params"],
                                   rtol=0, atol=1e-5)
        assert r[f"{variant}/counts"].tolist() == [steps, steps]
    assert np.abs(want - jx["after"][steps - 1]["params"]).max() > 0  # two frameworks
    assert np.abs(want - worker.flat_params(worker.tp_state(str(setup["work"]), variant).model)
                  ).max() > 1e-5  # the steps moved the parameters


@pytest.mark.parametrize("mesh", MESHES)
def test_gather_tree_rebuilds_moments_and_ema(mesh, setup, one_process, ranks):
    """Adam's moments and the EMA, stepped on the slices, come back whole
    from ``gather_tree`` equal to the one-process state's, on every rank of
    the model group; the EMA also equals JAX's."""
    steps = MESHES[mesh][2]
    for variant in VARIANTS:
        one = one_process[variant]["after"][steps - 1]
        for r in ranks[mesh]:
            for key in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq", "ema"):
                np.testing.assert_allclose(r[f"{variant}/{key}"], one[key], rtol=0, atol=1e-5,
                                           err_msg=f"{variant} {key}")
        np.testing.assert_allclose(ranks[mesh][0][f"{variant}/ema"],
                                   setup["jax"][variant]["after"][steps - 1]["ema"],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mesh", MESHES)
def test_tp_eval_step_matches_one_process_and_jax(mesh, variant, setup, one_process, ranks):
    for r in ranks[mesh]:
        got = r[f"{variant}/eval"]
        np.testing.assert_allclose(got, one_process[variant]["eval"], rtol=1e-5)
        np.testing.assert_allclose(got, setup["jax"][variant]["eval"], rtol=1e-5)
        assert got[2] == 3.0  # clip_mask [1, 1, 1, 0]


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_nonfinite_rows_skip_every_rank(mesh, ranks):
    """The last clip's loss is NaN: on the (2, 2) mesh only the ranks of
    data row 1 hold it; every rank skips, nothing moves."""
    for r in ranks[mesh]:
        assert r["skipped"].tolist() == [1, 1, 0]
        assert not np.isfinite(r["skip_loss"]) and float(r["skip_moved"]) == 0.0


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_float64_gradient_equals_one_process(mesh, variant, setup, ranks):
    """In float64 the channel-parallel gradient is the one-process gradient
    to 1e-12 (||d||/||g||): every crossing sums what it must, and what
    float32 leaves between the two is round-off (on the card, of cuDNN's
    algorithms at the sliced shapes)."""
    from bmcnet_esr_torch.training.train_step import sequence_loss

    m = worker.float64_state(str(setup["work"]), variant)
    total, _ = sequence_loss(m, torch_batch(setup["train"][0]), worker.LR, worker.GT,
                             use_remat=False)
    total.backward()
    want = np.concatenate([p.grad.reshape(-1).numpy() for p in m.parameters()])
    for r in ranks[mesh]:
        got = r[f"f64/{variant}"]
        assert got.dtype == np.float64
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-12


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_loss_terms_under_model_parallel(mesh, one_process, ranks):
    """recon, temporal consistency, TV and SSIM attached through the
    ``loss:`` block on a model axis of 2: the one-process step's loss,
    ``grad_norm`` and parameters."""
    want = one_process["terms"]
    assert want[0] > want[1]  # the terms add to the MSE
    for r in ranks[mesh]:
        np.testing.assert_allclose(r["terms"][:2], want[:2], rtol=1e-5)
        np.testing.assert_allclose(r["terms"][2], want[2], rtol=1e-4)
        np.testing.assert_allclose(r["terms/params"], one_process["terms/params"], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_unpinned_ssim_under_model_parallel(mesh, one_process, ranks):
    """SSIM with its range unpinned on a model axis of 2, on a batch whose
    last clip's GT counts range wider: the GT's range is the whole batch's,
    over the data axis of 2x2 and alike on the ranks of a model group, as in
    the one-process step."""
    want = one_process["range"]
    for r in ranks[mesh]:
        np.testing.assert_allclose(r["range"][:2], want[:2], rtol=1e-5)
        np.testing.assert_allclose(r["range"][2], want[2], rtol=1e-4)
        np.testing.assert_allclose(r["range/params"], one_process["range/params"], rtol=0,
                                   atol=1e-5)


def test_split_convolutions_take_pytorchs_own_kernels(ranks):
    """Inside ``OwnConvolutions`` (the forward enters it on CUDA) every
    float32 convolution of the channel-parallel forward, those inside the
    model's modules included, goes through ``own_conv2d``, none of the bf16
    ones; on the CPU the forward leaves them all to ``F.conv2d``."""
    for r in ranks["1x2"]:
        own32, left32 = r["conv/float32/True"].tolist()
        own16, left16 = r["conv/bfloat16/True"].tolist()
        assert own32 > 0 and left32 == 0
        assert own16 == 0 and left16 == own32
        assert r["conv/float32/None"].tolist() == [0, 0]


@pytest.mark.parametrize("kernel", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_own_convolutions_keep_exact_zeros(dtype, kernel):
    """Under ``OwnConvolutions`` a float32 ``F.conv2d`` runs PyTorch's own
    kernels forward and backward: an output whose input patch is all zero is
    exactly the bias, and the values and gradients are ``F.conv2d``'s, with
    channels-last weights too (a 1x1 one counts as contiguous).  Other
    dtypes, grouped and dilated convolutions are left to ``F.conv2d``."""
    import torch.nn.functional as F

    from bmcnet_esr_torch.parallel.tensor import OwnConvolutions

    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 5, 9, 11), generator=g).to(dtype)
    x[:, :, :4] = 0.0  # rows 0-2 of the output see only zeros
    x = x.contiguous(memory_format=torch.channels_last)
    w = (torch.randn((6, 5, kernel, kernel), generator=g) * 0.1).to(dtype)
    # channels-last strides as Module.to(memory_format=) lays a weight out
    w = torch.empty_strided(w.shape, (5 * kernel**2, 1, 5 * kernel, 5), dtype=dtype).copy_(w)
    b = torch.zeros(6, dtype=dtype)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    ref = [t.clone().requires_grad_() for t in (x, w, b)]
    pad = (kernel // 2, kernel // 2)
    with OwnConvolutions():
        y = F.conv2d(*leaves, padding=pad)
        grouped = F.conv2d(leaves[0][:, :4], leaves[1][:, :2], groups=2)
        dilated = F.conv2d(*leaves, padding=2, dilation=2)
    y_ref = F.conv2d(*ref, padding=pad)
    own = dtype == torch.float32
    assert (type(y.grad_fn).__name__ == "SlowConv2DBackward0") == own
    assert type(grouped.grad_fn).__name__ == type(dilated.grad_fn).__name__ == \
        "ConvolutionBackward0"
    if own:
        assert torch.all(y[:, :, :3] == 0)
    gy = torch.randn(y.shape, generator=g).to(dtype)
    y.backward(gy)
    y_ref.backward(gy)
    tol = {torch.float32: 1e-5, torch.bfloat16: 0.0, torch.float64: 0.0}[dtype]
    torch.testing.assert_close(y, y_ref, rtol=tol, atol=tol)
    for a, e in zip(leaves, ref):
        torch.testing.assert_close(a.grad, e.grad, rtol=tol, atol=tol)


def test_qat_under_model_parallel(one_process, ranks):
    """quant: qat on a model axis of 2: the fake-quant scales (the per-lane
    activation max over a whole input, the per-output-channel weight max)
    give the one-process QAT step's losses and parameters."""
    for r in ranks["1x2"]:
        np.testing.assert_allclose(r["qat/losses"], one_process["qat/losses"], rtol=1e-5)
        np.testing.assert_allclose(r["qat/params"], one_process["qat/params"], rtol=0, atol=1e-5)
    assert np.abs(one_process["qat/losses"] - one_process["plain"]["metrics"][:, 0]).max() > 0


def test_bf16_forward_sums_both_moments_in_one_collective(one_process, ranks):
    """The bf16 LayerNorm's statistics from one all-reduce of ``x`` and
    ``x**2``: two windows of the full bf16 model on a model axis of 2
    against the one-process bf16 forward."""
    want = one_process["bf16/pred"]
    for r in ranks["1x2"]:
        got = r["bf16/pred"]
        assert np.all(np.isfinite(got))
        rel = np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2))
        assert rel <= 1e-2, rel


@pytest.mark.parametrize("name", ["gather_scatter", "gather_own", "sum_grad", "sum"])
def test_crossing_gradients_by_central_differences(name, ranks):
    """Each crossing's backward in float64 on 2 ranks: the gradient of the
    global scalar by central differences, perturbing one rank's slice (or
    the whole tensor on every rank at once), against autograd's."""
    for r in ranks["1x2"]:
        err, scale = r[f"cross/{name}"]
        assert scale > 0.1 and err <= 1e-7, (err, scale)


def test_forward_refuses_an_uncut_model_and_int8_modes():
    axis = ChannelGroup(group=None, n=2, rank=0)
    with pytest.raises(ValueError, match="shard_tree_channels"):
        ChannelParallelForward(worker.tp_model("plain"), axis)
    with pytest.raises(ValueError, match="serves on one device"):
        ChannelParallelForward(worker.tp_model("plain", quant="pall"), axis)


# -- the Trainer -------------------------------------------------------------------------


def test_trainer_model_parallel_config(ranks, setup):
    """``model_parallel: 2`` on 4 ranks builds the ``(data 2, model 2)`` mesh
    with conv kernels cut to 4 of 8 rows, splits each node batch by the data
    coordinate (both ranks of a model group read the same 2 rows), validates,
    checkpoints on rank 0 and resumes cut again; equal to the one-process
    Trainer on the same loader."""
    from bmcnet_esr_torch.training import Trainer

    work = setup["work"]
    got = ranks["2x2"]
    for r in got:
        assert r["mesh"].tolist() == ["data=2", "model=2"]
        assert int(r["conv_rows"]) == int(r["resumed_rows"]) == 4
        assert r["rows"].tolist() == [2] * 5  # 4 train batches, 1 valid batch
        assert r["losses"].tolist() == got[0]["losses"].tolist()
        assert int(r["resume_start"]) == 4
    assert got[0]["checkpoints"].tolist() == ["best", "config.yml", "iteration_3"]
    run = RunConfig(worker.trainer_config(str(work / "tp_one"), ""), runid="tp_one")
    tr = Trainer(run, train_loader=worker.NodeBatchLoader(str(work), "train"),
                 valid_loader=worker.NodeBatchLoader(str(work), "valid"), seed=0, device="cpu")
    losses, step = [], tr.train_step

    def recording(state, batch):
        state, m = step(state, batch)
        losses.append(float(m["train_loss"]))
        return state, m

    tr.train_step = recording
    tr.train()
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5)
    assert float(got[0]["valid_loss"]) == pytest.approx(tr.valid_metrics.result()["valid_loss"],
                                                        rel=1e-5)


def test_trainer_model_parallel_resume(ranks, setup):
    """A checkpoint written under ``model_parallel: 2`` holds the one-device
    layout: one device resumes it, and the ranks resume one device's; both
    continue the uninterrupted one-device run (rel 1e-5), and the exported
    reference state dicts of the two checkpoints agree."""
    work = str(setup["work"])
    whole = setup["whole_losses"]
    for r in ranks["1x2"]:
        np.testing.assert_allclose(r["first"], whole[:2], rtol=1e-5)
        np.testing.assert_allclose(r["second"], whole[2:], rtol=1e-5)
        assert int(r["start"]) == 2
        np.testing.assert_allclose(r["params"], worker.flat_params(setup["whole"].state.model),
                                   rtol=0, atol=1e-5)
    assert setup["first"] == whole[:2]
    tp_ckpt = latest_checkpoint(RunConfig(worker.resume_config(work, "tp_first", 2),
                                          runid="tp_first", make_dirs=False).save_dir)
    assert tp_ckpt.endswith("iteration_1")
    resumed, losses = worker.resume_trainer(work, "one_second", 4, start=2)
    assert resumed.resume(tp_ckpt) == 2
    resumed.train(start_iteration=2)
    np.testing.assert_allclose(losses, whole[2:], rtol=1e-5)
    one_ckpt = latest_checkpoint(setup["one_first"].run.save_dir)
    exported = [export_torch_state_dict(torch.load(os.path.join(p, "state.pt"))["model"],
                                        "plain", worker.N_B) for p in (tp_ckpt, one_ckpt)]
    for k, t in exported[0].items():
        np.testing.assert_allclose(t.numpy(), exported[1][k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_trainer_model_parallel_rejects_bad_degree(ranks):
    """Inside a group of 4: a degree of 3, ``data_parallel: false`` with a
    degree of 2, and ``dcn_slices`` beside it raise ValueError."""
    errors = ranks["2x2"][0]["errors"].tolist()
    assert "model_parallel=3 does not divide the 4 available ranks" in errors[0]
    assert "data_parallel: false inside a process group of 4 ranks" in errors[1]
    assert "dcn_slices and model_parallel cannot combine yet" in errors[2]


def test_trainer_model_parallel_warns_across_nodes(ranks):
    """4 ranks as 2 nodes of 2: the model axis is dropped with a warning and
    the 4 ranks form a data mesh, as the JAX trainer does under multi-host."""
    for r in ranks["2x2"]:
        assert r["nodes_mesh"].tolist() == ["data=4"]
        assert any("model_parallel is a single-node layout knob" in w
                   for w in r["nodes_warnings"].tolist())
