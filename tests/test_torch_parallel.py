"""Data parallelism of bmcnet_esr_torch on the CPU: gloo ranks against one
process and against the JAX package's mesh, with BMCNet_plain at n_c=8, n_b=2,
x2.

Ranks run as spawned processes (``tests/torch_parallel_worker.py``) that
join a gloo group through a file store under ``tmp_path`` and write npz
results; the JAX references run here, on the suite's 8 virtual CPU devices.
Every spawn is joined with a 60 s timeout, after which its processes are
killed and the test fails.

Tolerances: losses at rtol 1e-5 (float32 summation order across processes
and frameworks), parameters at atol 1e-5 after three Adam steps
(``tests/test_parallel.py``), ranks' parameters equal bit for bit; the
engine's sharded streams at rel 1e-5 against the JAX sharded engine.
"""

import dataclasses
import logging
import multiprocessing
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bmcnet_esr_tpu.inference.engine import InferenceEngine as JInferenceEngine
from bmcnet_esr_tpu.models import BMCNetPlain as JBMCNetPlain
from bmcnet_esr_tpu.parallel import make_mesh as jmake_mesh
from bmcnet_esr_tpu.parallel import make_mesh_multislice as jmake_mesh_multislice
from bmcnet_esr_tpu.parallel import make_parallel_eval_step as jmake_parallel_eval_step
from bmcnet_esr_tpu.parallel import make_parallel_train_step as jmake_parallel_train_step
from bmcnet_esr_tpu.parallel import replicate_tree as jreplicate_tree
from bmcnet_esr_tpu.parallel import shard_batch as jshard_batch
from bmcnet_esr_tpu.training.optim import build_optimizer as jbuild_optimizer
from bmcnet_esr_tpu.training.train_step import init_train_state as jinit_train_state

import torch_parallel_worker as worker
from bmcnet_esr_torch.cli import infer as cli_infer
from bmcnet_esr_torch.data import DatasetConfig, SequenceConfig, SequenceLoader
from bmcnet_esr_torch.data import write_synthetic_fixture
from bmcnet_esr_torch.data.h5dataset import AugmentConfig
from bmcnet_esr_torch.inference import InferenceEngine
from bmcnet_esr_torch.models import BMCNetPlain, params_from_jax
from bmcnet_esr_torch.models.convert import export_torch_state_dict
from bmcnet_esr_torch.ops.batch import compact_events
from bmcnet_esr_torch.parallel import make_mesh, shard_batch
from bmcnet_esr_torch.training import build_optimizer, init_train_state, make_eval_step
from bmcnet_esr_torch.training import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L = 4, 3  # the global batch: 4 clips of 3 windows
JOIN_S = 60


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def spawn(fn, world, work, local_world=None, **kwargs):
    """Run ``worker.<fn>`` on ``world`` gloo ranks; their npz results by rank."""
    return join(launch(fn, world, work, local_world, **kwargs))


def launch(fn, world, work, local_world=None, tag="", **kwargs):
    """Start ``worker.<fn>`` on ``world`` gloo ranks (``tag`` names their
    store and results apart from another launch's); :func:`join` waits."""
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(work, f"store-{fn}{tag}-{world}")
    outs = [os.path.join(work, f"{fn}{tag}-{world}-{r}.npz") for r in range(world)]
    procs = [ctx.Process(target=worker.main, args=(fn, r, world, local_world or world, store,
                                                   str(work), outs[r], kwargs))
             for r in range(world)]
    for p in procs:
        p.start()
    return fn, procs, outs


def join(launched):
    """The npz results by rank of a :func:`launch`, its ranks joined within
    ``JOIN_S`` each (then killed, and the test fails)."""
    fn, procs, outs = launched
    try:
        for p in procs:
            p.join(JOIN_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} of {fn} still running after {JOIN_S} s"
        for r, p in enumerate(procs):
            if p.exitcode != 0:
                err = outs[r] + ".err"
                pytest.fail(f"rank {r} of {fn} exited {p.exitcode}:\n"
                            + (open(err).read() if os.path.exists(err) else ""))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    results = []
    for out in outs:
        with np.load(out) as z:
            results.append({k: z[k] for k in z.files})
    return results


def random_batch(rng, empty_gt_clip=None, hot_gt_clip=None):
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


def raw_batch(rng):
    """A raw batch (``{inp,gt}_events`` and the valid counts ``inp_len``) of
    B clips x L windows, the input windows zero-padded after 48 events."""
    out = {}
    for prefix, hw, n in (("inp", worker.LR, 64), ("gt", worker.GT, 256)):
        ev = np.zeros((B, L, 4, n), np.float32)
        ev[:, :, 0] = rng.integers(0, hw[1], (B, L, n))
        ev[:, :, 1] = rng.integers(0, hw[0], (B, L, n))
        ev[:, :, 2] = np.sort(rng.random((B, L, n)), axis=-1)
        ev[:, :, 3] = rng.integers(0, 2, (B, L, n)) * 2 - 1
        if prefix == "inp":
            ev[:, :, :, 48:] = 0.0
            out["inp_len"] = np.full((B, L), 48, np.int32)
        out[f"{prefix}_events"] = ev
    return out


def save_batches(path, batches):
    np.savez(path, **{f"{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Initial parameters (JAX-initialized), three train batches, a batch
    whose last clip is poisoned, a valid batch with an uneven mask, a raw
    batch, and ``ranged.npz``: a batch whose last clip's GT counts range
    wider than the others', then the same with an uneven mask."""
    work = tmp_path_factory.mktemp("dp")
    jm = JBMCNetPlain(scale=2, n_c=8, n_b=2)
    v = jm.init(jax.random.key(0), jnp.zeros((1, 2, 16, 16, 2)), *jm.init_state(1, 16, 16))
    v = jax.tree.map(np.asarray, v)
    torch.save(params_from_jax(v), work / "init.pt")
    rng = np.random.default_rng(0)
    train = [random_batch(rng) for _ in range(3)]
    poisoned = random_batch(rng, empty_gt_clip=B - 1)
    valid = dict(random_batch(rng), clip_mask=np.asarray([1, 1, 1, 0], np.float32))
    raw = raw_batch(rng)
    ranged = random_batch(rng, hot_gt_clip=B - 1)
    ranged_valid = dict(ranged, clip_mask=np.asarray([1, 1, 1, 0], np.float32))
    for name, bs in (("train", train), ("poisoned", [poisoned]), ("valid", [valid]),
                     ("raw", [raw]), ("ranged", [ranged, ranged_valid])):
        save_batches(work / f"{name}.npz", bs)
    return work, jm, v, train, poisoned, valid, raw


def port_run(work, batches):
    """The port's single-process step on the global batches."""
    state = worker.port_state(str(work))
    step = make_train_step(worker.LR, worker.GT, use_remat=False)
    losses = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(x) for k, x in b.items()})
        losses.append(float(m["train_loss"]))
    return np.asarray(losses), worker.flat_params(state.model)


def jax_run(jm, v, batches, mesh, **kw):
    tx, _ = jbuild_optimizer(worker.OPT, worker.SCHED, worker.TCFG)
    state = jreplicate_tree(jinit_train_state(jax.tree.map(jnp.array, v), tx), mesh)
    step = jmake_parallel_train_step(jm, tx, worker.LR, worker.GT, mesh, use_remat=False, **kw)
    metrics = []
    for b in batches:
        state, m = step(state, jshard_batch(b, mesh))
        metrics.append({k: float(x) for k, x in m.items()})
    params = params_from_jax(jax.tree.map(np.asarray, state.params))
    flat = np.concatenate([params[n].reshape(-1).numpy()
                           for n, _ in BMCNetPlain(scale=2, n_c=8, n_b=2).named_parameters()])
    return metrics, flat


@pytest.fixture(scope="module")
def two_ranks(setup):
    return spawn("steps", 2, setup[0])


@pytest.fixture(scope="module")
def four_ranks(setup):
    return spawn("steps", 4, setup[0])


def _check_steps(ranks, setup, mesh):
    work, jm, v, train, *_ = setup
    for r in ranks[1:]:  # replicated: every rank holds the same numbers
        assert np.array_equal(r["params"], ranks[0]["params"])
        assert np.array_equal(r["loss"], ranks[0]["loss"])
    losses, params = port_run(work, train)
    np.testing.assert_allclose(ranks[0]["loss"], losses, rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["params"], params, rtol=0, atol=1e-5)
    jm_, jparams = jax_run(jm, v, train, mesh)
    np.testing.assert_allclose(ranks[0]["loss"], [m["train_loss"] for m in jm_], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["mse"], [m["train_mse_loss"] for m in jm_], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["gnorm"], [m["grad_norm"] for m in jm_], rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["params"], jparams, rtol=0, atol=1e-5)
    assert np.abs(ranks[0]["params"] - worker.flat_params(worker.port_state(str(work)).model)
                  ).max() > 1e-5  # the steps moved the parameters


def test_two_ranks_match_one_process_and_the_jax_mesh(two_ranks, setup):
    _check_steps(two_ranks, setup, jmake_mesh(2))


def test_four_ranks_match_one_process_and_the_jax_mesh(four_ranks, setup):
    _check_steps(four_ranks, setup, jmake_mesh(4))


def test_multi_slice_matches_the_jax_multislice_mesh(setup):
    """4 ranks on a (dcn_data, data) = (2, 2) mesh: the gradients reduce
    within ``data``, then across ``dcn_data``."""
    _check_steps(spawn("steps", 4, setup[0], slices=2), setup, jmake_mesh_multislice(2, 2))


@pytest.mark.parametrize("world", [2, 4])
def test_nonfinite_rows_on_one_rank_skip_every_rank(world, two_ranks, four_ranks, setup):
    """Only the last rank's rows make the loss NaN: the all-reduced loss is
    NaN on every rank, so every rank skips, as the JAX mesh guard does."""
    _, jm, v, _, poisoned, *_ = setup
    ranks = two_ranks if world == 2 else four_ranks
    jm_, _ = jax_run(jm, v, [poisoned], jmake_mesh(world), skip_nonfinite=True, extra_losses=(
        ("poison", 1.0, lambda p, g, a: 0.0 * jnp.log(jnp.min(jnp.sum(g, axis=(1, 2, 3))))),))
    assert jm_[0]["train_skipped"] == 1 and not np.isfinite(jm_[0]["train_loss"])
    for r in ranks:
        assert r["skipped"].tolist() == [1, 1, 0]  # skipped, one step, no update
        assert not np.isfinite(r["skip_loss"]) and float(r["skip_moved"]) == 0.0


@pytest.mark.parametrize("world", [2, 4])
def test_event_term_on_ranks_sums_over_the_whole_batch(world, two_ranks, four_ranks, setup):
    """``event_warping`` (raw windows, ``events_len``) sums over the batch's
    clips: each rank's share is scaled by the data axis's size, so the
    ranks' step equals the port's one-process step and the JAX mesh step
    (GSPMD: the term over the global batch)."""
    from bmcnet_esr_tpu.losses.terms import LossContext as JLossContext
    from bmcnet_esr_tpu.losses.terms import event_warping as jevent_warping

    work, jm, v, *_, raw = setup
    state = worker.port_state(str(work))
    step = make_train_step(worker.LR, worker.GT, use_remat=False,
                           extra_losses=worker.event_terms())
    _, m = step(state, {k: torch.from_numpy(x) for k, x in raw.items()})
    jwarp = jevent_warping({"flow_key": "flow"}, JLossContext(worker.LR, worker.GT, worker.SCALE))

    def jterm(pred, gt, aux):
        b, kh, kw, c = aux["pred"].shape
        h, w = worker.LR
        flow = aux["pred"].reshape(b, h, kh // h, w, kw // w, c).mean(axis=(2, 4))
        return jwarp(pred, gt, dict(aux, flow=flow * worker.EVENT_FLOW_SCALE))

    jterm.needs_events = True
    jm_, jparams = jax_run(jm, v, [raw], jmake_mesh(world), extra_losses=(("warp", 0.1, jterm),))
    for r in two_ranks if world == 2 else four_ranks:
        loss, mse, gnorm = r["events"]
        assert loss == pytest.approx(float(m["train_loss"]), rel=1e-5)
        assert loss == pytest.approx(jm_[0]["train_loss"], rel=1e-5)
        assert mse == pytest.approx(jm_[0]["train_mse_loss"], rel=1e-5)
        assert gnorm == pytest.approx(float(m["grad_norm"]), rel=1e-4)
        np.testing.assert_allclose(r["events/params"], worker.flat_params(state.model), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(r["events/params"], jparams, rtol=0, atol=1e-5)
    assert float(m["train_loss"]) > float(m["train_mse_loss"])


@pytest.mark.parametrize("world", [2, 4])
def test_loss_terms_on_ranks_match_one_process_and_jax(world, two_ranks, four_ranks, setup):
    """recon, temporal consistency, TV and SSIM attached through the
    ``loss:`` block, with remat: each rank's step on its rows against the
    port's one-process step and the JAX mesh step with the JAX terms."""
    from bmcnet_esr_tpu.losses.terms import LossContext as JLossContext
    from bmcnet_esr_tpu.training.losses import build_extra_losses as jbuild_extra_losses

    work, jm, v, train, *_ = setup
    state = worker.port_state(str(work))
    step = make_train_step(worker.LR, worker.GT, use_remat=True, extra_losses=worker.loss_terms())
    _, m = step(state, {k: torch.from_numpy(x) for k, x in train[0].items()})
    jterms = jbuild_extra_losses(worker.LOSS_TERMS,
                                 JLossContext(worker.LR, worker.GT, worker.SCALE))
    jm_, jparams = jax_run(jm, v, train[:1], jmake_mesh(world), extra_losses=jterms)
    for r in two_ranks if world == 2 else four_ranks:
        loss, mse, gnorm = r["terms"]
        assert loss == pytest.approx(float(m["train_loss"]), rel=1e-5)
        assert loss == pytest.approx(jm_[0]["train_loss"], rel=1e-5)
        assert mse == pytest.approx(jm_[0]["train_mse_loss"], rel=1e-5)
        assert gnorm == pytest.approx(float(m["grad_norm"]), rel=1e-4)
        assert gnorm == pytest.approx(jm_[0]["grad_norm"], rel=1e-4)
        np.testing.assert_allclose(r["terms/params"], worker.flat_params(state.model), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(r["terms/params"], jparams, rtol=0, atol=1e-5)
    assert float(m["train_loss"]) > float(m["train_mse_loss"])


@pytest.mark.parametrize("world", [2, 4])
def test_unpinned_ssim_on_ranks_reads_the_whole_batch_range(world, two_ranks, four_ranks,
                                                            setup):
    """SSIM with its range unpinned reads the GT's max - min over the whole
    batch, as the JAX mesh step (GSPMD) and the one-process step do, though
    the ranks' rows each hold a narrower range: train step (with remat) and
    eval step."""
    from bmcnet_esr_tpu.losses.terms import LossContext as JLossContext
    from bmcnet_esr_tpu.training.losses import build_extra_losses as jbuild_extra_losses

    from bmcnet_esr_torch.ops.batch import counts_from_batch

    work, jm, v, *_ = setup
    with np.load(work / "ranged.npz") as z:
        train, valid = ({k.split("/")[1]: z[k] for k in z.files if k.startswith(f"{i}/")}
                        for i in range(2))
    mesh = jmake_mesh(world)
    jterms = jbuild_extra_losses(worker.RANGE_TERMS,
                                 JLossContext(worker.LR, worker.GT, worker.SCALE))
    jm_, jparams = jax_run(jm, v, [train], mesh, extra_losses=jterms)
    state = worker.port_state(str(work))
    step = make_train_step(worker.LR, worker.GT, use_remat=True,
                           extra_losses=worker.loss_terms(worker.RANGE_TERMS))
    _, m = step(state, {k: torch.from_numpy(x) for k, x in train.items()})
    want_eval = jmake_parallel_eval_step(jm, worker.LR, worker.GT, mesh, extra_losses=jterms)(
        jreplicate_tree(jax.tree.map(jnp.array, v), mesh), jshard_batch(valid, mesh))
    one_eval = make_eval_step(worker.LR, worker.GT,
                              extra_losses=worker.loss_terms(worker.RANGE_TERMS))(
        worker.port_state(str(work)).model, {k: torch.from_numpy(x) for k, x in valid.items()})
    for r in two_ranks if world == 2 else four_ranks:
        loss, mse, gnorm = r["range"]
        assert loss == pytest.approx(float(m["train_loss"]), rel=1e-5)
        assert loss == pytest.approx(jm_[0]["train_loss"], rel=1e-5)
        assert mse == pytest.approx(jm_[0]["train_mse_loss"], rel=1e-5)
        assert gnorm == pytest.approx(float(m["grad_norm"]), rel=1e-4)
        assert gnorm == pytest.approx(jm_[0]["grad_norm"], rel=1e-4)
        np.testing.assert_allclose(r["range/params"], worker.flat_params(state.model), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(r["range/params"], jparams, rtol=0, atol=1e-5)
        for k, name in enumerate(("valid_loss", "valid_mse_loss", "valid_clips")):
            assert r["range/eval"][k] == pytest.approx(float(want_eval[name]), rel=1e-5), name
            assert r["range/eval"][k] == pytest.approx(float(one_eval[name]), rel=1e-5), name
    # the case tells: some rank's rows hold a narrower GT range at every step
    gt = counts_from_batch({k: torch.from_numpy(x) for k, x in train.items()}, "gt", worker.GT)
    for t in range(1, gt.shape[1]):
        ranges = [float(g.max() - g.min()) for g in gt[:, t].chunk(world)]
        assert min(ranges) < float(gt[:, t].max() - gt[:, t].min())


def test_eval_step_with_uneven_valid_rows_matches_jax(two_ranks, setup):
    """Rank 0 holds two valid clips, rank 1 one: the weighted means equal the
    JAX sharded eval step's and the port's single-process one."""
    work, jm, v, _, _, valid, _ = setup
    want = jmake_parallel_eval_step(jm, worker.LR, worker.GT, jmake_mesh(2))(
        jreplicate_tree(jax.tree.map(jnp.array, v), jmake_mesh(2)), jshard_batch(valid,
                                                                               jmake_mesh(2)))
    one = make_eval_step(worker.LR, worker.GT)(worker.port_state(str(work)).model,
                                               {k: torch.from_numpy(x) for k, x in valid.items()})
    for k, name in enumerate(("valid_loss", "valid_mse_loss", "valid_clips")):
        for r in two_ranks:
            assert r["eval"][k] == pytest.approx(float(want[name]), rel=1e-5), name
            assert r["eval"][k] == pytest.approx(float(one[name]), rel=1e-5), name
    assert two_ranks[0]["eval"][2] == 3.0


# -- the loader's row split -----------------------------------------------------


@pytest.fixture(scope="module")
def h5(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_h5")
    return [write_synthetic_fixture(str(d / f"{s}.h5"), (32, 32), ("ori", "down2"),
                                    {"ori": 4000, "down2": 1000}, seed=s) for s in range(8)]


DS = DatasetConfig(scale=2, ori_scale="down2", window=128, sliding_window=64,
                   sequence=SequenceConfig(sequence_length=3, seqn=2, step_size=3))


@pytest.mark.parametrize("n", [2, 4])
def test_loader_rows_concatenate_to_the_one_process_batch(h5, n):
    """Every rank draws the whole batch's clip seeds and reads its own clips:
    the ranks' rows, concatenated, are the 1-process batch exactly, the
    augmentation draws and the pad_last mask included."""
    augmented = dataclasses.replace(DS, augment=AugmentConfig(enabled=True))

    def loader(rows):
        return SequenceLoader([h5[0]], augmented, batch_size=4, shuffle=True, pad_last=True,
                              compact=True, num_workers=1, seed=3, rows=rows)

    whole = list(loader((0, 1)))
    parts = [list(loader((r, n))) for r in range(n)]
    assert len(whole) > 1 and whole[-1]["clip_mask"].tolist() != [1.0] * 4
    for k, batch in enumerate(whole):
        for key, value in batch.items():
            got = np.concatenate([p[k][key] for p in parts])
            assert np.array_equal(got, value), (k, key)
    with pytest.raises(ValueError, match="do not split"):
        list(SequenceLoader([h5[0]], DS, batch_size=3, num_workers=1, rows=(0, 2)))


def test_shard_batch_rows():
    batch = {"a": np.arange(12).reshape(6, 2)}
    assert np.array_equal(np.concatenate([shard_batch(batch, r, 3)["a"] for r in range(3)]),
                          batch["a"])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(batch, 0, 4)


# -- the Trainer and cli.train ----------------------------------------------------


def test_trainer_runs_two_processes(h5, tmp_path):
    """The whole Trainer on 2 nodes of one rank: loaders sharded by node,
    the parallel steps, sharded validation, rank 0's checkpoint, the resume
    of both ranks (``tests/test_multihost.py::test_full_trainer_runs_two_process``)."""
    datalist = tmp_path / "list.txt"
    datalist.write_text(h5[0] + "\n")
    ranks = spawn("trainer", 2, tmp_path, local_world=1, datalist=str(datalist))
    a, b = ranks
    assert np.array_equal(a["losses"], b["losses"]) and len(a["losses"]) == 4
    assert np.all(np.isfinite(a["losses"]))
    assert np.array_equal(a["params"], b["params"])
    assert a["valid_loss"] == b["valid_loss"] and np.isfinite(a["valid_loss"])
    assert a["checkpoints"].tolist() == b["checkpoints"].tolist() == ["iteration_3"]
    assert int(a["resume_start"]) == int(b["resume_start"]) == 4


def test_trainer_splits_injected_node_batches_over_two_ranks(setup):
    """2 ranks of one node, each handed the whole node batch of 4 clips by an
    injected loader: the Trainer keeps its rank's rows, trains, validates
    over unevenly valid rows and saves on rank 0, equal to the Trainer of
    one process on the same loader."""
    from bmcnet_esr_torch.training import Trainer
    from bmcnet_esr_torch.training.config import RunConfig

    work = setup[0]
    a, b = spawn("node_batches", 2, work)
    assert np.array_equal(a["losses"], b["losses"]) and len(a["losses"]) == 4
    assert np.array_equal(a["params"], b["params"])
    assert a["valid_loss"] == b["valid_loss"]
    assert a["checkpoints"].tolist() == ["best", "config.yml", "iteration_3"]
    assert a["rows"].tolist() == b["rows"].tolist() == [2] * 5  # 4 train, 1 valid batch

    run = RunConfig(worker.trainer_config(str(work / "one"), ""), runid="one")
    tr = Trainer(run, train_loader=worker.NodeBatchLoader(str(work), "train"),
                 valid_loader=worker.NodeBatchLoader(str(work), "valid"), seed=0, device="cpu")
    losses, step = [], tr.train_step

    def recording(state, batch):
        state, m = step(state, batch)
        losses.append(float(m["train_loss"]))
        return state, m

    tr.train_step = recording
    tr.train()
    np.testing.assert_allclose(a["losses"], losses, rtol=1e-5)
    assert float(a["valid_loss"]) == pytest.approx(tr.valid_metrics.result()["valid_loss"],
                                                   rel=1e-5)
    np.testing.assert_allclose(a["params"], worker.flat_params(tr.state.model), rtol=0, atol=1e-5)


def test_trainer_refusals_inside_a_group(tmp_path):
    """dcn_slices that do not divide the world, data_parallel: false inside
    a group, and a node batch of 3 over 4 ranks raise ValueError."""
    errors = spawn("refusals", 4, tmp_path)[0]["errors"].tolist()
    assert "dcn_slices=3 does not divide the world size 4" in errors[0]
    assert "data_parallel: false inside a process group" in errors[1]
    assert "node batch of 3 clips does not split over the node's 4 ranks" in errors[2]


def _tiny_recipe(tmp_path, h5_paths, batch):
    """The NFS recipe at n_c=8, n_b=2 on fixture files of one clip each."""
    import yaml

    from bmcnet_esr_torch.training.config import load_yaml

    lst = tmp_path / "train.txt"
    lst.write_text("".join(f"{p}\n" for p in h5_paths))
    cfg = load_yaml(os.path.join(REPO, "configs", "train_nfs.yml"))
    ds = {"scale": 2, "ori_scale": "down2", "window": 128, "sliding_window": 64,
          "dataset_length": 3, "data_augment": {"enabled": False},
          "sequence": {"sequence_length": 3, "seqn": 2, "step_size": None}}
    for key in ("train_dataloader", "valid_dataloader"):
        cfg[key].update(path_to_datalist_txt=str(lst), batch_size=batch, num_workers=1,
                        dataset={**cfg[key]["dataset"], **ds})
    cfg["train_dataloader"]["drop_last"] = True
    cfg["model"]["args"].update(n_c=8, n_b=2, variant="plain")
    cfg["trainer"].update(output_path=str(tmp_path / "runs"), tensorboard=False)
    cfg["trainer"]["iteration_based_train"].update(
        iterations=4, save_period=100, train_log_step=1, valid_step=3)
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _logged_losses(tmp_path, runid):
    log = (tmp_path / "runs" / "logs" / "BMCNet_nfs" / runid / "info.txt").read_text()
    return [float(line.split("train_loss: ")[1].split()[0])
            for line in log.splitlines() if "train_loss: " in line], log


def test_cli_train_distributed_under_torchrun(h5, tmp_path):
    """``torchrun --nproc_per_node=2 -m bmcnet_esr_torch.cli.train ...
    --distributed --device cpu``: one node, its batch of 2 split over 2
    ranks, logged by rank 0 and equal to the 1-process run at rtol 1e-5."""
    from bmcnet_esr_torch.cli import train as cli_train

    path = _tiny_recipe(tmp_path, h5[1:3], batch=2)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           "-m", "bmcnet_esr_torch.cli.train", "-c", str(path), "-id", "dist", "-lr", "1e-3",
           "--distributed", "--device", "cpu"]
    proc = subprocess.Popen(cmd, env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=JOIN_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        pytest.fail(f"torchrun still running after {JOIN_S} s")
    assert proc.returncode == 0, out.decode()[-3000:]
    dist_losses, log = _logged_losses(tmp_path, "dist")
    assert len(dist_losses) == 4 and "valid_loss" in log
    assert "rank1" not in log  # rank 1 writes no log
    assert sorted(os.listdir(tmp_path / "runs" / "models" / "BMCNet_nfs" / "dist")) == [
        "best", "config.yml", "iteration_3"]
    cli_train.main(["-c", str(path), "-id", "one", "-lr", "1e-3", "--device", "cpu"])
    np.testing.assert_allclose(dist_losses, _logged_losses(tmp_path, "one")[0], rtol=1e-5)


# -- the engine's mesh= and cli.infer --mesh_devices ------------------------------


@pytest.fixture(scope="module")
def engines(setup):
    _, jm, v, *_ = setup
    model = BMCNetPlain(scale=2, n_c=8, n_b=2)
    model.load_state_dict(params_from_jax(v))
    cfg = DatasetConfig(scale=2, ori_scale="down2", window=128, sliding_window=64,
                        need_gt_events=True)
    return model, jm, v, cfg


def test_engine_mesh_of_eight_matches_unsharded_and_jax(engines, h5):
    """8 streams on ``make_mesh(8, devices=[cpu] * 8)``: one stream a
    replica; equal to the unsharded batch and to the JAX sharded engine."""
    from bmcnet_esr_tpu.data import DatasetConfig as JDatasetConfig

    model, jm, v, cfg = engines
    mesh = make_mesh(8, devices=["cpu"] * 8)
    sharded = InferenceEngine(model, cfg, chunk_size=4, visualize=False, mesh=mesh,
                              device="cpu").infer_file_batch(h5)
    plain = InferenceEngine(model, cfg, chunk_size=4, visualize=False,
                            device="cpu").infer_file_batch(h5)
    jcfg = JDatasetConfig(scale=2, ori_scale="down2", window=128, sliding_window=64,
                          need_gt_events=True)
    want = JInferenceEngine(jm, v, jcfg, chunk_size=4, visualize=False,
                            mesh=jmake_mesh(8)).infer_file_batch(h5)
    assert len({round(r["esr_mse"], 9) for r in sharded}) > 1  # distinct streams
    for got, ref, jref in zip(sharded, plain, want):
        for key in ("esr_mse", "bicubic_mse"):
            assert got[key] == ref[key], key
            assert got[key] == pytest.approx(jref[key], rel=1e-5), key


def test_engine_mesh_runs_a_tail_group_unsharded_with_one_warning(engines, h5, caplog):
    model, _, _, cfg = engines
    eng = InferenceEngine(model, cfg, chunk_size=4, visualize=False,
                          mesh=make_mesh(8, devices=["cpu"] * 8), device="cpu")
    with caplog.at_level(logging.WARNING):
        tail = eng.infer_file_batch(h5[:3])
        again = eng.infer_file_batch(h5[3:6])
    warned = [r for r in caplog.records if "does not divide the 8-device mesh" in r.message]
    assert len(warned) == 1
    solo = InferenceEngine(model, cfg, chunk_size=4, visualize=False, device="cpu")
    for got, want in ((tail, solo.infer_file_batch(h5[:3])),
                      (again, solo.infer_file_batch(h5[3:6]))):
        assert [(r["esr_mse"], r["bicubic_mse"]) for r in got] == [
            (r["esr_mse"], r["bicubic_mse"]) for r in want]


def test_engine_mesh_int8_pall_keeps_each_lane_scale(engines, h5, monkeypatch):
    """An int8_pall group of 4 streams on a mesh of 2: each replica
    calibrates its own lanes, as the unsharded batch does per lane."""
    from bmcnet_esr_torch.inference import engine as engine_mod
    from bmcnet_esr_torch.models import act_scales

    calibrated = []

    def recording(model, pairs, carry, *args, **kwargs):
        calibrated.append(pairs.shape[1])
        return calibrate(model, pairs, carry, *args, **kwargs)

    calibrate = engine_mod.calibrate_act_scales
    monkeypatch.setattr(engine_mod, "calibrate_act_scales", recording)
    model, _, v, cfg = engines
    q = BMCNetPlain(scale=2, n_c=8, n_b=2, dtype=torch.bfloat16, quant="pall")
    q.load_state_dict(params_from_jax(v))
    sharded_eng = InferenceEngine(q, cfg, chunk_size=4, visualize=False,
                                  mesh=make_mesh(2, devices=["cpu"] * 2), device="cpu")
    sharded = sharded_eng.infer_file_batch(h5[:4])
    plain = InferenceEngine(q, cfg, chunk_size=4, visualize=False,
                            device="cpu").infer_file_batch(h5[:4])
    for got, ref in zip(sharded, plain):
        assert np.isfinite(got["esr_mse"])
        assert got["esr_mse"] == pytest.approx(ref["esr_mse"], rel=1e-5)
    assert calibrated == [2, 2, 4]  # the two replicas, then the unsharded batch
    assert {s.shape[0] for s in act_scales(q).values()} == {4}


def test_engine_mesh_serves_what_the_caller_installs_after_construction(engines, h5):
    """Weights changed and per-lane int8 scales installed on ``engine.model``
    after the mesh engine was built reach every shard: each lane's scale is
    cut to its shard, and the caller's scales stay as they were."""
    from bmcnet_esr_torch.models import act_scales, set_act_scales

    model, _, v, cfg = engines
    mesh = make_mesh(2, devices=["cpu"] * 2)
    m = BMCNetPlain(scale=2, n_c=8, n_b=2)
    m.load_state_dict(params_from_jax(v))
    eng = InferenceEngine(m, cfg, chunk_size=4, visualize=False, mesh=mesh, device="cpu")
    with torch.no_grad():
        for p in eng.model.parameters():
            p.mul_(1.25)
    want = InferenceEngine(eng.model, cfg, chunk_size=4, visualize=False,
                           device="cpu").infer_file_batch(h5[:4])
    got = eng.infer_file_batch(h5[:4])
    assert [r["esr_mse"] for r in got] == [r["esr_mse"] for r in want]
    assert got[0]["esr_mse"] != InferenceEngine(model, cfg, chunk_size=4, visualize=False,
                                                device="cpu").infer_file_batch(h5[:1])[0][
        "esr_mse"]

    def int8():
        q = BMCNetPlain(scale=2, n_c=8, n_b=2, dtype=torch.bfloat16, quant="pall")
        q.load_state_dict(params_from_jax(v))
        return q

    solo = InferenceEngine(int8(), cfg, chunk_size=4, visualize=False, device="cpu")
    want = solo.infer_file_batch(h5[:4])
    scales = {k: s.clone() for k, s in act_scales(solo.model).items()}
    assert {s.shape[0] for s in scales.values()} == {4}
    eng = InferenceEngine(int8(), cfg, chunk_size=4, visualize=False, mesh=mesh, device="cpu")
    set_act_scales(eng.model, scales)
    got = eng.infer_file_batch(h5[:4])
    for g, w in zip(got, want):
        assert g["esr_mse"] == pytest.approx(w["esr_mse"], rel=1e-5)
    kept = act_scales(eng.model)
    assert all(torch.equal(kept[k], s) for k, s in scales.items())
    # the scales an engine derived are no caller's: a second engine on the
    # same model derives its own for its streams
    shared = InferenceEngine(solo.model, cfg, chunk_size=4, visualize=False, mesh=mesh,
                             device="cpu").infer_file_batch(h5[4:8])
    fresh = InferenceEngine(int8(), cfg, chunk_size=4, visualize=False,
                            device="cpu").infer_file_batch(h5[4:8])
    for g, w in zip(shared, fresh):
        assert g["esr_mse"] == pytest.approx(w["esr_mse"], rel=1e-5)


def test_cli_infer_mesh_devices_on_the_cpu(h5, tmp_path):
    """``--mesh_devices 2 --device cpu`` gives ``--mesh_devices 0``'s numbers."""
    ckpt = tmp_path / "w.pth"
    model = BMCNetPlain(scale=2, n_c=8, n_b=2, generator=torch.Generator().manual_seed(0))
    torch.save(export_torch_state_dict(model.state_dict(), "plain", n_b=2), ckpt)
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(h5[:4]) + "\n")
    common = ["--model_path", str(ckpt), "--variant", "plain", "--n_c", "8", "--n_b", "2", "--scale", "2",
              "--ori_scale", "down2", "--window", "128", "--sliding_window", "64",
              "--need_gt_events", "--no_images", "--device", "cpu", "--chunk_size", "4",
              "--data_list", str(lst), "--batch_streams", "4"]
    one = cli_infer.main(common + ["--output_path", str(tmp_path / "one")])
    two = cli_infer.main(common + ["--output_path", str(tmp_path / "two"),
                                   "--mesh_devices", "2"])
    for key in ("esr_mse", "bicubic_mse"):
        assert two["breakdown"][key] == pytest.approx(one["breakdown"][key], rel=1e-5)
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        make_mesh(3, devices=["cpu"] * 2)
