"""One rank of the data- and tensor-parallel CPU tests of bmcnet_esr_torch
(gloo).

``tests/test_torch_parallel.py`` and ``tests/test_torch_tensor_parallel.py``
start N of these as spawned processes; each joins a gloo group through a
file store, runs one of the functions below on its rows of the global
batches the test wrote, and saves what it saw to an npz file (a traceback to
``<out>.err`` when it fails).  Imports no JAX.
"""

import os
import traceback

import numpy as np
import torch

SCALE, N_C, N_B = 2, 8, 2
LR, GT = (16, 16), (32, 32)
OPT = {"name": "Adam", "args": {"lr": 1e-4, "weight_decay": 1e-5, "amsgrad": True}}
SCHED, TCFG = {"name": "ExponentialLR", "args": {"gamma": 0.5}}, {"lr_change_rate": 1}


def main(fn: str, rank: int, world: int, local_world: int, store: str, work: str, out: str,
         kwargs: dict) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank % local_world),
                      LOCAL_WORLD_SIZE=str(local_world))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from bmcnet_esr_torch.parallel import init_distributed

    try:
        init_distributed("cpu", init_method=f"file://{store}", timeout_s=60)
        result = globals()[fn](rank, world, work, **kwargs)
        np.savez(out, **result)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def empty_gt_term(pred, gt, aux):
    """0 x log of the smallest GT count of a clip: NaN when a clip of the
    batch has no GT event at this step, else 0 (the test's poison)."""
    return 0.0 * torch.log(torch.amin(gt.sum(dim=(1, 2, 3))))


def port_state(work: str):
    from bmcnet_esr_torch.models import BMCNetPlain
    from bmcnet_esr_torch.training import build_optimizer, init_train_state

    model = BMCNetPlain(scale=SCALE, n_c=N_C, n_b=N_B)
    model.load_state_dict(torch.load(os.path.join(work, "init.pt")))
    model = model.to(memory_format=torch.channels_last)
    opt, sched = build_optimizer(model.parameters(), OPT, SCHED, TCFG)
    return init_train_state(model, opt, sched)


def flat_params(model) -> np.ndarray:
    return np.concatenate([p.detach().reshape(-1).numpy() for p in model.parameters()])


def batches(work: str, name: str):
    with np.load(os.path.join(work, f"{name}.npz")) as z:
        n = len({k.split("/")[0] for k in z.files})
        return [{k.split("/")[1]: torch.from_numpy(z[k]) for k in z.files
                 if k.startswith(f"{i}/")} for i in range(n)]


def steps(rank: int, world: int, work: str, slices: int = 1) -> dict:
    """Three train steps on this rank's rows; then, from the initial state, a
    guarded step on a batch whose last clip is poisoned, the eval step, and
    steps with loss terms (SSIM's range pinned, unpinned with the eval step,
    an event term)."""
    from bmcnet_esr_torch.parallel import (
        make_parallel_eval_step,
        make_parallel_train_step,
        make_process_mesh,
        shard_batch,
    )

    mesh = make_process_mesh(slices)
    state = port_state(work)
    step = make_parallel_train_step(LR, GT, mesh, use_remat=False)
    out = {"loss": [], "mse": [], "gnorm": []}
    for b in batches(work, "train"):
        state, m = step(state, shard_batch(b, rank, world))
        out["loss"].append(float(m["train_loss"]))
        out["mse"].append(float(m["train_mse_loss"]))
        out["gnorm"].append(float(m["grad_norm"]))
    out = {k: np.asarray(v) for k, v in out.items()}
    out["params"] = flat_params(state.model)
    if slices > 1:
        return out

    state = port_state(work)
    guarded = make_parallel_train_step(LR, GT, mesh, use_remat=False, skip_nonfinite=True,
                                       extra_losses=(("poison", 1.0, empty_gt_term),))
    init = flat_params(state.model)
    poisoned = batches(work, "poisoned")[0]
    state, m = guarded(state, shard_batch(poisoned, rank, world))
    out["skipped"] = np.asarray([m["train_skipped"], state.step, state.updates])
    out["skip_loss"] = np.asarray(float(m["train_loss"]))
    out["skip_moved"] = np.asarray(float(np.abs(flat_params(state.model) - init).max()))

    ev = make_parallel_eval_step(LR, GT, mesh)
    m = ev(port_state(work).model, shard_batch(batches(work, "valid")[0], rank, world))
    out["eval"] = np.asarray([float(m[k]) for k in ("valid_loss", "valid_mse_loss",
                                                    "valid_clips")])

    state = port_state(work)
    step = make_parallel_train_step(LR, GT, mesh, use_remat=True, extra_losses=loss_terms())
    state, m = step(state, shard_batch(batches(work, "train")[0], rank, world))
    out["terms"] = np.asarray([float(m[k]) for k in ("train_loss", "train_mse_loss",
                                                     "grad_norm")])
    out["terms/params"] = flat_params(state.model)

    state = port_state(work)
    step = make_parallel_train_step(LR, GT, mesh, use_remat=True,
                                    extra_losses=loss_terms(RANGE_TERMS))
    ranged, ranged_valid = batches(work, "ranged")
    state, m = step(state, shard_batch(ranged, rank, world))
    out["range"] = np.asarray([float(m[k]) for k in ("train_loss", "train_mse_loss",
                                                     "grad_norm")])
    out["range/params"] = flat_params(state.model)
    ev = make_parallel_eval_step(LR, GT, mesh, extra_losses=loss_terms(RANGE_TERMS))
    m = ev(port_state(work).model, shard_batch(ranged_valid, rank, world))
    out["range/eval"] = np.asarray([float(m[k]) for k in ("valid_loss", "valid_mse_loss",
                                                          "valid_clips")])

    state = port_state(work)
    step = make_parallel_train_step(LR, GT, mesh, use_remat=False, extra_losses=event_terms())
    state, m = step(state, shard_batch(batches(work, "raw")[0], rank, world))
    out["events"] = np.asarray([float(m[k]) for k in ("train_loss", "train_mse_loss",
                                                      "grad_norm")])
    out["events/params"] = flat_params(state.model)
    return out


EVENT_FLOW_SCALE = 0.01


def event_terms():
    """``event_warping`` on the prediction mean-pooled to the LR grid (times
    ``EVENT_FLOW_SCALE``): a term that sums over the batch (``batch_sum``)."""
    from bmcnet_esr_torch.losses.terms import LossContext
    from bmcnet_esr_torch.training.losses import REGISTRY

    warp = REGISTRY["event_warping"]({"flow_key": "flow"}, LossContext(LR, GT, SCALE))

    def fn(pred, gt, aux):
        b, kh, kw, c = aux["pred"].shape
        flow = aux["pred"].reshape(b, LR[0], kh // LR[0], LR[1], kw // LR[1], c).mean(dim=(2, 4))
        return warp(pred, gt, dict(aux, flow=flow * EVENT_FLOW_SCALE))

    fn.needs_events = fn.batch_sum = True
    return (("warp", 0.1, fn),)


# batch means, so the ranks' mean is the global batch's; SSIM's range pinned
LOSS_TERMS = {"recon": {"weight": 0.5}, "temporal_consistency": 0.1, "total_variation": 0.05,
              "ssim": {"weight": 0.1, "data_range": 8.0}}
# SSIM's range unpinned: the GT's max - min over the whole batch, which a
# rank's rows alone do not hold
RANGE_TERMS = {"ssim": {"weight": 1.0}}


def loss_terms(spec: dict = LOSS_TERMS):
    """The count-image terms of the ``loss:`` block at this file's shapes."""
    from bmcnet_esr_torch.losses.terms import LossContext
    from bmcnet_esr_torch.training.losses import build_extra_losses

    return build_extra_losses(spec, LossContext(LR, GT, SCALE))


def trainer_config(work: str, datalist: str, **trainer) -> dict:
    dataset = {"scale": 2, "ori_scale": "down2", "window": 128, "sliding_window": 64,
               "sequence": {"sequence_length": 3, "seqn": 2, "step_size": 3}}
    loader = {"path_to_datalist_txt": datalist, "batch_size": 2, "num_workers": 1,
              "dataset": dataset}
    return {
        "experiment": "dp_trainer",
        "model": {"args": {"n_c": N_C, "n_b": N_B, "variant": "plain"}},
        "optimizer": {"name": "Adam", "args": {"lr": 1e-3}},
        "trainer": {
            "output_path": os.path.join(work, "runs"), "monitor": "min valid_loss",
            "early_stop": 100, "tensorboard": False,
            "iteration_based_train": {"enabled": True, "iterations": 4, "save_period": 1000,
                                      "train_log_step": 1, "valid_log_step": 1,
                                      "valid_step": 2, "lr_change_rate": 1000},
            **trainer,
        },
        "train_dataloader": {**loader, "shuffle": True, "drop_last": True},
        "valid_dataloader": {**loader, "shuffle": False, "drop_last": False},
    }


def trainer(rank: int, world: int, work: str, datalist: str = "") -> dict:
    """The whole Trainer: loaders sharded by node, the parallel steps,
    validation, rank 0's checkpoint and the collective resume."""
    import torch.distributed as dist

    from bmcnet_esr_torch.training import Trainer
    from bmcnet_esr_torch.training.checkpoint import latest_checkpoint
    from bmcnet_esr_torch.training.config import RunConfig

    run = RunConfig(trainer_config(work, datalist), runid="shared", make_dirs=rank == 0)
    tr = Trainer(run, seed=0, device="cpu")
    assert tr.mesh is not None and tr.mesh.size() == world, tr.mesh
    losses, step = [], tr.train_step

    def recording(state, batch):
        state, m = step(state, batch)
        losses.append(float(m["train_loss"]))
        return state, m

    tr.train_step = recording
    tr.train()
    ckpts = sorted(n for n in os.listdir(run.save_dir) if n.startswith("iteration_"))
    start = tr.resume(latest_checkpoint(run.save_dir))
    dist.barrier()
    return {"losses": np.asarray(losses), "params": flat_params(tr.state.model),
            "valid_loss": np.asarray(tr.valid_metrics.result()["valid_loss"]),
            "checkpoints": np.asarray(ckpts), "resume_start": np.asarray(start)}


class NodeBatchLoader:
    """The whole node batches of ``<work>/<name>.npz`` (the test's batches of
    4 clips), every epoch, the first one ``start`` batches in (a resumed run
    picks up where the uninterrupted one was): a loader that does not split
    its batches."""

    batch_size, inp_resolution, gt_resolution, seqn, compact = 4, LR, GT, 2, True

    def __init__(self, work: str, name: str, start: int = 0):
        with np.load(os.path.join(work, f"{name}.npz")) as z:
            n = len({k.split("/")[0] for k in z.files})
            self.batches = [{k.split("/")[1]: z[k] for k in z.files if k.startswith(f"{i}/")}
                            for i in range(n)]
        self.pad_last = "clip_mask" in self.batches[0]
        self.start = start

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches[self.start:] + self.batches[:self.start])


def node_batches(rank: int, world: int, work: str) -> dict:
    """The Trainer on injected node batches: it keeps this rank's rows of
    each, 3 train batches over 4 iterations, one validation at iteration 2
    over unevenly valid rows, rank 0's checkpoints."""
    from bmcnet_esr_torch.training import Trainer
    from bmcnet_esr_torch.training.config import RunConfig

    run = RunConfig(trainer_config(os.path.join(work, "node"), ""), runid="node",
                    make_dirs=rank == 0)
    tr = Trainer(run, train_loader=NodeBatchLoader(work, "train"),
                 valid_loader=NodeBatchLoader(work, "valid"), seed=0, device="cpu")
    assert tr.mesh is not None and tr.mesh.size() == world, tr.mesh
    losses, rows, step, evaluate = [], [], tr.train_step, tr.eval_step

    def recording(state, batch):
        rows.append(batch["inp_xy"].shape[0])
        state, m = step(state, batch)
        losses.append(float(m["train_loss"]))
        return state, m

    def evaluating(model, batch):
        rows.append(batch["inp_xy"].shape[0])
        return evaluate(model, batch)

    tr.train_step, tr.eval_step = recording, evaluating
    tr.train()
    return {"losses": np.asarray(losses), "params": flat_params(tr.state.model),
            "valid_loss": np.asarray(tr.valid_metrics.result()["valid_loss"]),
            "checkpoints": np.asarray(sorted(os.listdir(run.save_dir))),
            "rows": np.asarray(rows)}


def refusals(rank: int, world: int, work: str) -> dict:
    """What a Trainer inside a group refuses, before any collective."""
    from bmcnet_esr_torch.training import Trainer
    from bmcnet_esr_torch.training.config import RunConfig

    class NodeBatches:  # a loader of node batches of 3 clips
        batch_size, inp_resolution, gt_resolution, seqn, compact = 3, LR, GT, 2, True

    errors = []
    for over in ({"dcn_slices": 3}, {"data_parallel": False}, {}):
        cfg = trainer_config(work, "", **over)
        del cfg["valid_dataloader"]
        try:
            Trainer(RunConfig(cfg, runid="r", make_dirs=False), train_loader=NodeBatches(),
                    seed=0, device="cpu")
            errors.append("")
        except ValueError as e:
            errors.append(str(e))
    return {"errors": np.asarray(errors)}


# -- tensor parallelism (tests/test_torch_tensor_parallel.py) ---------------------


def tp_model(variant: str, **kw):
    from bmcnet_esr_torch.models import BMCNet, BMCNetPlain

    cls = BMCNet if variant == "full" else BMCNetPlain
    return cls(scale=SCALE, n_c=N_C, n_b=N_B, **kw).to(memory_format=torch.channels_last)


def tp_state(work: str, variant: str, **kw):
    """The whole state the test carried from JAX (``tp-<variant>.pt``):
    parameters, Adam's moments and counts, the EMA."""
    from bmcnet_esr_torch.training import build_optimizer, init_train_state

    model = tp_model(variant, **kw)
    opt, sched = build_optimizer(model.parameters(), OPT, SCHED, TCFG)
    state = init_train_state(model, opt, sched, ema=True)
    state.load_state_dict(torch.load(os.path.join(work, f"tp-{variant}.pt")))
    return state


def flat_state(state) -> dict:
    """Parameters, Adam's moments and the EMA, each flattened in parameter order."""
    params = list(state.model.parameters())
    out = {"params": flat_params(state.model),
           "ema": np.concatenate([state.ema[n].reshape(-1).numpy()
                                  for n, _ in state.model.named_parameters()])}
    for key in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"):
        out[key] = np.concatenate([state.optimizer.state[p][key].reshape(-1).numpy()
                                   for p in params])
    return out


def tp(rank: int, world: int, work: str, n_model: int = 2, steps: int = 2,
       parts: tuple = ()) -> dict:
    """On a ``(world / n_model, n_model)`` mesh, :func:`tp_steps` over the
    first ``steps`` train batches, then the ``tp_<part>`` functions below
    one after the other; their results in one dict."""
    from bmcnet_esr_torch.parallel import make_process_mesh

    mesh = make_process_mesh(1, n_model)
    out = tp_steps(rank, world, work, mesh, steps)
    for part in parts:
        out.update(globals()[f"tp_{part}"](rank, world, work, mesh))
    return out


def tp_steps(rank: int, world: int, work: str, mesh, steps: int) -> dict:
    """For both variants: the carried state cut to this rank's slices,
    ``steps`` train steps (remat on for the full model on 2 ranks), the
    whole state gathered back, and the eval step."""
    from bmcnet_esr_torch.parallel import (
        ChannelGroup,
        gather_tree,
        make_parallel_eval_step,
        make_parallel_train_step,
        shard_batch,
        shard_tree_channels,
    )

    n_model = ChannelGroup.of(mesh).n
    rows = (rank // n_model, world // n_model)
    out = {}
    for variant in ("plain", "full"):
        state = shard_tree_channels(tp_state(work, variant), mesh)
        out[f"{variant}/shapes"] = np.asarray([p.shape[0] for p in state.model.parameters()])
        step = make_parallel_train_step(LR, GT, mesh, ema_decay=0.9,
                                        use_remat=variant == "full" and world == 2)
        metrics = []
        for b in batches(work, "train")[:steps]:
            state, m = step(state, shard_batch(b, *rows))
            metrics.append([float(m[k]) for k in ("train_loss", "train_mse_loss", "grad_norm")])
        out[f"{variant}/metrics"] = np.asarray(metrics)
        out[f"{variant}/counts"] = np.asarray([state.step, state.updates])
        for k, v in flat_state(gather_tree(state, mesh)).items():
            out[f"{variant}/{k}"] = v
        ev = make_parallel_eval_step(LR, GT, mesh)
        m = ev(shard_tree_channels(tp_state(work, variant), mesh).model,
               shard_batch(batches(work, "valid")[0], *rows))
        out[f"{variant}/eval"] = np.asarray([float(m[k]) for k in ("valid_loss",
                                                                    "valid_mse_loss",
                                                                    "valid_clips")])
    return out


def tp_guard(rank: int, world: int, work: str, mesh) -> dict:
    """The guarded step on the poisoned batch (its last clip's loss is NaN),
    a step with the count-image loss terms and one with SSIM's range
    unpinned."""
    from bmcnet_esr_torch.parallel import (
        ChannelGroup,
        make_parallel_train_step,
        shard_batch,
        shard_tree_channels,
    )

    n_model = ChannelGroup.of(mesh).n
    rows = (rank // n_model, world // n_model)
    out = {}
    state = shard_tree_channels(tp_state(work, "plain"), mesh)
    init = flat_params(state.model)
    guarded = make_parallel_train_step(LR, GT, mesh, use_remat=False, skip_nonfinite=True,
                                       extra_losses=(("poison", 1.0, empty_gt_term),))
    state, m = guarded(state, shard_batch(batches(work, "poisoned")[0], *rows))
    out["skipped"] = np.asarray([m["train_skipped"], state.step, state.updates])
    out["skip_loss"] = np.asarray(float(m["train_loss"]))
    out["skip_moved"] = np.asarray(float(np.abs(flat_params(state.model) - init).max()))

    from bmcnet_esr_torch.parallel import gather_tree

    state = shard_tree_channels(tp_state(work, "plain"), mesh)
    step = make_parallel_train_step(LR, GT, mesh, use_remat=False, extra_losses=loss_terms())
    state, m = step(state, shard_batch(batches(work, "train")[0], *rows))
    out["terms"] = np.asarray([float(m[k]) for k in ("train_loss", "train_mse_loss",
                                                     "grad_norm")])
    out["terms/params"] = flat_params(gather_tree(state, mesh).model)

    state = shard_tree_channels(tp_state(work, "plain"), mesh)
    step = make_parallel_train_step(LR, GT, mesh, use_remat=False,
                                    extra_losses=loss_terms(RANGE_TERMS))
    state, m = step(state, shard_batch(batches(work, "ranged")[0], *rows))
    out["range"] = np.asarray([float(m[k]) for k in ("train_loss", "train_mse_loss",
                                                     "grad_norm")])
    out["range/params"] = flat_params(gather_tree(state, mesh).model)
    return out


def float64_state(work: str, variant: str):
    """The carried state's model as a float64 copy (the float64 reference
    dtype), one-device layout."""
    from bmcnet_esr_torch.models import BMCNet, BMCNetPlain

    cls = BMCNet if variant == "full" else BMCNetPlain
    m = cls(scale=SCALE, n_c=N_C, n_b=N_B, dtype=torch.float64)
    m.load_state_dict(tp_state(work, variant).model.state_dict())
    return m.double().to(memory_format=torch.channels_last)


def tp_float64(rank: int, world: int, work: str, mesh) -> dict:
    """The first train batch's gradient in float64 through the
    channel-parallel forward, each split parameter's gradient gathered
    whole: the crossings' sums against one process, free of float32
    round-off."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from bmcnet_esr_torch.parallel import ChannelGroup, ChannelParallelForward, channel_sharding
    from bmcnet_esr_torch.training.train_step import sequence_loss

    axis = ChannelGroup.of(mesh)
    out = {}
    for variant in ("plain", "full"):
        m = float64_state(work, variant)
        placements = channel_sharding(m, axis.n)
        with torch.no_grad():
            for name, p in m.named_parameters():
                if isinstance(placements.get(name), Shard):
                    p.data = p.data.chunk(axis.n)[axis.rank].clone()
        total, _ = sequence_loss(ChannelParallelForward(m, axis), batches(work, "train")[0], LR,
                                 GT, use_remat=False)
        total.backward()
        grads = []
        for name, p in m.named_parameters():
            g = p.grad.contiguous()
            if isinstance(placements.get(name), Shard):
                parts = [torch.empty_like(g) for _ in range(axis.n)]
                dist.all_gather(parts, g, group=axis.group)
                g = torch.cat(parts)
            grads.append(g.reshape(-1))
        out[f"f64/{variant}"] = torch.cat(grads).numpy()
    return out


def tp_extras(rank: int, world: int, work: str, mesh) -> dict:
    """QAT under model_parallel, the bf16 forward (two windows, the second
    on the states of the first) and the crossings' checks."""
    from bmcnet_esr_torch.parallel import (
        ChannelGroup,
        ChannelParallelForward,
        gather_tree,
        make_parallel_train_step,
        shard_tree_channels,
    )

    out = {}
    state = shard_tree_channels(tp_state(work, "plain", quant="qat"), mesh)
    step = make_parallel_train_step(LR, GT, mesh, use_remat=False)
    out["qat/losses"] = np.asarray([float(step(state, b)[1]["train_loss"])
                                    for b in batches(work, "train")[:2]])
    out["qat/params"] = flat_params(gather_tree(state, mesh).model)

    axis = ChannelGroup.of(mesh)
    fwd = ChannelParallelForward(
        shard_tree_channels(tp_state(work, "full", dtype=torch.bfloat16), mesh).model, axis)
    with torch.no_grad():
        x = torch.from_numpy(np.load(os.path.join(work, "tp_window.npy")))
        carry = fwd.init_state(x.shape[0], *LR)
        for _ in range(2):  # the second call runs on states the first made
            *carry, pred = fwd(x, *carry)
            carry = (*carry, pred)
    out["bf16/pred"] = pred.float().numpy()
    out.update(crossing_errors(rank, world, axis))
    out.update(conv_routes(work, mesh, x))
    return out


def conv_routes(work: str, mesh, x) -> dict:
    """How many convolutions of a float32 and a bf16 forward of the full
    model through ``ChannelParallelForward`` (the prediction and its
    gradient) took PyTorch's own kernels (``tensor.own_conv2d``) and how
    many were left to ``F.conv2d``: inside ``OwnConvolutions``, as the
    forward runs on CUDA, and float32 as it runs on the CPU."""
    import collections
    import contextlib

    from bmcnet_esr_torch.parallel import ChannelGroup, ChannelParallelForward
    from bmcnet_esr_torch.parallel import shard_tree_channels, tensor

    own, out = tensor.own_conv2d, {}
    for dtype, route in ((torch.float32, True), (torch.bfloat16, True), (torch.float32, None)):
        calls = collections.Counter()

        def counted(*args, **kwargs):
            y = own(*args, **kwargs)
            calls["own" if y is not None else "conv2d"] += 1
            return y

        model = shard_tree_channels(tp_state(work, "full", dtype=dtype), mesh).model
        fwd = ChannelParallelForward(model, ChannelGroup.of(mesh))
        tensor.own_conv2d = counted
        try:
            with tensor.OwnConvolutions() if route else contextlib.nullcontext():
                pred = fwd(x, *fwd.init_state(x.shape[0], *LR))[-1]
            pred.float().square().sum().backward()
        finally:
            tensor.own_conv2d = own
        out[f"conv/{str(dtype)[6:]}/{route}"] = np.asarray([calls["own"], calls["conv2d"]])
    return out


def crossing_errors(rank: int, world: int, axis) -> dict:
    """Float64 central differences of a global scalar against autograd's
    gradient on each rank, for each crossing of ``parallel/tensor.py``.  The
    global scalar sums each rank's part where the ranks compute different
    things, and is any rank's where they compute the same."""
    import torch.distributed as dist

    from bmcnet_esr_torch.parallel.tensor import cross, sum_ranks

    g = torch.Generator().manual_seed(5)
    shape = (1, 2, 2, 3)  # [B, c, H, W]: this rank's two channels
    xs = [torch.randn(shape, generator=g, dtype=torch.float64) for _ in range(world)]
    ws = [torch.randn((1, 2 * world, 2, 3), generator=g, dtype=torch.float64)
          for _ in range(world)]
    c = torch.randn((1, 2 * world, 2, 3), generator=g, dtype=torch.float64)
    w = ws[rank]

    def summed(v):
        v = v.detach().clone()
        dist.all_reduce(v, group=axis.group)
        return v

    cases = {  # name: (local loss of this rank's input, global scalar, input whole)
        "gather_scatter": (lambda x: (w * cross([x], axis, True, True)[0].square()).sum(),
                           summed, False),
        "gather_own": (lambda x: (c * cross([x], axis, True, False)[0].square()).sum(),
                       lambda v: v, False),
        "sum_grad": (lambda x: (w[:, :2] * cross([x], axis, False, True)[0].pow(3)).sum(),
                     summed, True),
        "sum": (lambda x: (w[:, :2] * sum_ranks(x, axis).square()).sum(), summed, False),
    }
    out = {}
    for name, (loss, total, whole) in cases.items():
        x0 = xs[0] if whole else xs[rank]
        x = x0.clone().requires_grad_()
        loss(x).backward()
        want = torch.zeros_like(x0)
        eps = 1e-6
        with torch.no_grad():
            for q in [rank] if whole else range(world):
                for i in range(x0.numel()):
                    vals = []
                    for sign in (1.0, -1.0):
                        xp = x0.clone()
                        if q == rank:
                            xp.view(-1)[i] += sign * eps
                        vals.append(total(loss(xp)))
                    if q == rank:
                        want.view(-1)[i] = (vals[0] - vals[1]) / (2 * eps)
        out[f"cross/{name}"] = np.asarray([float((x.grad - want).abs().max()),
                                           float(want.abs().max())])
    return out


def tp_trainer(rank: int, world: int, work: str, mesh=None) -> dict:
    """On 4 ranks: ``model_parallel: 2`` over injected node batches (the
    ``(data 2, model 2)`` mesh, validation, rank 0's checkpoints, the
    resume); then the refusals and, as 2 nodes of 2 ranks, the warning that
    drops the model axis."""
    import logging

    from bmcnet_esr_torch.training import Trainer
    from bmcnet_esr_torch.training.checkpoint import latest_checkpoint
    from bmcnet_esr_torch.training.config import RunConfig

    run = RunConfig(trainer_config(os.path.join(work, "tp_node"), "", model_parallel=2),
                    runid="tp_node", make_dirs=rank == 0)
    tr = Trainer(run, train_loader=NodeBatchLoader(work, "train"),
                 valid_loader=NodeBatchLoader(work, "valid"), seed=0, device="cpu")
    out = {"mesh": np.asarray([f"{k}={v}" for k, v in zip(tr.mesh.mesh_dim_names,
                                                           tr.mesh.shape)]),
           "conv_rows": np.asarray(tr.state.model.neuro.conv_fs.weight.shape[0])}
    losses, rows, step, evaluate = [], [], tr.train_step, tr.eval_step

    def recording(state, batch):
        rows.append(batch["inp_xy"].shape[0])
        state, m = step(state, batch)
        losses.append(float(m["train_loss"]))
        return state, m

    def evaluating(model, batch):
        rows.append(batch["inp_xy"].shape[0])
        return evaluate(model, batch)

    tr.train_step, tr.eval_step = recording, evaluating
    tr.train()
    start = tr.resume(latest_checkpoint(run.save_dir))
    out.update(losses=np.asarray(losses), rows=np.asarray(rows),
               valid_loss=np.asarray(tr.valid_metrics.result()["valid_loss"]),
               checkpoints=np.asarray(sorted(os.listdir(run.save_dir))),
               resume_start=np.asarray(start), resumed_rows=np.asarray(
                   tr.state.model.neuro.conv_fs.weight.shape[0]))

    class NodeBatches:  # a loader of node batches of 4 clips
        batch_size, inp_resolution, gt_resolution, seqn, compact = 4, LR, GT, 2, True

    def refusal(**over):
        cfg = trainer_config(work, "", **over)
        del cfg["valid_dataloader"]
        try:
            Trainer(RunConfig(cfg, runid="r", make_dirs=False), train_loader=NodeBatches(),
                    seed=0, device="cpu")
            return ""
        except ValueError as e:
            return str(e)

    out["errors"] = np.asarray([refusal(model_parallel=3),
                                refusal(model_parallel=2, data_parallel=False),
                                refusal(model_parallel=2, dcn_slices=2)])
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger(f"tp_nodes{rank}")
    logger.addHandler(handler)
    env = {k: os.environ[k] for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    os.environ.update(LOCAL_RANK=str(rank % 2), LOCAL_WORLD_SIZE="2")  # 2 nodes of 2 ranks
    try:
        cfg = trainer_config(work, "", model_parallel=2)
        del cfg["valid_dataloader"]
        tr = Trainer(RunConfig(cfg, runid="r", make_dirs=False), train_loader=NodeBatches(),
                     seed=0, device="cpu", logger=logger)
    finally:
        os.environ.update(env)
    out["nodes_mesh"] = np.asarray([f"{k}={v}" for k, v in zip(tr.mesh.mesh_dim_names,
                                                                tr.mesh.shape)])
    out["nodes_warnings"] = np.asarray([r.getMessage() for r in records
                                        if r.levelno == logging.WARNING] or [""])
    return out


def resume_config(work: str, runid: str, iterations: int) -> dict:
    """The node-batch Trainer without validation, ``iterations`` long, a
    checkpoint at the end only."""
    cfg = trainer_config(os.path.join(work, runid), "", monitor="off",
                         iteration_based_train={
                             "enabled": True, "iterations": iterations, "save_period": 1000,
                             "train_log_step": 1, "valid_log_step": 1, "valid_step": 1000,
                             "lr_change_rate": 1000})
    del cfg["valid_dataloader"]
    return cfg


def resume_trainer(work: str, runid: str, iterations: int, start: int = 0, make_dirs=True,
                   **trainer):
    """``(trainer, losses)``: the node-batch Trainer of :func:`resume_config`
    reading from batch ``start``, its losses recorded."""
    from bmcnet_esr_torch.training import Trainer
    from bmcnet_esr_torch.training.config import RunConfig

    cfg = resume_config(work, runid, iterations)
    cfg["trainer"].update(trainer)
    tr = Trainer(RunConfig(cfg, runid=runid, make_dirs=make_dirs),
                 train_loader=NodeBatchLoader(work, "train", start), seed=0, device="cpu")
    losses, step = [], tr.train_step

    def recording(state, batch):
        state, m = step(state, batch)
        losses.append(float(m["train_loss"]))
        return state, m

    tr.train_step = recording
    return tr, losses


def tp_resume(rank: int, world: int, work: str, mesh=None) -> dict:
    """``model_parallel: 2`` on 2 ranks: iterations 0-1 and a checkpoint,
    then iterations 2-3 resumed from the test's checkpoint of one device
    after iteration 1 (run ``one_first``)."""
    from bmcnet_esr_torch.parallel import gather_tree
    from bmcnet_esr_torch.training.checkpoint import latest_checkpoint
    from bmcnet_esr_torch.training.config import RunConfig

    one = RunConfig(resume_config(work, "one_first", 2), runid="one_first", make_dirs=False)
    tr, first = resume_trainer(work, "tp_first", 2, make_dirs=rank == 0, model_parallel=2)
    tr.train()
    tr2, second = resume_trainer(work, "tp_second", 4, start=2, make_dirs=rank == 0,
                                 model_parallel=2)
    start = tr2.resume(latest_checkpoint(one.save_dir))
    tr2.train(start_iteration=start)
    return {"first": np.asarray(first), "second": np.asarray(second),
            "start": np.asarray(start),
            "params": flat_params(gather_tree(tr2.state, tr2.mesh).model)}
