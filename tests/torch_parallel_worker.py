"""One rank of the data-parallel CPU tests of bmcnet_esr_torch (gloo).

``tests/test_torch_parallel.py`` starts N of these as spawned processes; each
joins a gloo group through a file store, runs one of the functions below on
its rows of the global batches the test wrote, and saves what it saw to an
npz file (a traceback to ``<out>.err`` when it fails).  Imports no JAX.
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
    guarded step on a batch whose last clip is poisoned and the eval step."""
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
    return out


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
    4 clips), every epoch: a loader that does not split its batches."""

    batch_size, inp_resolution, gt_resolution, seqn, compact = 4, LR, GT, 2, True

    def __init__(self, work: str, name: str):
        with np.load(os.path.join(work, f"{name}.npz")) as z:
            n = len({k.split("/")[0] for k in z.files})
            self.batches = [{k.split("/")[1]: z[k] for k in z.files if k.startswith(f"{i}/")}
                            for i in range(n)]
        self.pad_last = "clip_mask" in self.batches[0]

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


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
