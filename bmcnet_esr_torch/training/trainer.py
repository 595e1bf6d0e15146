"""Iteration-based trainer: the engine behind ``cli/train.py``.

Counterpart of ``bmcnet_esr_tpu/training/trainer.py`` (the reference
``Trainer``, ``train.py:86-617``, iteration mode only):

* each iteration is one ``make_train_step`` call: the batch's windows are
  rasterized on the device by the hand-written kernel (one launch for the
  inputs, one for the GT), then BPTT, backward and the optimizer update;
* batches go up one ahead from pinned memory with ``non_blocking`` copies
  on a side stream, so the next upload overlaps the running step;
* metrics stay on the device and are read at log boundaries; the work
  enqueued ahead of the device is bounded (the host waits on the event of
  the step five back);
* validation every ``valid_step`` iterations over a ``pad_last`` loader,
  early stopping on the monitored metric (``train.py:343-382``), checkpoints
  every ``save_period`` and on a new best, a final one at the end;
* SIGTERM: the running iteration finishes, a checkpoint is written, the
  loop ends; a second SIGTERM ends the process at once.

Parameters are initialized from ``torch.Generator().manual_seed(seed)``.

Data parallelism (``bmcnet_esr_tpu/training/trainer.py:255-411``): inside a
process group of more than one rank (``torchrun ... cli.train
--distributed``) with ``data_parallel: true``, the steps are
``parallel.make_parallel_train_step`` / ``make_parallel_eval_step``.
``batch_size`` is the node's batch: the loaders shard the clips over the
nodes (``shard_index`` = the node) and split each batch over the node's
ranks (``rows``), so the global batch is the JAX multi-host mesh's, clip
for clip.  ``dcn_slices: N`` lays the ranks on a ``(dcn_data, data)`` mesh.
Rank 0 alone writes checkpoints, the log file and tensorboard, with a
barrier after each save; every rank resumes from the shared path; a
SIGTERM stop is agreed by all ranks at an iteration boundary.  Two
divergences from the JAX trainer: a node batch that its ranks do not divide
raises (torchrun has fixed the rank count; JAX shrinks its data axis), and
one process that sees several GPUs outside a group raises.

Tensor parallelism (``trainer.py:256-330``): ``model_parallel: N`` lays the
node's ``W`` ranks on a ``("data", "model")`` mesh of ``(W / N, N)``
(``(1, N)`` with ``data_parallel: false``, which needs ``W == N``), model
groups of ``N`` consecutive ranks.  The state is cut to each rank's channel
slices (``parallel.shard_tree_channels``) and the steps run the
channel-parallel forward; a batch splits by the data coordinate, so the
ranks of a model group read the same rows.  An ``N`` that does not divide
``W`` raises (outside a group ``W`` is 1); across more than one node ``N``
is set to 1 with a warning, as JAX does under multi-host.  Checkpoints hold
the whole state, gathered over the model group, in the one-device layout:
a run under ``model_parallel`` resumes on one device and the other way
round.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import signal
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from bmcnet_esr_torch.data import DatasetConfig, SequenceLoader, load_datalist
from bmcnet_esr_torch.models import BMCNet, BMCNetPlain, count_params
from bmcnet_esr_torch.parallel.mesh import (
    any_rank,
    gather_tree,
    host_group,
    make_process_mesh,
    process_layout,
    replicate_tree,
    shard_batch,
    shard_tree_channels,
)
from bmcnet_esr_torch.training import checkpoint as ckpt_lib
from bmcnet_esr_torch.training.config import RunConfig
from bmcnet_esr_torch.training.losses import (
    LossContext,
    adapt_term,
    build_extra_losses,
    needs_events,
)
from bmcnet_esr_torch.training.optim import build_optimizer
from bmcnet_esr_torch.training.train_step import (
    init_train_state,
    make_eval_step,
    make_train_step,
)
from bmcnet_esr_torch.utils import (
    MetricTracker,
    TensorboardWriter,
    get_logger,
    resolve_device,
    strict_fp32,
)

def build_model(config: Dict[str, Any], scale: int, generator: Optional[torch.Generator] = None):
    """Model from the recipe's ``model`` block (defaults ``n_c=128``,
    ``n_b=5``, ``variant: full``).  ``quant: qat`` trains on the int8 grid
    with straight-through gradients; the serving-only int8 modes are refused."""
    args = (config.get("model", {}) or {}).get("args", {}) or {}
    quant = args.get("quant", False)
    if quant and quant != "qat":
        raise ValueError(
            f"model;args;quant: {quant!r} is a serving-only mode; the one "
            "trainable quant mode is 'qat'"
        )
    cls = BMCNetPlain if args.get("variant", "full") == "plain" else BMCNet
    dtype = torch.bfloat16 if args.get("dtype") == "bfloat16" else torch.float32
    return cls(scale=scale, n_c=int(args.get("n_c", 128)), n_b=int(args.get("n_b", 5)),
               dtype=dtype, quant=quant, generator=generator)


def build_loader(dl_cfg: Dict[str, Any], *, seed: int = 0, pad_last: bool = False,
                 layout=None) -> SequenceLoader:
    """``layout`` (a ``parallel.ProcessLayout``) shards the clips over the
    nodes and each batch over the node's ranks of the data axis."""
    shard = {}
    if layout is not None:
        shard = dict(shard_index=layout.node, shard_count=layout.n_nodes,
                     rows=(layout.data_rank, layout.data_size))
    return SequenceLoader(
        load_datalist(dl_cfg["path_to_datalist_txt"]),
        DatasetConfig.from_dict(dl_cfg["dataset"]),
        batch_size=dl_cfg.get("batch_size", 2),
        shuffle=dl_cfg.get("shuffle", False),
        drop_last=dl_cfg.get("drop_last", False),
        pad_last=dl_cfg.get("pad_last", pad_last),
        # int16 / int8 event transfer without timestamps (the count path
        # never reads them); compact_transfer: False ships raw float32
        compact=dl_cfg.get("compact_transfer", True),
        num_workers=dl_cfg.get("num_workers", 2),
        seed=seed,
        **shard,
    )


class Trainer:
    # the step reads only these batch keys (``inp_len`` joins them when a
    # loss term consumes raw events); the rest is not uploaded
    _STEP_KEYS = ("inp_events", "gt_events", "inp_xy", "inp_p", "gt_xy", "gt_p", "clip_mask")
    # steps the host may enqueue ahead of the device
    MAX_PENDING = 5

    def __init__(
        self,
        run: RunConfig,
        *,
        train_loader=None,
        valid_loader=None,
        seed: int = 3407,
        logger: Optional[logging.Logger] = None,
        extra_losses: tuple = (),
        device="cuda",
    ):
        self.run = run
        cfg = run.config
        self.logger = logger or get_logger("train")
        self.seed = seed
        self.device = resolve_device(device)
        tcfg = cfg["trainer"]
        icfg = tcfg["iteration_based_train"]
        if not icfg.get("enabled", True):
            raise ValueError("only iteration-based training is supported (the "
                             "reference's epoch path is dead code)")
        self.iterations = int(icfg["iterations"])
        self.save_period = int(icfg.get("save_period", 5000))
        self.train_log_step = int(icfg.get("train_log_step", 50))
        self.valid_log_step = int(icfg.get("valid_log_step", 50))
        self.valid_step = int(icfg.get("valid_step", 1000))

        # BPTT remat: recompute each step's activations in the backward
        # pass (memory) instead of storing them (time)
        self.use_remat = bool(tcfg.get("remat", True))
        self.grad_accum = int(tcfg.get("grad_accum", 1))
        self.skip_nonfinite = bool(tcfg.get("skip_nonfinite", False))
        self.skipped_steps = 0
        self.ema_decay = float(tcfg.get("ema", 0.0))
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(f"trainer.ema must be in [0, 1), got {self.ema_decay}")
        self.layout = self._parallel_layout(tcfg)
        self.is_writer = self.layout is None or self.layout.rank == 0
        if not self.is_writer:  # rank 0 writes the log; the others only warn
            self.logger = logging.getLogger(f"{self.logger.name}.rank{self.layout.rank}")
            self.logger.setLevel(logging.WARNING)

        monitor = tcfg.get("monitor", "off")
        if monitor == "off":
            self.mnt_mode, self.mnt_metric, self.mnt_best = "off", None, 0.0
        else:
            self.mnt_mode, self.mnt_metric = monitor.split()
            if self.mnt_mode not in ("min", "max"):
                raise ValueError(f"trainer.monitor must start with min or max, got {monitor!r}")
            self.mnt_best = math.inf if self.mnt_mode == "min" else -math.inf
        self.early_stop = tcfg.get("early_stop", math.inf)
        self.not_improved_count = 0

        self.train_loader = (train_loader if train_loader is not None
                             else build_loader(cfg["train_dataloader"], seed=seed,
                                               layout=self.layout))
        self.valid_loader = valid_loader
        if valid_loader is None and "valid_dataloader" in cfg:
            self.valid_loader = build_loader(cfg["valid_dataloader"], seed=seed, pad_last=True,
                                             layout=self.layout)
        for ld in (self.train_loader, self.valid_loader):
            self._rank_rows(ld)  # a node batch that does not split raises here

        scale = cfg["train_dataloader"]["dataset"]["scale"]
        self.scale = scale
        self.inp_resolution = tuple(self.train_loader.inp_resolution)
        self.gt_resolution = tuple(self.train_loader.gt_resolution)
        self.seqn = self.train_loader.seqn

        ctx = LossContext(self.inp_resolution, self.gt_resolution, scale, self.seqn)
        self.extra_losses = build_extra_losses(cfg.get("loss"), ctx) + tuple(
            (n, float(w), adapt_term(fn)) for n, w, fn in extra_losses
        )
        if needs_events(self.extra_losses):
            for label, loader in (("train_dataloader", self.train_loader),
                                  ("valid_dataloader", self.valid_loader)):
                if loader is not None and loader.compact:
                    raise ValueError(
                        "an attached loss term consumes raw event windows "
                        f"(needs_events) but the {label} uses the compact transfer "
                        "format, which drops timestamps — set compact_transfer: "
                        f"False in the {label} block"
                    )
        # the valid-event counts ship only when a term needs them
        self._step_keys = self._STEP_KEYS + (
            ("inp_len",) if needs_events(self.extra_losses) else ()
        )
        if getattr(self.train_loader, "pad_last", False):
            self.logger.warning(
                "train_dataloader pad_last=True: the final short batch's "
                "wrap-padded duplicate clips contribute full-weight gradients "
                "(clip_mask weighting applies to EVAL only); prefer drop_last for training"
            )
        if self.extra_losses:
            self.logger.info("extra loss terms: "
                             + ", ".join(f"{n} (w={w})" for n, w, _ in self.extra_losses))

        strict_fp32()
        # deterministic cuDNN algorithms, as the reference's init_seeds sets
        # them: a resumed run repeats an uninterrupted one bit for bit
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        model = build_model(cfg, scale, torch.Generator().manual_seed(seed))
        model = model.to(self.device, memory_format=torch.channels_last)
        optimizer, schedule = build_optimizer(
            model.parameters(), cfg.get("optimizer", {}), cfg.get("lr_scheduler", {}), icfg
        )
        self.schedule = schedule
        self.state = init_train_state(model, optimizer, schedule, ema=self.ema_decay > 0)
        self.logger.info(f"model params: {count_params(model)} on {self.device}")

        self.mesh = self._host = None
        if self.layout is None:
            self.train_step = make_train_step(
                self.inp_resolution, self.gt_resolution, self.seqn, use_remat=self.use_remat,
                extra_losses=self.extra_losses, grad_accum=self.grad_accum,
                skip_nonfinite=self.skip_nonfinite, ema_decay=self.ema_decay,
            )
            self.eval_step = make_eval_step(
                self.inp_resolution, self.gt_resolution, self.seqn,
                extra_losses=self.extra_losses,
            )
        else:
            # imported here: parallel.step imports this package's train_step
            from bmcnet_esr_torch.parallel.step import (
                make_parallel_eval_step,
                make_parallel_train_step,
            )

            if self.grad_accum > 1:
                self.logger.warning(
                    "grad_accum > 1 is a single-device memory lever; the mesh already "
                    "splits the batch across ranks — ignoring it")
                self.grad_accum = 1
            self.mesh = make_process_mesh(int(tcfg.get("dcn_slices", 1)), self.layout.n_model)
            self._host = host_group()
            replicate_tree(self.state)
            if self._model_parallel:
                shard_tree_channels(self.state, self.mesh)
            self.train_step = make_parallel_train_step(
                self.inp_resolution, self.gt_resolution, self.mesh, self.seqn,
                use_remat=self.use_remat, extra_losses=self.extra_losses,
                skip_nonfinite=self.skip_nonfinite, ema_decay=self.ema_decay,
            )
            self.eval_step = make_parallel_eval_step(
                self.inp_resolution, self.gt_resolution, self.mesh, self.seqn,
                extra_losses=self.extra_losses,
            )
            self.logger.info(f"mesh over {self.mesh.size()} ranks: "
                             f"{dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))}")
        self._copy_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        self.writer = TensorboardWriter(run.log_dir,
                                        tcfg.get("tensorboard", True) and self.is_writer,
                                        self.logger)
        self.train_metrics = MetricTracker(["train_mse_loss", "train_loss"])
        self.valid_metrics = MetricTracker(["valid_mse_loss", "valid_loss"])

    def _parallel_layout(self, tcfg: Dict[str, Any]):
        """This rank's ``ProcessLayout`` when the run spans a process group,
        else ``None``; refuses what it cannot run rather than quietly train
        on one device (``bmcnet_esr_tpu/training/trainer.py:255-330``)."""
        n_slices = int(tcfg.get("dcn_slices", 1))
        n_model = int(tcfg.get("model_parallel", 1))
        if n_slices > 1 and n_model > 1:
            raise ValueError("dcn_slices and model_parallel cannot combine yet")
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        layout = process_layout() if world > 1 else None
        if n_model > 1 and layout is not None and layout.n_nodes > 1:
            self.logger.warning(
                "model_parallel is a single-node layout knob; ignoring it across "
                f"{layout.n_nodes} nodes (the data axis spans the nodes instead)")
            n_model = 1
        if n_model < 1 or world % n_model:
            raise ValueError(f"model_parallel={n_model} does not divide the {world} available "
                             "ranks: launch a multiple of it with torchrun --nproc_per_node "
                             "... --distributed")
        use_dp = bool(tcfg.get("data_parallel", True)) and world > 1
        if n_slices > 1 and not use_dp:
            raise ValueError(
                "dcn_slices > 1 requires data parallelism (data_parallel: true inside a "
                "process group of more than one rank): the (dcn_data, data) mesh splits "
                "the batch over both axes")
        if world > 1 and not use_dp and world != n_model:
            raise ValueError(f"data_parallel: false inside a process group of {world} ranks: "
                             "every rank would train alone; launch one process"
                             + (f", or {n_model} for model_parallel={n_model}"
                                if n_model > 1 else ""))
        if (world == 1 and tcfg.get("data_parallel", True) and self.device.type == "cuda"
                and torch.cuda.device_count() > 1):
            raise ValueError(
                f"data_parallel with {torch.cuda.device_count()} visible devices in one "
                "process: launch one process per GPU with torchrun --nproc_per_node="
                f"{torch.cuda.device_count()} -m bmcnet_esr_torch.cli.train -c <recipe> "
                "--distributed, or set trainer.data_parallel: false, or make one device visible")
        if layout is None:
            return None
        if world % n_slices:
            raise ValueError(f"dcn_slices={n_slices} does not divide the world size {world}")
        return dataclasses.replace(layout, n_model=n_model)

    def _rank_rows(self, loader):
        """``(index, count)`` of the rows of each batch this rank takes from
        ``loader``, or ``None`` for all: a loader that splits its batches
        already (``SequenceLoader(rows=...)``) is read as it is; any other
        yields node batches, which the node's ranks split here."""
        if loader is None or self.layout is None:
            return None
        n, r = self.layout.data_size, self.layout.data_rank
        if loader.batch_size % n:
            raise ValueError(
                f"the node batch of {loader.batch_size} clips does not split over the "
                f"node's {n} ranks" + (" of the data axis" if self.layout.n_model > 1 else "")
                + ": make batch_size a multiple of the ranks per node")
        own = (getattr(loader, "row_index", 0), getattr(loader, "row_count", 1))
        if own == (r, n):
            return None
        if own[1] != 1:
            raise ValueError(f"the loader yields rows {own} of each batch; rank {r} of {n} "
                             "needs its own rows or whole batches")
        return r, n

    # -- checkpointing -----------------------------------------------------

    def save(self, iteration: int, best: bool = False) -> Optional[str]:
        """Rank 0 writes the checkpoint (``None`` elsewhere), the whole state
        gathered over its model group; every rank waits for it at a
        barrier."""
        if self._model_parallel:
            gather_tree(self.state, self.mesh)
        path = self._write_checkpoint(iteration, best) if self.is_writer else None
        if self.layout is not None:
            dist.barrier(group=self._host)
        if self._model_parallel:
            shard_tree_channels(self.state, self.mesh)
        return path

    @property
    def _model_parallel(self) -> bool:
        return self.layout is not None and self.layout.n_model > 1

    def _write_checkpoint(self, iteration: int, best: bool) -> str:
        meta = {
            "training_mode": "iteration_based_train",
            "monitor_best": (float(self.mnt_best)
                             if self.mnt_best not in (math.inf, -math.inf) else None),
            "experiment": self.run.experiment,
        }
        path = ckpt_lib.save_checkpoint(self.run.save_dir, self.state, iteration=iteration,
                                        best=best, meta=meta)
        self.logger.info(f"saved checkpoint: {path}")
        return path

    def resume(self, path: str, reset: bool = False) -> int:
        """Load the checkpoint at ``path`` (every rank reads it; under
        ``model_parallel`` each keeps its slices of the whole state)."""
        if self._model_parallel:
            gather_tree(self.state, self.mesh)
        _, meta = ckpt_lib.restore_checkpoint(path, self.state)
        if self._model_parallel:
            shard_tree_channels(self.state, self.mesh)
        ckpt_exp = meta.get("experiment")
        if ckpt_exp and ckpt_exp != self.run.experiment:
            self.logger.warning(f"checkpoint experiment {ckpt_exp!r} != current "
                                f"{self.run.experiment!r} — resuming anyway")
        if reset:
            self.logger.info(f"loaded weights from {path}; trainer state reset")
            return 0
        if meta.get("monitor_best") is not None:
            self.mnt_best = meta["monitor_best"]
        start = int(meta.get("iteration", 0)) + 1
        self.logger.info(f"resumed from {path} at iteration {start}")
        return start

    # -- host -> device ----------------------------------------------------

    def _upload(self, batch: Dict[str, np.ndarray]):
        """Enqueue one batch's upload: pinned host memory, ``non_blocking``
        copies on the side stream.  Returns ``(tensors, ready event)``."""
        arrays = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in batch.items() if k in self._step_keys}
        if self._copy_stream is None:
            return arrays, None
        with torch.cuda.stream(self._copy_stream):
            dev = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in arrays.items()}
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return dev, ready

    def _adopt(self, uploaded) -> Dict[str, torch.Tensor]:
        """Make an upload safe to use on the compute stream."""
        dev, ready = uploaded
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in dev.values():
                t.record_stream(stream)
        return dev

    def _device_prefetched(self, loader):
        """Yield batches on the device (this rank's rows of them), the next
        one's upload enqueued before the current one is handed out."""
        staged, rows = None, self._rank_rows(loader)
        for batch in loader:
            nxt = self._upload(batch if rows is None else shard_batch(batch, *rows))
            if staged is not None:
                yield self._adopt(staged)
            staged = nxt
        if staged is not None:
            yield self._adopt(staged)

    def _mark(self) -> Optional[torch.cuda.Event]:
        if self.device.type != "cuda":
            return None
        done = torch.cuda.Event()
        done.record()
        return done

    # -- evaluation --------------------------------------------------------

    def _valid(self, stamp: int) -> Dict[str, float]:
        self.valid_metrics.reset()
        for batch_idx, batch in enumerate(self._device_prefetched(self.valid_loader)):
            m = self.eval_step(self.state.model, batch)
            self.valid_metrics.update("valid_mse_loss", float(m["valid_mse_loss"]))
            self.valid_metrics.update("valid_loss", float(m["valid_loss"]))
            if batch_idx % self.valid_log_step == 0:
                self.logger.debug(f"valid stamp {stamp} [{batch_idx}/{len(self.valid_loader)}] "
                                  f"valid_loss: {float(m['valid_loss']):.4e}")
        return self.valid_metrics.result()

    def _eval_monitor(self, log: Dict[str, float]):
        """(stop_training, best) from the monitored metric (``train.py:343-382``)."""
        if self.mnt_mode == "off":
            return False, False
        if self.mnt_metric not in log:
            self.logger.warning(f"metric {self.mnt_metric!r} missing from valid log")
            return False, False
        value = log[self.mnt_metric]
        improved = value <= self.mnt_best if self.mnt_mode == "min" else value >= self.mnt_best
        if improved:
            self.mnt_best = value
            self.not_improved_count = 0
            return False, True
        self.not_improved_count += 1
        if self.not_improved_count > self.early_stop:
            self.logger.info(f"no improvement for {self.early_stop} stamps; early stopping")
            return True, False
        return False, False

    # -- main loop ---------------------------------------------------------

    def train(self, start_iteration: int = 0) -> Dict[str, float]:
        # SIGTERM drains: the handler only sets a flag; the loop finishes the
        # running iteration and checkpoints.  A second SIGTERM exits at once.
        self._preempted = False
        prev_handler = None
        try:
            prev_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:
            pass  # not the main thread: the flag still works
        try:
            return self._train_loop(start_iteration)
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    def _on_sigterm(self, signum, frame):
        if self._preempted:  # the second SIGTERM
            self._exit_now()
        self._preempted = True

    def _exit_now(self):  # separate, so tests can stub the re-kill
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)

    def _log_window(self, iter_idx: int, pending: list, start_iteration: int, t_start: float):
        window_mse, window_tot, window_skip = [], [], 0
        for _, m, _ in pending:
            mse, tot = float(m["train_mse_loss"]), float(m["train_loss"])
            window_mse.append(mse)
            window_tot.append(tot)
            window_skip += int(m.get("train_skipped", 0))
            self.train_metrics.update("train_mse_loss", mse)
            self.train_metrics.update("train_loss", tot)
        if window_skip:
            self.skipped_steps += window_skip
            self.logger.warning(
                f"skipped {window_skip} non-finite step(s) in this window "
                f"({self.skipped_steps} total) — params and optimizer state untouched "
                "for those batches"
            )
            self.writer.set_step(iter_idx)
            self.writer.add_scalar("skipped_steps", self.skipped_steps)
        # the scalar is the mean over the log window, not its last sample
        mse, tot = float(np.mean(window_mse)), float(np.mean(window_tot))
        lr = float(self.schedule(iter_idx))
        self.writer.set_step(iter_idx)
        self.writer.add_scalar("train_mse_loss", mse)
        self.writer.add_scalar("train_loss", tot)
        self.writer.add_scalar("learning_rate", lr)
        ips = (iter_idx - start_iteration + 1) / max(time.time() - t_start, 1e-9)
        self.logger.info(f"iter {iter_idx}/{self.iterations} train_mse_loss: {mse:.4e} "
                         f"train_loss: {tot:.4e} lr: {lr:.4e} iters/sec: {ips:.2f}")
        pending.clear()

    def _train_loop(self, start_iteration: int) -> Dict[str, float]:
        iter_idx, valid_stamp, stop = start_iteration, 1, False
        pending: list = []  # (iteration, device metrics, done event)
        t_start = time.time()
        while not stop:
            epoch_start = iter_idx
            for batch in self._device_prefetched(self.train_loader):
                self.state, metrics = self.train_step(self.state, batch)
                pending.append((iter_idx, metrics, self._mark()))
                if len(pending) >= self.MAX_PENDING and pending[-self.MAX_PENDING][2] is not None:
                    pending[-self.MAX_PENDING][2].synchronize()

                if iter_idx % self.train_log_step == 0:
                    self._log_window(iter_idx, pending, start_iteration, t_start)

                best = False
                if (self.valid_loader is not None and iter_idx % self.valid_step == 0
                        and iter_idx != 0):
                    val_log = self._valid(valid_stamp)
                    self.writer.set_step(valid_stamp, "valid")
                    for k, v in val_log.items():
                        self.writer.add_scalar(f"stamp_{k}", v)
                        self.logger.info(f"    {k:25s}: {v:.4e}")
                    stop, best = self._eval_monitor(val_log)
                    valid_stamp += 1
                    if stop:
                        # count the finished iteration before leaving: the
                        # final save labels iter_idx - 1, and the state holds
                        # this iteration's update already
                        iter_idx += 1
                        break

                if (iter_idx % self.save_period == 0 and iter_idx != 0) or best:
                    self.save(iter_idx, best=best)

                iter_idx += 1
                if iter_idx >= self.iterations:
                    self.logger.info("training completes!")
                    stop = True
                    break
                if (self._preempted if self.layout is None
                        else any_rank(self._preempted, self._host)):
                    self.logger.warning(f"SIGTERM received — checkpointing at iteration "
                                        f"{iter_idx - 1} and exiting for clean resume")
                    stop = True
                    break
            if iter_idx == epoch_start and not stop:
                # an epoch of no batch would loop here forever (a node's
                # shard of a small datalist under drop_last, for one)
                raise ValueError("the train loader yielded no batch in an epoch: fewer "
                                 "clips than batch_size with drop_last")

        # a final checkpoint always, so a resume never depends on 'best' alone
        self.save(iter_idx - 1 if iter_idx else 0, best=False)
        self.writer.flush()
        return self.train_metrics.result()
