"""Training CLI: the JAX package's ``cli/train.py`` flags plus ``--device``.

    python -m bmcnet_esr_torch.cli.train -c configs/train_nfs.yml \\
        [-id RUNID] [-seed N] [-r CKPT_DIR] [--reset] \\
        [-lr 1e-4] [-bs 2] [-o 'a;b;c' value ...] [--device cuda|cpu]

Overrides address config paths with ``;`` separators (reference
``config/parser.py:93-112``).  ``--device`` defaults to ``cuda`` and fails
without a GPU; ``--device cpu`` trains on the CPU.

Data-parallel training runs one process per GPU under torchrun, which sets
the ranks' environment; ``--distributed`` joins its process group (NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``) and leaves it on exit, the
counterpart of ``jax.distributed.initialize()``::

    torchrun --nnodes=1 --nproc_per_node=8 -m bmcnet_esr_torch.cli.train \
        -c configs/train_nfs.yml --distributed

``batch_size`` is then each node's batch, split over its ranks.  The
recipe's ``trainer.model_parallel: N`` adds tensor parallelism: the node's
ranks form model groups of N that split each convolution's output channels
and read the same rows of the batch (N must divide the ranks)::

    torchrun --standalone --nproc_per_node=4 -m bmcnet_esr_torch.cli.train \
        -c configs/train_nfs.yml --distributed -o 'trainer;model_parallel' 2
"""

from __future__ import annotations

import argparse
import ast
import datetime
import logging
import random
from typing import List, Tuple

import numpy as np


def parse_overrides(args) -> List[Tuple[str, object]]:
    overrides: List[Tuple[str, object]] = []
    if args.learning_rate is not None:
        overrides.append(("optimizer;args;lr", args.learning_rate))
    if args.batch_size is not None:
        overrides.append(("train_dataloader;batch_size", args.batch_size))
        overrides.append(("valid_dataloader;batch_size", args.batch_size))
    for target, raw in args.override or []:
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        overrides.append((target, value))
    return overrides


def main(argv=None):
    p = argparse.ArgumentParser(description="bmcnet_esr_torch trainer")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-id", "--runid", default=None)
    p.add_argument("-seed", "--seed", default=3407, type=int)
    p.add_argument("-r", "--resume", default=None)
    p.add_argument("--reset", action="store_true",
                   help="load weights from --resume but reset trainer state")
    p.add_argument("-lr", "--learning_rate", type=float, default=None)
    p.add_argument("-bs", "--batch_size", type=int, default=None)
    p.add_argument("-o", "--override", nargs=2, action="append",
                   metavar=("PATH", "VALUE"), help="config override: 'a;b;c' value")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel training: join the process group torchrun describes "
                        "(one process per GPU; batch_size is each node's batch)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; fails without a GPU) or cpu")
    args = p.parse_args(argv)

    import torch

    device = args.device
    if args.distributed:
        from bmcnet_esr_torch.parallel import init_distributed

        device = init_distributed(args.device)
    try:
        return _train(args, device)
    finally:
        if args.distributed:
            torch.distributed.destroy_process_group()


def _train(args, device):
    import torch
    import torch.distributed as dist

    # host-side RNGs; the parameters come from their own seeded generator
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    from bmcnet_esr_torch.training.config import RunConfig
    from bmcnet_esr_torch.training.trainer import Trainer
    from bmcnet_esr_torch.utils.logging import get_logger, setup_logging

    runid, writer = args.runid, True
    if args.distributed:
        # one run directory for all ranks, named by rank 0; rank 0 alone
        # writes it, the log file and the checkpoints
        shared = [runid or datetime.datetime.now().strftime("%m%d_%H%M%S")]
        dist.broadcast_object_list(shared, src=0)
        runid, writer = shared[0], dist.get_rank() == 0
        if not writer:
            setup_logging(None, console_level=logging.WARNING)
    run = RunConfig.from_file(args.config, runid=runid, overrides=parse_overrides(args),
                              make_dirs=writer)
    logger = get_logger("train")
    logger.info(f"run dir: {run.save_dir}")
    trainer = Trainer(run, seed=args.seed, logger=logger, device=device)
    start = trainer.resume(args.resume, reset=args.reset) if args.resume else 0
    return trainer.train(start_iteration=start)


if __name__ == "__main__":
    main()
