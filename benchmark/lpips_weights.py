"""Seeded LPIPS (alex, v0.1) weights: the released ``alex.pth`` heads and
torchvision's AlexNet weights are not in the repository.

Both sides get these: the program reads them from the bundle that the mode
writes with the program's ``LPIPS.to_npz``, the reference reads them as they
are.  The backbone takes PyTorch's default ``Conv2d`` initialisation (weights
and biases uniform in ``+-1 / sqrt(fan_in)``, what ``kaiming_uniform_(a=
sqrt(5))`` draws) from a CPU generator seeded from the run's seed; the heads
are non-negative, uniform in ``[0, head_high)``.  The configuration's
``lpips`` block gives ``head_high``."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from benchmark.reference.lpips import param_shapes

PURPOSE = 5  # beside benchmark/traffic.py's purposes of a run's seed


def seeded_lpips(config: Dict, seed: int) -> Dict[str, torch.Tensor]:
    """Float32 CPU tensors under ``reference/lpips.py``'s names."""
    state = np.random.SeedSequence([int(seed) % 2**64, PURPOSE]).generate_state(1, np.uint64)
    g = torch.Generator().manual_seed(int(state[0]) % 2**63)
    high = float(config["lpips"]["head_high"])
    shapes = param_shapes()
    out: Dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        u = torch.rand(shape, generator=g, dtype=torch.float32)
        if name.startswith("lin"):
            out[name] = u * high
        else:
            fan_in = math.prod(shapes[name.split(".")[0] + ".weight"][1:])
            out[name] = (2.0 * u - 1.0) / math.sqrt(fan_in)
    return out


def write_bundle(config: Dict, seed: int, path: str) -> str:
    """The program's LPIPS bundle of these weights (``LPIPS.to_npz``)."""
    from bmcnet_esr_torch.losses.lpips import LPIPS

    p = seeded_lpips(config, seed)
    lp = config["lpips"]
    backbone = {k: v.numpy() for k, v in p.items() if not k.startswith("lin")}
    lins = [p[f"lin{l}"].numpy() for l in range(len(lp["taps"]))]
    return LPIPS(backbone, lins, lp["net"], version=lp["version"]).to_npz(path)
