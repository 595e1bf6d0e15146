"""Seeded model weights, made on the device in one call.

Both sides get these: the program loads them into its model, the reference
reads them as they are.  Every convolution is ``normal(0, gain *
sqrt(2 / fan_in))``; the configuration names the gains (``init`` block):
``gain`` for every convolution but the output head (``head_gain``) and the
three recurrent-state heads (``state_gain``).
Biases are ``normal(0, bias_std)``, LayerNorm scales ``1 + normal(0,
norm_std)`` and shifts ``normal(0, norm_std)``."""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.model import param_shapes


STATE_HEADS = ("neuro.conv_hs.weight", "neuro.conv_hp.weight", "neuro.conv_hn.weight")


def model_dims(config: Dict) -> Dict[str, int]:
    m = config["model"]
    return {k: int(m[k]) for k in ("n_c", "n_b", "scale", "repeat")}


def seeded_params(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 parameters under the state dict's names, from ``seed``."""
    init = config["init"]
    shapes = param_shapes(**model_dims(config))
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**63)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        v = flat[at:at + n].view(shape)
        at += n
        if name.endswith(".weight") and len(shape) == 4:
            gain = init["gain"]
            if name == "neuro.conv_o.weight":
                gain = init["head_gain"]
            elif name in STATE_HEADS:
                gain = init["state_gain"]
            v = v * (gain * math.sqrt(2.0 / (shape[1] * shape[2] * shape[3])))
        elif ".norm_s." in name:
            v = v * init["norm_std"] + (1.0 if name.endswith(".weight") else 0.0)
        else:
            v = v * init["bias_std"]
        out[name] = v.contiguous()
    return out
