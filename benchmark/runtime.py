"""What every mode shares: the program's model built from the configuration,
the device's peak memory, seeded samples."""

from __future__ import annotations

import gc
from typing import Dict

import torch

from benchmark import traffic
from benchmark.weights import model_dims, seeded_params


def program_model(config: Dict, dtype: str, seed: int, device):
    """The program's model in the configuration's shape and the cell's dtype
    (``float32``, ``bfloat16`` or an ``int8*`` serving dtype), with the
    benchmark's seeded weights, placed as the program places its models
    (channels-last, eval)."""
    from bmcnet_esr_torch.inference.engine import DTYPES as P_DTYPES
    from bmcnet_esr_torch.inference.engine import INT8_DTYPES
    from bmcnet_esr_torch.models import BMCNet

    dims = model_dims(config)
    model = BMCNet(scale=dims["scale"], n_c=dims["n_c"], n_b=dims["n_b"], repeat=dims["repeat"],
                   dtype=P_DTYPES.get(dtype, torch.bfloat16), quant=INT8_DTYPES.get(dtype, False))
    model.load_state_dict(seeded_params(config, seed, device), strict=True)
    return model.to(device, memory_format=torch.channels_last).eval()


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if torch.device(device).type == "cuda" else 0


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


sample = traffic.sample


def strict_float32(autotune: bool = True) -> None:
    """Float32 products in float32 (no TF32) for the references, with cuDNN's
    algorithms timed (the references run after the window)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = autotune
