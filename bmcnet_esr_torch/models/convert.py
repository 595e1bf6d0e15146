"""Checkpoint loading into the port's models.

Counterpart of ``bmcnet_esr_tpu/models/convert.py``.  The port's parameter
names are the reference state dict's *canonical* keys: tied aliases
(``conv_f2``, ``convf2``, ``conv2_st``, ``conv_fnst``, ``conv_fns`` and the
module-level ``conv2``) and ``para_reschunk.N`` depth indices collapse onto
the one shared module, and conv kernels stay OIHW.  So loading a reference
checkpoint is: canonicalize every key, bit-check that all aliases of one
tensor agree (``convert.py:76-121``), keep one copy.  ``params_from_jax``
takes the JAX package's flax parameter tree (as numpy arrays) instead:
HWIO kernels become OIHW and the norms' ``scale`` becomes ``weight``.

The unique parameter counts are 1,003,296 (plain) and 2,731,680 (full) at
``n_c=128, n_b=5, x4``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

ORBAX_TODO = (
    "Orbax train-state directories are not loadable by the port yet "
    "(ROADMAP.md Queue 1 item 7); pass a .pth or .npz checkpoint"
)

_ALWAYS_ALIAS = {
    "convf2": "convf1",
    "conv2_st": "conv1_st",
    "conv_fnst": "conv_fpst",
    "conv_fns": "conv_fps",
    "conv_f2": "conv_f1",
}
_LEAF_NAMES = {"weight", "bias"}


def canonical_key(key: str) -> str:
    """Reference state-dict key -> the port's parameter name."""
    parts = key.split(".")
    out = []
    for i, part in enumerate(parts):
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        if part in _ALWAYS_ALIAS:
            out.append(_ALWAYS_ALIAS[part])
        elif part == "conv2" and nxt not in _LEAF_NAMES:
            out.append("conv1")  # module-level tied alias (BIE/ParallelBlk)
        elif part.isdigit():
            continue  # para_reschunk.N -> the single shared block
        else:
            out.append(part)
    return ".".join(out)


def convert_torch_state_dict(
    state: Mapping[str, Any], *, atol: float = 0.0
) -> Dict[str, torch.Tensor]:
    """Reference ``state_dict`` (tensors or numpy arrays) -> the port's
    state dict.  Tied aliases must agree within ``atol`` (default:
    bit-identical, which the released checkpoints are)."""
    seen: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        canon = canonical_key(key)
        if canon in seen:
            if seen[canon].shape != arr.shape or not np.allclose(seen[canon], arr, atol=atol, rtol=0):
                diff = np.abs(seen[canon] - arr).max() if seen[canon].shape == arr.shape else "shape"
                raise ValueError(f"tied alias mismatch at {key} -> {canon}: max|d|={diff}")
        else:
            seen[canon] = arr
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in seen.items()}


def params_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{'params': tree}`` (leaves as arrays) -> the port's
    state dict (HWIO -> OIHW; ``ChannelLayerNorm.scale`` -> ``weight``)."""
    params = variables.get("params", variables)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, path + [name])
                continue
            arr = np.array(child, np.float32)  # a writable copy
            if name == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            leaf = "bias" if name == "bias" else "weight"
            out[".".join(path + [leaf])] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(params, [])
    return out


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a checkpoint file into the port's state dict:

    * ``.pth``: a reference ``state_dict``;
    * ``.npz`` in reference layout (keys optionally prefixed ``sd/``, as the
      golden fixtures are; their ``x``/``preds``/``hs``/``meta`` are skipped);
    * ``.npz`` of a flattened flax tree (``params/...`` keys, ``cli.convert --npz``).
    """
    if os.path.isdir(path):
        raise NotImplementedError(f"{path}: {ORBAX_TODO}")
    if path.endswith(".pth"):
        state = torch.load(path, map_location="cpu", weights_only=True)
        return convert_torch_state_dict(state)
    if path.endswith(".npz"):
        with np.load(path) as z:
            if any(k.startswith("params/") for k in z.files):
                tree: Dict[str, Any] = {}
                for key in z.files:
                    node = tree
                    parts = key.split("/")
                    for part in parts[:-1]:
                        node = node.setdefault(part, {})
                    node[parts[-1]] = z[key]
                return params_from_jax(tree)
            sd = {
                k[3:] if k.startswith("sd/") else k: z[k]
                for k in z.files
                if k not in ("x", "preds", "hs", "meta")
            }
        return convert_torch_state_dict(sd)
    raise ValueError(f"{path}: expected a .pth or .npz checkpoint")


def count_params(model: torch.nn.Module) -> int:
    """Unique trainable parameters (tied aliases counted once)."""
    return sum(p.numel() for p in model.parameters())
