"""Checkpoint loading into the port's models.

Counterpart of ``bmcnet_esr_tpu/models/convert.py``.  The port's parameter
names are the reference state dict's *canonical* keys: tied aliases
(``conv_f2``, ``convf2``, ``conv2_st``, ``conv_fnst``, ``conv_fns`` and the
module-level ``conv2``) and ``para_reschunk.N`` depth indices collapse onto
the one shared module, and conv kernels stay OIHW.  So loading a reference
checkpoint is: canonicalize every key, bit-check that all aliases of one
tensor agree (``convert.py:76-121``), keep one copy.  ``params_from_jax``
takes the JAX package's flax parameter tree (as numpy arrays) instead:
HWIO kernels become OIHW and the norms' ``scale`` becomes ``weight``;
``act_scales_from_jax`` carries its int8 ``quant`` collection (calibrated
``act_scale`` leaves) over for ``models/quant.set_act_scales``;
``train_state_from_jax`` carries a whole JAX ``TrainState`` (parameters,
Adam moments and counts, EMA) into the port's ``TrainState``.
``export_torch_state_dict`` is the inverse of the reference loading: the
port's state dict back to the reference ``.pth`` layout, every tied alias
and depth index expanded.  ``load_checkpoint`` also reads the port's own
training checkpoints (``training/checkpoint.py``), their parameters or their
EMA.

The unique parameter counts are 1,003,296 (plain) and 2,731,680 (full) at
``n_c=128, n_b=5, x4``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

ORBAX_TODO = (
    "Orbax train-state directories need JAX and are not read by the port "
    "(ROADMAP.md Queue 1 item 7); carry a JAX TrainState over with "
    "models.convert.train_state_from_jax, or pass a .pth / .npz checkpoint"
)
# the payload file of a training checkpoint directory (training/checkpoint.py)
TRAIN_STATE_FILE = "state.pt"

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


def lpips_params_from_jax(params: Mapping) -> Dict:
    """The JAX ``LPIPSTrainer.params`` (``lins``, ``logit`` and, with
    ``pnet_tune``, ``backbone``; leaves as arrays) -> numpy in the same
    layout, for :meth:`LPIPSTrainer.load_params`."""
    out: Dict = {
        "lins": [np.array(w, np.float32) for w in params["lins"]],
        "logit": {k: np.array(v, np.float32) for k, v in params["logit"].items()},
    }
    if "backbone" in params:
        out["backbone"] = {k: np.array(v, np.float32) for k, v in params["backbone"].items()}
    return out


def act_scales_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``quant`` collection (``act_scale`` leaves of shape
    ``[B, 1, 1, 1]``, ``[1, 1, 1, 1]`` or ``()``) -> per-lane scales by the
    port's module names, for ``models/quant.set_act_scales``.  The module
    paths of the two packages are the same names."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, path + [name])
            elif name == "act_scale":
                arr = np.array(child, np.float32).reshape(-1)
                out[".".join(path)] = torch.from_numpy(arr)

    walk(variables.get("quant", {}), [])
    return out


def load_checkpoint(path: str, use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """Read a checkpoint into the port's state dict:

    * a training checkpoint directory of the port (``iteration_<N>/`` or
      ``best/``): its parameters, or with ``use_ema`` their EMA (refused
      when the run kept none);
    * ``.pth``: a reference ``state_dict``;
    * ``.npz`` in reference layout (keys optionally prefixed ``sd/``, as the
      golden fixtures are; their ``x``/``preds``/``hs``/``meta`` are skipped);
    * ``.npz`` of a flattened flax tree (``params/...`` keys, ``cli.convert --npz``).

    Files carry parameters only, so ``use_ema`` refuses them.
    """
    if os.path.isdir(path):
        state_file = os.path.join(path, TRAIN_STATE_FILE)
        if not os.path.isfile(state_file):
            raise NotImplementedError(f"{path}: {ORBAX_TODO}")
        payload = torch.load(state_file, map_location="cpu", weights_only=True)
        if not use_ema:
            return payload["model"]
        if payload.get("ema") is None:
            raise ValueError(f"use_ema: checkpoint {path} has no EMA "
                             "(train with trainer.ema: <decay> to keep one)")
        return payload["ema"]
    if use_ema:
        raise ValueError("use_ema needs a training checkpoint directory (flat .pth/.npz "
                         "checkpoints carry params only)")
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


_BIE_MODULES = [
    "clustering", "conv1.conv1", "conv1.conv2", "conv2.conv1", "conv2.conv2",
    "convf1", "convf2", "norm_s", "unclustering", "v1", "v2",
]
_PLAIN_TOP = ["conv_f1", "conv_f2", "conv_fs", "conv_h", "conv_o"]
_FULL_TOP = [
    "conv_fns", "conv_fnst", "conv_fps", "conv_fpst", "conv_fs",
    "conv_hn", "conv_hp", "conv_hs", "conv_o",
]
_FULL_BLK = [
    "conv1.conv1", "conv1.conv2", "conv1_st.conv1", "conv1_st.conv2",
    "conv2.conv1", "conv2.conv2", "conv2_st.conv1", "conv2_st.conv2",
] + [f"{b}.{m}" for b in ("gBIE", "lBIE") for m in _BIE_MODULES]


def torch_key_manifest(variant: str = "plain", n_b: int = 5) -> List[str]:
    """The reference state dict's keys for a model variant: every tied
    alias present, ``para_reschunk.{0..n_b-1}`` expanded (120 keys for plain
    at n_b=5, as in the released checkpoint)."""
    if variant == "plain":
        mods, blk = [f"neuro.{m}" for m in _PLAIN_TOP], _BIE_MODULES
    elif variant == "full":
        mods, blk = [f"neuro.{m}" for m in _FULL_TOP], _FULL_BLK
    else:
        raise ValueError(f"unknown variant {variant!r}")
    for i in range(n_b):
        mods += [f"neuro.para_reschunk.{i}.{m}" for m in blk]
    return [f"{m}.{leaf}" for m in mods for leaf in ("weight", "bias")]


def export_torch_state_dict(
    state: Mapping[str, torch.Tensor], variant: str = "plain", n_b: int = 5
) -> Dict[str, torch.Tensor]:
    """The port's state dict -> the reference layout (inverse of
    :func:`convert_torch_state_dict`): each reference key, tied aliases and
    depth indices included, gets its own CPU copy of the one shared tensor,
    so the result loads into the reference ``BMCNet`` / ``BMCNet_plain``
    with ``load_state_dict`` (``bmcnet_esr_tpu/models/convert.py``'s
    ``export_torch_state_dict``)."""
    return {key: state[canonical_key(key)].detach().cpu().clone()
            for key in torch_key_manifest(variant, n_b)}


def _field(node: Any, name: str) -> Any:
    return node[name] if isinstance(node, Mapping) else getattr(node, name)


def _leaves_with(node: Any, pred) -> List[Any]:
    """Every sub-node of a nested mapping / (named) tuple for which ``pred`` holds."""
    found = [node] if pred(node) else []
    if isinstance(node, Mapping):
        children = node.values()
    elif isinstance(node, (tuple, list)):
        children = node
    else:
        children = ()
    for child in children:
        found += _leaves_with(child, pred)
    return found


def train_state_from_jax(jax_state: Any, state) -> None:
    """Load the JAX package's ``TrainState`` (its leaves as numpy arrays,
    e.g. ``jax.tree.map(np.asarray, state)``, or a mapping of the same
    fields) into the port's :class:`~bmcnet_esr_torch.training.train_step.TrainState`
    ``state``, whose model and ``torch.optim.Adam`` are built:

    * ``params`` -> the model's parameters (:func:`params_from_jax`);
    * ``scale_by_torch_adam``'s ``mu`` / ``nu`` / ``nu_max`` / ``count`` ->
      Adam's ``exp_avg`` / ``exp_avg_sq`` / ``max_exp_avg_sq`` / ``step``;
    * the schedule's count (``scale_by_schedule``) -> ``state.updates``, the
      train step count -> ``state.step``;
    * ``ema_params`` -> ``state.ema``.
    """
    model, opt = state.model, state.optimizer
    if not isinstance(opt, torch.optim.Adam):
        raise TypeError(f"train_state_from_jax carries Adam state only, got {type(opt).__name__}")
    named = dict(model.named_parameters())
    weights = params_from_jax(_field(jax_state, "params"))
    if sorted(weights) != sorted(named):
        raise ValueError(f"parameter names differ: {sorted(set(weights) ^ set(named))[:8]}")
    opt_state = _field(jax_state, "opt_state")
    adam = _leaves_with(opt_state, lambda n: isinstance(n, Mapping) and "mu" in n)
    sched = _leaves_with(opt_state, lambda n: getattr(n, "_fields", None) == ("count",))
    if len(adam) != 1 or len(sched) > 1:
        raise ValueError("expected one scale_by_torch_adam state and at most one schedule count")
    adam = adam[0]
    amsgrad = opt.param_groups[0]["amsgrad"]
    if amsgrad != ("nu_max" in adam):
        raise ValueError(f"amsgrad={amsgrad} but the JAX state "
                         f"{'has' if 'nu_max' in adam else 'has no'} nu_max")
    moments = {k: params_from_jax(adam[k]) for k in ("mu", "nu", "nu_max") if k in adam}
    count = float(np.asarray(adam["count"]))

    def like(p: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        return torch.empty_like(p).copy_(src)

    with torch.no_grad():
        for name, p in named.items():
            p.copy_(weights[name])
            slot = {"step": torch.tensor(count, dtype=torch.float32),
                    "exp_avg": like(p, moments["mu"][name]),
                    "exp_avg_sq": like(p, moments["nu"][name])}
            if amsgrad:
                slot["max_exp_avg_sq"] = like(p, moments["nu_max"][name])
            opt.state[p] = slot
    state.step = int(np.asarray(_field(jax_state, "step")))
    state.updates = int(np.asarray(sched[0].count)) if sched else int(count)
    ema = (jax_state.get("ema_params") if isinstance(jax_state, Mapping)
           else getattr(jax_state, "ema_params", None))
    if (ema is None) != (state.ema is None):
        raise ValueError("the JAX state and the port's state disagree on keeping an EMA")
    if ema is not None:
        averages = params_from_jax(ema)
        with torch.no_grad():
            for name, e in state.ema.items():
                e.copy_(averages[name])


def count_params(model: torch.nn.Module) -> int:
    """Unique trainable parameters (tied aliases counted once)."""
    return sum(p.numel() for p in model.parameters())
