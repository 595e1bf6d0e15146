"""Meshes of devices and processes, and the data axis's helpers.

Counterpart of ``bmcnet_esr_tpu/parallel/mesh.py``.  JAX lays one program
over a ``jax.sharding.Mesh`` and lets GSPMD insert the collectives; here the
two uses of a mesh are kept apart:

* **in one process** (inference): :func:`make_mesh` returns a :class:`Mesh`
  of devices over which ``InferenceEngine(mesh=)`` splits its streams; no
  collective is needed.  A device may repeat, so an N-way mesh can be built
  on the CPU or on one card;
* **across processes** (training): one process per GPU, launched by
  ``torchrun``; :func:`init_distributed` joins the group from torchrun's
  environment and :func:`make_process_mesh` lays a
  ``torch.distributed.device_mesh.DeviceMesh`` over the ranks, ``("data",)``
  or, for a multi-slice (multi-node) deployment, ``("dcn_data", "data")``.

A torchrun node plays the part of a JAX host and its ranks the part of that
host's devices: ``batch_size`` is the node's batch, split over the node's
local ranks (:func:`shard_batch`, ``SequenceLoader(rows=...)``).

Only the data axis is ported.  Channel (tensor) and spatial sharding raise
(ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

PARALLEL_TODO = "is not ported yet (ROADMAP.md Queue 1 item 8)"
# torchrun's variables; MASTER_ADDR / MASTER_PORT unless an init_method is given
_RANK_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
_STORE_ENV = ("MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices of one process laid along named axes (a 1-D ``data`` mesh)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: self.size}


def make_mesh(n_data: Optional[int] = None, *, devices: Optional[Sequence] = None,
              axis: str = "data") -> Mesh:
    """1-D mesh over the first ``n_data`` of ``devices`` (default: every
    visible CUDA device).  Asking for more devices than there are raises."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices)
    if n_data < 1 or n_data > len(devices):
        raise ValueError(f"requested {n_data} devices, have {len(devices)}")
    return Mesh(tuple(devices[:n_data]), (axis,))


@dataclasses.dataclass(frozen=True)
class ProcessLayout:
    """Where this process sits: its rank among all, its rank on its node."""

    rank: int
    world_size: int
    local_rank: int
    local_world_size: int

    @property
    def node(self) -> int:
        return self.rank // self.local_world_size

    @property
    def n_nodes(self) -> int:
        return self.world_size // self.local_world_size


def _env_int(name: str) -> int:
    try:
        return int(os.environ[name])
    except (KeyError, ValueError):
        raise RuntimeError(
            f"{name} is not set to an integer: launch every rank with torchrun "
            "(torchrun --nproc_per_node=N -m bmcnet_esr_torch.cli.train -c <recipe> "
            "--distributed), which sets RANK, WORLD_SIZE, LOCAL_RANK and LOCAL_WORLD_SIZE"
        ) from None


def process_layout() -> ProcessLayout:
    """This rank's place, from the group and torchrun's ``LOCAL_*`` variables."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call init_distributed first")
    layout = ProcessLayout(dist.get_rank(), dist.get_world_size(),
                           _env_int("LOCAL_RANK"), _env_int("LOCAL_WORLD_SIZE"))
    if layout.world_size % layout.local_world_size or layout.local_rank != (
            layout.rank % layout.local_world_size):
        raise RuntimeError(f"{layout} is not a layout of equal nodes, ranks node-major")
    return layout


def init_distributed(device="cuda", *, backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     timeout_s: float = 600.0) -> torch.device:
    """Join the process group torchrun describes and return this rank's device.

    ``device="cuda"`` is ``cuda:LOCAL_RANK`` (an index given by the caller is
    kept) with NCCL; ``"cpu"`` uses gloo.  ``backend`` names another one
    (gloo on CUDA tensors, for ranks that share a card).  ``init_method``
    (``file://...``, ``tcp://...``) replaces ``MASTER_ADDR`` /
    ``MASTER_PORT``.  An incomplete environment, a missing GPU or a failed
    rendezvous raises: the process never carries on alone."""
    missing = [k for k in _RANK_ENV + (() if init_method else _STORE_ENV) if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"init_distributed: the environment lacks {', '.join(missing)}; launch every "
            "rank with torchrun (torchrun --nproc_per_node=N -m bmcnet_esr_torch.cli.train "
            "-c <recipe> --distributed)"
        )
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized in this process")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: device 'cuda' requested but CUDA is not "
                               "available; pass device='cpu' for gloo on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", _env_int("LOCAL_RANK"))
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=_env_int("RANK"),
        world_size=_env_int("WORLD_SIZE"), timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None,
    )
    return dev


def make_process_mesh(n_slices: int = 1):
    """``DeviceMesh`` over every rank: ``("data",)``, or ``(n_slices, world //
    n_slices)`` over ``("dcn_data", "data")`` with the ranks slice-major, so
    a slice is a node's ranks (``mesh.py:55-84``).  Its device type follows
    the backend: ``cuda`` for NCCL, ``cpu`` for gloo (whose groups also carry
    CUDA tensors, through host memory)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_slices < 1 or world % n_slices:
        raise ValueError(f"dcn_slices={n_slices} does not divide the world size {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if n_slices == 1:
        return init_device_mesh(device_type, (world,), mesh_dim_names=("data",))
    return init_device_mesh(device_type, (n_slices, world // n_slices),
                            mesh_dim_names=("dcn_data", "data"))


def shard_batch(batch: Dict, index: int, count: int) -> Dict:
    """Rows ``[index*b/count, (index+1)*b/count)`` of every entry of a batch
    (``b`` its leading size, which ``count`` must divide)."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % count:
            raise ValueError(f"batch of {b} rows does not split over {count} ranks")
        out[k] = v[index * b // count : (index + 1) * b // count]
    return out


@torch.no_grad()
def replicate_tree(state, src: int = 0, group=None) -> None:
    """Broadcast a ``TrainState``'s parameters, buffers, optimizer state and
    EMA from rank ``src`` to every rank, in place."""
    tensors = list(state.model.state_dict().values())
    for s in state.optimizer.state.values():
        tensors += [v for v in s.values() if torch.is_tensor(v)]
    if state.ema is not None:
        tensors += list(state.ema.values())
    for t in tensors:
        dist.broadcast(t, src, group=group)


def host_group():
    """A gloo group over every rank for host-side agreement (flags, not
    tensors on the device): the default group when it is gloo."""
    if dist.get_backend() == "gloo":
        return None
    return dist.new_group(backend="gloo")


def any_rank(flag: bool, group=None) -> bool:
    """True on every rank when ``flag`` is true on any (a collective)."""
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def channel_sharding(*_args, **_kwargs):
    raise NotImplementedError(f"channel (tensor-parallel) sharding {PARALLEL_TODO}")


def shard_tree_channels(*_args, **_kwargs):
    raise NotImplementedError(f"channel (tensor-parallel) sharding {PARALLEL_TODO}")


def spatial_sharding(*_args, **_kwargs):
    raise NotImplementedError(f"spatial sharding {PARALLEL_TODO}")
