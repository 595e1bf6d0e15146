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
  ``torch.distributed.device_mesh.DeviceMesh`` over the ranks, ``("data",)``,
  ``("dcn_data", "data")`` for a multi-slice (multi-node) deployment, or
  ``("data", "model")`` for tensor parallelism, where each convolution's
  output channels are split over the ``model`` axis
  (:func:`channel_sharding`, :func:`shard_tree_channels`, the forward in
  ``parallel/tensor.py``).

A torchrun node plays the part of a JAX host and its ranks the part of that
host's devices: ``batch_size`` is the node's batch, split over the node's
ranks of the data axis (:func:`shard_batch`, ``SequenceLoader(rows=...)``);
the ranks of one model group read the same rows.

A mesh in one process also serves live streams: ``StreamPool(mesh=)``
splits its slots over the devices, and ``StreamingSR(mesh=)`` splits one
stream's rows (:func:`spatial_sharding`, the forward in
``parallel/spatial.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

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
    """Where this process sits: its rank among all, its rank on its node,
    and the size of the model groups the node's ranks form (consecutive
    ranks, data-major, as ``make_mesh_2d``'s ``reshape(n_data, n_model)``)."""

    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    n_model: int = 1

    @property
    def node(self) -> int:
        return self.rank // self.local_world_size

    @property
    def n_nodes(self) -> int:
        return self.world_size // self.local_world_size

    @property
    def data_rank(self) -> int:
        """This rank's share of the node batch: its coordinate on the data axis."""
        return self.local_rank // self.n_model

    @property
    def data_size(self) -> int:
        """The shares a node batch splits into: the node's data-axis ranks."""
        return self.local_world_size // self.n_model


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


def make_process_mesh(n_slices: int = 1, n_model: int = 1):
    """``DeviceMesh`` over every rank: ``("data",)``; ``(n_slices, world //
    n_slices)`` over ``("dcn_data", "data")`` with the ranks slice-major, so
    a slice is a node's ranks (``mesh.py:55-84``); or, with ``n_model > 1``,
    ``(world // n_model, n_model)`` over ``("data", "model")`` with the
    ranks data-major, so a model group is ``n_model`` consecutive ranks
    (``make_mesh_2d``).  Its device type follows the backend: ``cuda`` for
    NCCL, ``cpu`` for gloo (whose groups also carry CUDA tensors, through
    host memory)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_slices < 1 or world % n_slices:
        raise ValueError(f"dcn_slices={n_slices} does not divide the world size {world}")
    if n_model < 1 or world % n_model:
        raise ValueError(f"model_parallel={n_model} does not divide the world size {world}")
    if n_slices > 1 and n_model > 1:
        raise ValueError("dcn_slices and model_parallel cannot combine yet")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if n_model > 1:
        return init_device_mesh(device_type, (world // n_model, n_model),
                                mesh_dim_names=("data", "model"))
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


def splits(channels: int, n: int) -> bool:
    """The channel rule: ``channels`` are cut into ``n`` equal slices when
    ``n`` divides them (the JAX ``channel_sharding``'s trailing-dim rule)."""
    return n > 1 and channels >= n and channels % n == 0


def channel_sharding(model: nn.Module, n: int) -> Dict[str, object]:
    """Each parameter's placement over an ``n``-way model axis
    (``mesh.py:134-153``): ``Shard(0)`` for a convolution's weight (OIHW, so
    output channels are dim 0, where JAX's HWIO has them last) and bias, and
    for a ``ChannelLayerNorm``'s weight and bias, wherever ``n`` divides the
    channels the module declares; ``Replicate()`` for anything else.  Read
    from the declared sizes, so a model already cut to its slices gives the
    same answer.  Adam's moments and the EMA follow their parameter."""
    from torch.distributed.tensor import Replicate, Shard

    from bmcnet_esr_torch.models.layers import ChannelLayerNorm

    out = {}
    for mname, m in model.named_modules():
        channels = (m.out_channels if isinstance(m, nn.Conv2d) else
                    m.features if isinstance(m, ChannelLayerNorm) else 0)
        for pname, _ in m.named_parameters(recurse=False):
            out[f"{mname}.{pname}" if mname else pname] = (
                Shard(0) if splits(channels, n) else Replicate())
    return out


@torch.no_grad()
def _map_split(state, n: int, fn) -> None:
    """Replace each tensor of ``state`` that follows a split parameter by
    ``fn(tensor)``: the parameter's data, its optimizer moments, its EMA."""
    from torch.distributed.tensor import Shard

    placements = channel_sharding(state.model, n)
    for name, p in state.model.named_parameters():
        if not isinstance(placements[name], Shard):
            continue
        p.data = fn(p.data)
        slot = state.optimizer.state.get(p, {})
        for key, value in slot.items():
            if torch.is_tensor(value) and value.dim():  # not Adam's step count
                slot[key] = fn(value)
        if state.ema is not None:
            state.ema[name] = fn(state.ema[name])


def shard_tree_channels(state, mesh, axis: str = "model"):
    """Cut a whole ``TrainState`` to this rank's slices of the ``axis`` of
    ``mesh``, in place (``mesh.py:156-159``): of each split tensor, rank
    ``r`` of ``n`` keeps rows ``[r*C/n, (r+1)*C/n)`` of dim 0 (the
    parameters, Adam's ``exp_avg`` / ``exp_avg_sq`` / ``max_exp_avg_sq``,
    the EMA).  The optimizer keeps its parameters' identity.  Returns
    ``state``."""
    from bmcnet_esr_torch.parallel.tensor import ChannelGroup

    a = ChannelGroup.of(mesh, axis)
    _map_split(state, a.n, lambda t: t.chunk(a.n)[a.rank].clone())
    return state


def gather_tree(state, mesh, axis: str = "model"):
    """The inverse of :func:`shard_tree_channels`, in place on every rank of
    the ``axis`` group (a collective): each split tensor whole again, in the
    one-device layout (channels-last parameters stay channels-last), so a
    checkpoint of it resumes on one device.  Returns ``state``."""
    from bmcnet_esr_torch.parallel.tensor import ChannelGroup

    a = ChannelGroup.of(mesh, axis)

    def whole(t):
        part = t.contiguous()
        parts = [torch.empty_like(part) for _ in range(a.n)]
        dist.all_gather(parts, part, group=a.group)
        out = torch.cat(parts, 0)
        if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
            out = out.contiguous(memory_format=torch.channels_last)
        return out

    _map_split(state, a.n, whole)
    return state


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """Row bands of NHWC tensors over a mesh's devices: of an image of
    height ``H``, device ``i`` holds rows ``[i * H / n, (i + 1) * H / n)``
    (the JAX package's ``P(None, axis, None, None)``).  A device may
    repeat."""

    devices: Tuple[torch.device, ...]
    axis: str = "data"

    @property
    def n(self) -> int:
        return len(self.devices)

    def rows(self, height: int) -> List[slice]:
        """Each device's rows of an image ``height`` rows high."""
        if height % self.n:
            raise ValueError(f"input height {height} must divide by the {self.n}-way "
                             f"'{self.axis}' mesh axis for spatial serving")
        h = height // self.n
        return [slice(i * h, (i + 1) * h) for i in range(self.n)]

    def shard(self, x: torch.Tensor, dim: int = 1) -> List[torch.Tensor]:
        """``x`` cut into its row bands along ``dim``, each on its device."""
        return [x[(slice(None),) * dim + (rows,)].to(d)
                for rows, d in zip(self.rows(x.shape[dim]), self.devices)]

    def gather(self, bands: Sequence[torch.Tensor], dim: int = 1) -> torch.Tensor:
        """The bands joined along ``dim`` on the first device."""
        return torch.cat([b.to(self.devices[0]) for b in bands], dim)


def spatial_sharding(mesh: Mesh, axis: str = "data") -> RowSharding:
    """Row (H-axis) bands of NHWC activations over ``mesh``'s ``axis``:
    ONE stream's image split across the devices, the layout of
    ``StreamingSR(mesh=)`` (``bmcnet_esr_tpu/parallel/mesh.py:96-108``)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {mesh.axis_names})")
    return RowSharding(mesh.devices, axis)
