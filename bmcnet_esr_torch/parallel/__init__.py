"""Parallelism: device meshes, process meshes, the data- and tensor-parallel
steps, the channel-parallel forward of training and the row-band forward of
spatial serving."""

from bmcnet_esr_torch.parallel.mesh import (
    Mesh,
    ProcessLayout,
    RowSharding,
    any_rank,
    channel_sharding,
    gather_tree,
    host_group,
    init_distributed,
    make_mesh,
    make_process_mesh,
    process_layout,
    replicate_tree,
    shard_batch,
    shard_tree_channels,
    spatial_sharding,
)
from bmcnet_esr_torch.parallel.step import make_parallel_eval_step, make_parallel_train_step
from bmcnet_esr_torch.parallel.tensor import ChannelGroup, ChannelParallelForward

__all__ = [
    "ChannelGroup", "ChannelParallelForward", "Mesh", "ProcessLayout", "RowSharding",
    "any_rank", "channel_sharding", "gather_tree", "host_group",
    "init_distributed", "make_mesh", "make_process_mesh", "process_layout", "replicate_tree",
    "shard_batch", "shard_tree_channels", "spatial_sharding", "make_parallel_eval_step",
    "make_parallel_train_step",
]
