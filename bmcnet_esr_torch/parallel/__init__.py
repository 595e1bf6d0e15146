"""Data parallelism: device meshes, process meshes and the parallel steps."""

from bmcnet_esr_torch.parallel.mesh import (
    Mesh,
    ProcessLayout,
    any_rank,
    channel_sharding,
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

__all__ = [
    "Mesh", "ProcessLayout", "any_rank", "channel_sharding", "host_group", "init_distributed",
    "make_mesh", "make_process_mesh", "process_layout", "replicate_tree", "shard_batch",
    "shard_tree_channels", "spatial_sharding", "make_parallel_eval_step",
    "make_parallel_train_step",
]
