"""BMCNet models (fp32 / bf16 path) and checkpoint loading."""

from bmcnet_esr_torch.models.bmcnet import BMCNet, BMCNetPlain
from bmcnet_esr_torch.models.convert import (
    convert_torch_state_dict,
    count_params,
    load_checkpoint,
    params_from_jax,
)
from bmcnet_esr_torch.models.layers import BIE, ChannelLayerNorm, ParallelBlk, ResidualBlock

__all__ = [
    "BMCNet", "BMCNetPlain", "convert_torch_state_dict", "count_params",
    "load_checkpoint", "params_from_jax", "BIE", "ChannelLayerNorm",
    "ParallelBlk", "ResidualBlock",
]
