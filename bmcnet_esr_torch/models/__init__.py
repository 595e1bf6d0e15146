"""BMCNet models (float and int8 serving modes), checkpoint loading and
int8 calibration."""

from bmcnet_esr_torch.models.bmcnet import BMCNet, BMCNetPlain
from bmcnet_esr_torch.models.convert import (
    act_scales_from_jax,
    convert_torch_state_dict,
    count_params,
    load_checkpoint,
    lpips_params_from_jax,
    params_from_jax,
)
from bmcnet_esr_torch.models.layers import (
    BIE,
    CHAIN_MODES,
    QUANT_MODES,
    ChannelLayerNorm,
    ParallelBlk,
    QuantConv,
    ResidualBlock,
)
from bmcnet_esr_torch.models.quant import (
    CALIB_QUANTILES,
    act_scales,
    calibrate_act_scales,
    calibrate_from_h5,
    quant_convs,
    set_act_scales,
)

__all__ = [
    "BMCNet", "BMCNetPlain", "act_scales_from_jax", "convert_torch_state_dict",
    "count_params", "load_checkpoint", "lpips_params_from_jax", "params_from_jax", "BIE",
    "CHAIN_MODES", "QUANT_MODES", "ChannelLayerNorm", "ParallelBlk", "QuantConv", "ResidualBlock",
    "CALIB_QUANTILES", "act_scales", "calibrate_act_scales", "calibrate_from_h5", "quant_convs",
    "set_act_scales",
]
