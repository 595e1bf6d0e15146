"""Host data layer of the inference path (numpy; h5py imported on use)."""

from bmcnet_esr_torch.data.h5dataset import (
    DatasetConfig,
    EventH5Dataset,
    ScaleLayout,
    SequenceConfig,
    resolve_scale_layout,
)
from bmcnet_esr_torch.data.packager import MultiScaleEventPackager, write_synthetic_fixture

__all__ = [
    "DatasetConfig", "EventH5Dataset", "ScaleLayout", "SequenceConfig",
    "resolve_scale_layout", "MultiScaleEventPackager", "write_synthetic_fixture",
]
