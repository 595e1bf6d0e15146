"""Host data layer (numpy; h5py imported on use): datasets, clips, loaders."""

from bmcnet_esr_torch.data.h5dataset import (
    DatasetConfig,
    EventH5Dataset,
    EventSequenceDataset,
    ScaleLayout,
    SequenceConfig,
    resolve_scale_layout,
)
from bmcnet_esr_torch.data.packager import MultiScaleEventPackager, write_synthetic_fixture
from bmcnet_esr_torch.data.pipeline import SequenceLoader, concatenate_datasets, load_datalist

__all__ = [
    "DatasetConfig", "EventH5Dataset", "EventSequenceDataset", "ScaleLayout",
    "SequenceConfig", "resolve_scale_layout", "MultiScaleEventPackager",
    "write_synthetic_fixture", "SequenceLoader", "concatenate_datasets", "load_datalist",
]
