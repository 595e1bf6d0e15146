"""Host data layer (numpy; h5py imported on use): datasets, clips, loaders,
and the event simulator with the dataset generation built on it."""

from bmcnet_esr_torch.data.h5dataset import (
    DatasetConfig,
    EventH5Dataset,
    EventSequenceDataset,
    ScaleLayout,
    SequenceConfig,
    resolve_scale_layout,
)
from bmcnet_esr_torch.data.packager import (
    SCALE_PREFIXES,
    MultiScaleEventPackager,
    write_synthetic_fixture,
)
from bmcnet_esr_torch.data.pipeline import SequenceLoader, concatenate_datasets, load_datalist
from bmcnet_esr_torch.data.simulator import (
    EventSimulator,
    SimulatorConfig,
    simulate_multiscale,
    simulator_state_from_jax,
)

__all__ = [
    "EventSimulator", "SimulatorConfig", "simulate_multiscale", "simulator_state_from_jax",
    "DatasetConfig", "EventH5Dataset", "EventSequenceDataset", "ScaleLayout",
    "SequenceConfig", "resolve_scale_layout", "MultiScaleEventPackager", "SCALE_PREFIXES",
    "write_synthetic_fixture", "SequenceLoader", "concatenate_datasets", "load_datalist",
]
