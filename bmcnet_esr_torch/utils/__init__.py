"""Metric tracking, result logging, timers, logging setup, tensorboard and
device policy."""

from bmcnet_esr_torch.utils.device import resolve_device, strict_fp32
from bmcnet_esr_torch.utils.logging import get_logger, setup_logging
from bmcnet_esr_torch.utils.metrics import MetricTracker
from bmcnet_esr_torch.utils.tensorboard import TensorboardWriter
from bmcnet_esr_torch.utils.timers import DeviceTimer, Timer
from bmcnet_esr_torch.utils.yaml_logger import YamlResultLogger

__all__ = [
    "resolve_device", "strict_fp32", "get_logger", "setup_logging", "MetricTracker",
    "TensorboardWriter", "DeviceTimer", "Timer", "YamlResultLogger",
]
