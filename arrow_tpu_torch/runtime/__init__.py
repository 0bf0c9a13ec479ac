"""Runtime layer: device handles and lazy pipelines."""

from .device import Device, as_device, default_device, set_default_device
from .pipeline import ComputePipeline, LazyArray

__all__ = [
    "ComputePipeline",
    "Device",
    "LazyArray",
    "as_device",
    "default_device",
    "set_default_device",
]
