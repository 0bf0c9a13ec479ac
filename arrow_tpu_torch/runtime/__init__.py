"""Runtime layer: device handles, lazy pipelines, profiling, health checks
and the native host library."""

from . import profiler
from .device import Device, as_device, default_device, set_default_device
from .pipeline import ComputePipeline, LazyArray

__all__ = [
    "ComputePipeline",
    "Device",
    "LazyArray",
    "as_device",
    "default_device",
    "profiler",
    "set_default_device",
]
