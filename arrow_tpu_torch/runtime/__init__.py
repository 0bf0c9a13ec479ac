"""Runtime layer: device handles."""

from .device import Device, as_device, default_device, set_default_device

__all__ = ["Device", "as_device", "default_device", "set_default_device"]
