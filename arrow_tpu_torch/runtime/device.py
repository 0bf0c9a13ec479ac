"""Device management (counterpart of ``arrow_tpu/runtime/device.py``).

A :class:`Device` wraps one ``torch.device``; every array carries one.  The
process-wide default is ``cuda:0`` when CUDA is present, else ``cpu``, and is
changed only by an explicit :func:`set_default_device`.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import numpy as np
import torch


class Device:
    """A compute device handle (one ``torch.device``)."""

    def __init__(self, torch_device: Union[torch.device, str, None] = None):
        if torch_device is None:
            torch_device = "cuda:0" if torch.cuda.is_available() else "cpu"
        self.torch_device = torch.device(torch_device)

    @property
    def platform(self) -> str:
        return self.torch_device.type

    def put(self, host: np.ndarray) -> torch.Tensor:
        """Host -> device copy.  Unsigned numpy arrays must already be viewed
        as their signed storage dtype (see ``dtypes.to_storage_np``)."""
        return torch.from_numpy(np.ascontiguousarray(host)).to(self.torch_device)

    def get(self, buf: torch.Tensor) -> np.ndarray:
        """Blocking device -> host copy."""
        return buf.detach().cpu().numpy()

    def synchronize(self) -> None:
        """Wait for all work queued on this device (nothing to wait for on
        the CPU)."""
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)

    def memory_stats(self) -> dict:
        """The allocator's statistics (``torch.cuda.memory_stats``); ``{}``
        where the platform keeps none, as on the CPU."""
        if self.torch_device.type == "cuda":
            return dict(torch.cuda.memory_stats(self.torch_device))
        return {}

    def __repr__(self) -> str:
        return f"Device({self.torch_device})"


def as_device(device: Union["Device", torch.device, str, None]) -> "Device":
    """Coerce a Device, torch.device, string or None (the default) to a Device."""
    if device is None:
        return default_device()
    if isinstance(device, Device):
        return device
    return Device(device)


_default_lock = threading.Lock()
_default_device: Optional[Device] = None


def default_device() -> Device:
    global _default_device
    if _default_device is None:
        with _default_lock:
            if _default_device is None:
                _default_device = Device()
    return _default_device


def set_default_device(device: Union[Device, torch.device, str]) -> None:
    global _default_device
    with _default_lock:
        _default_device = device if isinstance(device, Device) else Device(device)
