"""Device buffer handle (counterpart of ``arrow_tpu/array/buffer.py``)."""

from __future__ import annotations

import numpy as np
import torch


class Buffer:
    """A device buffer with the Arrow Buffer API surface."""

    __slots__ = ("_t",)

    def __init__(self, t: torch.Tensor):
        self._t = t

    @property
    def tensor(self) -> torch.Tensor:
        return self._t

    def __len__(self) -> int:
        return self.size

    @property
    def size(self) -> int:
        """Size in bytes."""
        return self._t.numel() * self._t.element_size()

    @property
    def capacity(self) -> int:
        return self.size

    def to_numpy(self) -> np.ndarray:
        return self._t.detach().cpu().numpy()

    def as_slice(self) -> bytes:
        return self.to_numpy().tobytes()

    def ptr_eq(self, other: "Buffer") -> bool:
        return self._t.data_ptr() == other._t.data_ptr()

    def __repr__(self) -> str:
        return f"Buffer(bytes={self.size}, dtype={self._t.dtype})"
