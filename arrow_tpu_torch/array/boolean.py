"""Bit-packed boolean arrays (counterpart of ``arrow_tpu/array/boolean.py``).

Values are packed LSB-first into int32 words, 1 bit per row.

Invariant: value bits and validity bits at positions >= len are zero.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from .. import dtypes as dt
from ..runtime.device import Device, as_device
from ..utils import bits as B
from .array import ArrowArrayBase, pad_words


class BooleanArray(ArrowArrayBase):
    """Packed 1-bit boolean column (+ optional packed validity)."""

    DTYPE = dt.ArrowType.BOOL

    __slots__ = ("dtype", "_data", "_validity", "_length", "device")

    def __init__(
        self,
        data: torch.Tensor,  # int32 packed value words
        validity: Optional[torch.Tensor],
        length: int,
        device: Optional[Device] = None,
    ):
        self._data = data
        self._validity = validity
        self._length = length
        self.dtype = dt.ArrowType.BOOL
        self.device = as_device(device if device is not None else data.device)

    @classmethod
    def from_slice(cls, values: Sequence[bool], device=None) -> "BooleanArray":
        device = as_device(device)
        mask = np.asarray(values, dtype=np.bool_)
        n = mask.shape[0]
        words = B.pack_bits_np(mask, pad_words(n)).view(np.int32)
        return cls(device.put(words), None, n, device)

    @classmethod
    def from_optional_slice(
        cls, values: Iterable[Optional[bool]], device=None
    ) -> "BooleanArray":
        device = as_device(device)
        vals = list(values)
        n = len(vals)
        data = np.fromiter((bool(v) for v in vals), count=n, dtype=np.bool_)
        valid = np.fromiter((v is not None for v in vals), count=n, dtype=np.bool_)
        words = B.pack_bits_np(data & valid, pad_words(n)).view(np.int32)
        if valid.all():
            return cls(device.put(words), None, n, device)
        vwords = B.pack_bits_np(valid, pad_words(n)).view(np.int32)
        return cls(device.put(words), device.put(vwords), n, device)

    @classmethod
    def from_words(
        cls,
        words: torch.Tensor,
        length: int,
        validity: Optional[torch.Tensor] = None,
        device=None,
    ) -> "BooleanArray":
        return cls(words, validity, length, device)

    @property
    def data(self) -> torch.Tensor:
        """Packed int32 value words."""
        return self._data

    @property
    def padded_length(self) -> int:
        return int(self._data.shape[0]) * B.WORD_BITS

    def clone(self) -> "BooleanArray":
        """A metadata copy: the buffers are shared."""
        return BooleanArray(self._data, self._validity, self._length, self.device)

    @property
    def validity(self) -> Optional[torch.Tensor]:
        return self._validity

    def raw_values(self) -> np.ndarray:
        """bool[len] host copy ignoring validity."""
        return B.unpack_bits_np(self.device.get(self._data), self._length)

    def values(self) -> list:
        raw = self.raw_values().tolist()
        if self._validity is None:
            return raw
        mask = self.null_mask()
        return [v if m else None for v, m in zip(raw, mask)]

    def to_numpy(self) -> np.ndarray:
        return self.raw_values()

    def __repr__(self) -> str:
        head = self.values()[:10]
        suffix = ", ..." if self._length > 10 else ""
        return f"BooleanArray(len={self._length}, values={head}{suffix})"
