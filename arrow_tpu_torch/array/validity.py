"""Validity (null) bitmaps (counterpart of ``arrow_tpu/array/validity.py``).

Invariant: bits at positions >= len are zero.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import bits as B


class BitBufferBuilder:
    """Host-side LSB-first bit builder."""

    def __init__(self, length: int = 0):
        self._mask = np.zeros(length, dtype=np.bool_)

    @classmethod
    def from_bools(cls, values) -> "BitBufferBuilder":
        b = cls(0)
        b._mask = np.asarray(values, dtype=np.bool_)
        return b

    def __len__(self) -> int:
        return int(self._mask.shape[0])

    def append(self, value: bool) -> None:
        self._mask = np.append(self._mask, np.bool_(value))

    def set_bit(self, i: int) -> None:
        self._mask[i] = True

    def unset_bit(self, i: int) -> None:
        self._mask[i] = False

    def is_set(self, i: int) -> bool:
        return bool(self._mask[i])

    def words(self, pad_words: Optional[int] = None) -> np.ndarray:
        return B.pack_bits_np(self._mask, pad_words)

    def mask(self) -> np.ndarray:
        return self._mask


class NullBitBuffer:
    """Packed validity bitmap (1 = valid, LSB-first int32 words)."""

    __slots__ = ("words", "length")

    def __init__(self, words: torch.Tensor, length: int):
        self.words = words
        self.length = length

    @classmethod
    def from_mask_np(cls, mask: np.ndarray, length: int, pad_words: int, device=None) -> "NullBitBuffer":
        from ..runtime.device import as_device

        words = B.pack_bits_np(mask[:length], pad_words).view(np.int32)
        return cls(as_device(device).put(words), length)

    @classmethod
    def from_words(cls, words: torch.Tensor, length: int) -> "NullBitBuffer":
        return cls(words, length)

    @classmethod
    def all_valid_words(cls, length: int, n_words: int, device=None) -> torch.Tensor:
        return B.tail_mask_words(n_words, length, device)

    def clone(self) -> "NullBitBuffer":
        return NullBitBuffer(self.words, self.length)

    def to_mask_np(self) -> np.ndarray:
        return B.unpack_bits_np(self.words.detach().cpu().numpy(), self.length)

    def null_count(self) -> int:
        return self.length - int(B.popcount_words(self.words))

    def is_valid(self, i: int) -> bool:
        if not 0 <= i < self.length:
            raise IndexError(i)
        w = int(self.words[i // B.WORD_BITS])
        return bool((w >> (i % B.WORD_BITS)) & 1)


def merge_validity(
    a: Optional[torch.Tensor], b: Optional[torch.Tensor]
) -> Optional[torch.Tensor]:
    """AND-combine two optional packed validity word buffers."""
    if a is None:
        return b
    if b is None:
        return a
    return a & b
