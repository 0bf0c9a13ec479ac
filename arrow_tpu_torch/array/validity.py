"""Validity (null) bitmaps (counterpart of ``arrow_tpu/array/validity.py``).

Invariant: bits at positions >= len are zero.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import bits as B


class NullBitBuffer:
    """Packed validity bitmap (1 = valid, LSB-first int32 words)."""

    __slots__ = ("words", "length")

    def __init__(self, words: torch.Tensor, length: int):
        self.words = words
        self.length = length

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
