"""Packed-bitmap helpers (Arrow LSB-first layout in 32-bit words).

Counterpart of ``arrow_tpu/utils/bits.py``.  Bit ``i`` of word ``w`` holds row
``w*32 + i``.  Words are int32 tensors holding the bit pattern of the JAX
package's uint32 words, so on a little-endian host their bytes are Arrow's
bitmap bytes.

Invariant maintained everywhere: bits at positions >= logical length are ZERO.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

WORD_BITS = 32


def num_words(length: int) -> int:
    return (length + WORD_BITS - 1) // WORD_BITS


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a value in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD_BITS, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# device-side (torch)
# ---------------------------------------------------------------------------


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool[N] -> int32[ceil(N/32)] (LSB-first); a partial last word is
    zero-filled.  Packs in int64 so that bit 31 is exact."""
    n = mask.shape[0]
    if n % WORD_BITS:
        mask = torch.nn.functional.pad(mask, (0, WORD_BITS - n % WORD_BITS))
    m = mask.reshape(-1, WORD_BITS).to(torch.int64)
    return _to_int32((m << _shifts(mask.device)).sum(dim=1))


def unpack_bits(words: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """int32[W] -> bool[W*32] (or the first n)."""
    bits = (words.to(torch.int64)[:, None] >> _shifts(words.device)) & 1
    flat = bits.reshape(-1).to(torch.bool)
    return flat if n is None else flat[:n]


def tail_mask_words(n_words: int, length: int, device=None) -> torch.Tensor:
    """int32[n_words]: all-ones below `length` bits, zeros above."""
    idx = torch.arange(n_words, dtype=torch.int64, device=device) * WORD_BITS
    nbits = (length - idx).clamp(0, WORD_BITS)
    return _to_int32((torch.ones_like(nbits) << nbits) - 1)


def mask_tail(words: torch.Tensor, length: int) -> torch.Tensor:
    """Zero all bits at positions >= length."""
    return words & tail_mask_words(words.shape[0], length, words.device)


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Total number of set bits (int64 scalar tensor), by SWAR per word."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = (x * 0x01010101) & 0xFFFFFFFF
    return (x >> 24).sum()


# ---------------------------------------------------------------------------
# host-side (numpy)
# ---------------------------------------------------------------------------


def pack_bits_np(mask: np.ndarray, pad_words: Optional[int] = None) -> np.ndarray:
    """bool[N] -> uint32[ceil(N/32)] (LSB-first), optionally padded with 0-words."""
    mask = np.asarray(mask, dtype=np.bool_)
    w = num_words(mask.shape[0]) if pad_words is None else pad_words
    nb = np.packbits(mask, bitorder="little")
    buf = np.zeros(w * 4, dtype=np.uint8)
    buf[: nb.shape[0]] = nb
    return buf.view(np.uint32)


def unpack_bits_np(words: np.ndarray, n: int) -> np.ndarray:
    """32-bit words (uint32 or int32) -> bool[n] (LSB-first)."""
    by = np.ascontiguousarray(words).view(np.uint8)
    return np.unpackbits(by, count=n, bitorder="little").astype(np.bool_)
