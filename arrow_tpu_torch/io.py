"""Host IO: Arrow-layout export and import (counterpart of ``arrow_tpu/io.py``).

``to_arrow_buffers`` gives the same host dict, byte for byte, as
``arrow_tpu.io.to_arrow_buffers``; ``from_arrow_buffers`` takes that dict's
buffers (from either package) and builds an array on a given device.  This is
how state crosses between the two packages.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import dtypes as dt
from .array.array import make_array, pad_len, pad_words
from .array.boolean import BooleanArray
from .runtime.device import as_device


def to_arrow_buffers(arr) -> Dict[str, object]:
    """Export an array as Arrow-layout host buffers.

    Returns {"data": values, "validity": bitmap bytes or None, "length": n,
    "null_count": 0 without a bitmap}.  For BOOL, data is the packed bitmap
    bytes (Arrow boolean layout).
    """
    n = arr.length
    if arr.dtype is dt.ArrowType.BOOL:
        data = arr.device.get(arr.data).view(np.uint8)[: (n + 7) // 8].copy()
    else:
        data = arr.raw_values().copy()
    validity = None
    null_count = 0
    if arr.validity is not None:
        words = arr.device.get(arr.validity)
        validity = words.view(np.uint8)[: (n + 7) // 8].copy()
        # padding bits are zero by invariant: the popcount counts valid rows
        null_count = n - int(np.unpackbits(words.view(np.uint8)).sum())
    return {"data": data, "validity": validity, "length": n, "null_count": null_count}


def _words_from_bytes(by: np.ndarray, length: int) -> np.ndarray:
    buf = np.zeros(pad_words(length) * 4, np.uint8)
    buf[: by.shape[0]] = by.view(np.uint8)
    words = buf.view(np.int32).copy()
    # keep the invariant even when the producer left bits past `length` set
    if length % 32:
        words[length // 32] &= np.int32((1 << (length % 32)) - 1)
    return words


def from_arrow_buffers(
    data: np.ndarray,
    length: int,
    validity: Optional[np.ndarray] = None,
    dtype: Optional[dt.ArrowType] = None,
    device=None,
):
    """Import Arrow-layout host buffers into an array on `device`."""
    device = as_device(device)
    v = None
    if validity is not None:
        v = device.put(_words_from_bytes(validity, length))
    if dtype is dt.ArrowType.BOOL:
        words = _words_from_bytes(data, length)
        return BooleanArray(device.put(words), v, length, device)
    dtype = dtype or dt.from_numpy_dtype(data.dtype)
    buf = np.zeros(pad_len(length), dtype=dt.storage_numpy(dtype))
    buf[:length] = dt.to_storage_np(data[:length], dtype)
    return make_array(device.put(buf), v, length, dtype, device)
