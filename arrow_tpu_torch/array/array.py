"""Typed columnar arrays held in torch tensors.

Counterpart of ``arrow_tpu/array/array.py``.  A :class:`PrimitiveArray` is a
value buffer padded to ``config.pad_unit`` elements (its capacity), an
optional packed int32 validity buffer, a logical length, an Arrow type and
the :class:`Device` the buffers live on.  Rows at and past the logical length
are zero in every buffer (the zero-padding invariant).

Unsigned types are stored as same-width signed bit patterns (see
``dtypes``); ``raw_values``/``values`` hand them back in the Arrow type.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from .. import dtypes as dt
from ..config import config
from ..runtime.device import Device, as_device
from ..utils import bits as B
from .validity import NullBitBuffer


def pad_len(n: int) -> int:
    """Round a logical length up to the buffer padding unit."""
    u = config.pad_unit
    return ((n + u - 1) // u) * u


def pad_words(n: int) -> int:
    """Number of 32-bit bitmap words for a padded length."""
    return pad_len(n) // B.WORD_BITS


def _padded_host(host: np.ndarray, n: int, dtype: dt.ArrowType) -> np.ndarray:
    buf = np.zeros(pad_len(n), dtype=dt.storage_numpy(dtype))
    buf[:n] = dt.to_storage_np(host, dtype)
    return buf


def densify_optionals(values: Iterable[Optional[Any]], npdt=None):
    """[v | None] -> (dense values with 0 for None, valid mask, length)."""
    vals = list(values)
    valid = np.fromiter((v is not None for v in vals), count=len(vals), dtype=np.bool_)
    present = [v for v in vals if v is not None]
    if npdt is None:
        npdt = np.asarray(present).dtype if present else np.dtype(np.float32)
    dense = np.zeros(len(vals), dtype=npdt)
    if present:
        dense[valid] = np.asarray(present, dtype=npdt)
    return dense, valid, len(vals)


class ArrowArrayBase:
    """Common API of every array."""

    dtype: dt.ArrowType
    _length: int
    device: Device

    def __len__(self) -> int:
        return self._length

    @property
    def length(self) -> int:
        return self._length

    def null_count(self) -> int:
        v = self.validity
        return 0 if v is None else self._length - int(B.popcount_words(v))

    def is_valid(self, i: int) -> bool:
        if not 0 <= i < self._length:
            raise IndexError(i)
        v = self.validity
        if v is None:
            return True
        w = int(v[i // B.WORD_BITS])
        return bool((w >> (i % B.WORD_BITS)) & 1)

    def is_null(self, i: int) -> bool:
        return not self.is_valid(i)

    def null_buffer(self) -> Optional[NullBitBuffer]:
        v = self.validity
        return None if v is None else NullBitBuffer(v, self._length)

    def null_mask(self) -> Optional[np.ndarray]:
        """Host bool mask (True = valid), or None if no nulls tracked."""
        v = self.validity
        if v is None:
            return None
        return B.unpack_bits_np(self.device.get(v), self._length)


class PrimitiveArray(ArrowArrayBase):
    """Dense fixed-width column: padded data buffer + optional validity bitmap."""

    DTYPE: Optional[dt.ArrowType] = None  # fixed in per-dtype subclasses

    __slots__ = ("dtype", "_data", "_validity", "_length", "device")

    def __init__(
        self,
        data: torch.Tensor,
        validity: Optional[torch.Tensor],
        length: int,
        dtype: dt.ArrowType,
        device: Optional[Device] = None,
    ):
        self._data = data
        self._validity = validity
        self._length = length
        self.dtype = dtype
        self.device = as_device(device if device is not None else data.device)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_slice(
        cls,
        values: Union[Sequence[Any], np.ndarray],
        dtype: Optional[dt.ArrowType] = None,
        device=None,
    ) -> "PrimitiveArray":
        dtype = dtype or cls.DTYPE
        if dtype is None:
            dtype = dt.from_numpy_dtype(np.asarray(values).dtype)
        device = as_device(device)
        host = np.asarray(values, dtype=dt.info(dtype).numpy)
        n = host.shape[0]
        return make_array(device.put(_padded_host(host, n, dtype)), None, n, dtype, device)

    @classmethod
    def from_optional_slice(
        cls,
        values: Iterable[Optional[Any]],
        dtype: Optional[dt.ArrowType] = None,
        device=None,
    ) -> "PrimitiveArray":
        """None -> a zero data value + a cleared validity bit."""
        dtype = dtype or cls.DTYPE
        device = as_device(device)
        vals, mask, n = densify_optionals(values, dt.info(dtype).numpy if dtype else None)
        if dtype is None:
            dtype = dt.from_numpy_dtype(vals.dtype)
        data = device.put(_padded_host(vals, n, dtype))
        if mask.all():
            return make_array(data, None, n, dtype, device)
        words = B.pack_bits_np(mask, pad_words(n)).view(np.int32)
        return make_array(data, device.put(words), n, dtype, device)

    # -- accessors ------------------------------------------------------------

    @property
    def data(self) -> torch.Tensor:
        """The padded value buffer (storage dtype)."""
        return self._data

    @property
    def validity(self) -> Optional[torch.Tensor]:
        return self._validity

    def raw_values(self) -> np.ndarray:
        """Host copy of the first `length` values in the Arrow type (nulls
        hold their zero default)."""
        host = self.device.get(self._data[: self._length])
        return dt.from_storage_np(host, self.dtype)

    def values(self) -> list:
        """Host copy as a list of Optional scalars."""
        py = self.raw_values().tolist()
        if self._validity is None:
            return py
        mask = self.null_mask()
        return [v if m else None for v, m in zip(py, mask)]

    def __repr__(self) -> str:
        head = self.values()[:10]
        suffix = ", ..." if self._length > 10 else ""
        return (
            f"{type(self).__name__}(len={self._length}, dtype={self.dtype.value}, "
            f"values={head}{suffix})"
        )


class Float32Array(PrimitiveArray):
    DTYPE = dt.ArrowType.FLOAT32


class Float64Array(PrimitiveArray):
    DTYPE = dt.ArrowType.FLOAT64


class UInt8Array(PrimitiveArray):
    DTYPE = dt.ArrowType.UINT8


class UInt16Array(PrimitiveArray):
    DTYPE = dt.ArrowType.UINT16


class UInt32Array(PrimitiveArray):
    DTYPE = dt.ArrowType.UINT32


class UInt64Array(PrimitiveArray):
    DTYPE = dt.ArrowType.UINT64


class Int8Array(PrimitiveArray):
    DTYPE = dt.ArrowType.INT8


class Int16Array(PrimitiveArray):
    DTYPE = dt.ArrowType.INT16


class Int32Array(PrimitiveArray):
    DTYPE = dt.ArrowType.INT32


class Int64Array(PrimitiveArray):
    DTYPE = dt.ArrowType.INT64


class Date32Array(PrimitiveArray):
    DTYPE = dt.ArrowType.DATE32


_CLASS_BY_DTYPE: dict[dt.ArrowType, type] = {
    c.DTYPE: c
    for c in (
        Float32Array, Float64Array, UInt8Array, UInt16Array, UInt32Array,
        UInt64Array, Int8Array, Int16Array, Int32Array, Int64Array, Date32Array,
    )
}


def make_array(
    data: torch.Tensor,
    validity: Optional[torch.Tensor],
    length: int,
    dtype: dt.ArrowType,
    device=None,
) -> ArrowArrayBase:
    """Factory returning the specific subclass for `dtype` (incl. BooleanArray)."""
    if dtype is dt.ArrowType.BOOL:
        from .boolean import BooleanArray

        return BooleanArray(data, validity, length, device)
    cls = _CLASS_BY_DTYPE[dtype]
    arr = cls.__new__(cls)
    PrimitiveArray.__init__(arr, data, validity, length, dtype, device)
    return arr
