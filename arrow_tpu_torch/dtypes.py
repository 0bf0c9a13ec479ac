"""Arrow dtypes and their torch storage.

Counterpart of ``arrow_tpu/dtypes.py``.  Each Arrow type maps to the numpy
dtype a user sees (``DTypeInfo.numpy``) and to the torch dtype its buffer is
stored in (``DTypeInfo.torch``).

Unsigned storage rule.  torch on the CPU has no compare, add, shift or
searchsorted for ``uint16``/``uint32``/``uint64``, so Arrow ``u8``/``u16``/
``u32``/``u64`` are stored as the signed torch dtype of the same width, holding
the same bit pattern.  Code that gives them unsigned meaning goes through the
helpers below:

- :func:`widen` zero-extends (``& 0xFFFFFFFF`` for u32) before any int64
  arithmetic; a plain ``.to(torch.int64)`` would sign-extend a key >= 2^31;
- :func:`order_key` flips the sign bit, so a signed sort or compare of the
  result follows the unsigned order (this is how a ``u64`` sorts);
- :func:`narrow` wraps an int64 result back into the storage width.

Packed bitmaps (BOOL data and every validity buffer) are int32 words holding
the Arrow LSB-first bit order, so their bytes equal the JAX package's u32
words.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class ArrowType(enum.Enum):
    """The Arrow types of the engine (same names and values as arrow_tpu)."""

    BOOL = "bool"
    UINT8 = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    FLOAT32 = "float32"
    DATE32 = "date32"
    UINT64 = "uint64"
    INT64 = "int64"
    FLOAT64 = "float64"

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"ArrowType.{self.name}"


@dataclasses.dataclass(frozen=True)
class DTypeInfo:
    arrow: ArrowType
    numpy: np.dtype  # the Arrow value type as numpy spells it
    torch: torch.dtype  # the storage dtype of the buffer
    item_size: int  # true byte width (1 for BOOL: bit-packed)
    bit_width: int
    is_float: bool
    is_signed: bool
    is_integer: bool
    is_temporal: bool = False

    @property
    def is_unsigned(self) -> bool:
        return self.is_integer and not self.is_signed


def _info(arrow, npdt, tdt, bits, *, f=False, s=False, i=False, t=False):
    return DTypeInfo(arrow, np.dtype(npdt), tdt, max(1, bits // 8), bits, f, s, i, t)


_REGISTRY: dict[ArrowType, DTypeInfo] = {
    # BOOL is bit-packed: its storage is the int32 word buffer
    ArrowType.BOOL: _info(ArrowType.BOOL, np.uint32, torch.int32, 1),
    ArrowType.UINT8: _info(ArrowType.UINT8, np.uint8, torch.int8, 8, i=True),
    ArrowType.UINT16: _info(ArrowType.UINT16, np.uint16, torch.int16, 16, i=True),
    ArrowType.UINT32: _info(ArrowType.UINT32, np.uint32, torch.int32, 32, i=True),
    ArrowType.UINT64: _info(ArrowType.UINT64, np.uint64, torch.int64, 64, i=True),
    ArrowType.INT8: _info(ArrowType.INT8, np.int8, torch.int8, 8, s=True, i=True),
    ArrowType.INT16: _info(ArrowType.INT16, np.int16, torch.int16, 16, s=True, i=True),
    ArrowType.INT32: _info(ArrowType.INT32, np.int32, torch.int32, 32, s=True, i=True),
    ArrowType.INT64: _info(ArrowType.INT64, np.int64, torch.int64, 64, s=True, i=True),
    ArrowType.FLOAT32: _info(ArrowType.FLOAT32, np.float32, torch.float32, 32, f=True, s=True),
    ArrowType.FLOAT64: _info(ArrowType.FLOAT64, np.float64, torch.float64, 64, f=True, s=True),
    ArrowType.DATE32: _info(
        ArrowType.DATE32, np.int32, torch.int32, 32, s=True, i=True, t=True
    ),
}


def info(t: ArrowType) -> DTypeInfo:
    return _REGISTRY[t]


def item_size(t: ArrowType) -> int:
    return _REGISTRY[t].item_size


def is_float(t: ArrowType) -> bool:
    return _REGISTRY[t].is_float


def is_integer(t: ArrowType) -> bool:
    return _REGISTRY[t].is_integer


def is_unsigned(t: ArrowType) -> bool:
    return _REGISTRY[t].is_unsigned


_FROM_NUMPY: dict[np.dtype, ArrowType] = {
    np.dtype(np.bool_): ArrowType.BOOL,
    np.dtype(np.uint8): ArrowType.UINT8,
    np.dtype(np.uint16): ArrowType.UINT16,
    np.dtype(np.uint32): ArrowType.UINT32,
    np.dtype(np.uint64): ArrowType.UINT64,
    np.dtype(np.int8): ArrowType.INT8,
    np.dtype(np.int16): ArrowType.INT16,
    np.dtype(np.int32): ArrowType.INT32,
    np.dtype(np.int64): ArrowType.INT64,
    np.dtype(np.float32): ArrowType.FLOAT32,
    np.dtype(np.float64): ArrowType.FLOAT64,
}


def from_numpy_dtype(npdt) -> ArrowType:
    npdt = np.dtype(npdt)
    try:
        return _FROM_NUMPY[npdt]
    except KeyError:
        raise TypeError(f"no ArrowType for numpy dtype {npdt}") from None


# ---------------------------------------------------------------------------
# the unsigned storage rule
# ---------------------------------------------------------------------------


def storage_numpy(t: ArrowType) -> np.dtype:
    """The numpy dtype with the storage dtype's width and signedness."""
    return np.dtype(str(_REGISTRY[t].torch).removeprefix("torch."))


def to_storage_np(host: np.ndarray, t: ArrowType) -> np.ndarray:
    """Arrow-typed host values -> the storage bit pattern (a view, no copy)."""
    return np.ascontiguousarray(host, dtype=_REGISTRY[t].numpy).view(storage_numpy(t))


def from_storage_np(host: np.ndarray, t: ArrowType) -> np.ndarray:
    """Storage bit pattern -> Arrow-typed host values (a view, no copy)."""
    return np.ascontiguousarray(host).view(_REGISTRY[t].numpy)


def sign_bit(t: ArrowType) -> int:
    """The storage dtype's minimum: the sign bit alone, as a signed value."""
    return -(1 << (8 * _REGISTRY[t].item_size - 1))


def widen(x: torch.Tensor, t: ArrowType) -> torch.Tensor:
    """Storage tensor -> int64 holding the Arrow value (zero-extends u8..u32).

    A u64 has no int64 form: it is returned as its bit pattern."""
    inf = _REGISTRY[t]
    wide = x.to(torch.int64)
    if inf.is_unsigned and inf.bit_width < 64:
        wide = wide & ((1 << inf.bit_width) - 1)
    return wide


def narrow(x: torch.Tensor, t: ArrowType) -> torch.Tensor:
    """int64 -> storage dtype, wrapping modulo 2^width (two's complement)."""
    inf = _REGISTRY[t]
    if inf.is_float:
        return x.to(inf.torch)
    bits = 8 * inf.item_size
    if bits < 64:
        half = 1 << (bits - 1)
        x = ((x + half) & ((1 << bits) - 1)) - half
    return x.to(inf.torch)


def order_key(x: torch.Tensor, t: ArrowType) -> torch.Tensor:
    """Same-width tensor whose signed order is the Arrow order of `x`.

    Unsigned types flip the sign bit; signed and float types are unchanged."""
    if _REGISTRY[t].is_unsigned:
        return x ^ sign_bit(t)
    return x


def to_float64(x: torch.Tensor, t: ArrowType) -> torch.Tensor:
    """Storage tensor -> float64 of the Arrow value (u64 >= 2^63 included)."""
    if t is ArrowType.UINT64:  # two exact halves, so the sum rounds once
        hi = ((x >> 32) & 0xFFFFFFFF).to(torch.float64)
        return hi * 2.0**32 + (x & 0xFFFFFFFF).to(torch.float64)
    if _REGISTRY[t].is_unsigned:
        return widen(x, t).to(torch.float64)
    return x.to(torch.float64)
