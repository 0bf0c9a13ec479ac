"""Array layer: typed columnar arrays, validity bitmaps, buffers, scalars."""

from .array import (
    ArrowArrayBase,
    Date32Array,
    Float32Array,
    Float64Array,
    Int8Array,
    Int16Array,
    Int32Array,
    Int64Array,
    PrimitiveArray,
    UInt8Array,
    UInt16Array,
    UInt32Array,
    UInt64Array,
    make_array,
    pad_len,
    pad_words,
)
from .boolean import BooleanArray
from .buffer import Buffer
from .scalar import Operand, Scalar, as_scalar
from .validity import BitBufferBuilder, NullBitBuffer, merge_validity

ArrowArray = ArrowArrayBase

__all__ = [
    "ArrowArray",
    "ArrowArrayBase",
    "BitBufferBuilder",
    "BooleanArray",
    "Buffer",
    "Date32Array",
    "Float32Array",
    "Float64Array",
    "Int8Array",
    "Int16Array",
    "Int32Array",
    "Int64Array",
    "NullBitBuffer",
    "Operand",
    "PrimitiveArray",
    "Scalar",
    "UInt8Array",
    "UInt16Array",
    "UInt32Array",
    "UInt64Array",
    "as_scalar",
    "make_array",
    "merge_validity",
    "pad_len",
    "pad_words",
]
