"""Typed scalar values (counterpart of ``arrow_tpu/array/scalar.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Union

import numpy as np

from .. import dtypes as dt
from .array import ArrowArrayBase


@dataclasses.dataclass(frozen=True)
class Scalar:
    """A typed scalar."""

    value: Any
    dtype: dt.ArrowType

    @classmethod
    def of(cls, value: Any, dtype: dt.ArrowType | None = None) -> "Scalar":
        if dtype is None:
            if isinstance(value, bool):
                dtype = dt.ArrowType.BOOL
            elif isinstance(value, int):
                dtype = dt.ArrowType.INT32
            elif isinstance(value, float):
                dtype = dt.ArrowType.FLOAT32
            else:
                dtype = dt.from_numpy_dtype(np.asarray(value).dtype)
        return cls(value, dtype)


    def to_numpy(self):
        if self.dtype is dt.ArrowType.BOOL:
            return np.bool_(self.value)
        return dt.info(self.dtype).numpy.type(self.value)


#: an array or a scalar: what an op that accepts either takes
Operand = Union[ArrowArrayBase, Scalar, int, float, bool]


def as_scalar(x: Operand, dtype: dt.ArrowType | None = None) -> Scalar:
    if isinstance(x, Scalar):
        return x
    if isinstance(x, ArrowArrayBase):
        raise TypeError("array operand where scalar expected")
    return Scalar.of(x, dtype)
