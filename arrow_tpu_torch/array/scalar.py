"""Typed scalar values (counterpart of ``arrow_tpu/array/scalar.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from .. import dtypes as dt


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

