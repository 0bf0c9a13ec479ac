"""RecordBatch/Table: named columns of equal length (counterpart of
``arrow_tpu/table.py``)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import dtypes as dt
from .array.array import ArrowArrayBase, PrimitiveArray
from .errors import ArrowTorchError


class RecordBatch:
    """An ordered set of equal-length named columns."""

    def __init__(self, columns: Dict[str, ArrowArrayBase]):
        if not columns:
            raise ArrowTorchError("RecordBatch needs at least one column")
        lengths = {len(c) for c in columns.values()}
        if len(lengths) != 1:
            raise ArrowTorchError(f"column length mismatch: {lengths}")
        self._columns = dict(columns)
        self._length = lengths.pop()

    # -- construction --------------------------------------------------------

    @classmethod
    def from_numpy(cls, data: Dict[str, np.ndarray], device=None) -> "RecordBatch":
        return cls(
            {name: PrimitiveArray.from_slice(arr, device=device) for name, arr in data.items()}
        )

    @classmethod
    def from_arrow_buffers(cls, buffers: Dict[str, dict], device=None) -> "RecordBatch":
        """Columns from the host dicts ``io.to_arrow_buffers`` gives (of either
        package); each dict may carry a ``"dtype"`` (ArrowType or its value)."""
        from .io import from_arrow_buffers

        cols = {}
        for name, b in buffers.items():
            dtype = b.get("dtype")
            if dtype is not None and not isinstance(dtype, dt.ArrowType):
                dtype = dt.ArrowType(dtype)
            cols[name] = from_arrow_buffers(
                b["data"], b["length"], b.get("validity"), dtype, device
            )
        return cls(cols)

    # -- accessors ------------------------------------------------------------

    def __len__(self) -> int:
        return self._length

    @property
    def num_rows(self) -> int:
        return self._length

    @property
    def column_names(self) -> List[str]:
        return list(self._columns)

    def __getitem__(self, name: str) -> ArrowArrayBase:
        return self._columns[name]

    def columns(self) -> Dict[str, ArrowArrayBase]:
        return dict(self._columns)

    @property
    def schema(self) -> List[Tuple[str, dt.ArrowType]]:
        return [(n, c.dtype) for n, c in self._columns.items()]

    # -- transforms -----------------------------------------------------------

    def select(self, names: Sequence[str]) -> "RecordBatch":
        return RecordBatch({n: self._columns[n] for n in names})

    def with_column(self, name: str, col: ArrowArrayBase) -> "RecordBatch":
        cols = dict(self._columns)
        cols[name] = col
        return RecordBatch(cols)

    def rename(self, mapping: Dict[str, str]) -> "RecordBatch":
        return RecordBatch({mapping.get(n, n): c for n, c in self._columns.items()})

    def take(self, indexes) -> "RecordBatch":
        from .kernels import take as _take

        return RecordBatch({n: _take(c, indexes) for n, c in self._columns.items()})

    def to_pydict(self) -> Dict[str, list]:
        return {n: c.values() for n, c in self._columns.items()}

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {n: c.to_numpy() for n, c in self._columns.items()}

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}: {c.dtype.value}" for n, c in self._columns.items())
        return f"RecordBatch(rows={self._length}, columns=[{cols}])"


Table = RecordBatch
