"""Filter / compaction operator: predicate mask -> densely packed selected rows.

Counterpart of ``arrow_tpu/compute/filter.py``.  The selection is the mask's
value words AND its validity words (a null mask row drops its row, Arrow
filter semantics).  ``method="auto"`` compacts with kernel B1
(``compute/kernels/compaction3``): every column of a batch, its value plane
and its validity plane, shares one launch per group of at most
``MAX_PLANES`` planes.  ``method="sort"`` keeps the JAX package's
stable-partition route.  Outputs keep the input's capacity, with zeros past
the logical length (the host-synced count).
"""

from __future__ import annotations

from typing import List, Tuple, Union

import torch

from .. import dtypes as dt
from ..array.array import ArrowArrayBase, make_array, pad_len
from ..array.boolean import BooleanArray
from ..errors import OperationNotSupported
from ..table import RecordBatch
from ..utils import bits as B
from ..utils.scans import stable_partition
from .kernels import compact_multi, compaction3


def _select_words(mask: BooleanArray) -> torch.Tensor:
    return mask.data if mask.validity is None else mask.data & mask.validity


def _filter_compact(cols, mask: BooleanArray) -> Tuple[list, int]:
    """Kernel B1 route: one launch per group of planes."""
    cap = pad_len(mask.length)
    nw = cap // B.WORD_BITS
    select = _select_words(mask)[:nw]
    planes = []  # (column index, is validity, tensor, is word plane)
    for ci, c in enumerate(cols):
        if c.dtype is dt.ArrowType.BOOL:
            planes.append((ci, False, c.data[:nw], True))
        else:
            d = c.data[:cap]
            planes.append((ci, False, d if d.element_size() >= 4 else d.to(torch.int32), False))
        if c.validity is not None:
            planes.append((ci, True, c.validity[:nw], True))

    out = {}
    count = None
    for g in range(0, len(planes), compaction3.MAX_PLANES):
        group = planes[g : g + compaction3.MAX_PLANES]
        vouts, wouts, count = compact_multi(
            [t for _, _, t, w in group if not w], [t for _, _, t, w in group if w], select, cap
        )
        vit, wit = iter(vouts), iter(wouts)
        for ci, is_valid, _, is_word in group:
            out[ci, is_valid] = B.pack_bits(next(wit) != 0) if is_word else next(vit)
    k = int(count)
    results = []
    for ci, c in enumerate(cols):
        d = out[ci, False]
        if c.dtype is not dt.ArrowType.BOOL and d.dtype != c.data.dtype:
            d = d.to(c.data.dtype)
        results.append((d, out.get((ci, True))))
    return results, k


def _filter_sort(cols, mask: BooleanArray) -> Tuple[list, int]:
    """Stable-partition route: one stable sort on the 0/1 selection key."""
    cap = pad_len(mask.length)
    sel = B.unpack_bits(_select_words(mask)[: cap // B.WORD_BITS], cap)
    k = int(sel.sum())
    operands, slots = [], []
    for c in cols:
        is_bool = c.dtype is dt.ArrowType.BOOL
        operands.append(B.unpack_bits(c.data, cap) if is_bool else c.data[:cap])
        slots.append(is_bool)
        if c.validity is not None:
            operands.append(B.unpack_bits(c.validity, cap))
    parts = iter(stable_partition(sel, operands))
    live = torch.arange(cap, device=sel.device) < k
    results = []
    for c, is_bool in zip(cols, slots):
        d = next(parts)
        d = B.pack_bits(d & live) if is_bool else torch.where(live, d, torch.zeros_like(d))
        v = B.pack_bits(next(parts) & live) if c.validity is not None else None
        results.append((d, v))
    return results, k


def filter(
    data: Union[ArrowArrayBase, RecordBatch],
    mask: BooleanArray,
    method: str = "auto",
) -> Union[ArrowArrayBase, RecordBatch]:
    """Compact rows where mask is true (and valid).

    method: "auto" and "pallas" (the JAX package's name for its hand-kernel
    route) = kernel B1 (any mix of 1/2/4/8-byte, bool and nullable columns);
    "sort" = the stable-partition route.
    """
    if mask.dtype is not dt.ArrowType.BOOL:
        raise OperationNotSupported("filter mask must be a BooleanArray")
    if len(data) != len(mask):
        raise OperationNotSupported("filter requires equal lengths")
    if method not in ("auto", "pallas", "sort"):
        raise OperationNotSupported(f"filter method {method!r} is not ported")
    cols: List[ArrowArrayBase] = (
        list(data.columns().values()) if isinstance(data, RecordBatch) else [data]
    )
    if method == "sort":
        results, k = _filter_sort(cols, mask)
    else:
        results, k = _filter_compact(cols, mask)
    out = [make_array(d, v, k, c.dtype, c.device) for c, (d, v) in zip(cols, results)]
    if isinstance(data, RecordBatch):
        return RecordBatch(dict(zip(data.columns().keys(), out)))
    return out[0]


def filter_count(mask: BooleanArray) -> int:
    """Number of rows a filter would select."""
    return int(B.popcount_words(_select_words(mask)))


def filter_indices(mask: BooleanArray) -> Tuple[ArrowArrayBase, int]:
    """Selected row indices (UInt32Array) + count; null mask rows excluded."""
    cap = pad_len(mask.length)
    rows = torch.arange(cap, dtype=torch.int32, device=mask.data.device)
    (out,), _, count = compact_multi(
        [rows], [], _select_words(mask)[: cap // B.WORD_BITS], cap
    )
    k = int(count)
    return make_array(out, None, k, dt.ArrowType.UINT32, mask.device), k
