"""Swizzle routines (ported so far: take).

Counterpart of ``arrow_tpu/ops/swizzle.py``, in plain PyTorch (the JAX
package leaves this tier to XLA's gather; no hand kernel is owed here).

``take(a, indexes)``: out[i] = a[indexes[i]], with the validity bits gathered
too; bool columns gather their bits and re-pack them.  Out-of-bounds indices
clamp to the last row of the buffer, as JAX's gather does.  The output has
the indexes' length and capacity, and zeros (data and validity) past the
length.  ``put`` and ``merge`` are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import dtypes as dt
from ..array.array import ArrowArrayBase, make_array
from ..errors import OperationNotSupported
from ..utils import bits as B
from .kernel import AV, dispatch, register


def _gather_bits(words: torch.Tensor, idx: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    bits = B.unpack_bits(words)
    return B.pack_bits(bits[idx.clamp(max=bits.shape[0] - 1)] & live)


def gather(a: AV, idx: torch.Tensor, length: int) -> AV:
    """out[i] = a[idx[i]] for i < length; idx: int64 row ids (any capacity
    >= length), clamped into the buffer; zeros from `length` on."""
    live = torch.arange(idx.shape[0], device=idx.device) < length
    v: Optional[torch.Tensor] = None
    if a.validity is not None:
        v = _gather_bits(a.validity, idx, live)
    if a.dtype is dt.ArrowType.BOOL:
        return AV(_gather_bits(a.data, idx, live), v, length, a.dtype)
    d = a.data[idx.clamp(max=a.data.shape[0] - 1)]
    return AV(torch.where(live, d, torch.zeros((), dtype=d.dtype, device=d.device)), v, length, a.dtype)


@register("take")
def _take_impl(a: AV, idx: AV) -> AV:
    return gather(a, dt.widen(idx.data, dt.ArrowType.UINT32), idx.length)


def take(a: ArrowArrayBase, indexes: ArrowArrayBase, pipeline=None) -> ArrowArrayBase:
    """Gather: out[i] = a[indexes[i]] (``indexes`` a UInt32Array)."""
    if indexes.dtype is not dt.ArrowType.UINT32:
        raise OperationNotSupported("take indexes must be a UInt32Array")
    return dispatch("take", [a, indexes], pipeline=pipeline)


def take_rows(a: ArrowArrayBase, idx: torch.Tensor, length: int) -> ArrowArrayBase:
    """:func:`take` by an int64 row-id tensor (the operators' form)."""
    out = gather(AV(a.data, a.validity, a.length, a.dtype), idx, length)
    return make_array(out.data, out.validity, length, a.dtype, a.device)
