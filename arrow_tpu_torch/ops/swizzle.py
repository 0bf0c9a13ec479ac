"""Swizzle routines: merge (select by mask), take (gather), put (scatter).

Counterpart of ``arrow_tpu/ops/swizzle.py``, in plain PyTorch (the JAX
package leaves this tier to XLA's gather and scatter).  The join's output
take does not come here on the card: ``compute/join.py`` gathers every
output column of both sides with the hand-written kernel ``take_columns``
(``compute.kernels``), whose plain version is :func:`gather` column by
column.

- ``take(a, indexes)``: out[i] = a[indexes[i]], with the validity bits
  gathered too; bool columns gather their bits and re-pack them.
  Out-of-bounds indices clamp to the last row of the buffer, as JAX's gather
  does.  The output has the indexes' length and capacity, and zeros (data
  and validity) past the length.
- ``merge(a, b, mask)``: rows whose mask *value* bit is set come from `a`,
  the rest from `b` (a null mask row holds value bit 0: `b`).  Validity is
  the reference's 4-stage composition: ``(va & m) | (vb & ~m)``, where a side
  without a validity buffer drops out (so if only one side tracks validity,
  the rows taken from the other side are null), then ``& mask_validity``;
  with neither side tracked, the mask's validity is cloned.
- ``put(src, src_indexes, dst, dst_indexes)``: dst[dst_idx[i]] =
  src[src_idx[i]] for i < min(len(src_idx), len(dst_idx)); eager ``put``
  rebinds `dst` to the new buffers (no buffer is written in place).  The
  validity bits scatter with the values (rows of a side without a validity
  buffer are valid).  Source indices clamp as in take; destination indices
  at or past dst's length are dropped, so the tail stays zero.  Which of two
  equal destination indices wins is implementation-defined.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import dtypes as dt
from ..array.array import ArrowArrayBase, make_array
from ..errors import OperationNotSupported
from ..utils import bits as B
from .kernel import AV, dispatch, register

__all__ = [f"{n}{s}" for n in ("merge", "put", "take") for s in ("", "_op", "_dyn", "_op_dyn")]


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


def _take_meta(avs, params):
    return [(avs[0].dtype, avs[1].length)]


@register("take", out_meta=_take_meta)
def _take_impl(a: AV, idx: AV) -> AV:
    return gather(a, dt.widen(idx.data, dt.ArrowType.UINT32), idx.length)


def take(a, indexes, pipeline=None):
    """Gather: out[i] = a[indexes[i]] (``indexes`` a UInt32Array)."""
    if indexes.dtype is not dt.ArrowType.UINT32:
        raise OperationNotSupported("take indexes must be a UInt32Array")
    return dispatch("take", [a, indexes], pipeline=pipeline)


def take_op(a, indexes, pipeline):
    return take(a, indexes, pipeline)


take_dyn = take
take_op_dyn = take_op


def _merge_validity_4way(va, vb, mask_words, mask_validity):
    """The reference's merge_null_buffers_op, on packed words."""
    v1 = (va & mask_words) if va is not None else None
    v2 = (vb & ~mask_words) if vb is not None else None
    if v1 is not None and v2 is not None:
        merged = v1 | v2
    else:
        merged = v1 if v1 is not None else v2
    if merged is not None and mask_validity is not None:
        return merged & mask_validity
    if merged is None:
        return mask_validity  # clone
    return merged


@register("merge")
def _merge_impl(a: AV, b: AV, mask: AV) -> AV:
    if a.dtype is dt.ArrowType.BOOL:
        out = (a.data & mask.data) | (b.data & ~mask.data)
    else:
        out = torch.where(B.unpack_bits(mask.data, a.data.shape[0]), a.data, b.data)
    v = _merge_validity_4way(a.validity, b.validity, mask.data, mask.validity)
    return AV(out, v, a.length, a.dtype)


def merge(a, b, mask, pipeline=None):
    """Select a[i] where mask[i] else b[i]."""
    if a.dtype is not b.dtype:
        raise OperationNotSupported("merge requires matching dtypes")
    if mask.dtype is not dt.ArrowType.BOOL:
        raise OperationNotSupported("merge mask must be a BooleanArray")
    if len(a) != len(b) or len(a) != len(mask):
        raise OperationNotSupported("merge requires equal lengths")
    return dispatch("merge", [a, b, mask], pipeline=pipeline)


def merge_op(a, b, mask, pipeline):
    return merge(a, b, mask, pipeline)


merge_dyn = merge
merge_op_dyn = merge_op


def _scatter_bits(words: torch.Tensor, di: torch.Tensor, bits: torch.Tensor, length: int) -> torch.Tensor:
    """`words` with bit di[i] set to bits[i]; di may name one spare bit past
    the words, whose write is dropped."""
    out = torch.zeros(words.shape[0] * B.WORD_BITS + 1, dtype=torch.bool, device=words.device)
    out[:-1] = B.unpack_bits(words)
    out[di] = bits
    return B.mask_tail(B.pack_bits(out[:-1]), length)


def _put_meta(avs, params):
    return [(avs[2].dtype, avs[2].length)]


@register("put", out_meta=_put_meta)
def _put_impl(src: AV, src_idx: AV, dst: AV, dst_idx: AV) -> AV:
    n = min(src_idx.length, dst_idx.length)
    si = dt.widen(src_idx.data[:n], dt.ArrowType.UINT32)
    di = dt.widen(dst_idx.data[:n], dt.ArrowType.UINT32)
    spare = dst.data.shape[0] * (B.WORD_BITS if dst.dtype is dt.ArrowType.BOOL else 1)
    di = torch.where(di < dst.length, di, spare)  # dropped writes land in a spare row
    if src.dtype is dt.ArrowType.BOOL:
        sbits = B.unpack_bits(src.data)
        out = _scatter_bits(dst.data, di, sbits[si.clamp(max=sbits.shape[0] - 1)], dst.length)
    else:
        out = torch.cat([dst.data, dst.data.new_zeros(1)])
        out[di] = src.data[si.clamp(max=src.data.shape[0] - 1)]
        out = out[:-1]
    v = dst.validity
    if src.validity is not None or dst.validity is not None:
        dv = dst.validity
        if dv is None:
            dv = B.tail_mask_words(B.num_words(spare), dst.length, dst.data.device)
        if src.validity is not None:
            svbits = B.unpack_bits(src.validity)
            svbits = svbits[si.clamp(max=svbits.shape[0] - 1)]
        else:
            svbits = torch.ones(n, dtype=torch.bool, device=dst.data.device)
        v = _scatter_bits(dv, di, svbits, dst.length)
    return AV(out, v, dst.length, dst.dtype)


def put(src, src_indexes, dst, dst_indexes, pipeline=None):
    """Scatter src[src_idx[i]] into dst[dst_idx[i]], rebinding `dst` to the
    result (returns None).  In pipeline mode returns the new dst handle
    instead (bound after finish)."""
    if src.dtype is not dst.dtype:
        raise OperationNotSupported("put requires matching dtypes")
    for ix in (src_indexes, dst_indexes):
        if ix.dtype is not dt.ArrowType.UINT32:
            raise OperationNotSupported("put indexes must be UInt32Arrays")
    result = dispatch("put", [src, src_indexes, dst, dst_indexes], pipeline=pipeline)
    if pipeline is None and isinstance(dst, ArrowArrayBase):
        dst._data = result.data
        dst._validity = result.validity
        return None
    return result


def put_op(src, src_indexes, dst, dst_indexes, pipeline):
    return put(src, src_indexes, dst, dst_indexes, pipeline)


put_dyn = put
put_op_dyn = put_op


def take_rows(a: ArrowArrayBase, idx: torch.Tensor, length: int) -> ArrowArrayBase:
    """:func:`take` by an int64 row-id tensor (the operators' form)."""
    out = gather(AV(a.data, a.validity, a.length, a.dtype), idx, length)
    return make_array(out.data, out.validity, length, a.dtype, a.device)
