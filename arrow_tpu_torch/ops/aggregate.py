"""Aggregation kernels: sum, min, max over a whole array.

Counterpart of ``arrow_tpu/ops/aggregate.py``, in plain PyTorch.  Each
returns a 1-row array of the input's dtype on a padded buffer, with no
validity.  Nulls are NOT skipped: a null row contributes its stored value
(the zero default), as in the JAX package.

- An integer sum wraps at the type's width (summed in int32, or int64 for
  64-bit types; the low bits are kept).
- Unsigned min/max order by ``dtypes.order_key``.
- Float min/max propagate NaN and order -0 below +0, as XLA's min and max
  do: a zero result takes the sign of any zero of the input, negative for
  min, positive for max.
- An empty array gives the reduction's identity: 0, or for min/max the
  fill the JAX package pads with (+-inf, or the type's bounds).
"""

from __future__ import annotations

import torch

from .. import dtypes as dt
from ..array.array import pad_len
from ..errors import OperationNotSupported
from .kernel import AV, dispatch, register

_SUM_DTYPES = {
    dt.ArrowType.FLOAT32,
    dt.ArrowType.FLOAT64,
    dt.ArrowType.UINT8,
    dt.ArrowType.UINT16,
    dt.ArrowType.UINT32,
    dt.ArrowType.UINT64,
    dt.ArrowType.INT8,
    dt.ArrowType.INT16,
    dt.ArrowType.INT32,
    dt.ArrowType.INT64,
}


def _one_meta(avs, params):
    return [(avs[0].dtype, 1)]


def _scalar_out(value: torch.Tensor, a: AV) -> AV:
    """A 1-row array (padded buffer) holding the 0-d `value`."""
    out = torch.zeros(pad_len(1), dtype=dt.info(a.dtype).torch, device=a.data.device)
    out[0] = value
    return AV(out, None, 1, a.dtype)


@register("sum", out_meta=_one_meta)
def _sum_impl(a: AV) -> AV:
    x = a.data[: a.length]
    if dt.is_float(a.dtype):
        return _scalar_out(torch.sum(x), a)
    # an int32 sum wraps as a u32/i32 sum does (and keeps the low 8 or 16
    # bits), and on CUDA it is several times faster than torch's default
    # int64 sum of int32 rows (chip_smoke.py's elementwise phase times both)
    acc = torch.int64 if dt.bit_width(a.dtype) == 64 else torch.int32
    return _scalar_out(dt.narrow(torch.sum(x, dtype=acc).to(torch.int64), a.dtype), a)


def _extreme(a: AV, largest: bool) -> AV:
    x = a.data[: a.length]
    if dt.is_float(a.dtype):
        if a.length == 0:
            return _scalar_out(torch.tensor(-torch.inf if largest else torch.inf), a)
        m = torch.amax(x) if largest else torch.amin(x)
        # a zero result: -0 if min saw a -0, +0 if max saw a +0, else the other
        want = 0.0 if largest else -0.0
        hit = torch.any((x == 0) & (torch.signbit(x) != largest))
        return _scalar_out(torch.where(m == 0, torch.where(hit, want, -want).to(m.dtype), m), a)
    if a.length == 0:  # the type's min for max, its max for min, in key order
        key = torch.tensor(dt.sign_bit(a.dtype) if largest else ~dt.sign_bit(a.dtype))
        return _scalar_out(dt.order_key(key, a.dtype), a)
    k = dt.order_key(x, a.dtype)
    return _scalar_out(dt.order_key(torch.amax(k) if largest else torch.amin(k), a.dtype), a)


@register("agg_min", out_meta=_one_meta)
def _min_impl(a: AV) -> AV:
    return _extreme(a, largest=False)


@register("agg_max", out_meta=_one_meta)
def _max_impl(a: AV) -> AV:
    return _extreme(a, largest=True)


def _check(name, a):
    if a.dtype not in _SUM_DTYPES and not (
        a.dtype is dt.ArrowType.DATE32 and name != "sum"
    ):
        raise OperationNotSupported(f"{name} not supported for {a.dtype.value}")


def sum_(a, pipeline=None):
    """Sum all elements -> 1-element array.  Nulls are NOT skipped."""
    _check("sum", a)
    return dispatch("sum", [a], pipeline=pipeline)


def sum_op(a, pipeline):
    return sum_(a, pipeline)


sum_dyn = sum_
sum_op_dyn = sum_op


def min_reduce(a, pipeline=None):
    _check("min", a)
    return dispatch("agg_min", [a], pipeline=pipeline)


def max_reduce(a, pipeline=None):
    _check("max", a)
    return dispatch("agg_max", [a], pipeline=pipeline)


__all__ = ["max_reduce", "min_reduce", "sum_", "sum_dyn", "sum_op", "sum_op_dyn"]
