"""Comparison kernels: eq/gt/gteq/lt/lteq -> BooleanArray.

Counterpart of ``arrow_tpu/ops/compare.py``, in plain PyTorch (the JAX
package leaves this tier to XLA fusion; no hand kernel is owed here).

Semantics: NaN compares false for every predicate; comparing a null gives
null (validity AND).  Unsigned types compare in their Arrow order: the
operands go through ``dtypes.order_key`` (sign bit flipped) first.
"""

from __future__ import annotations

import torch

from .. import dtypes as dt
from ..array.scalar import Scalar
from ..errors import OperationNotSupported
from ..utils import bits as B
from .kernel import AV, dispatch, merged_validity, register, scalar_data, scalar_av

_CMP_FNS = {
    "eq": torch.eq,
    "gt": torch.gt,
    "gteq": torch.ge,
    "lt": torch.lt,
    "lteq": torch.le,
}

_CMP_DTYPES = {
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
    dt.ArrowType.DATE32,
}


def _ordered(x: torch.Tensor, t: dt.ArrowType) -> torch.Tensor:
    """A tensor whose torch order is the Arrow order of `x`: u8..u32 widened
    to int64 (so that torch's type promotion against another operand is
    exact), u64 with its sign bit flipped, the rest unchanged."""
    if dt.is_unsigned(t) and dt.item_size(t) < 8:
        return dt.widen(x, t)
    return dt.order_key(x, t)


def _compare(fn, a: AV, b_data: torch.Tensor, b_dtype: dt.ArrowType) -> torch.Tensor:
    words = B.pack_bits(fn(_ordered(a.data, a.dtype), _ordered(b_data, b_dtype)))
    return B.mask_tail(words, a.length)


def _make_kernels():
    for name, fn in _CMP_FNS.items():

        def _impl(a: AV, b: AV, _fn=fn) -> AV:
            words = _compare(_fn, a, b.data, b.dtype)
            return AV(words, merged_validity(a, b), a.length, dt.ArrowType.BOOL)

        def _scalar_impl(a: AV, b: AV, _fn=fn) -> AV:
            words = _compare(_fn, a, scalar_data(b), b.dtype)
            return AV(words, a.validity, a.length, dt.ArrowType.BOOL)

        register(name)(_impl)
        register(f"{name}_scalar")(_scalar_impl)


_make_kernels()


def _check(op, *arrays):
    for a in arrays:
        if a.dtype not in _CMP_DTYPES:
            raise OperationNotSupported(f"{op} not supported for {a.dtype.value}")


def _coerce_scalar(a, value) -> AV:
    """A Python or Scalar rhs as a scalar AV on `a`'s device (a bare Python
    value takes `a`'s dtype); a 1-row array passes through."""
    if isinstance(value, AV):
        return value
    if isinstance(value, Scalar):
        return scalar_av(value, value.dtype, a.data.device)
    if isinstance(value, (int, float, bool)):
        return scalar_av(value, a.dtype, a.data.device)
    return value


def _make_api(name):
    def array_fn(a, b, pipeline=None):
        _check(name, a, b)
        return dispatch(name, [a, b], pipeline=pipeline)

    def scalar_fn(a, value, pipeline=None):
        _check(name, a)
        return dispatch(f"{name}_scalar", [a, _coerce_scalar(a, value)], pipeline=pipeline)

    return array_fn, scalar_fn


for _name in _CMP_FNS:
    _array_fn, _scalar_fn = _make_api(_name)
    globals()[_name] = _array_fn
    globals()[f"{_name}_dyn"] = _array_fn
    globals()[f"{_name}_scalar"] = _scalar_fn

__all__ = [
    f"{n}{suffix}" for n in _CMP_FNS for suffix in ("", "_dyn", "_scalar")
]
