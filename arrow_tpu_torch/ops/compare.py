"""Comparison kernels: eq/gt/gteq/lt/lteq -> BooleanArray; elementwise min/max.

Counterpart of ``arrow_tpu/ops/compare.py``, in plain PyTorch (the JAX
package leaves this tier to XLA fusion; no hand kernel is owed here).

Semantics: NaN compares false for every predicate; comparing a null gives
null (validity AND).  Unsigned types compare in their Arrow order: the
operands go through ``dtypes.order_key`` (sign bit flipped) first.

``min``/``max`` are elementwise over two arrays, as XLA's minimum and
maximum: NaN propagates, and -0 orders below +0.
"""

from __future__ import annotations

import torch

from .. import dtypes as dt
from ..errors import OperationNotSupported
from ..utils import bits as B
from .kernel import AV, dispatch, merged_validity, register, scalar_data

_CMP_FNS = {
    "eq": torch.eq,
    "gt": torch.gt,
    "gteq": torch.ge,
    "lt": torch.lt,
    "lteq": torch.le,
}

_MINMAX_FNS = {"min": torch.minimum, "max": torch.maximum}

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


def _bool_meta(avs, params):
    first = next(a for a in avs if not a.is_scalar)
    return [(dt.ArrowType.BOOL, first.length)]


def _minmax(fn, a: AV, b: AV) -> torch.Tensor:
    if not dt.is_float(a.dtype):
        return dt.order_key(fn(dt.order_key(a.data, a.dtype), dt.order_key(b.data, a.dtype)), a.dtype)
    # equal operands: -0 for min if either is -0, +0 for max if either is +0
    tie = torch.where(torch.signbit(a.data) == (fn is torch.minimum), a.data, b.data)
    return torch.where(a.data == b.data, tie, fn(a.data, b.data))


def _make_kernels():
    for name, fn in _CMP_FNS.items():

        def _impl(a: AV, b: AV, _fn=fn) -> AV:
            words = _compare(_fn, a, b.data, b.dtype)
            return AV(words, merged_validity(a, b), a.length, dt.ArrowType.BOOL)

        def _scalar_impl(a: AV, b: AV, _fn=fn) -> AV:
            words = _compare(_fn, a, scalar_data(b), b.dtype)
            return AV(words, a.validity, a.length, dt.ArrowType.BOOL)

        register(name, out_meta=_bool_meta)(_impl)
        register(f"{name}_scalar", out_meta=_bool_meta)(_scalar_impl)

    for name, fn in _MINMAX_FNS.items():

        def _mm(a: AV, b: AV, _fn=fn) -> AV:
            return AV(_minmax(_fn, a, b), merged_validity(a, b), a.length, a.dtype)

        register(name)(_mm)


_make_kernels()


def _check(op, *arrays):
    for a in arrays:
        if a.dtype not in _CMP_DTYPES:
            raise OperationNotSupported(f"{op} not supported for {a.dtype.value}")


def _make_api(name):
    def array_fn(a, b, pipeline=None):
        _check(name, a, b)
        return dispatch(name, [a, b], pipeline=pipeline)

    def scalar_fn(a, value, pipeline=None):
        from .arithmetic import _coerce_scalar

        _check(name, a)
        return dispatch(f"{name}_scalar", [a, _coerce_scalar(a, value)], pipeline=pipeline)

    return array_fn, scalar_fn


__all__ = []

for _name in list(_CMP_FNS) + list(_MINMAX_FNS):
    _array_fn, _scalar_fn = _make_api(_name)
    _forms = {
        "": _array_fn,
        "_op": lambda a, b, pipeline, _f=_array_fn: _f(a, b, pipeline),
        "_dyn": _array_fn,
        "_op_dyn": lambda a, b, pipeline, _f=_array_fn: _f(a, b, pipeline),
        "_scalar": _scalar_fn,
        "_scalar_op": lambda a, v, pipeline, _f=_scalar_fn: _f(a, v, pipeline),
    }
    for _suffix, _f in _forms.items():
        globals()[_name + _suffix] = _f
        __all__.append(_name + _suffix)

# dyn aliases of the reference's minmax names
min_array_dyn = globals()["min"]
max_array_dyn = globals()["max"]
min_array_op_dyn = globals()["min_op"]
max_array_op_dyn = globals()["max_op"]
__all__ += ["min_array_dyn", "max_array_dyn", "min_array_op_dyn", "max_array_op_dyn"]
