"""Arithmetic kernels: add/sub/mul/div/rem (array op array, array op scalar), neg.

Counterpart of ``arrow_tpu/ops/arithmetic.py``, in plain PyTorch (the JAX
package leaves this tier to XLA fusion; no hand kernel is owed here).

Semantics (the WGSL rules the JAX package keeps):

- integer add/sub/mul wrap (two's complement);
- integer ``x / 0 == x``; ``INT_MIN / -1 == INT_MIN``; ``x % 0 == 0``;
  ``INT_MIN % -1 == 0``; division truncates and the remainder takes the
  dividend's sign.  The divisor is made safe before torch divides, since
  torch raises on an integer division by zero on the CPU and gives
  undefined values on CUDA;
- unsigned types divide in their unsigned meaning although their storage is
  signed: u8..u32 widen to int64 through a mask, u64 divides by the
  unsigned long-division identity (:func:`_u64_divmod`);
- integer division is exact at every width (the JAX package divides through
  float32 or float64, which rounds dividends past 2^24 or 2^53);
- float division by zero gives +-inf/NaN; float ``%`` is ``torch.fmod``;
  a divisor moves to the dividend's device first, since CUDA divides by a
  host scalar as a multiply by its reciprocal, which may differ in the
  last bit;
- scalar ops clone the lhs validity; array ops AND both validity bitmaps.
"""

from __future__ import annotations

import torch

from .. import dtypes as dt
from ..array.scalar import Scalar
from ..errors import OperationNotSupported
from .kernel import AV, dispatch, merged_validity, register, scalar_av, scalar_data, zero_tail

_NUMERIC = {
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

_SIGNED = {
    dt.ArrowType.FLOAT32,
    dt.ArrowType.FLOAT64,
    dt.ArrowType.INT8,
    dt.ArrowType.INT16,
    dt.ArrowType.INT32,
    dt.ArrowType.INT64,
}

_U64_SIGN = dt.sign_bit(dt.ArrowType.UINT64)


def _u64_ge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b for int64 tensors holding u64 bit patterns."""
    return (a ^ _U64_SIGN) >= (b ^ _U64_SIGN)


def _u64_divmod(n: torch.Tensor, d: torch.Tensor):
    """Unsigned 64-bit (quotient, remainder) on int64 storage, WGSL rules
    (``n / 0 == n``, ``n % 0 == 0``).

    A divisor >= 2^63 gives a quotient of 0 or 1.  Below that,
    ``q = ((n >>> 1) // d) << 1`` is the quotient or one less (all operands
    nonnegative int64), and one step corrects it."""
    zero = d == 0
    big = d < 0  # d >= 2^63
    ds = torch.where(zero | big, 1, d)
    q = torch.div((n >> 1) & 0x7FFFFFFFFFFFFFFF, ds, rounding_mode="floor") << 1
    r = n - q * ds
    fix = _u64_ge(r, ds)
    q = torch.where(fix, q + 1, q)
    r = torch.where(fix, r - ds, r)
    over = _u64_ge(n, d)
    q = torch.where(big, over.to(torch.int64), q)
    r = torch.where(big, torch.where(over, n - d, n), r)
    return torch.where(zero, n, q), torch.where(zero, 0, r)


def _int_divmod_inputs(x, y, t: dt.ArrowType):
    """(x, y, bad) with u8..u32 widened to int64 and `bad` the rows whose
    division WGSL defines specially (divisor 0, or INT_MIN / -1)."""
    if dt.is_unsigned(t):
        x, y = dt.widen(x, t), dt.widen(y, t)
        return x, y, y == 0
    return x, y, (y == 0) | ((x == dt.sign_bit(t)) & (y == -1))


def _wgsl_div(x, y, t: dt.ArrowType):
    y = y.to(x.device)  # CUDA divides by a host scalar as a multiply by its reciprocal
    if dt.is_float(t):
        return x / y
    if t is dt.ArrowType.UINT64:
        return _u64_divmod(x, y)[0]
    xw, yw, bad = _int_divmod_inputs(x, y, t)
    q = torch.div(xw, torch.where(bad, 1, yw), rounding_mode="trunc")
    return dt.narrow(torch.where(bad, xw, q), t) if dt.is_unsigned(t) else torch.where(bad, x, q)


def _wgsl_rem(x, y, t: dt.ArrowType):
    y = y.to(x.device)
    if dt.is_float(t):
        return torch.fmod(x, y)  # trunc-style, sign of dividend (WGSL %)
    if t is dt.ArrowType.UINT64:
        return _u64_divmod(x, y)[1]
    xw, yw, bad = _int_divmod_inputs(x, y, t)
    r = torch.where(bad, 0, torch.fmod(xw, torch.where(bad, 1, yw)))
    return dt.narrow(r, t) if dt.is_unsigned(t) else r


_FNS = {
    "add": lambda x, y, t: x + y,
    "sub": lambda x, y, t: x - y,
    "mul": lambda x, y, t: x * y,
    "div": _wgsl_div,
    "rem": _wgsl_rem,
}


def _out(data: torch.Tensor, validity, a: AV) -> AV:
    """The result in `a`'s storage dtype, its tail cleared."""
    data = zero_tail(data.to(dt.info(a.dtype).torch), a.length)
    return AV(data, validity, a.length, a.dtype)


def _make_kernels():
    for name, fn in _FNS.items():

        def _array_impl(a: AV, b: AV, _fn=fn) -> AV:
            return _out(_fn(a.data, b.data, a.dtype), merged_validity(a, b), a)

        def _scalar_impl(a: AV, b: AV, _fn=fn) -> AV:
            return _out(_fn(a.data, scalar_data(b), a.dtype), a.validity, a)  # clone lhs validity

        register(name)(_array_impl)
        register(f"{name}_scalar")(_scalar_impl)


_make_kernels()


@register("neg")
def _neg_impl(a: AV) -> AV:
    return _out(-a.data, a.validity, a)


# ---------------------------------------------------------------------------
# typed + dyn API
# ---------------------------------------------------------------------------


def _coerce_scalar(a, value) -> AV:
    """A Python or Scalar rhs as a scalar AV held on the host (a bare Python
    value takes `a`'s dtype): torch passes a 0-d host tensor to a CUDA
    kernel as an argument, where it reads a 0-d device tensor as a stride-0
    operand, on a slower path.  A 1-row array passes through (its row stays
    on its device)."""
    if isinstance(value, AV):
        return value
    if isinstance(value, Scalar):
        return scalar_av(value, value.dtype)
    if isinstance(value, (int, float, bool)):
        return scalar_av(value, a.dtype)
    return value  # 1-row array used as scalar


def _check(op: str, *dtypes: dt.ArrowType) -> None:
    for d in dtypes:
        if d not in _NUMERIC:
            raise OperationNotSupported(f"{op} not supported for {[x.value for x in dtypes]}")


def _make_api(name: str):
    def array_fn(a, b, pipeline=None):
        _check(name, a.dtype, b.dtype)
        return dispatch(name, [a, b], pipeline=pipeline)

    def scalar_fn(a, value, pipeline=None):
        _check(name, a.dtype)
        return dispatch(f"{name}_scalar", [a, _coerce_scalar(a, value)], pipeline=pipeline)

    def generic_dyn(a, b, pipeline=None):
        # route array-vs-scalar by operand length
        la, lb = len(a), len(b)
        if (la == 1 and lb == 1) or (la != 1 and lb != 1):
            return array_fn(a, b, pipeline)
        if lb == 1:
            return scalar_fn(a, b, pipeline)
        return scalar_fn(b, a, pipeline)

    return array_fn, scalar_fn, generic_dyn


__all__ = ["neg", "neg_dyn", "neg_op", "neg_op_dyn"]

for _name in _FNS:
    _array_fn, _scalar_fn, _generic = _make_api(_name)
    _forms = {
        "": _array_fn,
        "_op": lambda a, b, pipeline, _f=_array_fn: _f(a, b, pipeline),
        "_scalar": _scalar_fn,
        "_scalar_op": lambda a, v, pipeline, _f=_scalar_fn: _f(a, v, pipeline),
        "_array_dyn": _array_fn,
        "_array_op_dyn": lambda a, b, pipeline, _f=_array_fn: _f(a, b, pipeline),
        "_scalar_dyn": _scalar_fn,
        "_scalar_op_dyn": lambda a, v, pipeline, _f=_scalar_fn: _f(a, v, pipeline),
        "_dyn": _generic,
        "_op_dyn": lambda a, b, pipeline, _f=_generic: _f(a, b, pipeline),
    }
    for _suffix, _f in _forms.items():
        globals()[_name + _suffix] = _f
        __all__.append(_name + _suffix)


def neg(a, pipeline=None):
    if a.dtype not in _SIGNED:
        raise OperationNotSupported(f"neg not supported for {a.dtype.value}")
    return dispatch("neg", [a], pipeline=pipeline)


def neg_op(a, pipeline):
    return neg(a, pipeline)


neg_dyn = neg
neg_op_dyn = neg_op
