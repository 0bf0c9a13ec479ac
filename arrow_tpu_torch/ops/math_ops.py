"""Math kernels: abs, sqrt, cbrt, exp, exp2, log, log2, power.

Counterpart of ``arrow_tpu/ops/math_ops.py``, in plain PyTorch.

- ``cbrt`` is ``sign(x) * |x| ** (1/3)``, the JAX package's formula;
- integer ``power`` follows the WGSL loop: a wrapping multiply for exponents
  >= 0; for exponents < 0 the loop's closed form: x == 0 -> 1, |x| == 1 ->
  x to the parity of the exponent, else 0 (``torch.pow`` raises on a
  negative integer exponent, so only exponents >= 0 reach it);
- float ``power`` is IEEE ``pow``;
- ``sqrt`` is correctly rounded on every device (see :func:`_sqrt`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dtypes as dt
from ..errors import OperationNotSupported
from .kernel import AV, dispatch, merged_validity, register, zero_tail

_F = {dt.ArrowType.FLOAT32, dt.ArrowType.FLOAT64}
_ABS_DTYPES = _F | {dt.ArrowType.INT8, dt.ArrowType.INT16, dt.ArrowType.INT32, dt.ArrowType.INT64}
_POWER_DTYPES = _F | {dt.ArrowType.INT32, dt.ArrowType.INT64}


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _sqrt(x):
    """IEEE sqrt, correctly rounded.  torch's CPU sqrt is within an ulp but
    not always correctly rounded, so a CPU tensor goes through numpy's (the
    same memory, no copy); CUDA's sqrt is IEEE."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.sqrt(x.numpy()))


_UNARY_FNS = {
    "abs": torch.abs,
    "sqrt": _sqrt,
    "cbrt": _cbrt,
    "exp": torch.exp,
    "exp2": torch.exp2,
    "log": torch.log,
    "log2": torch.log2,
}


def _make_unary_kernels():
    for name, fn in _UNARY_FNS.items():

        def _impl(a: AV, _fn=fn) -> AV:
            return AV(zero_tail(_fn(a.data), a.length), a.validity, a.length, a.dtype)

        register(f"math_{name}")(_impl)


_make_unary_kernels()


@register("power")
def _power_impl(a: AV, b: AV) -> AV:
    x, p = a.data, b.data
    if dt.is_float(a.dtype):
        out = torch.pow(x, p)
    else:
        neg = p < 0
        pos = torch.pow(x, torch.where(neg, 0, p))  # wraps, as repeated multiplies do
        unit = (x == 1) | (x == -1)
        closed = torch.where(x == 0, 1, torch.where(unit, torch.where((p & 1) == 1, x, 1), 0))
        out = torch.where(neg, closed.to(x.dtype), pos)
    return AV(zero_tail(out, a.length), merged_validity(a, b), a.length, a.dtype)


def _check(name, a, allowed):
    if a.dtype not in allowed:
        raise OperationNotSupported(f"{name} not supported for {a.dtype.value}")


def _make_api(name, allowed):
    def fn(a, pipeline=None):
        _check(name, a, allowed)
        return dispatch(f"math_{name}", [a], pipeline=pipeline)

    return fn


for _name in _UNARY_FNS:
    _fn = _make_api(_name, _ABS_DTYPES if _name == "abs" else _F)
    globals()[_name] = _fn
    globals()[f"{_name}_op"] = lambda a, pipeline, _f=_fn: _f(a, pipeline)
    globals()[f"{_name}_dyn"] = _fn
    globals()[f"{_name}_op_dyn"] = lambda a, pipeline, _f=_fn: _f(a, pipeline)


def power(a, b, pipeline=None):
    _check("power", a, _POWER_DTYPES)
    if a.dtype is not b.dtype:
        raise OperationNotSupported("power requires matching dtypes")
    return dispatch("power", [a, b], pipeline=pipeline)


def power_op(a, b, pipeline):
    return power(a, b, pipeline)


power_dyn = power
power_op_dyn = power_op

__all__ = [f"{n}{s}" for n in (*_UNARY_FNS, "power") for s in ("", "_op", "_dyn", "_op_dyn")]
