"""Trigonometry kernels: sin, cos, acos, sinh.

Counterpart of ``arrow_tpu/ops/trigonometry.py``, in plain PyTorch.  Integer
inputs (u8/i8/u16/i16) return Float32 arrays: the Arrow value is converted
to float32 first.  Validity is cloned.
"""

from __future__ import annotations

import torch

from .. import dtypes as dt
from ..errors import OperationNotSupported
from .kernel import AV, dispatch, register, zero_tail

def _sinh(x):
    """sinh through float64, rounded once: torch's vectorised float32 sinh on
    the CPU overflows to inf from |x| = 88.7, where sinh is finite up to
    89.4, and is ~20 ulps off just below."""
    return torch.sinh(x.to(torch.float64)).to(x.dtype)


_FNS = {
    "sin": torch.sin,
    "cos": torch.cos,
    "acos": torch.acos,
    "sinh": _sinh,
}

#: input dtypes; integers produce FLOAT32 outputs
_DTYPES = {
    dt.ArrowType.FLOAT32,
    dt.ArrowType.FLOAT64,
    dt.ArrowType.UINT8,
    dt.ArrowType.UINT16,
    dt.ArrowType.INT8,
    dt.ArrowType.INT16,
}


def _out_dtype(src: dt.ArrowType) -> dt.ArrowType:
    return src if dt.is_float(src) else dt.ArrowType.FLOAT32


def _trig_meta(avs, params):
    return [(_out_dtype(avs[0].dtype), avs[0].length)]


def _make_kernels():
    for name, fn in _FNS.items():

        def _impl(a: AV, _fn=fn) -> AV:
            x = a.data if dt.is_float(a.dtype) else dt.widen(a.data, a.dtype).to(torch.float32)
            return AV(zero_tail(_fn(x), a.length), a.validity, a.length, _out_dtype(a.dtype))

        register(f"trig_{name}", out_meta=_trig_meta)(_impl)


_make_kernels()


def _make_api(name):
    def fn(a, pipeline=None):
        if a.dtype not in _DTYPES:
            raise OperationNotSupported(f"{name} not supported for {a.dtype.value}")
        return dispatch(f"trig_{name}", [a], pipeline=pipeline)

    return fn


for _name in _FNS:
    _fn = _make_api(_name)
    globals()[_name] = _fn
    globals()[f"{_name}_op"] = lambda a, pipeline, _f=_fn: _f(a, pipeline)
    globals()[f"{_name}_dyn"] = _fn
    globals()[f"{_name}_op_dyn"] = lambda a, pipeline, _f=_fn: _f(a, pipeline)

__all__ = [f"{n}{s}" for n in _FNS for s in ("", "_op", "_dyn", "_op_dyn")]
