"""Cast kernels: dtype conversions and bit reinterpretation.

Counterpart of ``arrow_tpu/ops/cast.py``, in plain PyTorch.

- int -> int: sign/zero extension or truncation (wrapping), computed on the
  Arrow value (``dtypes.widen``) and wrapped into the target width;
- int -> float: one rounding to nearest even, as numpy rounds; a u64 of 2^63
  or more (negative in its int64 storage) is halved with its lowest bit kept
  sticky, converted and doubled, which rounds the same;
- float -> int (WGSL ``u32(f)``/``i32(f)``): NaN -> 0, clip to the *32-bit*
  bounds of the target's signedness (also for 64-bit targets), truncate
  toward zero, then wrap to the target width: ``f32 -> u8`` is mod 256 after
  a saturating cast;
- bool -> numeric: 1/0 from the packed bits;
- bitcast between types of one width: the storage reinterpreted.

Validity is cloned through every cast.
"""

from __future__ import annotations

import torch

from .. import dtypes as dt
from ..errors import CastingNotSupported
from ..utils import bits as B
from .kernel import AV, dispatch, register


def _target_meta(avs, params):
    return [(params["to"], avs[0].length)]


def _int_to_float(x: torch.Tensor, src: dt.ArrowType, fdt: torch.dtype) -> torch.Tensor:
    if src is not dt.ArrowType.UINT64:
        return dt.widen(x, src).to(fdt)
    high = x < 0  # >= 2^63: halve with a sticky lowest bit, convert, double
    halved = ((x >> 1) & 0x7FFFFFFFFFFFFFFF) | (x & 1)
    return torch.where(high, halved.to(fdt) * 2, x.to(fdt))


@register("cast", out_meta=_target_meta)
def _cast_impl(a: AV, to: dt.ArrowType) -> AV:
    src, dst = a.dtype, to
    tdst = dt.info(dst).torch
    if src is dt.ArrowType.BOOL:
        out = B.unpack_bits(a.data).to(tdst)  # one row a bit; the tail bits are 0
    elif dt.is_float(src) and dt.is_integer(dst):
        x64 = torch.nan_to_num(a.data.to(torch.float64), nan=0.0, posinf=1e18, neginf=-1e18)
        lo, hi = (-2147483648.0, 2147483647.0) if dt.is_signed(dst) else (0.0, 4294967295.0)
        out = dt.narrow(torch.trunc(x64.clamp(lo, hi)).to(torch.int64), dst)
    elif dt.is_float(dst):
        out = a.data.to(tdst) if dt.is_float(src) else _int_to_float(a.data, src, tdst)
    else:
        out = dt.narrow(dt.widen(a.data, src), dst)
    return AV(out, a.validity, a.length, dst)


@register("bitcast", out_meta=_target_meta)
def _bitcast_impl(a: AV, to: dt.ArrowType) -> AV:
    if dt.bit_width(a.dtype) != dt.bit_width(to):
        raise CastingNotSupported(
            f"bitcast requires equal widths: {a.dtype.value} -> {to.value}"
        )
    return AV(a.data.view(dt.info(to).torch), a.validity, a.length, to)


# -- registered cast pairs: the reference's 22 + bool->f32, extended to the
#    full closure of numeric pairs (as the JAX package has them).
_A = dt.ArrowType
_REFERENCE_PAIRS = {
    (_A.INT8, _A.UINT8), (_A.INT8, _A.UINT16), (_A.INT8, _A.UINT32),
    (_A.INT8, _A.INT16), (_A.INT8, _A.INT32), (_A.INT8, _A.FLOAT32),
    (_A.INT16, _A.INT32), (_A.INT16, _A.UINT16), (_A.INT16, _A.UINT32),
    (_A.INT16, _A.FLOAT32),
    (_A.UINT8, _A.UINT16), (_A.UINT8, _A.UINT32), (_A.UINT8, _A.INT8),
    (_A.UINT8, _A.INT16), (_A.UINT8, _A.INT32), (_A.UINT8, _A.FLOAT32),
    (_A.UINT16, _A.UINT32), (_A.UINT16, _A.INT16), (_A.UINT16, _A.INT32),
    (_A.UINT16, _A.FLOAT32),
    (_A.FLOAT32, _A.UINT8),
    (_A.BOOL, _A.FLOAT32),
}

_NUMERIC = {
    _A.UINT8, _A.UINT16, _A.UINT32, _A.UINT64,
    _A.INT8, _A.INT16, _A.INT32, _A.INT64,
    _A.FLOAT32, _A.FLOAT64, _A.DATE32,
}


def _cast_supported(src: dt.ArrowType, dst: dt.ArrowType) -> bool:
    if (src, dst) in _REFERENCE_PAIRS:
        return True
    if src is _A.BOOL:
        return dst in _NUMERIC
    return src in _NUMERIC and dst in _NUMERIC


def cast(a, to, pipeline=None):
    """Cast `a` to dtype `to` (ArrowType or DataType)."""
    to = to.arrow if isinstance(to, dt.DataType) else to
    if not _cast_supported(a.dtype, to):
        raise CastingNotSupported(f"cast {a.dtype.value} -> {to.value} not supported")
    if a.dtype is to:
        return a.clone() if pipeline is None else a
    return dispatch("cast", [a], params={"to": to}, pipeline=pipeline)


def cast_op(a, to, pipeline):
    return cast(a, to, pipeline)


cast_dyn = cast
cast_op_dyn = cast_op


def bitcast(a, to, pipeline=None):
    to = to.arrow if isinstance(to, dt.DataType) else to
    if a.dtype is _A.BOOL or to is _A.BOOL:
        raise CastingNotSupported("bitcast involving bool not supported")
    if dt.bit_width(a.dtype) != dt.bit_width(to):
        raise CastingNotSupported(
            f"bitcast requires equal widths: {a.dtype.value} -> {to.value}"
        )
    if a.dtype is to:
        return a.clone() if pipeline is None else a
    return dispatch("bitcast", [a], params={"to": to}, pipeline=pipeline)


def bitcast_op(a, to, pipeline):
    return bitcast(a, to, pipeline)


bitcast_dyn = bitcast
bitcast_op_dyn = bitcast_op

__all__ = [f"{n}{s}" for n in ("cast", "bitcast") for s in ("", "_op", "_dyn", "_op_dyn")]
