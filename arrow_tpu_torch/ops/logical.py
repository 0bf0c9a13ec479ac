"""Logical kernels: bitwise and/or/xor/not, shl/shr, any/all reductions.

Counterpart of ``arrow_tpu/ops/logical.py``, in plain PyTorch.

- Integer dtypes: torch bitwise ops on the storage (the bits are the same
  under either signedness).
- Boolean arrays: the ops run on the packed int32 words, 32 rows a word;
  ``not`` re-masks the tail so that bits past the length stay zero.
- Shifts take a UInt32Array of amounts, WGSL style: the value is widened to
  32 bits, shifted by ``amount & 31`` and truncated back to its width (64-bit
  values shift by ``amount & 63``).  Right shifts are arithmetic for signed
  types and logical for unsigned ones: values up to 32 bits are widened to
  int64 first (zero-extended when unsigned), and a u64's sign-extended bits
  are masked off, since torch's ``>>`` is arithmetic on the signed storage.
- ``any_``/``all_`` return host bools: any value word nonzero; popcount of
  the value words == length.  Nulls are not consulted.
"""

from __future__ import annotations

import torch

from .. import dtypes as dt
from ..errors import OperationNotSupported
from ..utils import bits as B
from .kernel import AV, dispatch, merged_validity, register, zero_tail

_INT_DTYPES = {
    dt.ArrowType.UINT8,
    dt.ArrowType.UINT16,
    dt.ArrowType.UINT32,
    dt.ArrowType.UINT64,
    dt.ArrowType.INT8,
    dt.ArrowType.INT16,
    dt.ArrowType.INT32,
    dt.ArrowType.INT64,
}

_LOGICAL_DTYPES = _INT_DTYPES | {dt.ArrowType.BOOL}

_BIN_FNS = {
    "bitwise_and": torch.bitwise_and,
    "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
}


def _make_kernels():
    for name, fn in _BIN_FNS.items():

        def _impl(a: AV, b: AV, _fn=fn) -> AV:
            # BOOL: packed words combine bitwise; tail bits stay 0 (0 op 0 = 0)
            return AV(_fn(a.data, b.data), merged_validity(a, b), a.length, a.dtype)

        register(name)(_impl)


_make_kernels()


@register("bitwise_not")
def _not_impl(a: AV) -> AV:
    if a.dtype is dt.ArrowType.BOOL:
        out = B.mask_tail(~a.data, a.length)
    else:
        out = zero_tail(~a.data, a.length)
    return AV(out, a.validity, a.length, a.dtype)


def _shift_impl_factory(left: bool):
    def _impl(a: AV, amt: AV) -> AV:
        width = dt.bit_width(a.dtype)
        amount = dt.widen(amt.data, dt.ArrowType.UINT32) & (63 if width == 64 else 31)
        if width < 64:
            x = dt.widen(a.data, a.dtype)  # exact in int64 whatever the shift
            out = dt.narrow((x << amount) if left else (x >> amount), a.dtype)
        elif left:
            out = a.data << amount
        else:
            out = a.data >> amount
            if dt.is_unsigned(a.dtype):  # clear the bits the sign filled in
                out = out & ~((torch.full_like(out, -1) << (63 - amount)) << 1)
        return AV(zero_tail(out, a.length), merged_validity(a, amt), a.length, a.dtype)

    return _impl


register("bitwise_shl")(_shift_impl_factory(left=True))
register("bitwise_shr")(_shift_impl_factory(left=False))


# ---------------------------------------------------------------------------
# API
# ---------------------------------------------------------------------------


def _check(op, *arrays, allowed=_LOGICAL_DTYPES):
    for a in arrays:
        if a.dtype not in allowed:
            raise OperationNotSupported(f"{op} not supported for {a.dtype.value}")


def _make_api(name):
    def fn(a, b, pipeline=None):
        _check(name, a, b)
        if a.dtype is not b.dtype:
            raise OperationNotSupported(f"{name} requires matching dtypes")
        return dispatch(name, [a, b], pipeline=pipeline)

    return fn


__all__ = ["and_", "or_", "xor", "not_", "any_", "all_"]

for _name in _BIN_FNS:
    _fn = _make_api(_name)
    globals()[_name] = _fn
    globals()[f"{_name}_op"] = lambda a, b, pipeline, _f=_fn: _f(a, b, pipeline)
    globals()[f"{_name}_dyn"] = _fn
    globals()[f"{_name}_op_dyn"] = lambda a, b, pipeline, _f=_fn: _f(a, b, pipeline)

# operator-style aliases
and_ = globals()["bitwise_and"]
or_ = globals()["bitwise_or"]
xor = globals()["bitwise_xor"]


def bitwise_not(a, pipeline=None):
    _check("bitwise_not", a)
    return dispatch("bitwise_not", [a], pipeline=pipeline)


def bitwise_not_op(a, pipeline):
    return bitwise_not(a, pipeline)


bitwise_not_dyn = bitwise_not
bitwise_not_op_dyn = bitwise_not_op
not_ = bitwise_not


def _shift(name, a, amount, pipeline):
    _check(name, a, allowed=_INT_DTYPES)
    if amount.dtype is not dt.ArrowType.UINT32:
        raise OperationNotSupported("shift amounts must be a UInt32Array")
    return dispatch(name, [a, amount], pipeline=pipeline)


def bitwise_shl(a, amount, pipeline=None):
    return _shift("bitwise_shl", a, amount, pipeline)


def bitwise_shr(a, amount, pipeline=None):
    return _shift("bitwise_shr", a, amount, pipeline)


def bitwise_shl_op(a, amount, pipeline):
    return bitwise_shl(a, amount, pipeline)


def bitwise_shr_op(a, amount, pipeline):
    return bitwise_shr(a, amount, pipeline)


bitwise_shl_dyn = bitwise_shl
bitwise_shr_dyn = bitwise_shr
bitwise_shl_op_dyn = bitwise_shl_op
bitwise_shr_op_dyn = bitwise_shr_op

__all__ += [
    f"{n}{s}"
    for n in (*_BIN_FNS, "bitwise_not", "bitwise_shl", "bitwise_shr")
    for s in ("", "_op", "_dyn", "_op_dyn")
]


# -- reductions (host results) --


def any_(arr) -> bool:
    """True if any value bit is set (nulls NOT consulted)."""
    if arr.dtype is not dt.ArrowType.BOOL:
        raise OperationNotSupported("any requires a BooleanArray")
    return bool(torch.any(arr.data != 0))


def all_(arr) -> bool:
    """True if all `len` value bits are set (popcount == len)."""
    if arr.dtype is not dt.ArrowType.BOOL:
        raise OperationNotSupported("all requires a BooleanArray")
    return int(B.popcount_words(arr.data)) == arr.length
