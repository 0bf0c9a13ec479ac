"""Sort operators: stable sort / argsort / sort_by_key / lex_sort.

Counterpart of ``arrow_tpu/compute/sort.py``.  Routes (``method=``):

- "xla": one stable ``torch.sort`` of an integer code of the key (it stands
  where the JAX package has ``lax.sort``), then a gather;
- "radix": kernel B3 (B4 under ``ARROW_TPU_RADIX_R=4``, see
  ``kernels/radix.py``): the key code and every payload plane ride the sort,
  over the significant digits of the logical prefix only;
- "merge": kernel B7 through ``sort_kv``: (key code, row id) in
  unique-payload mode, then a gather.  32-bit non-null ascending keys only;
- "auto": radix for a non-null radix key on a CUDA tensor whose buffer holds
  at least ``RADIX_AUTO_ROWS`` rows; merge under ``ARROW_TPU_FORCE_MERGE=1``;
  else xla.  ``ARROW_TPU_SORT=radix|xla`` forces radix or keeps it off, as
  in the JAX package.

Every route sorts the same unsigned-order code (:func:`key_code`).  Float
keys get one canonical code for +0 and -0 and the largest code for every
NaN, so the order never depends on the route or the device: it is the JAX
package's default-route order (its radix route puts -0 before +0 and its
merge route also puts -NaN first).  Nulls sort last in both directions,
stably.  Only the logical prefix is sorted; outputs keep the input's
capacity, with zeros past the length.
"""

from __future__ import annotations

import os
from typing import List, Optional, Union

import torch

from .. import dtypes as dt
from ..array.array import ArrowArrayBase, make_array
from ..errors import OperationNotSupported
from ..ops.swizzle import take_rows
from ..table import RecordBatch
from ..utils import bits as B
from . import kernels as CK

_A = dt.ArrowType
_SORTABLE = {
    _A.UINT8, _A.UINT16, _A.UINT32, _A.UINT64, _A.INT8, _A.INT16, _A.INT32, _A.INT64,
    _A.FLOAT32, _A.FLOAT64, _A.DATE32,
}
_RADIX_KEY_DTYPES = {_A.UINT32, _A.INT32, _A.FLOAT32, _A.DATE32, _A.UINT64, _A.INT64}
_MERGE_KEY_DTYPES = {_A.UINT32, _A.INT32, _A.FLOAT32, _A.DATE32}
METHODS = ("auto", "xla", "radix", "merge")
#: "auto" takes the radix route on CUDA from this buffer length on (the JAX
#: package's gate; the H100 crossover is measured by chip_smoke.py)
RADIX_AUTO_ROWS = 1 << 26


def _sign(code: torch.Tensor) -> int:
    return -(1 << (8 * code.element_size() - 1))


def key_code(data: torch.Tensor, dtype: _A, descending: bool = False) -> torch.Tensor:
    """The unsigned-order code of keys: int32 bits for keys of up to 32
    bits, int64 bits for 64-bit keys; read as unsigned, the code orders the
    keys ascending (descending with `descending`).  Floats: +0 and -0 share
    a code, every NaN takes the largest (all ones) in both directions."""
    info = dt.info(dtype)
    if info.is_float:
        y = data.view(torch.int32 if info.item_size == 4 else torch.int64)
        y = torch.where(data == 0, torch.zeros_like(y), y)  # -0 -> +0
        enc = torch.where(y < 0, ~y, y | _sign(y))
        if descending:
            enc = ~enc
        return torch.where(torch.isnan(data), torch.full_like(enc, -1), enc)
    if info.item_size < 4:
        enc = dt.widen(data, dtype).to(torch.int32)
        if info.is_signed:
            enc = enc ^ _sign(enc)
    elif info.is_unsigned:
        enc = data
    else:
        enc = data ^ _sign(data)
    return ~enc if descending else enc


def _decode(code: torch.Tensor, dtype: _A, descending: bool, length: int) -> torch.Tensor:
    """Inverse of :func:`key_code` for 32/64-bit integer keys; zeros from
    `length` on."""
    enc = ~code if descending else code
    out = enc if dt.is_unsigned(dtype) else enc ^ _sign(enc)
    out[length:] = 0
    return out


def _perm_xla(a: ArrowArrayBase, descending: bool) -> torch.Tensor:
    """Stable permutation of the logical prefix, nulls last: torch.sort of
    the signed-order code (packed with the null rank for 32-bit codes)."""
    n = a.length
    code = key_code(a.data[:n], a.dtype, descending)
    if a.validity is None:
        return torch.sort(code ^ _sign(code), stable=True).indices
    valid = B.unpack_bits(a.validity, n)
    if code.element_size() == 4:
        packed = torch.where(valid, code.to(torch.int64) & 0xFFFFFFFF, 1 << 32)
        return torch.sort(packed, stable=True).indices
    perm = torch.sort(torch.where(valid, code ^ _sign(code), 0), stable=True).indices
    return perm[torch.sort((~valid)[perm].to(torch.int32), stable=True).indices]


def _perm_merge(a: ArrowArrayBase) -> torch.Tensor:
    """Stable permutation of a non-null 32-bit key by kernel B7: sort_kv of
    (code, row id) in unique-payload mode."""
    n = a.length
    code = key_code(a.data[:n], a.dtype)
    rows = torch.arange(n, dtype=torch.int32, device=code.device)
    _, (order,) = CK.sort_kv(code ^ _sign(code), (rows,), unique_payload=True)
    return order.to(torch.int64)


def _padded(perm: torch.Tensor, cap: int) -> torch.Tensor:
    out = torch.zeros(cap, dtype=torch.int64, device=perm.device)
    out[: perm.shape[0]] = perm
    return out


def _take(col: ArrowArrayBase, perm: torch.Tensor) -> ArrowArrayBase:
    cap = col.data.shape[0] * (B.WORD_BITS if col.dtype is _A.BOOL else 1)
    return take_rows(col, _padded(perm, cap), col.length)


def _perm_array(perm: torch.Tensor, like: ArrowArrayBase) -> ArrowArrayBase:
    data = _padded(perm, like.data.shape[0]).to(torch.int32)
    return make_array(data, None, like.length, _A.UINT32, like.device)


# ---- kernel B3 route -------------------------------------------------------


def _radix_eligible(keys: ArrowArrayBase, payload_cols) -> bool:
    if keys.dtype not in _RADIX_KEY_DTYPES or keys.validity is not None:
        return False
    nplanes = 1 + dt.is_float(keys.dtype)
    for c in payload_cols:
        if len(c) != len(keys):
            return False
        nplanes += 1 + (c.validity is not None)
    return nplanes <= CK.radix.MAX_PLANES


def _radix_auto(keys: ArrowArrayBase) -> bool:
    forced = os.environ.get("ARROW_TPU_SORT")
    if forced == "radix":
        return True
    if forced == "xla":
        return False
    return keys.data.is_cuda and keys.data.shape[0] >= RADIX_AUTO_ROWS


def _sort_radix(keys: ArrowArrayBase, payload_cols, descending: bool = False):
    """Kernel B3/B4 over the logical prefix: plane 0 the key code, then the
    raw float key (the code is not invertible there), then each payload
    column's data plane (bool unpacked, 8/16-bit widened to int32) and its
    unpacked validity plane.  Returns (sorted keys, [sorted columns])."""
    n = keys.length
    code = key_code(keys.data, keys.dtype, descending)
    is_float = dt.is_float(keys.dtype)
    planes = [code, keys.data] if is_float else [code]
    for c in payload_cols:
        if c.dtype is _A.BOOL:
            planes.append(B.unpack_bits(c.data).to(torch.int32))
        else:
            planes.append(c.data if c.data.element_size() >= 4 else c.data.to(torch.int32))
        if c.validity is not None:
            planes.append(B.unpack_bits(c.validity).to(torch.int32))
    out = iter(CK.radix_sort(planes, 8 * code.element_size(), n))
    kcode = next(out)
    key = next(out) if is_float else _decode(kcode, keys.dtype, descending, n)
    cols = []
    for c in payload_cols:
        d = next(out)
        if c.dtype is _A.BOOL:
            d = B.pack_bits(d != 0)
        elif d.dtype != c.data.dtype:
            d = d.to(c.data.dtype)
        v = B.pack_bits(next(out) != 0) if c.validity is not None else None
        cols.append(make_array(d, v, c.length, c.dtype, c.device))
    return make_array(key, None, n, keys.dtype, keys.device), cols


# ---- kernel B7 route -------------------------------------------------------


def _merge_eligible(keys: ArrowArrayBase, descending: bool, force: bool = False) -> bool:
    if descending or keys.validity is not None or keys.dtype not in _MERGE_KEY_DTYPES:
        return False
    return force or os.environ.get("ARROW_TPU_FORCE_MERGE") == "1"


def _check(a: ArrowArrayBase, method: str = "auto") -> None:
    if a.dtype not in _SORTABLE:
        raise OperationNotSupported(f"sort not supported for {a.dtype.value}")
    if method not in METHODS:
        raise OperationNotSupported(f"unknown sort method {method!r}")


def argsort(a: ArrowArrayBase, descending: bool = False) -> ArrowArrayBase:
    """Stable permutation (UInt32Array) sorting `a` (nulls last)."""
    _check(a)
    perm = _perm_merge(a) if _merge_eligible(a, descending) else _perm_xla(a, descending)
    return _perm_array(perm, a)


def sort(a: ArrowArrayBase, descending: bool = False, method: str = "auto") -> ArrowArrayBase:
    """Stable sort of one column, nulls last (see the module note on
    `method`)."""
    _check(a, method)
    radix_ok = _radix_eligible(a, [])
    if method == "radix" and not radix_ok:
        raise OperationNotSupported("radix sort requires a non-null u32/i32/f32/date32/u64/i64 key")
    if radix_ok and (method == "radix" or (method == "auto" and _radix_auto(a))):
        return _sort_radix(a, [], descending)[0]
    if method == "merge" and not _merge_eligible(a, descending, force=True):
        raise OperationNotSupported("merge sort requires a 32-bit non-null ascending key")
    if method in ("auto", "merge") and _merge_eligible(a, descending, force=method == "merge"):
        return _take(a, _perm_merge(a))
    return _take(a, _perm_xla(a, descending))


def _payload_cols(payload) -> List[ArrowArrayBase]:
    if isinstance(payload, RecordBatch):
        return list(payload.columns().values())
    return [payload] if payload is not None else []


def _rebuild(payload, cols):
    if payload is None:
        return None
    if isinstance(payload, RecordBatch):
        return RecordBatch(dict(zip(payload.columns().keys(), cols)))
    return cols[0]


def sort_by_key(
    keys: ArrowArrayBase,
    payload: Union[ArrowArrayBase, RecordBatch, None] = None,
    descending: bool = False,
    method: str = "auto",
):
    """Stable key + payload sort.  Returns (sorted_keys, sorted_payload):
    the payload a column, a RecordBatch of columns, or None."""
    _check(keys, method)
    pcols = _payload_cols(payload)
    if _radix_eligible(keys, pcols) and (
        method == "radix" or (method == "auto" and _radix_auto(keys))
    ):
        ok, outs = _sort_radix(keys, pcols, descending)
        return ok, _rebuild(payload, outs)
    if method == "radix":
        raise OperationNotSupported(
            "radix sort requires a non-null u32/i32/f32/date32/u64/i64 key and at most "
            f"{CK.radix.MAX_PLANES} planes across key and payload columns"
        )
    merge_ok = _merge_eligible(keys, descending, force=method == "merge") and all(
        len(c) == len(keys) for c in pcols
    )
    if method == "merge" and not merge_ok:
        raise OperationNotSupported(
            "merge sort requires a 32-bit non-null ascending key and equal-length payload columns"
        )
    if payload is None and not merge_ok:
        return sort(keys, descending), None
    perm = _perm_merge(keys) if merge_ok else _perm_xla(keys, descending)
    return _take(keys, perm), _rebuild(payload, [_take(c, perm) for c in pcols])


def lex_sort(
    keys: "list[ArrowArrayBase]",
    payload: Union[ArrowArrayBase, RecordBatch, None] = None,
    descending: bool = False,
):
    """Lexicographic multi-key stable sort (first key most significant):
    one stable torch.sort per key, least significant first.  Returns
    (sorted keys, sorted payload or None, order)."""
    if not keys:
        raise OperationNotSupported("lex_sort needs at least one key column")
    for k in keys:
        if k.dtype not in _SORTABLE or k.validity is not None:
            raise OperationNotSupported("lex_sort keys must be non-null primitives")
    n = keys[0].length
    perm = torch.arange(n, device=keys[0].data.device)
    for k in reversed(keys):
        code = key_code(k.data[:n], k.dtype, descending)
        perm = perm[torch.sort((code ^ _sign(code))[perm], stable=True).indices]
    order = _perm_array(perm, keys[0])
    sorted_keys = [_take(k, perm) for k in keys]
    if payload is None:
        return sorted_keys, None, order
    return sorted_keys, _rebuild(payload, [_take(c, perm) for c in _payload_cols(payload)]), order


def sortable_limbs(keys: torch.Tensor, dtype: _A) -> List[torch.Tensor]:
    """int32 limbs, most significant first, whose signed orders compose
    lexicographically to the Arrow order of integer `keys` (the merge
    route's keys; 64-bit keys give two)."""
    if dt.item_size(dtype) == 8:
        hi = (keys >> 32).to(torch.int32)
        lo = B.to_int32(keys & 0xFFFFFFFF) ^ -(1 << 31)
        return [hi ^ -(1 << 31) if dt.is_unsigned(dtype) else hi, lo]
    code = key_code(keys, dtype)
    return [code ^ _sign(code)]


__all__ = ["argsort", "key_code", "lex_sort", "sort", "sort_by_key", "sortable_limbs"]
