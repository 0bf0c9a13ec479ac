"""Hash aggregate: GROUP BY key with SUM / COUNT / MIN / MAX / MEAN.

Counterpart of ``arrow_tpu/compute/hash_aggregate.py``, sort route only
(``groupby_core`` and ``hash_aggregate``):

  1. one stable sort by (valid-key rank, key), then a gather of every value
     plane and validity plane by the permutation;
  2. group starts by neighbour compare; each aggregate as a segmented scan
     (kernel B2) that restarts at the group starts, so a group's result sits
     at its last row;
  3. the group-end rows of (key, results) compacted to the front (kernel B1).

Under ``ARROW_TPU_FORCE_MERGE=1`` the sort of step 1 runs on kernel B7
(``groupby_core``'s ``merge_len`` branch), as in the JAX package.

Groups come out in ascending key order.  Rows with a null key are dropped;
null values are skipped by sum/min/max/mean and not counted by count.

The MXU, partition and radix routes are not ported yet: naming them raises
:class:`OperationNotSupported`.  The output never depends on the route.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch

from .. import dtypes as dt
from ..array.array import ArrowArrayBase, make_array, pad_len
from ..errors import OperationNotSupported
from ..table import RecordBatch
from ..utils import bits as B
from ..utils.scans import compact_rows, segment_ends, segmented_scan
from . import kernels as CK

AGG_KINDS = ("sum", "count", "min", "max", "mean")
_A = dt.ArrowType


def _valid_bools(validity: Optional[torch.Tensor], length: int, n: int, device) -> torch.Tensor:
    in_range = torch.arange(n, device=device) < length
    if validity is None:
        return in_range
    return B.unpack_bits(validity, n) & in_range


def _sort_perm(key: torch.Tensor, key_type: _A, kvalid: Optional[torch.Tensor]) -> torch.Tensor:
    """Stable permutation ordering rows by (rank, key): valid keys first, in
    Arrow key order.  kvalid None: every row is valid (the key alone)."""
    ordered = dt.order_key(key, key_type)  # signed order == Arrow order
    if kvalid is None:
        return torch.sort(ordered, stable=True).indices
    if dt.item_size(key_type) <= 4:  # one sort of (rank << 32) | key in [0, 2^32)
        packed = (ordered.to(torch.int64) + (1 << 31)) | ((~kvalid).to(torch.int64) << 32)
        return torch.sort(packed, stable=True).indices
    # 64-bit keys: two stable sorts, least significant key first
    perm = torch.sort(ordered, stable=True).indices
    rank = (~kvalid).to(torch.int32)[perm]
    return perm[torch.sort(rank, stable=True).indices]


def _acc_plane(svals: torch.Tensor, vtype: _A) -> Tuple[torch.Tensor, bool]:
    """The sum accumulator: f64 for floats, i64 for signed and u8..u32, u64
    bits (unsigned) for u64.  Returns (accumulator values, unsigned)."""
    if dt.is_float(vtype):
        return svals.to(torch.float64), False
    return dt.widen(svals, vtype), vtype is _A.UINT64


def groupby_core(
    key_data: torch.Tensor,
    key_type: _A,
    kvalid: torch.Tensor,
    val_entries: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    agg_spec: Sequence[Tuple[str, Optional[_A]]],
    dense: bool = False,
    merge_len: Optional[int] = None,
):
    """Sort + segmented-scan group-by.

    key_data: (n,) storage keys of `key_type`; kvalid: (n,) bool valid-key
    mask; val_entries: (values, valid bools) for each non-count_all entry of
    agg_spec, a list of (agg, value type).  dense: every row of every buffer
    is valid, so the sort drops the rank key and the validity planes.
    merge_len: the keys are non-null 32-bit and every row below merge_len is
    valid; the sort runs on kernel B7 (``sort_kv``) with each value plane (of
    at most 4 bytes) and its validity riding as 32-bit planes.
    Returns (num_groups tensor, out_keys, [out_agg...]) with capacity n,
    groups at the front in ascending key order, zeros after them.
    """
    n = key_data.shape[0]
    device = key_data.device
    if merge_len is not None:
        planes, small = [], []
        for v, ok in val_entries:
            small.append(v.dtype if v.element_size() < 4 else None)
            planes.append(v.to(torch.int32) if v.element_size() < 4 else v)
            planes.append(ok.to(torch.int32))
        skey, outs = CK.sort_kv(key_data, planes, merge_len, unsigned=dt.is_unsigned(key_type))
        in_group = torch.arange(n, device=device) < merge_len
        sorted_vals = [
            (sv if sd is None else sv.to(sd), (sf != 0) & in_group)
            for sd, sv, sf in zip(small, outs[::2], outs[1::2])
        ]
    elif dense:
        perm = _sort_perm(key_data, key_type, None)
        skey = key_data[perm]
        in_group = torch.ones(n, dtype=torch.bool, device=device)
        sorted_vals = [(v[perm], in_group) for v, _ in val_entries]
    else:
        perm = _sort_perm(key_data, key_type, kvalid)
        skey = key_data[perm]
        in_group = kvalid[perm]
        sorted_vals = [(v[perm], ok[perm] & in_group) for v, ok in val_entries]

    idx = torch.arange(n, device=device)
    starts = in_group & ((idx == 0) | (skey != torch.roll(skey, 1)))
    num_groups = starts.sum()
    ends = segment_ends(starts, in_group.sum())

    def scan(v, op, unsigned=False):
        return segmented_scan(v, starts, op, unsigned)

    def count(ok):  # int32 counts ride the 4-byte planes, widened at the end
        return scan(ok.to(torch.int32), "add")

    results, post = [], []
    vi = 0
    for agg, vtype in agg_spec:
        if agg == "count_all":
            results.append(count(in_group))
            post.append(torch.int64)
            continue
        svals, svalid = sorted_vals[vi]
        vi += 1
        if agg in ("sum", "mean"):
            acc, unsigned = _acc_plane(svals, vtype)
            ssum = scan(torch.where(svalid, acc, torch.zeros_like(acc)), "add", unsigned)
            if agg == "sum":
                results.append(dt.narrow(ssum, vtype))
            else:
                s = ssum.to(torch.float64) if dt.is_float(vtype) else dt.to_float64(
                    ssum, _A.UINT64 if unsigned else _A.INT64
                )
                results.append(s / count(svalid).clamp(min=1).to(torch.float64))
            post.append(None)
        elif agg == "count":
            results.append(count(svalid))
            post.append(torch.int64)
        elif agg in ("min", "max"):
            info = dt.info(vtype)
            small = info.item_size < 4  # 8/16-bit values scan as int32 values
            plane = dt.widen(svals, vtype).to(torch.int32) if small else svals
            unsigned = info.is_unsigned and not small
            if info.is_float:
                init = float("inf") if agg == "min" else float("-inf")
            elif unsigned:  # storage of the type's max (all ones) / min
                init = -1 if agg == "min" else 0
            elif info.is_unsigned:
                init = (1 << info.bit_width) - 1 if agg == "min" else 0
            else:
                init = (1 << (info.bit_width - 1)) - 1 if agg == "min" else -(1 << (info.bit_width - 1))
            contrib = torch.where(svalid, plane, torch.full_like(plane, init))
            res = scan(contrib, agg, unsigned)
            results.append(dt.narrow(res.to(torch.int64), vtype) if small else res)
            post.append(None)
        else:
            raise OperationNotSupported(f"unknown aggregation {agg!r}")

    parts = compact_rows(ends, [skey, *results])
    out_aggs = [p if t is None else p.to(t) for p, t in zip(parts[1:], post)]
    return num_groups, parts[0], out_aggs


def _merge_sort_ok(keys: ArrowArrayBase, value_cols) -> bool:
    """Whether the group-by sort rides kernel B7: opt-in through the JAX
    package's ``ARROW_TPU_FORCE_MERGE=1`` only, for non-null keys of 32-bit
    storage (u32/i32/date32) and value columns of at most 4 bytes."""
    if os.environ.get("ARROW_TPU_FORCE_MERGE") != "1":
        return False
    if keys.validity is not None or keys.data.dtype != torch.int32:
        return False
    return all(c is None or dt.item_size(c.dtype) <= 4 for c in value_cols)


def hash_aggregate(
    keys: ArrowArrayBase,
    aggregations: Sequence[Tuple[str, Optional[ArrowArrayBase], str]],
    method: str = "auto",
) -> RecordBatch:
    """GROUP BY `keys` computing `aggregations`: (out_name, value_column, kind).

    kind in {sum, count, min, max, mean}; value_column None + kind "count"
    counts rows per group.  Returns a RecordBatch with column "key" + one
    column per aggregation; group order = ascending key order.

    method: "auto" and "sort" run the sort route; "mxu", "partition" and
    "radix" are not ported yet and raise.
    """
    if not dt.is_integer(keys.dtype):
        raise OperationNotSupported(f"group-by key dtype {keys.dtype.value} unsupported")
    if method in ("mxu", "partition", "radix"):
        raise OperationNotSupported(f"hash_aggregate method {method!r}: not yet ported")
    if method not in ("auto", "sort"):
        raise OperationNotSupported(f"unknown hash_aggregate method {method!r}")
    n = pad_len(keys.length)
    device = keys.data.device
    agg_spec: List[Tuple[str, Optional[_A]]] = []
    val_entries = []
    any_value_nulls = False
    for _name, col, kind in aggregations:
        if kind not in AGG_KINDS:
            raise OperationNotSupported(f"unknown aggregation {kind!r}")
        if col is None:
            if kind != "count":
                raise OperationNotSupported("only count may omit the value column")
            agg_spec.append(("count_all", None))
            continue
        if len(col) != len(keys):
            raise OperationNotSupported("value column length mismatch")
        if col.dtype is _A.BOOL:
            raise OperationNotSupported("bool value columns unsupported")
        agg_spec.append((kind, col.dtype))
        val_entries.append(
            (col.data[:n], _valid_bools(col.validity, keys.length, n, device))
        )
        any_value_nulls |= col.validity is not None

    dense = keys.validity is None and keys.length == n and not any_value_nulls
    kvalid = _valid_bools(keys.validity, keys.length, n, device)
    use_merge = _merge_sort_ok(keys, [col for _n, col, _k in aggregations])
    num_groups, out_keys, out_aggs = groupby_core(
        keys.data[:n], keys.dtype, kvalid, val_entries, agg_spec, dense=dense,
        merge_len=keys.length if use_merge else None,
    )
    ng = int(num_groups)

    def wrap(buf, dtype):
        return make_array(buf, None, ng, dtype, keys.device)

    cols = {"key": wrap(out_keys, keys.dtype)}
    for (name, col, kind), buf in zip(aggregations, out_aggs):
        if kind == "count":
            cols[name] = wrap(buf, _A.INT64)
        elif kind == "mean":
            cols[name] = wrap(buf, _A.FLOAT64)
        else:
            cols[name] = wrap(buf, col.dtype)
    return RecordBatch(cols)
