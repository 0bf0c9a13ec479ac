"""Hash aggregate: GROUP BY key with SUM / COUNT / MIN / MAX / MEAN.

Counterpart of ``arrow_tpu/compute/hash_aggregate.py``.  Four routes, tried
in this order under ``method="auto"``, as in the JAX package:

- **mxu**: keys in [0, 4096), sum/count/mean of non-negative integer
  columns of at most 64 bits, no nulls, each column's logical rows x its
  largest value below 2^63 (so its sums are exact in int64).  One
  dense-table kernel launch per value column (kernel B5,
  ``kernels/groupby_mxu.py``; a 64-bit column stays 64-bit); the groups are
  the occupied slots.
- **partition**: the mxu route's columns of at most 32 bits, over keys in
  [0, 2^22) with a key of at least 4096.  The rows are grouped by class
  (``key >> 12``) by a radix sort over the class bits (kernel B3), then one
  region-table launch per value column (kernel B6,
  ``kernels/groupby_region.py``).
- **radix**: no nulls, a full buffer, 32-bit keys and values, on any device.
  A radix sort over the keys' significant bits (B3) carrying the value
  planes replaces the sort route's sort; steps 2-3 below follow.  Under
  ``auto`` it also needs a buffer long enough for
  ``compute.sort.radix_pays``, the row gate of every radix route (2^26 rows,
  the JAX package's gate).  The JAX package also sends keys of more than 28
  significant bits to the sort route; on the H100 the radix route wins at 31
  bits too (``chip_smoke.py``'s groupby phase: 39.1 against 49.5 ms at 2^27
  rows), so the port has no bit gate.
- **sort**, any keys, values and nulls (``groupby_core``):

  1. one stable sort by (valid-key rank, key), then a gather of every value
     plane and validity plane by the permutation;
  2. group starts by neighbour compare; each aggregate as a segmented scan
     (kernel B2) that restarts at the group starts, so a group's result sits
     at its last row;
  3. the group-end rows of (key, results) compacted to the front (kernel B1).

Groups come out in ascending key order, and the output never depends on the
route.  Rows with a null key are dropped; null values are skipped by
sum/min/max/mean and not counted by count.  The range checks of the mxu and
partition routes read the logical rows in one reduction per column and one
host read, with the unsigned types read as unsigned (a u32 of 2^31 or more
is stored negative); a ``key_domain`` guarantee skips them.

Under a profiler each call is an ``att.groupby`` span, each route tried an
``att.groupby.route.<name>`` span within it, and each phase of a route a span
of its own (``runtime.profiler.span``): ``range_check``, ``dense_kernel``,
``class_sort`` and ``dense_result`` on the dense routes; ``prepare``,
``order``, ``gather``, ``scan`` and ``compact`` on the sort and radix routes.
Each host wait is an ``att.sync.<cause>`` span: ``range_check``,
``dense_groups`` (the occupied slots' ``nonzero``), ``num_groups``, and
``last_segment_end`` (``segment_ends``' flag set from a Python scalar, which
torch copies from the host and waits for).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch

from .. import dtypes as dt
from ..array.array import ArrowArrayBase, make_array, pad_len
from ..errors import OperationNotSupported
from ..runtime.profiler import host_read, span
from ..table import RecordBatch
from ..utils import bits as B
from ..utils.scans import compact_rows, segment_ends, segmented_scan
from . import kernels as CK
from .kernels.groupby_mxu import SLOTS, nlimbs_for_bits
from .kernels.radix import MAX_PLANES as RADIX_MAX_PLANES
from .sort import radix_pays

AGG_KINDS = ("sum", "count", "min", "max", "mean")
_A = dt.ArrowType
PARTITION_MAX_BITS = 22  # the partition route's key domain: at most 2^22


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
    presorted: bool = False,
):
    """Sort + segmented-scan group-by.

    key_data: (n,) storage keys of `key_type`; kvalid: (n,) bool valid-key
    mask; val_entries: (values, valid bools) for each non-count_all entry of
    agg_spec, a list of (agg, value type).  dense: every row of every buffer
    is valid, so the sort drops the rank key and the validity planes.  presorted
    (with dense): the caller already ordered the key and value planes by key
    (the radix route), so there is no sort.
    Returns (num_groups tensor, out_keys, [out_agg...]) with capacity n,
    groups at the front in ascending key order, zeros after them.
    """
    n = key_data.shape[0]
    device = key_data.device
    if dense:
        perm = None
        if not presorted:
            with span("att.groupby.order"):
                perm = _sort_perm(key_data, key_type, None)
        with span("att.groupby.gather"):
            in_group = torch.ones(n, dtype=torch.bool, device=device)
            skey = key_data if perm is None else key_data[perm]
            sorted_vals = [(v if perm is None else v[perm], in_group) for v, _ in val_entries]
    else:
        with span("att.groupby.order"):
            perm = _sort_perm(key_data, key_type, kvalid)
        with span("att.groupby.gather"):
            skey = key_data[perm]
            in_group = kvalid[perm]
            sorted_vals = [(v[perm], ok[perm] & in_group) for v, ok in val_entries]

    with span("att.groupby.scan"):
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

    with span("att.groupby.compact"):
        parts = compact_rows(ends, [skey, *results])
        out_aggs = [p if t is None else p.to(t) for p, t in zip(parts[1:], post)]
    return num_groups, parts[0], out_aggs


def _value_columns(aggregations) -> list:
    """The distinct value columns of `aggregations`, in first-use order."""
    cols, seen = [], set()
    for _name, col, _kind in aggregations:
        if col is not None and id(col) not in seen:
            seen.add(id(col))
            cols.append(col)
    return cols


def _dense_eligible(keys: ArrowArrayBase, aggregations, value_bytes: int) -> bool:
    """Whether a dense route may take the query (the ranges are checked
    later): integer keys without nulls; sum, count and mean of integer
    columns of at most `value_bytes` bytes (the mxu route 8, the partition
    route 4) without nulls.  The JAX package's ``_mxu_path_eligible`` also
    asks for a multiple of 8192 rows, its pad unit, and 32-bit values; the
    port's kernels take any length."""
    if keys.validity is not None or not dt.is_integer(keys.dtype):
        return False
    for _name, col, kind in aggregations:
        if kind not in ("sum", "count", "mean"):
            return False
        if col is not None and (
            col.validity is not None
            or not dt.is_integer(col.dtype)
            or dt.item_size(col.dtype) > value_bytes
            or len(col) != len(keys)
        ):
            return False
    return True


def _range_check(keys: ArrowArrayBase, cols) -> Tuple[int, int, List[int], List[int]]:
    """(key min, key max, value maxima, value minima) over the logical rows:
    one min/max reduction of each column's storage, one host read.

    Unsigned types are stored as signed bit patterns, so a stored minimum
    below 0 means a value with the top bit set: the column's maximum is then
    taken as the type's (a key past every dense domain, a value of the
    type's full width, so the same limbs) and its minimum as 0; otherwise
    the stored minimum and maximum are the values'."""
    n = keys.length
    if n == 0:
        return 0, 0, [0] * len(cols), [0] * len(cols)
    arrays = (keys, *cols)
    with span("att.groupby.range_check"):
        stats = torch.stack([torch.stack(torch.aminmax(a.data[:n])).to(torch.int64) for a in arrays])
        with host_read("range_check"):
            stats = stats.tolist()
    ranges = []
    for a, (lo, hi) in zip(arrays, stats):
        info = dt.info(a.dtype)
        if info.is_unsigned and lo < 0:
            lo, hi = 0, (1 << info.bit_width) - 1
        ranges.append((lo, hi))
    (kmin, kmax), vals = ranges[0], ranges[1:]
    return kmin, kmax, [hi for _lo, hi in vals], [lo for lo, _hi in vals]


def _value_limits(cols, key_domain, value_bits, ranges, fits, rows):
    """(largest key, value maxima) when the keys are non-negative, the
    largest one `fits` the route, the values are non-negative and `rows`
    times each column's largest value is below 2^63 (its sums exact in
    int64); else None.  key_domain=(lo, hi) is the caller's guarantee of
    keys in [lo, hi) and non-negative values below 2^value_bits (default:
    the column's own width, at least 32, so a 64-bit column without
    value_bits declines)."""
    if key_domain is not None:
        lo, hi = key_domain
        kmax = hi - 1
        vmaxes = [(1 << (value_bits or max(32, 8 * dt.item_size(c.dtype)))) - 1 for c in cols]
        if lo < 0 or not fits(kmax):
            return None
    else:
        kmin, kmax, vmaxes, vmins = ranges()
        if kmin < 0 or not fits(kmax) or any(v < 0 for v in vmins):
            return None
    if any(rows * v >= 1 << 63 for v in vmaxes):
        return None
    return kmax, vmaxes


def _int32_plane(arr: ArrowArrayBase, n: int) -> torch.Tensor:
    """The first n rows of an integer column as the int32 plane the dense
    kernels take (32-bit storage as it is; other widths through int64)."""
    data = arr.data[:n]
    return data if data.dtype == torch.int32 else dt.widen(data, arr.dtype).to(torch.int32)


def _value_plane(arr: ArrowArrayBase, n: int) -> torch.Tensor:
    """The first n rows of a value column as B5 takes them: 64-bit storage as
    it is, the rest as :func:`_int32_plane`."""
    data = arr.data[:n]
    return data if data.element_size() == 8 else _int32_plane(arr, n)


def _nlimb(vmax: int) -> int:
    return nlimbs_for_bits(max(vmax, 1).bit_length())


def _dense_result(keys: ArrowArrayBase, aggregations, count, sums, domain: int) -> RecordBatch:
    """The groups of dense (count, sum) tables over [0, domain): the
    occupied slots in ascending key order, in buffers of pad_len(domain)
    rows that are zero past the groups."""
    with span("att.groupby.dense_result"):
        with host_read("dense_groups"):
            order = torch.nonzero(count > 0).flatten()
        ng = int(order.shape[0])
        cap = pad_len(domain)
        device = keys.data.device

        def wrap(values: torch.Tensor, dtype: _A):
            buf = torch.zeros(cap, dtype=dt.info(dtype).torch, device=device)
            buf[:ng] = dt.narrow(values, dtype)
            return make_array(buf, None, ng, dtype, keys.device)

        cnt = count[order].to(torch.int64)
        cols = {"key": wrap(order, keys.dtype)}
        for name, col, kind in aggregations:
            if kind == "count":
                cols[name] = wrap(cnt, _A.INT64)
            elif kind == "mean":
                mean = sums[id(col)][order].to(torch.float64) / cnt.clamp(min=1).to(torch.float64)
                cols[name] = wrap(mean, _A.FLOAT64)
            else:
                cols[name] = wrap(sums[id(col)][order], col.dtype)
        return RecordBatch(cols)


def _hash_aggregate_mxu(keys, aggregations, key_domain, value_bits, ranges):
    """Keys in [0, 4096): one B5 launch per value column.  None when the
    ranges disqualify the route."""
    cols = _value_columns(aggregations)
    n = keys.length
    limits = _value_limits(cols, key_domain, value_bits, ranges, lambda k: k < SLOTS, n)
    if limits is None:
        return None
    with span("att.groupby.dense_kernel"):
        kp = _int32_plane(keys, n)
        count, sums = None, {}
        for col, vmax in zip(cols, limits[1]):
            c, sums[id(col)] = CK.groupby_dense(kp, _value_plane(col, n), _nlimb(vmax), n)
            count = c if count is None else count
        if count is None:  # count(*) alone: any value plane will do
            count, _ = CK.groupby_dense(kp, kp, 1, n)
    return _dense_result(keys, aggregations, count, sums, SLOTS)


def _hash_aggregate_partition(keys, aggregations, key_domain, value_bits, ranges):
    """Keys in [0, 2^22), the largest at least 4096: the rows grouped by
    class (key >> 12) by a radix sort over the class bits (B3), then one B6
    launch per value column.  None when the ranges disqualify the route.

    The JAX package splits by class on its radix chain on the TPU and on an
    XLA ladder of binary splits elsewhere (``_partition_by_class``); the
    port sorts on B3 on every device.  It sorts the logical rows only, so it
    needs no garbage class for padded rows."""
    cols = _value_columns(aggregations)
    if 1 + len(cols) > RADIX_MAX_PLANES:
        return None
    n = keys.length
    limits = _value_limits(
        cols, key_domain, value_bits, ranges, lambda k: SLOTS <= k < 1 << PARTITION_MAX_BITS, n
    )
    if limits is None:
        return None
    kmax, vmaxes = limits
    dom_bits = max(kmax, 1).bit_length()
    nclass = (1 << dom_bits) // SLOTS
    class_bit = SLOTS.bit_length() - 1
    with span("att.groupby.class_sort"):
        planes = [_int32_plane(c, n) for c in (keys, *cols)]
        skey, *svals = (p[:n] for p in CK.radix_sort(planes, range(class_bit, dom_bits), n))
    with span("att.groupby.dense_kernel"):
        count, sums = None, {}
        for col, sv, vmax in zip(cols, svals, vmaxes):
            c, sums[id(col)] = CK.groupby_region(skey, sv, _nlimb(vmax), nclass)
            count = c if count is None else count
        if count is None:  # count(*) alone
            count, _ = CK.groupby_region(skey, skey, 1, nclass)
    return _dense_result(keys, aggregations, count, sums, 1 << dom_bits)


def _sorted_result(keys, aggregations, num_groups, out_keys, out_aggs) -> RecordBatch:
    """The sort and radix routes' groups as a RecordBatch."""
    with span("att.groupby.compact"), host_read("num_groups"):
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


def _hash_aggregate_radix(keys, aggregations, auto: bool):
    """The sort route with its sort on B3: a radix sort of the key's
    unsigned-order code over its significant bits, carrying the value
    planes.  None when the route does not apply: nulls, a padded buffer,
    keys or values not of 32 bits (the JAX package's gate lets 8- and 16-bit
    ones through to a bitcast that raises), more than 7 value columns; under
    ``auto`` also a buffer too short for ``radix_pays``."""
    n = int(keys.data.shape[0])
    if auto and not radix_pays(n):
        return None
    if keys.validity is not None or keys.length != n or dt.item_size(keys.dtype) != 4:
        return None
    agg_spec: List[Tuple[str, Optional[_A]]] = []
    entry_cols = []  # the value column of each non-count(*) aggregation
    for _name, col, kind in aggregations:
        if kind not in AGG_KINDS or (col is None and kind != "count"):
            return None
        if col is None:
            agg_spec.append(("count_all", None))
            continue
        if (
            len(col) != len(keys)
            or col.validity is not None
            or col.dtype is _A.BOOL
            or dt.item_size(col.dtype) != 4
        ):
            return None
        agg_spec.append((kind, col.dtype))
        entry_cols.append(col)
    cols = _value_columns(aggregations)  # each column rides the sort once
    if 1 + len(cols) > RADIX_MAX_PLANES:
        return None
    flip = dt.sign_bit(keys.dtype) if dt.info(keys.dtype).is_signed else 0
    with span("att.groupby.prepare"):
        code = keys.data ^ flip  # unsigned order == Arrow order
        every = torch.ones(n, dtype=torch.bool, device=code.device)
    with span("att.groupby.order"):
        scode, *svals = CK.radix_sort([code, *(c.data for c in cols)], 32, n)  # its significant bits
        skey = scode ^ flip
    sorted_by_col = {id(c): v for c, v in zip(cols, svals)}
    num_groups, out_keys, out_aggs = groupby_core(
        skey, keys.dtype, every, [(sorted_by_col[id(c)], every) for c in entry_cols],
        agg_spec, dense=True, presorted=True,
    )
    return _sorted_result(keys, aggregations, num_groups, out_keys, out_aggs)


def hash_aggregate(
    keys: ArrowArrayBase,
    aggregations: Sequence[Tuple[str, Optional[ArrowArrayBase], str]],
    method: str = "auto",
    key_domain: Optional[Tuple[int, int]] = None,
    value_bits: Optional[int] = None,
) -> RecordBatch:
    """GROUP BY `keys` computing `aggregations`: (out_name, value_column, kind).

    kind in {sum, count, min, max, mean}; value_column None + kind "count"
    counts rows per group.  Returns a RecordBatch with column "key" + one
    column per aggregation; group order = ascending key order.

    method: "mxu" (keys in [0, 4096), kernel B5), "partition" (keys in
    [0, 2^22), B3 then B6), "radix" (the sort route on B3), "sort", or
    "auto": the first of those four that takes the query (see the module
    note).  A route named explicitly that cannot take the query raises
    :class:`OperationNotSupported`.

    key_domain=(lo, hi): the caller's guarantee that the keys lie in
    [lo, hi) and the values are non-negative below 2^value_bits (default
    each column's width, at least 32); the mxu and partition routes then
    skip their range check and its host read.
    """
    if not dt.is_integer(keys.dtype):
        raise OperationNotSupported(f"group-by key dtype {keys.dtype.value} unsupported")
    if method not in ("auto", "sort", "mxu", "partition", "radix"):
        raise OperationNotSupported(f"unknown hash_aggregate method {method!r}")
    with span("att.groupby"):
        ranges = functools.cache(lambda: _range_check(keys, _value_columns(aggregations)))
        if method in ("auto", "mxu") and _dense_eligible(keys, aggregations, 8):
            with span("att.groupby.route.mxu"):
                out = _hash_aggregate_mxu(keys, aggregations, key_domain, value_bits, ranges)
            if out is not None:
                return out
        if method == "mxu":
            raise OperationNotSupported(
                "mxu groupby requires dense keys in [0, 4096), non-negative "
                "integer values, rows x the largest value below 2^63 and no nulls"
            )
        if method in ("auto", "partition") and _dense_eligible(keys, aggregations, 4):
            with span("att.groupby.route.partition"):
                out = _hash_aggregate_partition(keys, aggregations, key_domain, value_bits, ranges)
            if out is not None:
                return out
        if method == "partition":
            raise OperationNotSupported(
                "partition groupby requires dense keys in (4096, 2^22], "
                "non-negative integer values of at most 32 bits and no nulls"
            )
        if method in ("auto", "radix"):
            with span("att.groupby.route.radix"):
                out = _hash_aggregate_radix(keys, aggregations, auto=method == "auto")
            if out is not None:
                return out
        if method == "radix":
            raise OperationNotSupported(
                "radix groupby requires dense no-null full-buffer keys and "
                "values of 32 bits"
            )
        with span("att.groupby.route.sort"):
            return _hash_aggregate_sort(keys, aggregations)


def _hash_aggregate_sort(keys, aggregations) -> RecordBatch:
    """The sort route (``groupby_core``): any keys, values and nulls."""
    n = pad_len(keys.length)
    device = keys.data.device
    agg_spec: List[Tuple[str, Optional[_A]]] = []
    val_entries = []
    any_value_nulls = False
    with span("att.groupby.prepare"):
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
        kvalid = _valid_bools(keys.validity, keys.length, n, device)

    dense = keys.validity is None and keys.length == n and not any_value_nulls
    num_groups, out_keys, out_aggs = groupby_core(
        keys.data[:n], keys.dtype, kvalid, val_entries, agg_spec, dense=dense
    )
    return _sorted_result(keys, aggregations, num_groups, out_keys, out_aggs)
