"""Distributed operators over ShardedBatches: filter, aggregate, join, sort, sum.

Counterpart of ``arrow_tpu/parallel/distributed_ops.py``, each operator with
the JAX package's signature and result layout.  Each rank runs the port's
single-chip operators on its own shard, so the kernels are theirs: the
filter compacts with kernel B1, the group-by scans with B2 and compacts the
group ends with B1, the join's probe bounds scan with B2 (B7 where its sort
gates send it), and the shuffle groups rows by destination and the sort
orders a shard with B3.  Cross-shard movement is the ragged exchange of
``shuffle`` (one ``all_to_all_single`` a shuffle); each result's counts are
gathered so that every rank holds them.

Operators that can fail on one shard (an exchange or a join that overflows)
decide from gathered counts, so every rank raises together and none is
left waiting in a collective.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from .. import dtypes as dt
from ..array.array import make_array
from ..array.boolean import BooleanArray
from ..compute.filter import filter as filter_batch
from ..compute.hash_aggregate import groupby_core
from ..compute.join import legacy_emit
from ..compute.sort import key_code, sort_by_key
from ..errors import ArrowTorchError, OperationNotSupported
from ..ops.kernel import AV
from ..ops.swizzle import gather
from ..table import RecordBatch
from ..utils import bits as B
from .mesh import MeshRuntime
from .sharding import ShardedBatch, ShardedColumn
from .shuffle import Exchange, decode_columns, encode_columns, start_hash_partition, hash_partition

_A = dt.ArrowType


def _valid_prefix(col: ShardedColumn, count: int, n: int) -> torch.Tensor:
    """(n,) bool over a shard's first n rows: below its count and valid."""
    m = torch.arange(n, device=col.data.device) < count
    if col.validity is not None:
        m = m & B.unpack_bits(col.validity[: B.num_words(n)], n)
    return m


def _fit(x: torch.Tensor, rows: int, cap: int) -> torch.Tensor:
    """The first `rows` of x in a zeroed buffer of `cap` rows."""
    out = torch.zeros(cap, dtype=x.dtype, device=x.device)
    out[:rows] = x[:rows]
    return out


def _gathered_counts(rt: MeshRuntime, local: torch.Tensor) -> torch.Tensor:
    """(P,) int32 counts from every rank's 0-d count: one all_gather."""
    return rt.all_gather(local.reshape(1).to(torch.int32)).reshape(-1)


# ---------------------------------------------------------------------------
# distributed filter
# ---------------------------------------------------------------------------


def distributed_filter(sb: ShardedBatch, mask: str) -> ShardedBatch:
    """Compact every shard by a BOOL mask column (kernel B1; a null mask row
    drops its row).  No exchange: one all_gather of the new counts."""
    mcol = sb.columns[mask]
    if mcol.dtype is not _A.BOOL:
        raise OperationNotSupported("filter mask column must be BOOL")
    rt = sb.runtime
    cap = sb.capacity
    words = mcol.data if mcol.validity is None else mcol.data & mcol.validity
    words = words & B.tail_mask_words(words.shape[0], sb.local_count(), words.device)
    batch = RecordBatch({n: make_array(c.data, c.validity, cap, c.dtype, rt.device)
                         for n, c in sb.columns.items() if n != mask})
    kept = filter_batch(batch, BooleanArray(words, None, cap, rt.device))
    k = torch.tensor(kept.num_rows, device=rt.device)
    cols = {n: ShardedColumn(a.data, a.validity, a.dtype) for n, a in kept.columns().items()}
    return ShardedBatch(cols, _gathered_counts(rt, k), rt)


# ---------------------------------------------------------------------------
# distributed sum / aggregate
# ---------------------------------------------------------------------------


def distributed_sum(sb: ShardedBatch, column: str) -> torch.Tensor:
    """Global sum of a column: a masked local sum, then all_reduce(SUM).

    The JAX package's ``jnp.sum`` + ``psum``: integers sum in 64 bits (int64
    for signed types; for unsigned types the uint64 sum, returned as its
    int64 bits), floats in their own type.  A 0-d tensor on the rank's
    device, the same on every rank.
    """
    col = sb.columns[column]
    if col.dtype is _A.BOOL:
        raise OperationNotSupported("sum over BOOL unsupported")
    n = int(sb.local_count())
    vals = col.data[:n]
    if dt.is_unsigned(col.dtype):
        vals = dt.widen(vals, col.dtype)  # zero-extended (a u64 keeps its bits)
    if col.validity is not None:
        valid = B.unpack_bits(col.validity[: B.num_words(n)], n)
        vals = torch.where(valid, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    acc = vals.dtype if dt.is_float(col.dtype) else torch.int64
    return sb.runtime.all_reduce_sum(torch.sum(vals, dtype=acc))


def _live_rows(sb: ShardedBatch) -> Tuple[int, int]:
    """(this rank's row count, read to the host; the rows the local
    operators take: the count, and at least 1, a dead row standing in for
    none)."""
    c = int(sb.local_count())
    return c, max(c, 1)


def _local_groupby(sb: ShardedBatch, key: str, aggregations):
    """Per-shard group-by (``groupby_core`` on the live rows, no
    collectives): groups at the front in ascending key order.  Returns
    (num_groups, keys, [aggs]), the buffers of the shard's capacity."""
    c, n = _live_rows(sb)
    kcol = sb.columns[key]
    entries, spec = [], []
    for _name, vc, kind in aggregations:
        if vc is None:
            if kind != "count":
                raise OperationNotSupported("only count may omit the value column")
            spec.append(("count_all", None))
            continue
        col = sb.columns[vc]
        entries.append((col.data[:n], _valid_prefix(col, c, n)))
        spec.append((kind, col.dtype))
    # no nulls and no dead row among the n: the sort needs no rank key
    used = [key] + [vc for _, vc, _ in aggregations if vc is not None]
    dense = c == n and all(sb.columns[name].validity is None for name in used)
    g, keys, aggs = groupby_core(kcol.data[:n], kcol.dtype, _valid_prefix(kcol, c, n), entries, spec, dense=dense)
    cap = sb.capacity
    return g, _fit(keys, n, cap), [_fit(a, n, cap) for a in aggs]


def distributed_aggregate(
    sb: ShardedBatch,
    key: str,
    aggregations: Sequence[Tuple[str, Optional[str], str]],
    pre_partitioned: bool = False,
    pre_aggregate: bool = True,
    bucket_rows: Optional[int] = None,
) -> ShardedBatch:
    """GROUP BY across the mesh: (optionally) pre-aggregate each shard
    locally, hash-partition the partials by key (one exchange), then combine
    per shard; groups never span shards afterwards.

    Pre-aggregation (a key held by every row still ships at most P partial
    rows) applies when every aggregation decomposes (sum/count/min/max);
    counts become INT64 partials combined by sum.  Otherwise the raw rows
    are shuffled.

    aggregations: (out_name, value_column_name | None, kind).
    Returns a ShardedBatch of group rows {key, *outputs}.
    """
    rt = sb.runtime
    decomposable = all(k in ("sum", "count", "min", "max") for _, _, k in aggregations)
    if pre_aggregate and decomposable and not pre_partitioned:
        g, keys, partials = _local_groupby(sb, key, aggregations)
        pcols = {"key": ShardedColumn(keys, None, sb.columns[key].dtype)}
        combine = []
        for (name, vc, kind), buf in zip(aggregations, partials):
            pcols[name] = ShardedColumn(buf, None, _A.INT64 if kind == "count" else sb.columns[vc].dtype)
            combine.append((name, name, "sum" if kind == "count" else kind))
        partial = ShardedBatch(pcols, _gathered_counts(rt, g), rt)
        shuffled = hash_partition(partial, "key", bucket_rows=bucket_rows)
        return distributed_aggregate(shuffled, "key", combine, pre_partitioned=True, pre_aggregate=False)

    if not pre_partitioned:
        sb = hash_partition(sb, key, bucket_rows=bucket_rows)
    g, keys, outs = _local_groupby(sb, key, aggregations)
    cols = {"key": ShardedColumn(keys, None, sb.columns[key].dtype)}
    for (name, vc, kind), buf in zip(aggregations, outs):
        if kind == "count":
            cols[name] = ShardedColumn(buf, None, _A.INT64)
        elif kind == "mean":
            cols[name] = ShardedColumn(buf, None, _A.FLOAT64)
        else:
            cols[name] = ShardedColumn(buf, None, sb.columns[vc].dtype)
    return ShardedBatch(cols, _gathered_counts(rt, g), rt)


# ---------------------------------------------------------------------------
# distributed join
# ---------------------------------------------------------------------------


def _check_join_keys(bcol: ShardedColumn, pcol: ShardedColumn) -> None:
    if bcol.dtype is not pcol.dtype:
        raise OperationNotSupported("join key dtypes must match")
    if not dt.is_integer(bcol.dtype):
        raise OperationNotSupported("join keys must be integer dtypes")


def join_shard_local(build: ShardedBatch, probe: ShardedBatch, build_key: str, probe_key: str,
                     out_cap: int) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Per-shard sort-probe inner join of co-partitioned shards' live rows:
    the port's ``probe_bounds`` + ``build_order`` and the searchsorted
    expansion of the first `out_cap` matches (``join.legacy_emit``), as the
    JAX package expands `out_cap` slots.  Returns (this shard's match total,
    probe row ids, build row ids), the ids int32 over `out_cap` rows, zero
    from the total on (probe-major order)."""
    bcol, pcol = build.columns[build_key], probe.columns[probe_key]
    (bc, nb), (pc, np_) = _live_rows(build), _live_rows(probe)
    bvalid, pvalid = _valid_prefix(bcol, bc, nb), _valid_prefix(pcol, pc, np_)
    pidx, bidx, total = legacy_emit(bcol.data[:nb], bvalid, pcol.data[:np_], pvalid, bcol.dtype, limit=out_cap)
    k = min(total, out_cap)
    return total, _fit(pidx, k, out_cap), _fit(bidx, k, out_cap)


def distributed_join_indices(
    build: ShardedBatch,
    probe: ShardedBatch,
    build_key: str,
    probe_key: str,
    out_capacity: Optional[int] = None,
    pre_partitioned: bool = False,
    bucket_rows: Optional[int] = None,
    check: bool = True,
):
    """Distributed inner equi-join: co-partition both sides by key hash (two
    exchanges), then a per-shard sort-probe join.

    Returns (counts (P,), probe_row_idx ShardedColumn, build_row_idx
    ShardedColumn, partitioned_build, partitioned_probe): the indices are
    local to the partitioned batches, which are returned so that callers can
    gather payload columns.  A shard with more matches than `out_capacity`
    (default: the larger partitioned capacity) raises with `check`, on every
    rank; otherwise its first matches are kept.
    """
    _check_join_keys(build.columns[build_key], probe.columns[probe_key])
    if not pre_partitioned:
        build = hash_partition(build, build_key, bucket_rows=bucket_rows)
        probe = hash_partition(probe, probe_key, bucket_rows=bucket_rows)
    return _join_partitioned(build, probe, build_key, probe_key, out_capacity, check)


def _join_partitioned(build, probe, build_key, probe_key, out_capacity, check):
    rt = build.runtime
    out_cap = out_capacity or max(build.capacity, probe.capacity)
    total, pidx, bidx = join_shard_local(build, probe, build_key, probe_key, out_cap)
    totals = rt.all_gather(torch.tensor([total], dtype=torch.int64, device=rt.device)).reshape(-1)
    if check and int(totals.max()) > out_cap:
        raise ArrowTorchError(f"join output overflow: raise out_capacity (got {out_cap})")
    counts = totals.clamp(max=out_cap).to(torch.int32)
    return (
        counts,
        ShardedColumn(pidx, None, _A.UINT32),
        ShardedColumn(bidx, None, _A.UINT32),
        build,
        probe,
    )


def _sharded_take(sb: ShardedBatch, idx: ShardedColumn, counts: torch.Tensor) -> Dict[str, ShardedColumn]:
    """Per-shard gather of every column: out[j] = col[idx[j]] for j below
    the shard's count, zero after."""
    k = counts[sb.runtime.rank]
    rows = dt.widen(idx.data, _A.UINT32)
    out: Dict[str, ShardedColumn] = {}
    for n, col in sb.columns.items():
        got = gather(AV(col.data, col.validity, col.capacity, col.dtype), rows, k)
        out[n] = ShardedColumn(got.data, got.validity, col.dtype)
    return out


def distributed_join(
    left: ShardedBatch,
    right: ShardedBatch,
    left_on: str,
    right_on: str,
    out_capacity: Optional[int] = None,
    bucket_rows: Optional[int] = None,
    suffixes: Tuple[str, str] = ("_l", "_r"),
    check: bool = True,
    fused: bool = True,
) -> ShardedBatch:
    """Distributed inner equi-join returning the joined ShardedBatch; `right`
    is the build side.

    fused=True starts both sides' exchanges (asynchronous
    ``all_to_all_single``) before the local join waits on either, the
    counterpart of the JAX package's one-program overlap; fused=False runs
    them one after the other through :func:`distributed_join_indices`.  Both
    give the same rows.
    """
    _check_join_keys(right.columns[right_on], left.columns[left_on])
    if fused:
        pending_b = start_hash_partition(right, right_on, bucket_rows=bucket_rows, check=check)
        pending_p = start_hash_partition(left, left_on, bucket_rows=bucket_rows, check=check)
        pb, pp_ = pending_b.finish(), pending_p.finish()
        counts, pidx, bidx, pb, pp_ = _join_partitioned(pb, pp_, right_on, left_on, out_capacity, check)
    else:
        counts, pidx, bidx, pb, pp_ = distributed_join_indices(
            right, left, right_on, left_on, out_capacity=out_capacity, bucket_rows=bucket_rows, check=check,
        )
    lcols = _sharded_take(pp_, pidx, counts)
    rcols = _sharded_take(pb, bidx, counts)
    cols: Dict[str, ShardedColumn] = {}
    for n, c in lcols.items():
        clash = n in right.column_names and not (n == left_on and n == right_on)
        cols[n + suffixes[0] if clash else n] = c
    for n, c in rcols.items():
        if n == right_on and left_on == right_on:
            continue  # key already present from the probe side
        cols[n + suffixes[1] if n in left.column_names else n] = c
    return ShardedBatch(cols, counts, left.runtime)


# ---------------------------------------------------------------------------
# distributed sort (sample-splitter range partition + local sort)
# ---------------------------------------------------------------------------


def _max_code(dtype: _A, device) -> torch.Tensor:
    """key_code of the type's largest value (+inf for floats): what dead
    rows sample and sort as."""
    info = dt.info(dtype)
    if info.is_float:
        top = torch.inf
    elif info.is_unsigned:
        top = -1  # all ones in signed storage
    else:
        top = torch.iinfo(info.torch).max
    return key_code(torch.tensor([top], dtype=info.torch, device=device), dtype)


def _splitters(rt: MeshRuntime, kcol: ShardedColumn, n: int, n_samples: int) -> torch.Tensor:
    """(P - 1,) ascending splitters, as key codes: a strided sample of each
    shard's keys over its whole capacity (rows from n on at the type's
    maximum), all_gathered and sorted, at the quantiles (1..P-1) * (len //
    P)."""
    cap = kcol.capacity
    idx = torch.arange(0, cap, max(cap // n_samples, 1), device=kcol.data.device)[:n_samples]
    code = key_code(kcol.data[idx], kcol.dtype)
    sample = torch.where(idx < n, code, _max_code(kcol.dtype, code.device))
    sign = -(1 << (8 * code.element_size() - 1))
    ssorted = torch.sort(rt.all_gather(sample).reshape(-1) ^ sign).values ^ sign
    p = rt.num_shards
    return ssorted[torch.arange(1, p, device=code.device) * (ssorted.shape[0] // p)]


def distributed_sort(
    sb: ShardedBatch,
    key: str,
    out_capacity: Optional[int] = None,
    n_samples: int = 256,
    skew_factor: Optional[int] = None,
    check: bool = True,
) -> ShardedBatch:
    """Globally sort by `key`: sampled splitters, a range-partition exchange,
    then a stable local sort of key and payloads (``sort_by_key``: kernel B3
    where its gate sends it).  Shard s holds globally-ordered range s, in
    the key's Arrow order (u32 keys order unsigned).  Non-null primitive keys
    and payloads only.

    Without `skew_factor` nothing is capped on the send side (the outcome of
    the JAX package's automatic retry at bucket = cap), and a shard that
    receives more than `out_capacity` rows (default 2 * cap) raises.  A
    pinned `skew_factor` caps each (source, destination) send at
    skew_factor x the balanced share: an overflow raises, or with
    check=False truncates.
    """
    rt = sb.runtime
    kcol = sb.columns[key]
    if kcol.validity is not None or kcol.dtype is _A.BOOL:
        raise OperationNotSupported("distributed_sort: non-null primitive keys only")
    payload_names = [n for n in sb.columns if n != key]
    for n in payload_names:
        col = sb.columns[n]
        if col.validity is not None or col.dtype is _A.BOOL:
            raise OperationNotSupported("distributed_sort payload must be non-null primitive")
    cap = sb.capacity
    p = rt.num_shards
    out_cap = out_capacity or 2 * cap
    bucket = None if skew_factor is None else min(cap, skew_factor * -(-cap // p))

    n = int(sb.local_count())
    dest = None
    if p > 1:
        code = key_code(kcol.data[:n], kcol.dtype)
        sign = -(1 << (8 * code.element_size() - 1))  # code ^ sign: signed order == the Arrow order
        dest = torch.searchsorted(_splitters(rt, kcol, n, n_samples) ^ sign, code ^ sign, right=True)
        dest = dest.to(torch.int32)

    names = [key] + payload_names
    planes, slots = encode_columns(sb.columns, names, n)
    error = (
        "distributed_sort receive overflow; raise out_capacity"
        if bucket is None
        else "distributed_sort capacity overflow; raise out_capacity/skew_factor"
    )
    x = Exchange(rt, n, dest, planes, out_cap, bucket, check, error)
    recv = x.wait()
    cols = decode_columns(recv, slots, out_cap)
    total = recv.shape[0]
    arrays = {n: make_array(cols[n].data, None, total, cols[n].dtype, rt.device) for n in names}
    skey, spay = sort_by_key(arrays[key], RecordBatch({n: arrays[n] for n in payload_names})
                             if payload_names else None)
    out = {key: ShardedColumn(skey.data, None, kcol.dtype)}
    for n in payload_names:
        out[n] = ShardedColumn(spay[n].data, None, sb.columns[n].dtype)
    return ShardedBatch(out, x.counts, rt)


__all__ = [
    "distributed_aggregate", "distributed_filter", "distributed_join", "distributed_join_indices",
    "distributed_sort", "distributed_sum",
]
