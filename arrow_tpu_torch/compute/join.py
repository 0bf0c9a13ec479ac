"""Hash join: inner equi-join on integer keys, duplicates supported.

Counterpart of ``arrow_tpu/compute/join.py``: sort-probe instead of a hash
table.  One co-sort of build and probe keys gives each probe row its match
ranks [lo, hi) among the valid build rows in key order; an emit pass then
expands the ranges into (probe row, build row) pairs.

Two emits, as in the JAX package:

- **merge-expand** (the default on CUDA): no random gathers.  The co-sort
  (kernel B3 for a single u32 key plane, the native key or a narrowed 64-bit
  one, at ``RADIX_COSORT_ROWS`` buffer rows and more; ``torch.sort``
  otherwise) gives the key-ordered build row list and the non-empty probe run
  list, compacted by kernel B1.  A merge pass (kernel B7) of the run ends
  with the output positions run-length-decodes every output slot, segmented
  max scans (kernel B2) fill the runs' values in, and a second merge pass
  against the rank-indexed build list resolves build ranks to row ids.
  Output order is build-rank-major;
- **legacy** (the default on the CPU): ``probe_bounds`` + ``build_order``
  and a searchsorted emit, probe-major.

``ARROW_TPU_JOIN_EMIT=merge|legacy`` overrides the choice, as in the JAX
package.  Output order is implementation-defined: compare pair sets.

Only the logical prefixes of the key columns take part.  Null keys never
match (dropped from both sides).
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from .. import dtypes as dt
from ..array.array import ArrowArrayBase, make_array, pad_len
from ..errors import OperationNotSupported
from ..ops.swizzle import take
from ..table import RecordBatch
from ..utils import bits as B
from ..utils.scans import (
    compact_rows, merge_lex_sort, merge_sort_ok, prefix_sum, segmented_scan, shift_cummax,
)
from . import kernels as CK
from .sort import sortable_limbs

_A = dt.ArrowType
_SENT = 0x7FFFFFFF
#: the co-sort rides kernel B3 from this many buffer rows (build + probe) on
RADIX_COSORT_ROWS = 1 << 26
#: 64-bit keys are checked for a u32 range (narrowing) from this many on
NARROW_MIN_ROWS = 1 << 22


def _valid(arr: ArrowArrayBase) -> torch.Tensor:
    if arr.validity is None:
        return torch.ones(arr.length, dtype=torch.bool, device=arr.data.device)
    return B.unpack_bits(arr.validity, arr.length)


def _order_key(keys: torch.Tensor, dtype: _A) -> torch.Tensor:
    """int64 whose signed order is the Arrow order of integer keys."""
    return dt.order_key(keys, dtype) if dt.item_size(dtype) == 8 else dt.widen(keys, dtype)


def _key_starts(sk: torch.Tensor) -> torch.Tensor:
    start = sk != torch.roll(sk, 1)
    start[0] = True
    return start


def _run_bounds(skey: torch.Tensor, sb: torch.Tensor):
    """Over co-sorted rows with build flags `sb` (int32 0/1): for every row,
    lo = build rows in strictly earlier key segments and hi = build rows up to
    the end of its own segment."""
    b4 = prefix_sum(sb) - sb
    start = _key_starts(skey)
    # b4 is non-decreasing, so a masked cummax carries it across the segment
    lo = shift_cummax(torch.where(start, b4, -1))
    nbv = sb.sum(dtype=torch.int32)
    after = nbv - b4 - sb  # build rows strictly after each row
    end = torch.roll(start, -1)
    end[-1] = True
    hi = nbv - shift_cummax(torch.where(end, after, -1), reverse=True)
    return lo, hi


def probe_bounds(bkeys, bvalid, pkeys, pvalid, dtype: _A):
    """Per-probe [lo, hi) match ranks among valid build rows: one co-sort of
    concat(build, probe), build flags riding along, and one unsort."""
    n, m = bkeys.shape[0], pkeys.shape[0]
    device = bkeys.device
    isb = torch.cat([bvalid.to(torch.int32), torch.zeros(m, dtype=torch.int32, device=device)])
    rows = torch.arange(n + m, dtype=torch.int32, device=device)
    use_merge = merge_sort_ok(bkeys, pkeys)
    if use_merge:
        limbs = [
            torch.cat([b, p]) for b, p in zip(sortable_limbs(bkeys, dtype), sortable_limbs(pkeys, dtype))
        ]
        out = merge_lex_sort(limbs, [isb, rows])
        skey = out[0] if len(limbs) == 1 else (out[0].to(torch.int64) << 32) | (out[1].to(torch.int64) & 0xFFFFFFFF)
        sb, sorig = out[len(limbs)], out[len(limbs) + 1]
    else:
        okey = torch.cat([_order_key(bkeys, dtype), _order_key(pkeys, dtype)])
        skey, perm = torch.sort(okey, stable=True)
        sb, sorig = isb[perm], perm.to(torch.int32)
    lo_s, hi_s = _run_bounds(skey, sb)
    if use_merge:
        _, lo_o, hi_o = merge_lex_sort([sorig], [lo_s, hi_s])
    else:
        lo_o, hi_o = torch.empty_like(lo_s), torch.empty_like(hi_s)
        lo_o[sorig.to(torch.int64)] = lo_s
        hi_o[sorig.to(torch.int64)] = hi_s
    lo_p = torch.where(pvalid, lo_o[n:], 0)
    hi_p = torch.where(pvalid, hi_o[n:], 0)
    return lo_p, torch.maximum(hi_p, lo_p)


def build_order(bkeys, bvalid, dtype: _A, all_valid: bool = False) -> torch.Tensor:
    """Valid build rows' ids in key order (rank -> row id), invalid last."""
    rows = torch.arange(bkeys.shape[0], dtype=torch.int32, device=bkeys.device)
    if all_valid and merge_sort_ok(bkeys):
        return merge_lex_sort(sortable_limbs(bkeys, dtype), [rows])[-1]
    perm = torch.sort(_order_key(bkeys, dtype), stable=True).indices
    perm = perm[torch.sort((~bvalid)[perm].to(torch.int32), stable=True).indices]
    return perm.to(torch.int32)


def _bucket(n: int) -> int:
    """The emit capacity: a power of two of at least 1024 rows."""
    n = max(n, 1)
    b = pad_len(n)
    p = 1024
    while p < b:
        p <<= 1
    return p


def _empty(device) -> Tuple[ArrowArrayBase, ArrowArrayBase, int]:
    empty = torch.zeros(0, dtype=torch.int32, device=device)
    return make_array(empty, None, 0, _A.UINT32), make_array(empty, None, 0, _A.UINT32), 0


def _emit_legacy(bk, bvalid, pk, pvalid, dtype, all_valid):
    """probe_bounds + build_order, then a searchsorted expansion."""
    sorder = build_order(bk, bvalid, dtype, all_valid)
    lo, hi = probe_bounds(bk, bvalid, pk, pvalid, dtype)
    cnt = (hi - lo).to(torch.int64)
    ends = torch.cumsum(cnt, 0)
    t = int(ends[-1])
    cap = _bucket(t)
    j = torch.arange(cap, dtype=torch.int64, device=bk.device)
    pi = torch.searchsorted(ends, j, right=True).clamp(max=pk.shape[0] - 1)
    bpos = lo[pi].to(torch.int64) + (j - (ends[pi] - cnt[pi]))
    bi = sorder[bpos.clamp(0, bk.shape[0] - 1)]
    live = j < t
    return torch.where(live, pi, 0).to(torch.int32), torch.where(live, bi, 0).to(torch.int32), t


def _fit(x: torch.Tensor, cap: int) -> torch.Tensor:
    """x cut or zero-padded to `cap` rows."""
    if x.shape[0] >= cap:
        return x[:cap]
    return torch.cat([x, torch.zeros(cap - x.shape[0], dtype=x.dtype, device=x.device)])


def _radix_cosort(buffer_rows: int, device: torch.device) -> bool:
    """The JAX package's gate for the co-sort on the radix chain, read on
    buffer lengths: CUDA tensors, at least ``RADIX_COSORT_ROWS`` rows."""
    return device.type == "cuda" and buffer_rows >= RADIX_COSORT_ROWS


def _plan(bk, bvalid, pk, pvalid, dtype, narrow: bool, buffer_rows: int):
    """prep -> co-sort -> post: the key-ordered build row list (sorder) and
    the non-empty probe runs (end, probe row, lo), compacted by kernel B1."""
    nb, np_ = bk.shape[0], pk.shape[0]
    tot = nb + np_
    device = bk.device
    valid = torch.cat([bvalid, pvalid])
    sorig = torch.where(valid, torch.arange(tot, dtype=torch.int32, device=device), tot)
    if narrow or dtype is _A.UINT32:  # one u32 key plane; dead rows the largest
        key = torch.cat([bk, pk])
        if narrow:
            key = B.to_int32(key & 0xFFFFFFFF)
        key = torch.where(valid, key, -1)
        if _radix_cosort(buffer_rows, device):
            skey, so = CK.radix_sort((key, sorig), 32)
        else:
            skey, perm = torch.sort(dt.widen(key, _A.UINT32))
            so = sorig[perm]
    else:
        okey = torch.cat([_order_key(bk, dtype), _order_key(pk, dtype)])
        skey, perm = torch.sort(torch.where(valid, okey, torch.iinfo(torch.int64).max))
        so = sorig[perm]
    isb = (so < nb).to(torch.int32)
    isp = (so >= nb) & (so < tot)
    lo_s, hi_s = _run_bounds(skey, isb)
    cnt_s = torch.where(isp, hi_s - lo_s, 0).to(torch.int32)
    total = int(cnt_s.sum(dtype=torch.int64))
    ends_s = prefix_sum(cnt_s.to(torch.int64)).to(torch.int32)  # total < 2^31 on this path
    (sorder,) = compact_rows(isb == 1, [so])
    runs = isp & (cnt_s > 0)
    ends_l, prow_l, lo_l = compact_rows(runs, [ends_s, so - nb, lo_s])
    return total, int(runs.sum()), sorder, ends_l, prow_l, lo_l


def _expand(cap: int, ends_l, prow_l, lo_l, m_eff: int, total: int):
    """Run-length decode: output slot j -> (probe row, build rank).

    One B7 pass merges the strictly increasing run ends (A, dead rows the
    sentinel) with the output positions (B); ties put a run end first, so the
    slot at a run's end opens the next run.  A rows carry the next run's
    (probe row, lo); segmented max scans (B2) with the A rows as segment
    starts fill them onto that run's slots."""
    device = ends_l.device
    qi = torch.arange(cap, dtype=torch.int32, device=device)
    live_a = qi < m_eff
    ka = torch.where(live_a, _fit(ends_l, cap), _SENT)
    p1a = torch.where(live_a, torch.roll(_fit(prow_l, cap), -1), 0)
    p2a = torch.where(live_a, torch.roll(_fit(lo_l, cap), -1), 0)
    mk, m1, m2 = CK.merge_pass(
        (torch.cat([ka, qi]), torch.cat([p1a, torch.full_like(qi, -1)]), torch.cat([p2a, torch.zeros_like(qi)])),
        cap,
    )
    tag = m1 >= 0
    fk = segmented_scan(torch.where(tag, mk, -1), tag, "max")
    f1 = segmented_scan(m1, tag, "max")
    f2 = segmented_scan(m2, tag, "max")
    valid = f1 >= 0  # slots before the first run end belong to run 0
    prow_j = torch.where(valid, f1, prow_l[0])
    lo_j = torch.where(valid, f2, lo_l[0])
    bpos = lo_j + (mk - torch.where(valid, fk, 0))
    bpos = torch.where(mk < total, bpos, _SENT - 1)  # dead slots sort last below
    pidx, bposc = compact_rows(~tag, [prow_j, bpos])
    return pidx[:cap], bposc[:cap]


def _rank_fill(cap: int, table_len: int, bpos, pidx, sorder, total: int):
    """Build ranks -> build row ids without a gather: sort the queries by
    rank (any sort), merge them (B7) after the rank-indexed build list, fill
    each rank's row id onto its queries (B2), compact (B1)."""
    L = max(cap, table_len)
    sb, order = torch.sort(bpos)
    sp = pidx[order]
    qi = torch.arange(L, dtype=torch.int32, device=bpos.device)
    kb = _fit(sb, L)
    if cap < L:
        kb = torch.where(qi < cap, kb, _SENT)
    mk, mv, mt = CK.merge_pass(
        (torch.cat([qi, kb]), torch.cat([_fit(sorder, L), _fit(sp, L)]),
         torch.cat([torch.ones_like(qi), torch.zeros_like(qi)])),
        L,
    )
    tag = mt == 1
    bidx = segmented_scan(torch.where(tag, mv, -1), tag, "max")
    pid_o, bid_o = compact_rows(mt == 0, [mv, bidx])
    # when every table row is real the compaction keeps every query row, so
    # mask the dead slots [total, cap) explicitly
    live = torch.arange(cap, device=bpos.device) < total
    return torch.where(live, pid_o[:cap], 0), torch.where(live, bid_o[:cap], 0)


def _narrow_ok(build_keys: ArrowArrayBase, probe_keys: ArrowArrayBase) -> bool:
    """64-bit keys whose values (as u64) all fit in 32 bits co-sort on one
    u32 plane; the check costs a host sync, so it runs at scale only."""
    if dt.item_size(build_keys.dtype) != 8:
        return False
    if build_keys.data.shape[0] + probe_keys.data.shape[0] < NARROW_MIN_ROWS:
        return False
    return not any(
        bool(((k.data[: k.length] >> 32) != 0).any()) for k in (build_keys, probe_keys)
    )


def join_indices(
    build_keys: ArrowArrayBase, probe_keys: ArrowArrayBase
) -> Tuple[ArrowArrayBase, ArrowArrayBase, int]:
    """Inner-join match pairs: (probe_indices, build_indices, count)."""
    for k in (build_keys, probe_keys):
        if not dt.is_integer(k.dtype):
            raise OperationNotSupported(f"join key dtype {k.dtype.value} unsupported")
    if build_keys.dtype is not probe_keys.dtype:
        raise OperationNotSupported("join key dtypes must match")
    device = probe_keys.data.device
    if build_keys.length == 0 or probe_keys.length == 0:
        return _empty(device)
    dtype = build_keys.dtype
    bk, pk = build_keys.data[: build_keys.length], probe_keys.data[: probe_keys.length]
    bvalid, pvalid = _valid(build_keys), _valid(probe_keys)
    mode = os.environ.get("ARROW_TPU_JOIN_EMIT", "auto")
    if mode == "merge" or (mode == "auto" and device.type == "cuda"):
        buffer_rows = build_keys.data.shape[0] + probe_keys.data.shape[0]
        total, m_eff, sorder, ends_l, prow_l, lo_l = _plan(
            bk, bvalid, pk, pvalid, dtype, _narrow_ok(build_keys, probe_keys), buffer_rows
        )
        if total == 0:
            return _empty(device)
        if total < 1 << 31:
            cap = _bucket(total)
            pidx, bpos = _expand(cap, ends_l, prow_l, lo_l, m_eff, total)
            pidx, bidx = _rank_fill(cap, bk.shape[0], bpos, pidx, sorder, total)
            return (
                make_array(pidx, None, total, _A.UINT32),
                make_array(bidx, None, total, _A.UINT32),
                total,
            )
        # 2^31 pairs or more: the legacy emit's int64 positions
    probe_idx, build_idx, t = _emit_legacy(bk, bvalid, pk, pvalid, dtype, build_keys.validity is None)
    if t == 0:
        return _empty(device)
    return make_array(probe_idx, None, t, _A.UINT32), make_array(build_idx, None, t, _A.UINT32), t


def hash_join(
    left: RecordBatch,
    right: RecordBatch,
    left_on: str,
    right_on: str,
    suffixes: Tuple[str, str] = ("_l", "_r"),
) -> RecordBatch:
    """Inner equi-join of two RecordBatches; `right` is the build side."""
    probe_idx, build_idx, _ = join_indices(right[right_on], left[left_on])
    cols = {}
    for name, col in left.columns().items():
        clash = name in right.column_names and not (name == left_on and name == right_on)
        cols[name + suffixes[0] if clash else name] = take(col, probe_idx)
    for name, col in right.columns().items():
        if name == right_on and left_on == right_on:
            continue  # key column already present from the left side
        out_name = name + suffixes[1] if name in left.column_names else name
        cols[out_name] = take(col, build_idx)
    return RecordBatch(cols)


__all__ = ["build_order", "hash_join", "join_indices", "probe_bounds"]
