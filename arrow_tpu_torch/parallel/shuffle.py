"""Hash-partition shuffle: the ragged all-to-all exchange.

Counterpart of ``arrow_tpu/parallel/shuffle.py``, ported from its ragged
exchange (``shuffle_shard_local_ragged``), not from its padded buckets.  One
exchange on each rank:

  1. route each live row to a destination rank (``hash_key(key) % P``,
     unsigned, for the hash partition);
  2. group the rows stably by destination: one pass of the radix sort
     (kernel B3) over the destination's ``ceil(log2 P)`` bits, the column
     planes riding along (nothing to group at P = 1);
  3. count the rows for each destination;
  4. one ``all_gather`` of those counts gives the (P, P) matrix
     ``allg[src, dst]``; from it, the exclusive prefix over sources for each
     destination, the clamp against the receiver's capacity, the send and
     receive sizes and the overflow flag, as ``shuffle.py:216-224`` computes
     them; one host read of the matrix gives the split sizes;
  5. one ``all_to_all_single`` of a (rows, planes) int32 tensor: every
     column rides as u32 words (64-bit types as lo/hi, narrower types
     widened, bools and validity as 0/1 words);
  6. the received rows decoded into a dense local batch with a zero tail.

Received rows land grouped by source rank, each source's rows in their
stable order: the slot order (s, j) of the JAX package's padded exchange, so
a shard after the shuffle equals the JAX package's row for row.  Overflow is
decided from the gathered matrix, which every rank holds, so every rank
raises (or truncates) together.

The JAX package's ``ARROW_TPU_SHUFFLE`` switch, its ragged exchange's size
bound and its mesh registry (``_MESHES``) are TPU plumbing and are not
ported.  Without a pinned ``bucket_rows`` nothing is capped on the send
side: the outcome of the JAX path's automatic retry at ``bucket = cap``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..array.array import pad_len
from ..compute import kernels as CK
from ..errors import ArrowTorchError
from ..utils import bits as B
from .mesh import MeshRuntime
from .sharding import ShardedBatch, ShardedColumn, counts_tensor

_A = dt.ArrowType
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# hashing: the murmur3 finalizers, bit for bit, in int64 arithmetic (torch
# has no uint32/uint64 multiply or logical shift on the CPU); no product
# exceeds 2^34, so nothing relies on a signed overflow wrapping
# ---------------------------------------------------------------------------


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for a in [0, 2^32) (int64) and a 32-bit constant b."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    return (a_lo * b_lo + (((a_hi * b_lo + a_lo * b_hi) & 0xFFFF) << 16)) & _M32


def _mul32_wide(a: torch.Tensor, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 64-bit product a * b as (high, low) 32-bit words."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    mid = a_lo * b_hi + a_hi * b_lo
    low = a_lo * b_lo + ((mid & 0xFFFF) << 16)
    return a_hi * b_hi + (mid >> 16) + (low >> 32), low & _M32


def _mul64(hi: torch.Tensor, lo: torch.Tensor, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi:lo * c) mod 2^64, words in and out."""
    c_hi, c_lo = c >> 32, c & _M32
    h, l = _mul32_wide(lo, c_lo)
    return (h + _mul32(hi, c_lo) + _mul32(lo, c_hi)) & _M32, l


def _fmix32_u(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _fmix64_words(hi: torch.Tensor, lo: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """murmur3/splitmix's 64-bit finalizer on (high, low) words; x >> 33 is
    the high word shifted by one into the low word."""
    lo = lo ^ (hi >> 1)
    hi, lo = _mul64(hi, lo, 0xFF51AFD7ED558CCD)
    lo = lo ^ (hi >> 1)
    hi, lo = _mul64(hi, lo, 0xC4CEB9FE1A85EC53)
    return hi, lo ^ (hi >> 1)


def _float_to_uint(x: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A float key converted to a `bits`-bit unsigned value, as (high, low)
    words: truncated toward zero, NaN and negatives 0, too large the
    maximum.  That is XLA's CPU conversion (``astype(uint32)``); XLA leaves
    NaN, negatives and overflow to the implementation."""
    y = torch.trunc(x.to(torch.float64))
    y = torch.where(torch.isnan(y), 0.0, y).clamp(0.0, 2.0**bits)
    hi = torch.floor(y / 2.0**32)
    lo = (y - hi * 2.0**32).to(torch.int64)
    hi = hi.to(torch.int64)
    sat = y >= 2.0**bits
    hi = torch.where(sat, _M32 if bits == 64 else 0, hi)
    return hi, torch.where(sat, _M32, lo)


def _words64(x: torch.Tensor, dtype: _A) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x.astype(uint64)`` as (high, low) words."""
    if dt.is_float(dtype):
        return _float_to_uint(x, 64)
    v = dt.widen(x, dtype)  # sign-extends signed types; a u64 stays its bits
    return (v >> 32) & _M32, v & _M32


def _u32(x: torch.Tensor, dtype: _A) -> torch.Tensor:
    """``x.astype(uint32)`` as int64 values in [0, 2^32)."""
    if dt.is_float(dtype):
        return _float_to_uint(x, 32)[1]
    return dt.widen(x, dtype) & _M32


def _arrow_type(x: torch.Tensor, dtype: Optional[_A]) -> _A:
    return dtype if dtype is not None else dt.from_torch_dtype(x.dtype)


def _as_int64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return torch.where(hi >= 1 << 31, hi - (1 << 32), hi) * (1 << 32) + lo


def fmix32(x: torch.Tensor, dtype: Optional[_A] = None) -> torch.Tensor:
    """murmur3 32-bit finalizer of ``x.astype(uint32)``, as the bits of the
    uint32 result in int32 (the port's u32 storage).  dtype: x's Arrow type
    (default: the signed or float type of its storage)."""
    return B.to_int32(_fmix32_u(_u32(x, _arrow_type(x, dtype))))


def fmix64(x: torch.Tensor, dtype: Optional[_A] = None) -> torch.Tensor:
    """murmur3/splitmix 64-bit finalizer of ``x.astype(uint64)``, as the
    bits of the uint64 result in int64 (the port's u64 storage)."""
    return _as_int64(*_fmix64_words(*_words64(x, _arrow_type(x, dtype))))


def _hash_u32(data: torch.Tensor, dtype: _A) -> torch.Tensor:
    if dt.item_size(dtype) == 8:
        return _fmix64_words(*_words64(data, dtype))[1]
    return _fmix32_u(_u32(data, dtype))


def hash_key(data: torch.Tensor, dtype: Optional[_A] = None) -> torch.Tensor:
    """The routing hash of a key column: fmix64's low word for 8-byte
    types, fmix32 otherwise; the uint32 bits in int32."""
    return B.to_int32(_hash_u32(data, _arrow_type(data, dtype)))


# ---------------------------------------------------------------------------
# u32 word planes: how a column rides the exchange
# ---------------------------------------------------------------------------


def _ride_plane(data: torch.Tensor, dtype: _A) -> torch.Tensor:
    """A column as one plane the radix sort carries: 8-byte types as int64
    bits, 4-byte types as int32 bits, narrower types widened to int32 as
    ``astype(uint32)`` widens them."""
    size = dt.item_size(dtype)
    if size == 8:
        return data.view(torch.int64)
    if size == 4:
        return data.view(torch.int32)
    return dt.widen(data, dtype).to(torch.int32)


def _plane_words(plane: torch.Tensor) -> torch.Tensor:
    """(rows, 1 or 2) int32 words of a ride plane, lo before hi."""
    return plane.view(torch.int32).view(plane.shape[0], plane.element_size() // 4)


def u32_planes(data: torch.Tensor, dtype: Optional[_A] = None) -> List[torch.Tensor]:
    """A column as the u32 word planes of the exchange (int32 bits): 64-bit
    types as [lo, hi], narrower types widened, 32-bit types bitcast."""
    words = _plane_words(_ride_plane(data, _arrow_type(data, dtype)))
    return [words[:, i] for i in range(words.shape[1])]


def u32_decode(words: Sequence[torch.Tensor], dtype: _A) -> torch.Tensor:
    """Inverse of :func:`u32_planes`: the column's storage tensor."""
    storage = dt.info(dtype).torch
    size = dt.item_size(dtype)
    if size == 8:
        return torch.stack(list(words), dim=-1).view(torch.int64).view(storage).reshape(-1)
    if size < 4:
        return dt.narrow(words[0].to(torch.int64), dtype)
    return words[0].contiguous().view(storage)


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Slot:
    """One column buffer on the exchange: its words [lo, hi) of a row."""

    name: str
    dtype: _A
    bits: bool  # a packed bitmap (BOOL data or validity), riding as 0/1 words
    lo: int
    hi: int


def encode_columns(columns: Dict[str, ShardedColumn], names: Sequence[str], rows: int):
    """(ride planes, slots) of the first `rows` rows of the named columns:
    each column's values, then its validity if it has one."""
    planes: List[torch.Tensor] = []
    slots: List[_Slot] = []
    w = 0
    nw = B.num_words(rows)

    def add(name, dtype, bits, plane):
        nonlocal w
        width = plane.element_size() // 4
        planes.append(plane)
        slots.append(_Slot(name, dtype, bits, w, w + width))
        w += width

    for name in names:
        col = columns[name]
        if col.dtype is _A.BOOL:
            add(name, col.dtype, True, B.unpack_bits(col.data[:nw], rows).to(torch.int32))
        else:
            add(name, col.dtype, False, _ride_plane(col.data[:rows], col.dtype).contiguous())
        if col.validity is not None:
            add(name, col.dtype, True, B.unpack_bits(col.validity[:nw], rows).to(torch.int32))
    return planes, slots


def decode_columns(recv: torch.Tensor, slots: Sequence[_Slot], out_cap: int) -> Dict[str, ShardedColumn]:
    """The received (rows, words) int32 tensor as columns of `out_cap` rows,
    zero past the received rows."""
    total = recv.shape[0]
    out: Dict[str, ShardedColumn] = {}
    for s in slots:
        if s.bits:
            flags = torch.zeros(out_cap, dtype=torch.bool, device=recv.device)
            flags[:total] = recv[:, s.lo] != 0
            words = B.pack_bits(flags)
            if s.name in out:  # the column's validity, after its values
                out[s.name] = ShardedColumn(out[s.name].data, words, s.dtype)
            else:
                out[s.name] = ShardedColumn(words, None, s.dtype)
            continue
        vals = torch.zeros(out_cap, dtype=dt.info(s.dtype).torch, device=recv.device)
        vals[:total] = u32_decode([recv[:, i] for i in range(s.lo, s.hi)], s.dtype)
        out[s.name] = ShardedColumn(vals, None, s.dtype)
    return out


def group_by_destination(dest: torch.Tensor, planes: Sequence[torch.Tensor], p: int, n: int) -> List[torch.Tensor]:
    """The first n rows of every plane, grouped stably by `dest` ((n,)
    int32 in [0, p)): radix sort passes over dest's bits (kernel B3), at most seven
    planes riding each call.  Rows from n on come out zero."""
    bits = list(range((p - 1).bit_length()))
    out: List[torch.Tensor] = []
    step = CK.radix.MAX_PLANES - 1
    for i in range(0, len(planes), step):
        out.extend(CK.radix_sort([dest, *planes[i : i + step]], bits, n)[1:])
    return out


def exchange_plan(allg: np.ndarray, out_cap: int, bucket: Optional[int]) -> Tuple[np.ndarray, bool]:
    """From the (P, P) matrix ``allg[src, dst]`` of rows each source routes
    to each destination: the rows actually sent, ``clamp[src, dst]``, and
    whether any row is dropped.  A source sends at most `bucket` rows to a
    destination (when pinned), and a destination takes rows in source order
    up to `out_cap` (``shuffle.py:216-224``)."""
    sent = allg if bucket is None else np.minimum(allg, bucket)
    excl = np.cumsum(sent, axis=0) - sent  # exclusive prefix over sources
    clamp = np.minimum(sent, np.maximum(out_cap - excl, 0))
    return clamp, bool((clamp != allg).any())


class Exchange:
    """One ragged exchange, started: the count matrix gathered and read,
    the rows grouped and handed to ``all_to_all_single`` (asynchronously);
    :meth:`wait` returns the received (rows, words) int32 tensor.

    n: this rank's live rows (a prefix); dest: their (n,) int32
    destinations, None at P = 1; planes: ride planes of at least n rows.
    Raises ArrowTorchError(`error`) on every rank when `check` and a row
    would be dropped.
    """

    def __init__(self, rt: MeshRuntime, n: int, dest: Optional[torch.Tensor], planes: Sequence[torch.Tensor],
                 out_cap: int, bucket: Optional[int], check: bool, error: str):
        p, me = rt.num_shards, rt.rank
        if p == 1:
            cnt = torch.full((1,), n, dtype=torch.int32, device=rt.device)
        else:
            cnt = torch.bincount(dest.to(torch.int64), minlength=p).to(torch.int32)
        # the one host read of the exchange: every split size comes from it
        allg = rt.all_gather(cnt).cpu().numpy().astype(np.int64)
        clamp, overflow = exchange_plan(allg, out_cap, bucket)
        if check and overflow:
            raise ArrowTorchError(error)
        if p > 1:
            planes = group_by_destination(dest, planes, p, n)
        send = torch.cat([_plane_words(pl[:n]) for pl in planes], dim=1)
        send_sz = clamp[me]
        if (send_sz != allg[me]).any():  # the first rows of each destination's run
            starts = np.cumsum(allg[me]) - allg[me]
            send = torch.cat([send[s : s + z] for s, z in zip(starts.tolist(), send_sz.tolist())])
        recv_sz = clamp[:, me]
        self.recv = torch.empty((int(recv_sz.sum()), send.shape[1]), dtype=torch.int32, device=send.device)
        self._send = send  # alive until the exchange completes
        self._work = rt.all_to_all(self.recv, send, recv_sz.tolist(), send_sz.tolist(), async_op=True)
        self.counts = counts_tensor(clamp.sum(axis=0), rt)

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        self._send = None
        return self.recv


class PendingPartition:
    """A hash partition whose exchange is in flight (see :func:`hash_partition`)."""

    def __init__(self, sb: ShardedBatch, names: Sequence[str], x: Exchange, slots, out_cap: int):
        self._sb, self._names, self._x, self._slots, self._out_cap = sb, names, x, slots, out_cap

    def finish(self) -> ShardedBatch:
        cols = decode_columns(self._x.wait(), self._slots, self._out_cap)
        return ShardedBatch({n: cols[n] for n in self._names}, self._x.counts, self._sb.runtime)


def start_hash_partition(
    sb: ShardedBatch,
    key: str,
    bucket_rows: Optional[int] = None,
    out_capacity: Optional[int] = None,
    check: bool = True,
) -> PendingPartition:
    """:func:`hash_partition` up to its exchange, started asynchronously."""
    rt = sb.runtime
    p = rt.num_shards
    cap = sb.capacity
    if key not in sb.columns:
        raise ArrowTorchError(f"unknown key column {key!r}")
    kcol = sb.columns[key]
    if kcol.dtype is _A.BOOL:
        raise ArrowTorchError("bool partition keys unsupported")
    bucket = None if bucket_rows is None else min(bucket_rows, cap)
    # default output capacity carries 2x skew slack over balanced placement
    out_cap = out_capacity or pad_len(2 * cap)
    n = int(sb.local_count())
    dest = None if p == 1 else (_hash_u32(kcol.data[:n], kcol.dtype) % p).to(torch.int32)
    names = [key] + [c for c in sb.columns if c != key]
    planes, slots = encode_columns(sb.columns, names, n)
    error = (
        f"shuffle receive overflow — raise out_capacity (out_cap={out_cap})"
        if bucket is None
        else f"shuffle bucket/capacity overflow — raise bucket_rows/out_capacity (bucket={bucket}, out_cap={out_cap})"
    )
    x = Exchange(rt, n, dest, planes, out_cap, bucket, check, error)
    return PendingPartition(sb, names, x, slots, out_cap)


def hash_partition(
    sb: ShardedBatch,
    key: str,
    bucket_rows: Optional[int] = None,
    out_capacity: Optional[int] = None,
    check: bool = True,
) -> ShardedBatch:
    """Redistribute rows so equal keys land on the same shard
    (``hash_key(key) % P``); the key column comes first in the result.

    bucket_rows: when given, each (source, destination) pair sends at most
    that many rows (at most the capacity): the first ones, in stable order.
    out_capacity: post-shuffle capacity a shard (default ``pad_len(2 * cap)``);
    a destination keeps the first `out_capacity` rows in source order.  A
    dropped row raises with `check`, else the result is truncated.
    """
    return start_hash_partition(sb, key, bucket_rows, out_capacity, check).finish()
