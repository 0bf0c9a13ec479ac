"""Sharded columnar batches: a table partitioned across the ranks of a mesh.

Counterpart of ``arrow_tpu/parallel/sharding.py``.  The JAX package holds
every column as one ``(P, cap)`` array over the mesh; here rank ``r`` holds
its own row of that layout:

  data:     (cap,)       this shard's value buffer ((cap/32,) words for BOOL)
  validity: (cap/32,)    packed int32 words, the single-chip layout
  counts:   (P,)         every shard's logical row count, int32, identical
                         on every rank and resident on the rank's device

Rows at and past a shard's count are zero in every buffer.  Each operator
ends with the counts of its result on every rank (one ``all_gather``, or the
count matrix its exchange already gathered), so ``num_rows()`` needs no
collective.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import dtypes as dt
from ..array.array import ArrowArrayBase, make_array, pad_len
from ..errors import ArrowTorchError
from ..table import RecordBatch
from ..utils import bits as B
from .mesh import MeshRuntime


@dataclasses.dataclass
class ShardedColumn:
    data: torch.Tensor  # (cap,) value buffer ((cap/32,) words for BOOL)
    validity: Optional[torch.Tensor]  # (cap/32,) packed words
    dtype: dt.ArrowType

    @property
    def capacity(self) -> int:
        if self.dtype is dt.ArrowType.BOOL:
            return int(self.data.shape[0]) * B.WORD_BITS
        return int(self.data.shape[0])


@dataclasses.dataclass
class ShardedBatch:
    columns: Dict[str, ShardedColumn]
    counts: torch.Tensor  # (P,) int32 logical rows per shard
    runtime: MeshRuntime

    @property
    def num_shards(self) -> int:
        return int(self.counts.shape[0])

    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).capacity

    def num_rows(self) -> int:
        return int(self.counts.sum())

    def local_count(self) -> torch.Tensor:
        """This rank's row count, a 0-d tensor on its device."""
        return self.counts[self.runtime.rank]

    def column(self, name: str) -> ShardedColumn:
        return self.columns[name]

    def __getitem__(self, name: str) -> ShardedColumn:
        return self.columns[name]

    @property
    def column_names(self):
        return list(self.columns)

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}: {c.dtype.value}" for n, c in self.columns.items())
        return (
            f"ShardedBatch(shards={self.num_shards}, cap={self.capacity}, "
            f"rows={self.num_rows()}, columns=[{cols}])"
        )


def counts_tensor(counts, runtime: MeshRuntime) -> torch.Tensor:
    return torch.as_tensor(np.asarray(counts, dtype=np.int32), device=runtime.device)


def _shard_cap(n: int, p: int) -> int:
    return max(pad_len(-(-n // p)), 1024)


def shift_words(words: torch.Tensor, offset: int, count: int, out_words: int) -> torch.Tensor:
    """Bits [offset, offset + count) of a packed bitmap, moved to bit 0 of
    `out_words` int32 words; the bits past `count` are zero.  The offset
    need not be a multiple of 32."""
    w0, s = divmod(offset, B.WORD_BITS)
    nw = B.num_words(count)
    src = torch.zeros(nw + 1, dtype=torch.int64, device=words.device)
    avail = min(nw + 1, words.shape[0] - w0)
    if avail > 0:
        src[:avail] = words[w0 : w0 + avail].to(torch.int64) & 0xFFFFFFFF
    moved = src[:nw] >> s
    if s:
        moved = moved | ((src[1:] << (B.WORD_BITS - s)) & 0xFFFFFFFF)
    out = torch.zeros(out_words, dtype=torch.int32, device=words.device)
    out[:nw] = B.mask_tail(B.to_int32(moved), count)
    return out


def shard_batch(
    batch: RecordBatch, runtime: MeshRuntime, capacity: Optional[int] = None
) -> ShardedBatch:
    """Contiguous row-range partitioning (the cheap initial placement; use
    ``shuffle.hash_partition`` for key-based): shard s takes ``n // P`` rows,
    one more for the first ``n % P`` shards.

    Every rank passes the same batch, wherever it lives, and copies its own
    range to its device; bitmaps are re-packed from the range's first row.
    """
    p, r = runtime.num_shards, runtime.rank
    n = batch.num_rows
    cap = capacity or _shard_cap(n, p)
    counts_np = np.full(p, n // p, np.int32)
    counts_np[: n % p] += 1
    if counts_np.max() > cap:
        raise ArrowTorchError(f"capacity {cap} < max shard rows {counts_np.max()}")
    if cap % B.WORD_BITS:
        raise ArrowTorchError(f"capacity {cap} is not a multiple of {B.WORD_BITS}")
    off, c = int(counts_np[:r].sum()), int(counts_np[r])
    nw = cap // B.WORD_BITS
    device = runtime.device

    cols = {}
    for name, col in batch.columns().items():
        if col.dtype is dt.ArrowType.BOOL:
            buf = shift_words(col.data, off, c, nw).to(device)
        else:
            buf = torch.zeros(cap, dtype=col.data.dtype, device=device)
            buf[:c] = col.data[off : off + c]
        v = None if col.validity is None else shift_words(col.validity, off, c, nw).to(device)
        cols[name] = ShardedColumn(buf, v, col.dtype)
    return ShardedBatch(cols, counts_tensor(counts_np, runtime), runtime)


def _prefixes_bits(words: torch.Tensor, counts: List[int]) -> torch.Tensor:
    """Bools of each shard's first counts[s] bits, concatenated in shard order."""
    return torch.cat([B.unpack_bits(words[s], c) for s, c in enumerate(counts)])


def gather_batch(sb: ShardedBatch) -> RecordBatch:
    """Collect a ShardedBatch into a host (CPU) RecordBatch in shard order,
    on every rank: one all_gather of each buffer."""
    rt = sb.runtime
    counts = [int(c) for c in sb.counts.tolist()]
    n = sum(counts)
    cols: Dict[str, ArrowArrayBase] = {}
    for name, col in sb.columns.items():
        data = rt.all_gather(col.data).cpu()
        mask = None if col.validity is None else _prefixes_bits(rt.all_gather(col.validity).cpu(), counts)
        vwords = None if mask is None else B.pack_bits(torch.nn.functional.pad(mask, (0, pad_len(n) - n)))
        if col.dtype is dt.ArrowType.BOOL:
            bools = _prefixes_bits(data, counts)
            if mask is not None:
                bools = bools & mask
                if bool(mask.all()):
                    vwords = None
            words = B.pack_bits(torch.nn.functional.pad(bools, (0, pad_len(n) - n)))
            cols[name] = make_array(words, vwords, n, col.dtype, "cpu")
        else:
            vals = torch.zeros(pad_len(n), dtype=data.dtype)
            vals[:n] = torch.cat([data[s, :c] for s, c in enumerate(counts)])
            cols[name] = make_array(vals, vwords, n, col.dtype, "cpu")
    return RecordBatch(cols)
