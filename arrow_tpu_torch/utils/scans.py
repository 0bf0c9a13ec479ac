"""Scan and partition primitives (counterpart of ``arrow_tpu/utils/scans.py``).

Routing: every function here that has a kernel behind it calls the kernel's
wrapper, which launches the CUDA kernel for CUDA tensors and runs the plain
PyTorch version for CPU tensors (the plain version on any device inside
``compute.kernels.plain_versions()``, the reference path).  The JAX
package's ``merge_lex_sort`` has no counterpart here: the port sorts on
kernel B7 only where a caller asks ``compute.sort`` for ``method="merge"``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .. import dtypes as dt
from ..compute import kernels as CK
from ..runtime.profiler import host_read
from . import bits as B


def stable_partition(flags: torch.Tensor, operands: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Move rows where `flags` is True to the front (stable), carrying the
    operands: one stable sort on a 0/1 key, then a gather per operand."""
    perm = torch.sort((~flags).to(torch.int32), stable=True).indices
    return [o[perm] for o in operands]


def segmented_scan(
    vals: torch.Tensor,
    starts: torch.Tensor,
    op: str,
    unsigned: bool = False,
) -> torch.Tensor:
    """Inclusive scan of `vals` with `op` (add/max/min/first), restarting at
    rows where `starts` is True (kernel B2)."""
    return CK.segmented_scan(vals, starts, op, unsigned)


def prefix_sum(v: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum (kernel B2, plain scan)."""
    return CK.segmented_scan(v, None, "add")


def segment_broadcast_first(vals: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Every row takes the value `vals` has at its segment's first row."""
    return CK.segmented_scan(vals, starts, "first")


def segment_broadcast_last(vals: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Every row takes the value `vals` has at its segment's last row."""
    return torch.flip(CK.segmented_scan(torch.flip(vals, (0,)), torch.flip(ends, (0,)), "first"), (0,))


def shift_cummax(v: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Cumulative max, forward or from the end (kernel B2, plain scan)."""
    if reverse:
        return torch.flip(CK.segmented_scan(torch.flip(v, (0,)), None, "max"), (0,))
    return CK.segmented_scan(v, None, "max")


def sort_limbs(keys: torch.Tensor, dtype: dt.ArrowType) -> List[torch.Tensor]:
    """Split an integer key column into int64 limbs of at most 32 bits, high
    limb first, whose signed orders compose lexicographically to the Arrow
    order of `keys` (for a multi-key stable sort)."""
    if dt.item_size(dtype) == 8:
        hi = keys >> 32  # arithmetic: the signed order of an i64's high half
        if dt.is_unsigned(dtype):
            hi = hi & 0xFFFFFFFF
        return [hi, keys & 0xFFFFFFFF]
    return [dt.widen(keys, dtype)]


def segment_ends(starts: torch.Tensor, n_valid) -> torch.Tensor:
    """End-of-segment flags given start flags over the valid prefix.

    Row i ends its segment iff row i+1 starts one (or i is the last valid row).
    """
    n = starts.shape[0]
    if n == 0:
        return starts.clone()
    nxt = torch.roll(starts, -1)
    # torch copies the Python scalar from pageable host memory and waits
    with host_read("last_segment_end"):
        nxt[n - 1] = True
    idx = torch.arange(n, device=starts.device)
    return (idx < n_valid) & (nxt | (idx == n_valid - 1))


def compact_rows(flags: torch.Tensor, operands: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Stable-compact rows where `flags` is True to the front of each operand
    (kernel B1, at most ``compaction3.MAX_PLANES`` planes per launch).

    Rows at and past the count are zero in every output.  4- and 8-byte
    planes ride as they are; narrower ones are widened to int32 and back.
    """
    n = flags.shape[0]
    select = B.pack_bits(flags)
    planes = [p if p.element_size() >= 4 else p.to(torch.int32) for p in operands]
    outs: List[torch.Tensor] = []
    for i in range(0, len(planes), CK.compaction3.MAX_PLANES):
        vouts, _, _ = CK.compact_multi(planes[i : i + CK.compaction3.MAX_PLANES], (), select, n)
        outs.extend(vouts)
    return [o if o.dtype == p.dtype else o.to(p.dtype) for o, p in zip(outs, operands)]
