"""Stable pairwise merge of sorted runs (kernel B7) and the sort built on it.

Counterpart of ``arrow_tpu/compute/kernels/merge.py``: ``merge_pass_pallas``
(one merge pass), ``to_sortable_i32`` / ``from_sortable_i32`` and
``sort_kv_pallas``.  The CUDA kernel is ``arrow_tpu_torch/csrc/merge.cu``.
Beside it, :func:`merge_pass_plain` is the same pass in plain PyTorch: a
stable sort of each run pair by (pair, key[, payload]).

:func:`merge_pass` is the wrapper: the plain version for CPU tensors, the
kernel for CUDA tensors, never one in place of the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Sequence, Tuple

import torch

from . import _build

MAX_PLANES = 8
RUN0 = 8192  # stage-1 run length of sort_kv
SENT = 0x7FFFFFFF  # the largest sortable key: rows past `length` take it
_HALF = 1 << 31

KERNEL = _build.register_kernel(
    _build.Kernel(
        name="merge_pass",
        source="arrow_tpu_torch/csrc/merge.cu",
        replaces="arrow_tpu/compute/kernels/merge.py:373",
    )
)

Planes = Tuple[torch.Tensor, ...]


def _check_args(planes, run_len: int, unique_payload: bool) -> None:
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"merge_pass takes 1 to {MAX_PLANES} planes, not {len(planes)}")
    if unique_payload and len(planes) != 2:
        raise ValueError("unique_payload mode requires exactly key + payload")
    if run_len < 1:
        raise ValueError(f"run length {run_len} < 1")
    n, device = planes[0].shape[0], planes[0].device
    if not n < 1 << 31:
        raise ValueError(f"row count {n} out of range")
    for i, p in enumerate(planes):
        if p.dtype != torch.int32:
            raise ValueError(f"plane {i} must be int32, not {p.dtype}")
        if p.dim() != 1 or p.shape[0] != n:
            raise ValueError(f"plane {i} must be 1-D with {n} rows")
        if p.device != device:
            raise ValueError(f"plane {i} is on {p.device}, the key on {device}")


def merge_pass_plain(planes: Sequence[torch.Tensor], run_len: int, unique_payload: bool = False) -> Planes:
    """Plain PyTorch B7: one stable sort of every run pair by (pair, key),
    packed into int64; in unique-payload mode a stable sort by the payload
    first, so that ties of the key fall to it."""
    planes = tuple(planes)
    _check_args(planes, run_len, unique_payload)
    n = planes[0].shape[0]
    pair = torch.arange(n, dtype=torch.int64, device=planes[0].device) // (2 * run_len)
    perm = torch.arange(n, device=planes[0].device)
    if unique_payload:
        perm = torch.sort(planes[1], stable=True).indices
    packed = (pair[perm] << 32) | (planes[0][perm].to(torch.int64) + _HALF)
    perm = perm[torch.sort(packed, stable=True).indices]
    return tuple(p[perm] for p in planes)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` (a build of csrc/merge.cu) with its C entries' argument and
    result types set."""
    lib.arrow_merge_scratch_bytes.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    lib.arrow_merge_scratch_bytes.restype = ctypes.c_longlong
    void_pp = ctypes.POINTER(ctypes.c_void_p)
    lib.arrow_merge_pass.argtypes = [
        void_pp, void_pp, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.arrow_merge_pass.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    """The kernel library, declared once."""
    return declare(_build.load().cdll)


def merge_pass_cuda(planes: Sequence[torch.Tensor], run_len: int, unique_payload: bool = False) -> Planes:
    """Launch the B7 CUDA kernel (see :func:`merge_pass_plain`)."""
    planes = tuple(p.contiguous() for p in planes)
    _check_args(planes, run_len, unique_payload)
    device = planes[0].device
    if device.type != "cuda":
        raise ValueError("merge_pass_cuda needs CUDA tensors")
    n = planes[0].shape[0]
    outs = tuple(torch.empty(n, dtype=torch.int32, device=device) for _ in planes)  # 16-byte aligned
    if n == 0:
        return outs
    lib = _lib()
    scratch = torch.empty(lib.arrow_merge_scratch_bytes(n, run_len), dtype=torch.uint8, device=device)
    k = len(planes)
    with torch.cuda.device(device):
        err = lib.arrow_merge_pass(
            (ctypes.c_void_p * k)(*[p.data_ptr() for p in planes]),
            (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs]),
            k, n, run_len, int(unique_payload), scratch.data_ptr(), _build.stream_of(planes[0]),
        )
    _build.check(err, "merge_pass")
    KERNEL.launches += 1
    return outs


def merge_pass(planes: Sequence[torch.Tensor], run_len: int, unique_payload: bool = False) -> Planes:
    """One pass of a stable merge of adjacent sorted runs.

    planes: 1 to 8 int32 planes of n rows, plane 0 the sortable key, holding
    sorted runs of `run_len` rows (the last may be short).  Runs 2k and 2k+1
    merge into one; A's rows come first on equal keys.  unique_payload: two
    planes, runs sorted by (key, payload), and the payload breaks ties.
    Returns the merged planes.  CPU tensors take the plain version; CUDA
    tensors launch the kernel.
    """
    planes = tuple(planes)
    if planes and planes[0].device.type == "cpu":
        return merge_pass_plain(planes, run_len, unique_payload)
    return merge_pass_cuda(planes, run_len, unique_payload)


def to_sortable_i32(x: torch.Tensor, unsigned: bool = False) -> torch.Tensor:
    """Order-preserving bijection into int32 (ascending): int32 as is, u32
    (int32 storage, `unsigned`) with the sign bit flipped, f32 with the
    magnitude bits of negatives flipped (-NaN first, +NaN last)."""
    if x.dtype == torch.float32:
        i = x.view(torch.int32)
        return torch.where(i < 0, i ^ 0x7FFFFFFF, i)
    if x.dtype != torch.int32:
        raise TypeError(f"no sortable transform for {x.dtype}")
    return x ^ -_HALF if unsigned else x


def from_sortable_i32(k: torch.Tensor, dtype: torch.dtype, unsigned: bool = False) -> torch.Tensor:
    """Inverse of :func:`to_sortable_i32`."""
    if dtype == torch.float32:
        return torch.where(k < 0, k ^ 0x7FFFFFFF, k).view(torch.float32)
    if dtype != torch.int32:
        raise TypeError(f"no sortable transform for {dtype}")
    return k ^ -_HALF if unsigned else k


def sort_kv(
    keys: torch.Tensor,
    payloads: Sequence[torch.Tensor] = (),
    length: Optional[int] = None,
    unique_payload: bool = False,
    unsigned: bool = False,
    merge: Callable[..., Planes] = merge_pass,
) -> Tuple[torch.Tensor, Planes]:
    """Stable sort of int32/u32/f32 keys with 32-bit payload planes: stage 1
    sorts runs of ``RUN0`` rows (``torch.sort``), then `merge` passes (B7)
    double the runs until one is left.

    Rows from `length` on sort last, as the largest key.  unique_payload:
    exactly one payload whose values strictly order equal keys (row ids);
    the merge breaks ties by it.  With more payloads than a merge pass moves
    (``MAX_PLANES - 1``), the passes sort row ids and the payloads are
    gathered by them.  Returns (sorted keys, sorted payloads) in the input
    dtypes.
    """
    n = keys.shape[0]
    if unique_payload and len(payloads) != 1:
        raise ValueError("unique_payload mode requires exactly one payload")
    if 1 + len(payloads) > MAX_PLANES:  # more planes than a pass moves: sort row ids
        rows = torch.arange(n, dtype=torch.int32, device=keys.device)
        out_k, (order,) = sort_kv(keys, (rows,), length, True, unsigned, merge)
        return out_k, tuple(p[order] for p in payloads)
    k = to_sortable_i32(keys, unsigned)
    if length is not None and length < n:
        k = torch.where(torch.arange(n, device=k.device) < length, k, SENT)
    planes = [k, *(p.view(torch.int32) if p.dtype != torch.int32 else p for p in payloads)]
    full = n - n % RUN0
    pieces = [[] for _ in planes]
    for lo, hi in ((0, full), (full, n)):  # the whole runs, then the short one
        if hi == lo:
            continue
        runs = [p[lo:hi].reshape(-1, min(RUN0, hi - lo)) for p in planes]
        if unique_payload:  # (key, payload) in one int64, payload signed
            packed = (runs[0].to(torch.int64) << 32) | (runs[1].to(torch.int64) + _HALF)
            order = torch.sort(packed, dim=1, stable=True).indices
        else:
            order = torch.sort(runs[0], dim=1, stable=True).indices
        for ps, r in zip(pieces, runs):
            ps.append(torch.gather(r, 1, order).reshape(-1))
    planes = tuple(torch.cat(ps) if len(ps) != 1 else ps[0] for ps in pieces) if n else tuple(planes)
    run = RUN0
    while run < n:
        planes = merge(planes, run, unique_payload)
        run *= 2
    out_k = from_sortable_i32(planes[0], keys.dtype, unsigned)
    out_ps = tuple(o.view(p.dtype) if p.dtype != torch.int32 else o for o, p in zip(planes[1:], payloads))
    return out_k, out_ps
