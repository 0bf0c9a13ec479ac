"""Gather of many columns by one or two index planes: the join's output take.

The JAX package's join takes each output column with ``ops.take``, which XLA
compiles to a gather, so this kernel replaces no Pallas kernel.  Its CUDA
source is ``arrow_tpu_torch/csrc/take_columns.cu``, whose note says why it
was added and how it is built.  Beside it, :func:`take_columns_plain` is the
same function in plain PyTorch: ``ops.swizzle.gather`` column by column.

:func:`take_columns` is the wrapper: the plain version for index planes on
the CPU, the kernel for index planes on a CUDA device (one launch a
``MAX_COLUMNS`` columns), never one in place of the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from ... import dtypes as dt
from ...ops.kernel import AV
from ...ops.swizzle import gather
from ...utils import bits as B
from . import _build

MAX_COLUMNS = 16
MAX_PLANES = 2
_KIND_BY_SIZE = {1: 0, 2: 1, 4: 2, 8: 3}
_KIND_BITS = 4

KERNEL = _build.register_kernel(
    _build.Kernel(
        name="take_columns",
        source="arrow_tpu_torch/csrc/take_columns.cu",
        replaces="none: XLA's gather (arrow_tpu/ops/swizzle.py take)",
    )
)

#: an output column's source and the index plane it reads
Column = Tuple[AV, int]


def take_columns_plain(columns: Sequence[Column], planes: Sequence[torch.Tensor], length: int) -> List[AV]:
    """Plain PyTorch version: for each (column, plane), out[i] =
    column[planes[plane][i]] for i < `length`, the u32 index clamped to the
    column's buffer, validity gathered alike; zeros (data and validity) from
    `length` to the planes' capacity."""
    wide = [dt.widen(p, dt.ArrowType.UINT32) for p in planes]
    return [gather(a, wide[p], length) for a, p in columns]


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` (a build of csrc/take_columns.cu) with its C entry's argument
    and result types set."""
    void_pp = ctypes.POINTER(ctypes.c_void_p)
    ll_p = ctypes.POINTER(ctypes.c_longlong)
    int_p = ctypes.POINTER(ctypes.c_int)
    lib.arrow_take_columns.argtypes = [
        void_pp, void_pp, void_pp, void_pp, ll_p, ll_p, int_p, int_p, ctypes.c_int, void_pp, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.arrow_take_columns.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    """The kernel library, declared once."""
    return declare(_build.load().cdll)


def _check(columns: Sequence[Column], planes: Sequence[torch.Tensor], length: int) -> int:
    """The planes' capacity, after checking what the kernel takes."""
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"take_columns takes 1 to {MAX_PLANES} index planes, not {len(planes)}")
    device, cap = planes[0].device, int(planes[0].shape[0])
    for i, p in enumerate(planes):
        if p.device != device or p.dtype != torch.int32 or p.dim() != 1 or not p.is_contiguous():
            raise ValueError(f"index plane {i} must be a contiguous 1-D int32 tensor on {device}")
        if p.shape[0] != cap:
            raise ValueError(f"index plane {i} has {p.shape[0]} rows, plane 0 {cap}")
    if not 0 <= length <= cap < 1 << 31:
        raise ValueError(f"length {length} outside [0, {cap}], or capacity {cap} past 2^31")
    for i, (a, p) in enumerate(columns):
        if not 0 <= p < len(planes):
            raise ValueError(f"column {i} reads index plane {p} of {len(planes)}")
        for what, t in (("data", a.data), ("validity", a.validity)):
            if t is None:
                continue
            if t.device != device or t.dim() != 1 or not t.is_contiguous():
                raise ValueError(f"column {i}'s {what} must be a contiguous 1-D tensor on {device}")
            if length and t.shape[0] == 0:
                raise ValueError(f"column {i}'s {what} is empty: no row to take")
        if a.validity is not None and a.validity.dtype != torch.int32:
            raise ValueError(f"column {i}'s validity must be int32 words")
        if a.dtype is dt.ArrowType.BOOL and a.data.dtype != torch.int32:
            raise ValueError(f"column {i}'s BOOL data must be int32 words")
    return cap


def outputs(columns: Sequence[Column], cap: int, length: int, device) -> List[AV]:
    """The kernel's outputs, allocated (not written): `cap` rows of each
    column's storage type (BOOL: words), validity words where it has some."""
    nwords = B.num_words(cap)
    outs = []
    for a, _ in columns:
        bits = a.dtype is dt.ArrowType.BOOL
        data = torch.empty(nwords if bits else cap, dtype=a.data.dtype, device=device)
        valid = None if a.validity is None else torch.empty(nwords, dtype=torch.int32, device=device)
        outs.append(AV(data, valid, length, a.dtype))
    return outs


def launch(lib: ctypes.CDLL, columns: Sequence[Column], planes: Sequence[torch.Tensor], length: int,
           outs: Sequence[AV], stream) -> int:
    """Call `lib`'s ``arrow_take_columns`` once a ``MAX_COLUMNS`` columns
    into `outs` (from :func:`outputs`), on `stream`; raises if a call
    returns an error.  Returns the launches made; counts none."""
    cap = int(planes[0].shape[0])
    if cap == 0:
        return 0
    index_planes = (ctypes.c_void_p * len(planes))(*[p.data_ptr() for p in planes])
    made = 0
    for lo in range(0, len(columns), MAX_COLUMNS):
        srcs = [a for a, _ in columns[lo:lo + MAX_COLUMNS]]
        dsts = outs[lo:lo + MAX_COLUMNS]
        k = len(srcs)

        def ptrs(ts):
            return (ctypes.c_void_p * k)(*[None if t is None else t.data_ptr() for t in ts])

        bits = [a.dtype is dt.ArrowType.BOOL for a in srcs]
        kinds = [_KIND_BITS if b else _KIND_BY_SIZE[a.data.element_size()] for a, b in zip(srcs, bits)]
        rows = [a.data.shape[0] * (B.WORD_BITS if b else 1) for a, b in zip(srcs, bits)]
        valid_rows = [0 if a.validity is None else a.validity.shape[0] * B.WORD_BITS for a in srcs]
        err = lib.arrow_take_columns(
            ptrs([a.data for a in srcs]), ptrs([a.validity for a in srcs]),
            ptrs([o.data for o in dsts]), ptrs([o.validity for o in dsts]),
            (ctypes.c_longlong * k)(*rows), (ctypes.c_longlong * k)(*valid_rows), (ctypes.c_int * k)(*kinds),
            (ctypes.c_int * k)(*[p for _, p in columns[lo:lo + MAX_COLUMNS]]), k,
            index_planes, len(planes), length, cap, stream,
        )
        _build.check(err, "take_columns")
        made += 1
    return made


def take_columns_cuda(columns: Sequence[Column], planes: Sequence[torch.Tensor], length: int) -> List[AV]:
    """Launch the CUDA kernel, once a ``MAX_COLUMNS`` columns (see
    :func:`take_columns_plain`); the outputs are allocated here."""
    cap = _check(columns, planes, length)
    device = planes[0].device
    if device.type != "cuda":
        raise ValueError("take_columns_cuda needs CUDA tensors")
    planes = [p if p.data_ptr() % 16 == 0 else p.clone() for p in planes]  # the kernel's 16-byte index loads
    outs = outputs(columns, cap, length, device)
    with torch.cuda.device(device):
        KERNEL.launches += launch(_lib(), columns, planes, length, outs, _build.stream_of(planes[0]))
    return outs


def take_columns(columns: Sequence[Column], planes: Sequence[torch.Tensor], length: int) -> List[AV]:
    """Gather many columns by one or two index planes of equal capacity.

    columns: (AV, plane) pairs, the plane being the index into `planes` that
    the column reads; planes: 1-D int32 tensors holding u32 row ids (a
    ``UInt32Array``'s data, as ``join_indices`` returns it); `length`: the
    rows to take.  Returns one AV a column, in order: out[i] =
    column[min(idx[i], rows - 1)] for i < `length` (rows: the column's buffer
    rows), validity and BOOL bits gathered alike, zeros in data and validity
    from `length` to the planes' capacity, which is the outputs' capacity.
    CPU planes take the plain version; CUDA planes launch the kernel.
    """
    if planes[0].device.type == "cpu":
        return take_columns_plain(columns, planes, length)
    return take_columns_cuda(columns, planes, length)
