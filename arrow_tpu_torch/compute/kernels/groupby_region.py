"""COUNT and exact SUM over class-grouped keys in [0, nclass x 4096) (kernel B6).

Counterpart of ``arrow_tpu/compute/kernels/groupby_region.py::groupby_region_pallas``.
The CUDA kernel is ``arrow_tpu_torch/csrc/groupby_region.cu``: each block
walks a contiguous range of rows with one 4096-slot region table in shared
memory and flushes it with global atomics when the class (``key >> 12``)
changes; its source note says how it is built.  Beside it,
:func:`groupby_region_plain` is the same function in plain PyTorch.

Contract, both versions: keys in [0, nclass x 4096) (others add nothing);
values read as unsigned 32-bit, below 2^(8 x nlimb).  The rows come grouped
by class (the partition group-by sorts them so), which makes the kernel fast;
its flushes add, so it is right for any row order.  There is no garbage
class: the caller passes only live rows.  Returns (count (nclass x 4096,)
int32, sum (nclass x 4096,) int64), exact.

:func:`groupby_region` is the wrapper: the plain version for tensors on the
CPU, the kernel for tensors on a CUDA device, never one in place of the
other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .groupby_mxu import SLOTS, check_planes, table_plain

MAX_CLASSES = 1024  # a key domain of at most 2^22

KERNEL = _build.register_kernel(
    _build.Kernel(
        name="groupby_region",
        source="arrow_tpu_torch/csrc/groupby_region.cu",
        replaces="arrow_tpu/compute/kernels/groupby_region.py:217",
    )
)


def _check(keys, vals, nlimb, nclass) -> None:
    if not 1 <= nclass <= MAX_CLASSES:
        raise ValueError(f"nclass {nclass} not in 1..{MAX_CLASSES}")
    check_planes(keys, vals, nlimb, int(keys.shape[0]))


def groupby_region_plain(
    keys: torch.Tensor, vals: torch.Tensor, nlimb: int, nclass: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch B6 (see the module note)."""
    _check(keys, vals, nlimb, nclass)
    return table_plain(keys, vals[: keys.shape[0]], nlimb, nclass * SLOTS)


def groupby_region_cuda(
    keys: torch.Tensor, vals: torch.Tensor, nlimb: int, nclass: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the B6 CUDA kernel (see :func:`groupby_region_plain`)."""
    _check(keys, vals, nlimb, nclass)
    if keys.device.type != "cuda":
        raise ValueError("groupby_region_cuda needs CUDA tensors")
    slots = nclass * SLOTS
    count = torch.zeros(slots, dtype=torch.int32, device=keys.device)
    total = torch.zeros(slots, dtype=torch.int64, device=keys.device)
    fn = _build.load().cdll.arrow_groupby_region
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(keys.device):
        err = fn(keys.data_ptr(), vals.data_ptr(), int(keys.shape[0]), nlimb, nclass,
                 count.data_ptr(), total.data_ptr(), _build.stream_of(keys))
    _build.check(err, "groupby_region")
    KERNEL.launches += 1
    return count, total


def groupby_region(
    keys: torch.Tensor, vals: torch.Tensor, nlimb: int, nclass: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """COUNT and exact SUM of `vals` by `keys` in [0, nclass x 4096), rows
    best grouped by ``key >> 12``.  keys: int32; vals: 32-bit integers read
    as unsigned, below 2^(8 x nlimb).  Returns (count (nclass x 4096,)
    int32, sum (nclass x 4096,) int64).  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if keys.device.type == "cpu":
        return groupby_region_plain(keys, vals, nlimb, nclass)
    return groupby_region_cuda(keys, vals, nlimb, nclass)
