"""COUNT and exact SUM grouped by dense keys in [0, 4096) (kernel B5).

Counterpart of ``arrow_tpu/compute/kernels/groupby_mxu.py::groupby_dense_pallas``.
The CUDA kernel is ``arrow_tpu_torch/csrc/groupby_mxu.cu``, a histogram
privatised in each block's shared memory (the TPU kernel's one-hot MXU
matmuls on 8-bit limbs are TPU plumbing); its source note says how it is
built.  Beside it, :func:`groupby_dense_plain` is the same function in plain
PyTorch (``index_add_`` into an int64 table and a count).

Contract, both versions: keys in [0, 4096) (others add nothing); values read
as unsigned 32-bit, below 2^(8 x nlimb) (bits above are cut, as the TPU
kernel's limbs cut them); rows at and past ``length`` excluded.  Returns
(count (4096,) int32, sum (4096,) int64), exact.

:func:`groupby_dense` is the wrapper: the plain version for tensors on the
CPU, the kernel for tensors on a CUDA device, never one in place of the
other.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

SLOTS = 4096
LIMB_BITS = 8
MAX_LIMBS = 4

KERNEL = _build.register_kernel(
    _build.Kernel(
        name="groupby_dense",
        source="arrow_tpu_torch/csrc/groupby_mxu.cu",
        replaces="arrow_tpu/compute/kernels/groupby_mxu.py:242",
    )
)


def nlimbs_for_bits(valbits: int) -> int:
    """The 8-bit limbs that hold a value of `valbits` bits."""
    return max(1, -(-valbits // LIMB_BITS))


def value_mask(nlimb: int) -> int:
    """The value bits the sums keep: the low 8 x nlimb."""
    return (1 << (LIMB_BITS * nlimb)) - 1


def check_planes(keys: torch.Tensor, vals: torch.Tensor, nlimb: int, rows: int) -> None:
    """What both group-by kernels take: 1-D contiguous int32 keys and 4-byte
    values of at least `rows` rows on one device, 1 to 4 limbs."""
    if not 1 <= nlimb <= MAX_LIMBS:
        raise ValueError(f"nlimb {nlimb} not in 1..{MAX_LIMBS}")
    if keys.dtype != torch.int32:
        raise ValueError(f"keys must be int32, not {keys.dtype}")
    if vals.element_size() != 4 or vals.is_floating_point():
        raise ValueError(f"values must be 32-bit integers, not {vals.dtype}")
    if vals.device != keys.device:
        raise ValueError(f"values are on {vals.device}, keys on {keys.device}")
    for name, t in (("keys", keys), ("values", vals)):
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
        if t.shape[0] < rows:
            raise ValueError(f"{name} have {t.shape[0]} rows, need {rows}")
    if not 0 <= rows < 1 << 31:
        raise ValueError(f"row count {rows} out of range")


def table_plain(keys: torch.Tensor, vals: torch.Tensor, nlimb: int, slots: int):
    """(count int32, sum int64) over `slots` keys by index_add_; keys outside
    [0, slots) land in one extra slot that is dropped."""
    k = keys.to(torch.int64)
    k = torch.where((k >= 0) & (k < slots), k, slots)
    v = vals.to(torch.int64) & value_mask(nlimb)  # unsigned 32-bit, cut to the limbs
    count = torch.bincount(k, minlength=slots + 1)[:slots].to(torch.int32)
    total = torch.zeros(slots + 1, dtype=torch.int64, device=keys.device).index_add_(0, k, v)
    return count, total[:slots]


def _rows(keys: torch.Tensor, length: Optional[int]) -> int:
    n = int(keys.shape[0])
    return n if length is None else max(0, min(n, length))


def groupby_dense_plain(
    keys: torch.Tensor, vals: torch.Tensor, nlimb: int = 4, length: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch B5 (see the module note)."""
    n = _rows(keys, length)
    check_planes(keys, vals, nlimb, n)
    return table_plain(keys[:n], vals[:n], nlimb, SLOTS)


def groupby_dense_cuda(
    keys: torch.Tensor, vals: torch.Tensor, nlimb: int = 4, length: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the B5 CUDA kernel (see :func:`groupby_dense_plain`)."""
    n = _rows(keys, length)
    check_planes(keys, vals, nlimb, n)
    if keys.device.type != "cuda":
        raise ValueError("groupby_dense_cuda needs CUDA tensors")
    count = torch.zeros(SLOTS, dtype=torch.int32, device=keys.device)
    total = torch.zeros(SLOTS, dtype=torch.int64, device=keys.device)
    fn = _build.load().cdll.arrow_groupby_dense
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(keys.device):
        err = fn(keys.data_ptr(), vals.data_ptr(), n, nlimb, count.data_ptr(), total.data_ptr(),
                 _build.stream_of(keys))
    _build.check(err, "groupby_dense")
    KERNEL.launches += 1
    return count, total


def groupby_dense(
    keys: torch.Tensor, vals: torch.Tensor, nlimb: int = 4, length: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """COUNT and exact SUM of `vals` by `keys` in [0, 4096) over the first
    `length` rows (default: all).  keys: int32; vals: 32-bit integers read
    as unsigned, below 2^(8 x nlimb).  Returns (count (4096,) int32, sum
    (4096,) int64).  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if keys.device.type == "cpu":
        return groupby_dense_plain(keys, vals, nlimb, length)
    return groupby_dense_cuda(keys, vals, nlimb, length)
