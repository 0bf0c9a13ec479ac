"""COUNT and exact SUM grouped by dense keys in [0, 4096) (kernel B5).

Counterpart of ``arrow_tpu/compute/kernels/groupby_mxu.py::groupby_dense_pallas``.
The CUDA kernel is ``arrow_tpu_torch/csrc/groupby_mxu.cu``, a histogram
privatised in each block's shared memory (the TPU kernel's one-hot MXU
matmuls on 8-bit limbs are TPU plumbing); its source note says how it is
built.  Beside it, :func:`groupby_dense_plain` is the same function in plain
PyTorch (``index_add_`` into an int64 table and a count).

Contract, both versions: keys in [0, 4096) (others add nothing); values of
32 or 64 bits read as unsigned, below 2^(8 x nlimb) (bits above are cut, as
the TPU kernel's limbs cut them; nlimb up to the value's bytes); rows at and
past ``length`` excluded.  Returns (count (4096,) int32, sum (4096,) int64),
exact while each sum stays below 2^64 (64-bit values: the caller checks rows
x the largest value).

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


def check_planes(keys: torch.Tensor, vals: torch.Tensor, nlimb: int, rows: int,
                 value_bytes: Tuple[int, ...] = (4,)) -> None:
    """What the group-by kernels take: 1-D contiguous int32 keys and integer
    values of one of `value_bytes` bytes (B5: 4 or 8; B6: 4), of at least
    `rows` rows on one device, 1 to (the values' bytes) limbs."""
    if keys.dtype != torch.int32:
        raise ValueError(f"keys must be int32, not {keys.dtype}")
    if vals.element_size() not in value_bytes or vals.is_floating_point() or vals.dtype == torch.bool:
        bits = " or ".join(str(8 * b) for b in value_bytes)
        raise ValueError(f"values must be {bits}-bit integers, not {vals.dtype}")
    if not 1 <= nlimb <= vals.element_size():
        raise ValueError(f"nlimb {nlimb} not in 1..{vals.element_size()}")
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
    v = vals.to(torch.int64)  # 64-bit sums wrap as the kernel's u64 sums do
    if nlimb < 8:  # unsigned, cut to the limbs
        v &= value_mask(nlimb)
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
    check_planes(keys, vals, nlimb, n, (4, 8))
    return table_plain(keys[:n], vals[:n], nlimb, SLOTS)


def declare(cdll: ctypes.CDLL):
    """The C entry ``arrow_groupby_dense`` of `cdll`, typed: (keys, values,
    rows, value bytes, nlimb, count, sum, stream)."""
    fn = cdll.arrow_groupby_dense
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def groupby_dense_cuda(
    keys: torch.Tensor, vals: torch.Tensor, nlimb: int = 4, length: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the B5 CUDA kernel (see :func:`groupby_dense_plain`)."""
    n = _rows(keys, length)
    check_planes(keys, vals, nlimb, n, (4, 8))
    if keys.device.type != "cuda":
        raise ValueError("groupby_dense_cuda needs CUDA tensors")
    count = torch.zeros(SLOTS, dtype=torch.int32, device=keys.device)
    total = torch.zeros(SLOTS, dtype=torch.int64, device=keys.device)
    fn = declare(_build.load().cdll)
    with torch.cuda.device(keys.device):
        err = fn(keys.data_ptr(), vals.data_ptr(), n, vals.element_size(), nlimb, count.data_ptr(),
                 total.data_ptr(), _build.stream_of(keys))
    _build.check(err, "groupby_dense")
    KERNEL.launches += 1
    return count, total


def groupby_dense(
    keys: torch.Tensor, vals: torch.Tensor, nlimb: int = 4, length: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """COUNT and exact SUM of `vals` by `keys` in [0, 4096) over the first
    `length` rows (default: all).  keys: int32; vals: 32- or 64-bit integers
    read as unsigned, below 2^(8 x nlimb).  Returns (count (4096,) int32, sum
    (4096,) int64).  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if keys.device.type == "cpu":
        return groupby_dense_plain(keys, vals, nlimb, length)
    return groupby_dense_cuda(keys, vals, nlimb, length)
