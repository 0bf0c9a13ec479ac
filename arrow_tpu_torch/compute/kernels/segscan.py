"""Inclusive segmented (or plain) scan of one to three planes (kernel B2).

Counterpart of ``arrow_tpu/compute/kernels/segscan.py``: ``segscan_pallas``
(planes of one dtype that share one flag plane) and
``segmented_scan_pallas`` (one plane).  The CUDA kernel is
``arrow_tpu_torch/csrc/segscan.cuh``, a single-pass scan with decoupled
look-back, launched from ``segscan.cu`` (4-byte types) and
``segscan_wide.cu`` (8-byte types).  Beside it, :func:`segmented_scan_plain`
is the same function in plain PyTorch: the Hillis-Steele ladder of
``arrow_tpu/utils/scans.py::segmented_scan``, so that on the CPU it adds in
the JAX package's CPU order.

Semantics, in flat order, on each plane::

    out[i] = vals[i]                       if flags[i] or i == 0
             combine(out[i-1], vals[i])    otherwise

combine is add, max, min or first.  `unsigned=True` gives int32/int64
storage its u32/u64 meaning (unsigned max/min; add is the same bits).

:func:`segmented_scan_multi` is the wrapper: plain version for CPU tensors,
one kernel launch for CUDA tensors, never one in place of the other.
:func:`segmented_scan` is its one-plane case.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from . import _build

OPS = ("add", "max", "min", "first")
MAX_PLANES = 3  # as the join fills them in one call
_OP_CODE = {op: i for i, op in enumerate(OPS)}
# (torch dtype, unsigned) -> the kernel's dtype code
_DTYPE_CODE = {
    (torch.int32, False): 0,
    (torch.int32, True): 1,
    (torch.float32, False): 2,
    (torch.int64, False): 3,
    (torch.int64, True): 4,
    (torch.float64, False): 5,
}

KERNEL = _build.register_kernel(
    _build.Kernel(
        name="segmented_scan",
        source="arrow_tpu_torch/csrc/segscan.cuh",
        replaces="arrow_tpu/compute/kernels/segscan.py:206",
    )
)


def _combine(op: str, dtype: torch.dtype, unsigned: bool):
    if op == "add":
        return torch.add
    if op == "first":
        return lambda a, b: a
    fn = torch.maximum if op == "max" else torch.minimum
    if not unsigned:
        return fn
    # unsigned order = signed order with the sign bit flipped
    sign = torch.iinfo(dtype).min
    return lambda a, b: fn(a ^ sign, b ^ sign) ^ sign


def _check_args(vals, flags, op, unsigned):
    if op not in OPS:
        raise ValueError(f"unknown scan op {op!r}")
    if (vals.dtype, unsigned) not in _DTYPE_CODE:
        raise ValueError(f"scan of {vals.dtype} (unsigned={unsigned}) not supported")
    if vals.dim() != 1:
        raise ValueError("scan input must be 1-D")
    if flags is not None:
        if flags.dtype != torch.bool or flags.shape != vals.shape:
            raise ValueError("flags must be a bool tensor of the values' shape")
        if flags.device != vals.device:
            raise ValueError(f"flags on {flags.device}, values on {vals.device}")


def segmented_scan_plain(
    vals: torch.Tensor, flags: Optional[torch.Tensor], op: str, unsigned: bool = False
) -> torch.Tensor:
    """Plain PyTorch B2: log2(n) shift+combine passes (Hillis-Steele)."""
    _check_args(vals, flags, op, unsigned)
    combine = _combine(op, vals.dtype, unsigned)
    n = vals.shape[0]
    idx = torch.arange(n, device=vals.device)
    v = vals
    f = flags if flags is not None else torch.zeros(n, dtype=torch.bool, device=vals.device)
    d = 1
    while d < n:
        pv = torch.roll(v, d)
        pf = torch.roll(f, d)
        has_pred = idx >= d
        take = has_pred & ~f
        v = torch.where(take, combine(pv, v), v)
        f = f | (has_pred & pf)
        d <<= 1
    return v


def _check_planes(planes, flags, op, unsigned) -> list:
    planes = list(planes)
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"a scan takes 1 to {MAX_PLANES} planes, got {len(planes)}")
    head = planes[0]
    for p in planes[1:]:
        if p.dtype != head.dtype or p.shape != head.shape or p.device != head.device:
            raise ValueError("scan planes must share one dtype, length and device")
    _check_args(head, flags, op, unsigned)
    return planes


def segmented_scan_multi_plain(
    planes: Sequence[torch.Tensor], flags: Optional[torch.Tensor], op: str, unsigned: bool = False
) -> List[torch.Tensor]:
    """Plain PyTorch B2 over planes that share `flags`: the ladder of
    :func:`segmented_scan_plain` on each plane."""
    planes = _check_planes(planes, flags, op, unsigned)
    return [segmented_scan_plain(p, flags, op, unsigned) for p in planes]


def segmented_scan_multi_cuda(
    planes: Sequence[torch.Tensor], flags: Optional[torch.Tensor], op: str, unsigned: bool = False
) -> List[torch.Tensor]:
    """Launch the B2 CUDA kernel once for all planes (see
    :func:`segmented_scan_multi_plain`)."""
    planes = _check_planes(planes, flags, op, unsigned)
    if planes[0].device.type != "cuda":
        raise ValueError("segmented_scan_multi_cuda needs CUDA tensors")
    planes = [p.contiguous() for p in planes]
    flags = flags.contiguous() if flags is not None else None
    n, k = planes[0].shape[0], len(planes)
    outs = [torch.empty_like(p) for p in planes]
    if n == 0:
        return outs
    dtype, opc = _DTYPE_CODE[(planes[0].dtype, unsigned)], _OP_CODE[op]
    lib = _build.load().cdll
    lib.arrow_segscan_scratch_bytes.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.arrow_segscan_scratch_bytes.restype = ctypes.c_longlong
    scratch = torch.empty(
        lib.arrow_segscan_scratch_bytes(n, dtype, opc, k), dtype=torch.uint8, device=planes[0].device
    )
    # a view with a storage offset takes the kernel's element-wise path
    ptrs = [t.data_ptr() for t in (*planes, *outs, *([flags] if flags is not None else []))]
    aligned = all(ptr % 16 == 0 for ptr in ptrs)
    fn = lib.arrow_segscan
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(planes[0].device):
        err = fn(
            (ctypes.c_void_p * k)(*[p.data_ptr() for p in planes]),
            (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs]),
            k, flags.data_ptr() if flags is not None else None, dtype, opc, n, int(aligned),
            scratch.data_ptr(), _build.stream_of(planes[0]),
        )
    _build.check(err, "segmented_scan")
    KERNEL.launches += 1
    return outs


def segmented_scan_multi(
    planes: Sequence[torch.Tensor], flags: Optional[torch.Tensor], op: str, unsigned: bool = False
) -> List[torch.Tensor]:
    """Inclusive scan with `op` of each of 1-3 planes of one dtype, all
    restarting where `flags` is True (flags None: plain scans), as
    ``segscan_pallas`` takes them.  CPU tensors take the plain version; CUDA
    tensors launch the kernel once."""
    planes = list(planes)
    if planes and planes[0].device.type == "cpu":
        return segmented_scan_multi_plain(planes, flags, op, unsigned)
    return segmented_scan_multi_cuda(planes, flags, op, unsigned)


def segmented_scan_cuda(
    vals: torch.Tensor, flags: Optional[torch.Tensor], op: str, unsigned: bool = False
) -> torch.Tensor:
    """Launch the B2 CUDA kernel on one plane."""
    return segmented_scan_multi_cuda([vals], flags, op, unsigned)[0]


def segmented_scan(
    vals: torch.Tensor, flags: Optional[torch.Tensor], op: str, unsigned: bool = False
) -> torch.Tensor:
    """Inclusive scan of `vals` with `op`, restarting where `flags` is True
    (flags None: a plain scan): the one-plane case of
    :func:`segmented_scan_multi`."""
    return segmented_scan_multi([vals], flags, op, unsigned)[0]
