"""Inclusive segmented (or plain) scan of one plane (kernel B2).

Counterpart of ``arrow_tpu/compute/kernels/segscan.py::segmented_scan_pallas``.
The CUDA kernel is ``arrow_tpu_torch/csrc/segscan.cu``.  Beside it,
:func:`segmented_scan_plain` is the same function in plain PyTorch: the
Hillis-Steele ladder of ``arrow_tpu/utils/scans.py::segmented_scan``, so that
on the CPU it adds in the JAX package's CPU order.

Semantics, in flat order::

    out[i] = vals[i]                       if flags[i] or i == 0
             combine(out[i-1], vals[i])    otherwise

combine is add, max, min or first.  `unsigned=True` gives int32/int64
storage its u32/u64 meaning (unsigned max/min; add is the same bits).

:func:`segmented_scan` is the wrapper: plain version for CPU tensors, the
kernel for CUDA tensors, never one in place of the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

OPS = ("add", "max", "min", "first")
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
        source="arrow_tpu_torch/csrc/segscan.cu",
        replaces="arrow_tpu/compute/kernels/segscan.py:276",
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


def segmented_scan_cuda(
    vals: torch.Tensor, flags: Optional[torch.Tensor], op: str, unsigned: bool = False
) -> torch.Tensor:
    """Launch the B2 CUDA kernel (see :func:`segmented_scan_plain`)."""
    _check_args(vals, flags, op, unsigned)
    if vals.device.type != "cuda":
        raise ValueError("segmented_scan_cuda needs CUDA tensors")
    vals = vals.contiguous()
    flags = flags.contiguous() if flags is not None else None
    n = vals.shape[0]
    out = torch.empty_like(vals)
    if n == 0:
        return out
    lib = _build.load().cdll
    lib.arrow_segscan_scratch_bytes.argtypes = [ctypes.c_longlong]
    lib.arrow_segscan_scratch_bytes.restype = ctypes.c_longlong
    scratch = torch.empty(
        lib.arrow_segscan_scratch_bytes(n), dtype=torch.uint8, device=vals.device
    )
    fn = lib.arrow_segscan
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(vals.device):
        err = fn(
            vals.data_ptr(), flags.data_ptr() if flags is not None else None,
            _DTYPE_CODE[(vals.dtype, unsigned)], _OP_CODE[op], n,
            scratch.data_ptr(), out.data_ptr(), _build.stream_of(vals),
        )
    _build.check(err, "segmented_scan")
    KERNEL.launches += 1
    return out


def segmented_scan(
    vals: torch.Tensor, flags: Optional[torch.Tensor], op: str, unsigned: bool = False
) -> torch.Tensor:
    """Inclusive scan of `vals` with `op`, restarting where `flags` is True
    (flags None: a plain scan).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if vals.device.type == "cpu":
        return segmented_scan_plain(vals, flags, op, unsigned)
    return segmented_scan_cuda(vals, flags, op, unsigned)
