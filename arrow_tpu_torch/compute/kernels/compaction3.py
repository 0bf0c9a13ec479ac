"""Stable multi-plane compaction by a packed mask (kernel B1).

Counterpart of ``arrow_tpu/compute/kernels/compaction3.py::compact_multi_pallas``.
The CUDA kernel is ``arrow_tpu_torch/csrc/compaction3.cu``; its source note
says how it is built.  Beside it, :func:`compact_multi_plain` is the same
function in plain PyTorch.

:func:`compact_multi` is the wrapper: it runs the plain version for tensors
on the CPU and launches the kernel for tensors on a CUDA device; it never
falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ...utils import bits as B
from . import _build

MAX_PLANES = 16
_KIND_VALUE4, _KIND_VALUE8, _KIND_WORDS = 0, 1, 2

KERNEL = _build.register_kernel(
    _build.Kernel(
        name="compact_multi",
        source="arrow_tpu_torch/csrc/compaction3.cu",
        replaces="arrow_tpu/compute/kernels/compaction3.py:446",
    )
)

Result = Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...], torch.Tensor]


def _rows(vplanes, wplanes, mask_words, n: Optional[int]) -> int:
    if n is not None:
        return n
    if vplanes:
        return int(vplanes[0].shape[0])
    return int(mask_words.shape[0]) * B.WORD_BITS


def compact_multi_plain(
    vplanes: Sequence[torch.Tensor],
    wplanes: Sequence[torch.Tensor],
    mask_words: torch.Tensor,
    n: Optional[int] = None,
) -> Result:
    """Plain PyTorch B1: the first `n` rows of each plane where the mask is
    set, moved to the front of a zeroed length-`n` output; word planes come
    out unpacked as 0/1 int32.  Returns (vouts, wouts, count)."""
    n = _rows(vplanes, wplanes, mask_words, n)
    sel = B.unpack_bits(mask_words[: B.num_words(n)], n)

    def compact(p: torch.Tensor) -> torch.Tensor:
        picked = p[:n][sel]
        out = torch.zeros(n, dtype=p.dtype, device=p.device)
        out[: picked.shape[0]] = picked
        return out

    vouts = tuple(compact(p) for p in vplanes)
    wouts = tuple(
        compact(B.unpack_bits(w[: B.num_words(n)], n).to(torch.int32)) for w in wplanes
    )
    return vouts, wouts, sel.sum(dtype=torch.int32)


def _check_plane(t: torch.Tensor, what: str, device: torch.device, min_len: int) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, the mask on {device}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 1-D tensor")
    if t.shape[0] < min_len:
        raise ValueError(f"{what} has {t.shape[0]} elements, needs {min_len}")


def compact_multi_cuda(
    vplanes: Sequence[torch.Tensor],
    wplanes: Sequence[torch.Tensor],
    mask_words: torch.Tensor,
    n: Optional[int] = None,
) -> Result:
    """Launch the B1 CUDA kernel (see :func:`compact_multi_plain`)."""
    n = _rows(vplanes, wplanes, mask_words, n)
    device = mask_words.device
    if device.type != "cuda":
        raise ValueError("compact_multi_cuda needs CUDA tensors")
    if len(vplanes) + len(wplanes) > MAX_PLANES:
        raise ValueError(f"at most {MAX_PLANES} planes per launch")
    if not 0 <= n < 1 << 31:
        raise ValueError(f"row count {n} out of range")
    nw = B.num_words(n)
    if mask_words.dtype != torch.int32:
        raise ValueError("mask words must be int32")
    _check_plane(mask_words, "mask", device, nw)
    ins, outs, kinds = [], [], []
    vouts, wouts = [], []
    for i, p in enumerate(vplanes):
        _check_plane(p, f"value plane {i}", device, n)
        if p.element_size() not in (4, 8):
            raise ValueError(f"value plane {i}: element size {p.element_size()} not 4 or 8")
        o = torch.empty(n, dtype=p.dtype, device=device)
        ins.append(p.data_ptr())
        outs.append(o.data_ptr())
        kinds.append(_KIND_VALUE4 if p.element_size() == 4 else _KIND_VALUE8)
        vouts.append(o)
    for i, w in enumerate(wplanes):
        _check_plane(w, f"word plane {i}", device, nw)
        if w.dtype != torch.int32:
            raise ValueError(f"word plane {i} must be int32")
        o = torch.empty(n, dtype=torch.int32, device=device)
        ins.append(w.data_ptr())
        outs.append(o.data_ptr())
        kinds.append(_KIND_WORDS)
        wouts.append(o)
    lib = _build.load().cdll
    lib.arrow_compact_scratch_bytes.argtypes = [ctypes.c_longlong]
    lib.arrow_compact_scratch_bytes.restype = ctypes.c_longlong
    scratch = torch.empty(
        lib.arrow_compact_scratch_bytes(n), dtype=torch.uint8, device=device
    )
    count = torch.empty((), dtype=torch.int32, device=device)

    fn = lib.arrow_compact_multi
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    k = len(kinds)
    with torch.cuda.device(device):
        err = fn(
            (ctypes.c_void_p * k)(*ins), (ctypes.c_void_p * k)(*outs),
            (ctypes.c_int * k)(*kinds), k, mask_words.data_ptr(), n,
            scratch.data_ptr(), count.data_ptr(), _build.stream_of(mask_words),
        )
    _build.check(err, "compact_multi")
    KERNEL.launches += 1
    return tuple(vouts), tuple(wouts), count


def compact_multi(
    vplanes: Sequence[torch.Tensor],
    wplanes: Sequence[torch.Tensor],
    mask_words: torch.Tensor,
    n: Optional[int] = None,
) -> Result:
    """Stable compaction of the first `n` rows of several planes by one
    packed mask.

    vplanes: 1-D planes of 4- or 8-byte elements (any dtype, moved as bits);
    wplanes: packed int32 bitmap planes (validity, bool data), unpacked to
    0/1 int32; mask_words: packed int32 selection words.  Returns (vouts,
    wouts, count): length-`n` outputs with the selected rows first, in order,
    and zeros from `count` on; `count` is a 0-d int32 tensor on the device.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if mask_words.device.type == "cpu":
        return compact_multi_plain(vplanes, wplanes, mask_words, n)
    return compact_multi_cuda(vplanes, wplanes, mask_words, n)
