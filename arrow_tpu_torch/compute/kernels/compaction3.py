"""Stable multi-plane compaction by a packed mask (kernel B1) and the stable
dual-output split (kernel B8).

Counterparts of ``arrow_tpu/compute/kernels/compaction3.py::compact_multi_pallas``
and ``split_multi_pallas``.  Both CUDA kernels are in
``arrow_tpu_torch/csrc/compaction3.cu``; its source note says how they are
built.  Beside them, :func:`compact_multi_plain` and
:func:`split_multi_plain` are the same functions in plain PyTorch.

:func:`compact_multi` and :func:`split_multi` are the wrappers: they run the
plain version for tensors on the CPU and launch the kernel for tensors on a
CUDA device; they never fall back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from ...utils import bits as B
from . import _build

MAX_PLANES = 16
MAX_SPLIT_PLANES = 8
_KIND_VALUE4, _KIND_VALUE8, _KIND_WORDS = 0, 1, 2

KERNEL = _build.register_kernel(
    _build.Kernel(
        name="compact_multi",
        source="arrow_tpu_torch/csrc/compaction3.cu",
        replaces="arrow_tpu/compute/kernels/compaction3.py:446",
    )
)

SPLIT_KERNEL = _build.register_kernel(
    _build.Kernel(
        name="split_multi",
        source="arrow_tpu_torch/csrc/compaction3.cu",
        replaces="arrow_tpu/compute/kernels/compaction3.py:873",
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


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` (a build of csrc/compaction3.cu) with its C entries' argument
    and result types set."""
    lib.arrow_compact_scratch_bytes.argtypes = [ctypes.c_longlong]
    lib.arrow_compact_scratch_bytes.restype = ctypes.c_longlong
    void_pp = ctypes.POINTER(ctypes.c_void_p)
    lib.arrow_compact_multi.argtypes = [
        void_pp, void_pp, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.arrow_compact_multi.restype = ctypes.c_int
    lib.arrow_split_multi.argtypes = [
        void_pp, void_pp, void_pp, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.arrow_split_multi.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    """The kernel library, declared once."""
    return declare(_build.load().cdll)


def _scratch(lib: ctypes.CDLL, n: int, device) -> torch.Tensor:
    """The ticket and look-back descriptors that both C entries take."""
    return torch.empty(lib.arrow_compact_scratch_bytes(n), dtype=torch.uint8, device=device)


def _check_plane(t: torch.Tensor, what: str, device: torch.device, min_len: int) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, the mask on {device}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 1-D tensor")
    if t.shape[0] < min_len:
        raise ValueError(f"{what} has {t.shape[0]} elements, needs {min_len}")


def launch_compact(
    vplanes: Sequence[torch.Tensor],
    wplanes: Sequence[torch.Tensor],
    mask_words: torch.Tensor,
    n: Optional[int] = None,
) -> Result:
    """Check the arguments and launch ``arrow_compact_multi``; counts no
    launch (its callers do, each for its own kernel)."""
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
    lib = _lib()
    scratch = _scratch(lib, n, device)
    count = torch.empty((), dtype=torch.int32, device=device)
    k = len(kinds)
    with torch.cuda.device(device):
        err = lib.arrow_compact_multi(
            (ctypes.c_void_p * k)(*ins), (ctypes.c_void_p * k)(*outs),
            (ctypes.c_int * k)(*kinds), k, mask_words.data_ptr(), n,
            scratch.data_ptr(), count.data_ptr(), _build.stream_of(mask_words),
        )
    _build.check(err, "compact_multi")
    return tuple(vouts), tuple(wouts), count


def compact_multi_cuda(
    vplanes: Sequence[torch.Tensor],
    wplanes: Sequence[torch.Tensor],
    mask_words: torch.Tensor,
    n: Optional[int] = None,
) -> Result:
    """Launch the B1 CUDA kernel (see :func:`compact_multi_plain`)."""
    out = launch_compact(vplanes, wplanes, mask_words, n)
    KERNEL.launches += 1
    return out


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


SplitResult = Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...], torch.Tensor]


def _check_split(vplanes, mask_words, bit) -> int:
    if (mask_words is None) == (bit is None):
        raise ValueError("split_multi takes a mask or a bit, not both or neither")
    if not 1 <= len(vplanes) <= MAX_SPLIT_PLANES:
        raise ValueError(f"split_multi takes 1 to {MAX_SPLIT_PLANES} planes, not {len(vplanes)}")
    n = int(vplanes[0].shape[0])
    if not 0 <= n < 1 << 31:
        raise ValueError(f"row count {n} out of range")
    device = vplanes[0].device
    for i, p in enumerate(vplanes):
        _check_plane(p, f"plane {i}", device, n)
        if p.shape[0] != n or p.element_size() != 4:
            raise ValueError(f"plane {i}: {p.shape[0]} rows of {p.element_size()} bytes; "
                             f"needs {n} rows of 4 bytes")
    if mask_words is not None:
        if mask_words.dtype != torch.int32:
            raise ValueError("mask words must be int32")
        _check_plane(mask_words, "mask", device, B.num_words(n))
    elif not 0 <= bit < 32:
        raise ValueError(f"bit {bit} outside a 32-bit plane")
    return n


def split_multi_plain(
    vplanes: Sequence[torch.Tensor],
    mask_words: Optional[torch.Tensor] = None,
    bit: Optional[int] = None,
) -> SplitResult:
    """Plain PyTorch B8: (selected-front planes, unselected-front planes,
    count).  Each output has the input's n rows: the selected (unselected)
    rows first, in order, then zeros."""
    vplanes = tuple(vplanes)
    n = _check_split(vplanes, mask_words, bit)
    if mask_words is not None:
        sel = B.unpack_bits(mask_words[: B.num_words(n)], n)
    else:  # the rows whose plane-0 bit is zero
        sel = ((vplanes[0].view(torch.int32) >> bit) & 1) == 0

    def front(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        picked = p[m]
        out = torch.zeros_like(p)
        out[: picked.shape[0]] = picked
        return out

    return (tuple(front(p, sel) for p in vplanes), tuple(front(p, ~sel) for p in vplanes),
            sel.sum(dtype=torch.int32))


def split_multi_cuda(
    vplanes: Sequence[torch.Tensor],
    mask_words: Optional[torch.Tensor] = None,
    bit: Optional[int] = None,
) -> SplitResult:
    """Launch the B8 CUDA kernel (see :func:`split_multi_plain`)."""
    vplanes = tuple(vplanes)
    n = _check_split(vplanes, mask_words, bit)
    device = vplanes[0].device
    if device.type != "cuda":
        raise ValueError("split_multi_cuda needs CUDA tensors")
    sel = [torch.empty_like(p) for p in vplanes]
    unsel = [torch.empty_like(p) for p in vplanes]
    lib = _lib()
    scratch = _scratch(lib, n, device)
    count = torch.empty((), dtype=torch.int32, device=device)
    k = len(vplanes)

    def ptrs(ts):
        return (ctypes.c_void_p * k)(*[t.data_ptr() for t in ts])

    with torch.cuda.device(device):
        err = lib.arrow_split_multi(
            ptrs(vplanes), ptrs(sel), ptrs(unsel), k,
            None if mask_words is None else mask_words.data_ptr(), 0 if bit is None else bit, n,
            scratch.data_ptr(), count.data_ptr(), _build.stream_of(vplanes[0]),
        )
    _build.check(err, "split_multi")
    SPLIT_KERNEL.launches += 1
    return tuple(sel), tuple(unsel), count


def split_multi(
    vplanes: Sequence[torch.Tensor],
    mask_words: Optional[torch.Tensor] = None,
    bit: Optional[int] = None,
) -> SplitResult:
    """Stable dual-output split of up to 8 planes of n 4-byte rows, from one
    read of the input.

    The selection is `mask_words` (packed int32 words) or `bit`: the rows
    whose plane-0 bit `bit` is zero.  Returns (selected-front planes,
    unselected-front planes, count): each output has n rows, its rows first
    in input order, zeros after them; `count` (selected rows) is a 0-d int32
    tensor on the device.  CPU tensors take the plain version; CUDA tensors
    launch the kernel.
    """
    if vplanes and vplanes[0].device.type == "cpu":
        return split_multi_plain(vplanes, mask_words, bit)
    return split_multi_cuda(vplanes, mask_words, bit)
