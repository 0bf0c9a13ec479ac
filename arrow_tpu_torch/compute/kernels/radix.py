"""Stable LSD radix sort of up to 8 planes by plane 0 (kernels B3 and B4).

Counterpart of ``arrow_tpu/compute/kernels/radix.py``: the chain of
``_radix_pass_call`` (B3, one bit a pass) behind
``radix_sort_chain[_parts]``, and its 2-bit form ``_radix4_pass_call`` (B4),
which a call selects with ``digit_bits=2``.  The CUDA kernel is
``arrow_tpu_torch/csrc/radix.cu``, templated on the digit width: 1 is B3's
pass, 2 is B4's, 8 the default: one histogram of every pass's digits, then
one onesweep launch a pass.  Beside it, :func:`radix_sort_plain` is the same
function in plain PyTorch: one stable ``torch.sort`` of the digit and a
gather per pass, at the same width and the same digit positions.

Contract: plane 0 is a 32- or 64-bit key whose bit pattern, read as
unsigned, orders the rows (an unsigned-order code); the other planes are
payloads of 4 or 8 bytes.  The first `n` rows of every plane come out stably
sorted by the key; rows from `n` on are zero.  The sort is by a set of key
bits: with an int `nbits_or_bits`, the significant ones, where the keys' OR ^
AND mask has a bit (as ``significant_bits_mask``; the others are equal in
every key); with a sequence, the given bit positions.  The passes' digits are
aligned to those bits (:func:`_shifts`): each starts at the lowest bit not yet
sorted by, so bits 12-19 are one 8-bit pass; the other bits are masked off.
The wrappers add the passes a call made to ``KERNEL.passes`` beside its
launch count.

:func:`radix_sort` is the wrapper: the plain version for CPU tensors, the
kernel for CUDA tensors, never one in place of the other.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ...runtime.profiler import host_read
from . import _build

DIGIT_BITS = (1, 2, 8)
DEFAULT_DIGIT_BITS = 8
MAX_PLANES = 8

KERNEL = _build.register_kernel(
    _build.Kernel(
        name="radix_sort",
        source="arrow_tpu_torch/csrc/radix.cu",
        replaces="arrow_tpu/compute/kernels/radix.py:756",
    )
)
KERNEL_2BIT = _build.register_kernel(
    _build.Kernel(
        name="radix_sort_2bit",
        source="arrow_tpu_torch/csrc/radix.cu",
        replaces="arrow_tpu/compute/kernels/radix.py:683",
    )
)

Bits = Union[int, Sequence[int]]


def _kernel(digit_bits: int) -> _build.Kernel:
    return KERNEL_2BIT if digit_bits == 2 else KERNEL


def _rows(planes, n: Optional[int]) -> int:
    return int(planes[0].shape[0]) if n is None else n


def _check_args(planes, nbits_or_bits: Bits, n: int, digit_bits: int) -> None:
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"radix_sort takes 1 to {MAX_PLANES} planes, not {len(planes)}")
    if digit_bits not in DIGIT_BITS:
        raise ValueError(f"digit width {digit_bits} not in {DIGIT_BITS}")
    key = planes[0]
    if key.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"key plane must be int32 or int64, not {key.dtype}")
    if not 0 <= n < 1 << 31:
        raise ValueError(f"row count {n} out of range")
    device = key.device
    for i, p in enumerate(planes):
        if p.device != device:
            raise ValueError(f"plane {i} is on {p.device}, the key on {device}")
        if p.dim() != 1 or not p.is_contiguous():
            raise ValueError(f"plane {i} must be a contiguous 1-D tensor")
        if p.element_size() not in (4, 8):
            raise ValueError(f"plane {i}: element size {p.element_size()} not 4 or 8")
        if p.shape[0] < n:
            raise ValueError(f"plane {i} has {p.shape[0]} rows, needs {n}")
    key_bits = 8 * key.element_size()
    if isinstance(nbits_or_bits, int):
        if not 0 <= nbits_or_bits <= key_bits:
            raise ValueError(f"{nbits_or_bits} key bits in a {key_bits}-bit key")
    elif any(not 0 <= b < key_bits for b in nbits_or_bits):
        raise ValueError(f"bit positions {list(nbits_or_bits)} outside a {key_bits}-bit key")


def _as_signed(mask: int, bits: int) -> int:
    """A `bits`-wide bit pattern as the signed integer torch takes."""
    return mask - (1 << bits) if mask >> (bits - 1) else mask


def _shifts(sig: int, key_bits: int, digit_bits: int) -> List[int]:
    """The shifts of the passes that cover the bits of `sig`, LSD first: each
    digit starts at the lowest bit not yet covered, or lower where it would
    otherwise end past the key's top bit.  Such a digit holds bits that an
    earlier pass sorted by, which an LSD chain does not mind."""
    mask = (1 << digit_bits) - 1
    shifts, rest = [], sig
    while rest:
        lowest = (rest & -rest).bit_length() - 1
        shifts.append(min(lowest, key_bits - digit_bits))
        rest &= ~(mask << shifts[-1])
    return shifts


def _bits_mask(nbits_or_bits: Bits, sig_fn) -> int:
    if isinstance(nbits_or_bits, int):
        return sig_fn() & ((1 << nbits_or_bits) - 1)
    mask = 0
    for b in nbits_or_bits:
        mask |= 1 << b
    return mask


def significant_mask_plain(key: torch.Tensor, n: int) -> int:
    """OR ^ AND of the first `n` keys' bit patterns, as a Python int: a bit
    orders the rows only where the keys differ on it.  A tree of halvings
    (torch has no OR reduction)."""
    if n == 0:
        return 0
    o = a = key[:n]
    while o.shape[0] > 1:
        h = o.shape[0] // 2
        odd = o.shape[0] % 2
        o = torch.cat([o[:h] | o[h : 2 * h], o[2 * h :]]) if odd else o[:h] | o[h:]
        a = torch.cat([a[:h] & a[h : 2 * h], a[2 * h :]]) if odd else a[:h] & a[h:]
    bits = 8 * key.element_size()
    with host_read("radix_significant_bits"):
        return (int(o[0]) ^ int(a[0])) & ((1 << bits) - 1)


def _zero_tail(sorted_prefix: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(like)
    out[: sorted_prefix.shape[0]] = sorted_prefix
    return out


def radix_sort_plain(
    planes: Sequence[torch.Tensor],
    nbits_or_bits: Bits,
    n: Optional[int] = None,
    digit_bits: int = DEFAULT_DIGIT_BITS,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch B3/B4: per pass of :func:`_shifts`, LSD first, one
    stable sort of the digit (the bits not sorted by masked off) and a gather
    of every plane."""
    planes = tuple(planes)
    n = _rows(planes, n)
    _check_args(planes, nbits_or_bits, n, digit_bits)
    key = planes[0]
    sig = _bits_mask(nbits_or_bits, lambda: significant_mask_plain(key, n))
    cur = [p[:n] for p in planes]
    key_bits = 8 * key.element_size()
    dmask, kmask = (1 << digit_bits) - 1, _as_signed(sig, key_bits)
    shifts = _shifts(sig, key_bits, digit_bits) if n > 1 else []
    _kernel(digit_bits).passes += len(shifts)
    for s in shifts:
        perm = torch.sort(((cur[0] & kmask) >> s) & dmask, stable=True).indices
        cur = [p[perm] for p in cur]
    return tuple(_zero_tail(c, p) for c, p in zip(cur, planes))


def significant_mask_cuda(key: torch.Tensor, n: int) -> int:
    """OR ^ AND of the first `n` keys, reduced on the card by
    ``arrow_radix_or_and`` (one host sync)."""
    lib = _build.load().cdll
    fn = lib.arrow_radix_or_and
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(2, dtype=torch.int64, device=key.device)
    with torch.cuda.device(key.device):
        err = fn(key.data_ptr(), int(key.element_size() == 8), n, out.data_ptr(), _build.stream_of(key))
    _build.check(err, "radix significant bits")
    with host_read("radix_significant_bits"):
        o, a = (int(v) for v in out.tolist())
    return (o ^ a) & ((1 << (8 * key.element_size())) - 1)


def radix_sort_cuda(
    planes: Sequence[torch.Tensor],
    nbits_or_bits: Bits,
    n: Optional[int] = None,
    digit_bits: int = DEFAULT_DIGIT_BITS,
) -> Tuple[torch.Tensor, ...]:
    """Launch the B3/B4 CUDA kernel (see :func:`radix_sort_plain`)."""
    planes = tuple(planes)
    n = _rows(planes, n)
    _check_args(planes, nbits_or_bits, n, digit_bits)
    key = planes[0]
    if key.device.type != "cuda":
        raise ValueError("radix_sort_cuda needs CUDA tensors")
    sig = _bits_mask(nbits_or_bits, lambda: significant_mask_cuda(key, n))
    shifts = _shifts(sig, 8 * key.element_size(), digit_bits) if n > 1 else []
    if not shifts:  # already in order: nothing to launch
        return tuple(_zero_tail(p[:n], p) for p in planes)
    buf_a = [torch.empty_like(p) for p in planes]
    buf_b = [torch.empty_like(p) for p in planes] if len(shifts) > 1 else buf_a
    lib = _build.load().cdll
    lib.arrow_radix_scratch_bytes.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    lib.arrow_radix_scratch_bytes.restype = ctypes.c_longlong
    scratch = torch.empty(
        lib.arrow_radix_scratch_bytes(n, digit_bits, len(shifts)), dtype=torch.uint8, device=key.device
    )
    fn = lib.arrow_radix_sort
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_longlong, ctypes.c_ulonglong, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    k = len(planes)

    def ptrs(ts):
        return (ctypes.c_void_p * k)(*[t.data_ptr() for t in ts])

    with torch.cuda.device(key.device):
        err = fn(
            ptrs(planes), ptrs(buf_a), ptrs(buf_b),
            (ctypes.c_int * k)(*[int(p.element_size() == 8) for p in planes]), k, n, sig,
            (ctypes.c_int * len(shifts))(*shifts), len(shifts), digit_bits,
            scratch.data_ptr(), _build.stream_of(key),
        )
    _build.check(err, "radix_sort")
    _kernel(digit_bits).launches += 1
    _kernel(digit_bits).passes += len(shifts)
    out = buf_a if len(shifts) % 2 else buf_b
    for o in out:
        o[n:] = 0
    return tuple(out)


def radix_sort(
    planes: Sequence[torch.Tensor],
    nbits_or_bits: Bits,
    n: Optional[int] = None,
    digit_bits: int = DEFAULT_DIGIT_BITS,
) -> Tuple[torch.Tensor, ...]:
    """Stable LSD radix sort of the first `n` rows (default: all) of up to 8
    planes by plane 0's unsigned bit order, `digit_bits` (1, 2 or 8) a pass.

    nbits_or_bits: the key's bit width (32 or 64; the significant digits are
    found from the keys) or the bit positions to sort by.  Returns the planes
    sorted, each its input's length, zero from row `n` on.  CPU tensors take
    the plain version; CUDA tensors launch the kernel.
    """
    planes = tuple(planes)
    if planes and planes[0].device.type == "cpu":
        return radix_sort_plain(planes, nbits_or_bits, n, digit_bits)
    return radix_sort_cuda(planes, nbits_or_bits, n, digit_bits)
