"""Single-plane compaction by a packed mask (kernel B9).

Counterpart of ``arrow_tpu/compute/kernels/compaction.py::compact_pallas``:
one 32-bit plane, its selected rows moved in order to the front.  On the card
it is a one-plane call of B1's CUDA kernel (``arrow_compact_multi`` in
``arrow_tpu_torch/csrc/compaction3.cu``) with a launch count of its own;
beside it, :func:`compact_plain` is the same function in plain PyTorch.  The
TPU version's capacity slack (n + block + tile rows) is TPU plumbing: the
output here has the input's n rows, zeros from the count on.

:func:`compact` is the wrapper: the plain version for tensors on the CPU,
the kernel for tensors on a CUDA device, never one in place of the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from . import compaction3 as C3

KERNEL = _build.register_kernel(
    _build.Kernel(
        name="compact",
        source="arrow_tpu_torch/csrc/compaction3.cu",
        replaces="arrow_tpu/compute/kernels/compaction.py:218",
    )
)


def _check(data: torch.Tensor) -> None:
    if data.element_size() != 4:
        raise ValueError(f"compact takes a 32-bit plane, not {data.dtype}")


def compact_plain(data: torch.Tensor, mask_words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch B9: (out, count), out with data's n rows, the selected
    rows first in order, zeros after them."""
    _check(data)
    (out,), _, count = C3.compact_multi_plain([data], [], mask_words, int(data.shape[0]))
    return out, count


def compact_cuda(data: torch.Tensor, mask_words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the B9 CUDA kernel (see :func:`compact_plain`)."""
    _check(data)
    (out,), _, count = C3.launch_compact([data], [], mask_words, int(data.shape[0]))
    KERNEL.launches += 1
    return out, count


def compact(data: torch.Tensor, mask_words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable compaction of one 32-bit plane by packed int32 mask words.
    Returns (out, count): out has the plane's n rows, the selected rows
    first in order and zeros after them; count is a 0-d int32 tensor on the
    device.  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if mask_words.device.type == "cpu":
        return compact_plain(data, mask_words)
    return compact_cuda(data, mask_words)
