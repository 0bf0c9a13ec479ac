"""Hand-written CUDA kernels of the port, each with its plain PyTorch version.

- ``compaction3``: B1, stable multi-plane compaction by a packed mask;
- ``segscan``: B2, inclusive segmented scan.

Neither module builds or loads anything at import: ``_build`` compiles the
library at the first launch on a CUDA tensor.

The operators reach the kernels through :func:`compact_multi` and
:func:`segmented_scan` here, which call the kernel wrappers.  Inside a
:func:`plain_versions` block they call the plain versions instead, on any
device: that is the reference path the kernels are held against on the card.
"""

import contextlib

from . import _build, compaction3, segscan  # noqa: F401  (registers KERNELS)

__all__ = ["compaction3", "segscan", "compact_multi", "segmented_scan", "plain_versions"]

_plain = False


@contextlib.contextmanager
def plain_versions():
    """Within the block, the operators compute with the kernels' plain
    PyTorch versions on CPU and CUDA tensors alike (process-wide)."""
    global _plain
    saved, _plain = _plain, True
    try:
        yield
    finally:
        _plain = saved


def compact_multi(vplanes, wplanes, mask_words, n=None):
    """Kernel B1 as the operators call it (see ``compaction3.compact_multi``)."""
    fn = compaction3.compact_multi_plain if _plain else compaction3.compact_multi
    return fn(vplanes, wplanes, mask_words, n)


def segmented_scan(vals, flags, op, unsigned=False):
    """Kernel B2 as the operators call it (see ``segscan.segmented_scan``)."""
    fn = segscan.segmented_scan_plain if _plain else segscan.segmented_scan
    return fn(vals, flags, op, unsigned)
