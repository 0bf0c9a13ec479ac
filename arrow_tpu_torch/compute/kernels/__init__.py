"""Hand-written CUDA kernels of the port, each with its plain PyTorch version.

- ``compaction3``: B1, stable multi-plane compaction by a packed mask;
- ``segscan``: B2, inclusive segmented scan;
- ``radix``: B3 and B4, stable LSD radix sort of planes (1-, 2- or 8-bit
  digits);
- ``merge``: B7, stable pairwise merge of sorted runs, and ``sort_kv`` on it.

No module builds or loads anything at import: ``_build`` compiles the
library at the first launch on a CUDA tensor.

The operators reach the kernels through :func:`compact_multi`,
:func:`segmented_scan`, :func:`radix_sort`, :func:`merge_pass` and
:func:`sort_kv` here, which call the kernel wrappers.  Inside a
:func:`plain_versions` block they call the plain versions instead, on any
device: that is the reference path the kernels are held against on the card.
"""

import contextlib

from . import _build, compaction3, merge, radix, segscan  # noqa: F401  (registers KERNELS)

__all__ = [
    "compaction3", "merge", "radix", "segscan", "compact_multi", "merge_pass",
    "plain_versions", "radix_sort", "segmented_scan", "sort_kv",
]

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


def radix_sort(planes, nbits_or_bits, n=None, digit_bits=None):
    """Kernels B3/B4 as the operators call them (see ``radix.radix_sort``);
    the digit width defaults to ``radix.chain_digit_bits()``."""
    fn = radix.radix_sort_plain if _plain else radix.radix_sort
    return fn(planes, nbits_or_bits, n, digit_bits or radix.chain_digit_bits())


def merge_pass(planes, run_len, unique_payload=False):
    """Kernel B7 as the operators call it (see ``merge.merge_pass``)."""
    fn = merge.merge_pass_plain if _plain else merge.merge_pass
    return fn(planes, run_len, unique_payload)


def sort_kv(keys, payloads=(), length=None, unique_payload=False, unsigned=False):
    """``merge.sort_kv`` with its merge passes on :func:`merge_pass`."""
    return merge.sort_kv(keys, payloads, length, unique_payload, unsigned, merge=merge_pass)
