"""Hand-written CUDA kernels of the port, each with its plain PyTorch version.

- ``compaction3``: B1, stable multi-plane compaction by a packed mask, and
  B8, the stable dual-output split by a mask or a key bit;
- ``compaction``: B9, single-plane compaction (a one-plane call of B1's
  kernel);
- ``groupby_mxu``: B5, COUNT and exact SUM by dense keys in [0, 4096);
- ``groupby_region``: B6, the same over class-grouped keys in
  [0, nclass x 4096);
- ``segscan``: B2, inclusive segmented scan of one to three planes;
- ``radix``: B3 and B4, stable LSD radix sort of planes (1-, 2- or 8-bit
  digits);
- ``merge``: B7, stable pairwise merge of sorted runs, and ``sort_kv`` on it;
- ``take``: ``take_columns``, the join's output take: many columns gathered
  by one or two index planes in one launch (no TPU kernel: XLA's gather
  there).

Importing the package registers every kernel in ``_build.KERNELS``.  No
module builds or loads anything at import: ``_build`` compiles the
library at the first launch on a CUDA tensor.

The operators reach the kernels through :func:`compact_multi`,
:func:`segmented_scan`, :func:`segmented_scan_multi`, :func:`radix_sort`,
:func:`merge_pass`, :func:`sort_kv`, :func:`groupby_dense`,
:func:`groupby_region` and :func:`take_columns` here (:func:`compact` and
:func:`split_multi` too, though no operator calls them), which call the
kernel wrappers.  Inside a :func:`plain_versions` block they call the plain
versions instead, on any device: that is the reference path the kernels are
held against on the card.
"""

import contextlib

from . import _build, compaction, compaction3, groupby_mxu, merge, radix, segscan, take  # noqa: F401
from . import groupby_region as region  # the module; groupby_region() below is its entry

__all__ = [
    "compaction", "compaction3", "groupby_mxu", "merge", "radix", "region", "segscan", "take",
    "compact", "compact_multi", "groupby_dense", "groupby_region", "merge_pass",
    "plain_versions", "radix_sort", "using_plain", "segmented_scan", "segmented_scan_multi", "sort_kv",
    "split_multi", "take_columns",
]

_plain = False


def using_plain() -> bool:
    """Whether the operators call the plain versions (inside
    :func:`plain_versions`)."""
    return _plain


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


def compact(data, mask_words):
    """Kernel B9 as the operators would call it (see ``compaction.compact``)."""
    fn = compaction.compact_plain if _plain else compaction.compact
    return fn(data, mask_words)


def split_multi(vplanes, mask_words=None, bit=None):
    """Kernel B8 as the operators would call it (see ``compaction3.split_multi``)."""
    fn = compaction3.split_multi_plain if _plain else compaction3.split_multi
    return fn(vplanes, mask_words, bit)


def segmented_scan(vals, flags, op, unsigned=False):
    """Kernel B2 as the operators call it (see ``segscan.segmented_scan``)."""
    fn = segscan.segmented_scan_plain if _plain else segscan.segmented_scan
    return fn(vals, flags, op, unsigned)


def segmented_scan_multi(planes, flags, op, unsigned=False):
    """Kernel B2 on 1-3 planes that share `flags`, one launch (see
    ``segscan.segmented_scan_multi``)."""
    fn = segscan.segmented_scan_multi_plain if _plain else segscan.segmented_scan_multi
    return fn(planes, flags, op, unsigned)


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


def groupby_dense(keys, vals, nlimb, length=None):
    """Kernel B5 as the operators call it (see ``groupby_mxu.groupby_dense``)."""
    fn = groupby_mxu.groupby_dense_plain if _plain else groupby_mxu.groupby_dense
    return fn(keys, vals, nlimb, length)


def groupby_region(keys, vals, nlimb, nclass):
    """Kernel B6 as the operators call it (see ``groupby_region.groupby_region``)."""
    fn = region.groupby_region_plain if _plain else region.groupby_region
    return fn(keys, vals, nlimb, nclass)


def take_columns(columns, planes, length):
    """The join's output take as the operators call it (see
    ``take.take_columns``)."""
    fn = take.take_columns_plain if _plain else take.take_columns
    return fn(columns, planes, length)
