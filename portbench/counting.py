"""Least bytes: what a question or a hand-written kernel call has to move,
each input read once and each output written once, by the formulas of the
kernel table in PERF.md (its "Bound" column).  A share of the roofline is
these bytes over the card's published bandwidth (``peaks.json``), divided
by the device time measured."""

import json
import pathlib

import torch

HERE = pathlib.Path(__file__).resolve().parent
SLOTS = 4096  # B5's dense table, B6's table a class
SLOT_BYTES = 12  # an int32 count and an int64 sum a slot


def peak_bytes_per_s(device_name: str):
    """The card's published bandwidth, or None for a card not in the table."""
    entry = json.loads((HERE / "peaks.json").read_text()).get(device_name)
    return None if entry is None else float(entry["hbm_bytes_per_s"])


def question_bytes(question, tables: dict, result: dict) -> int:
    """A question's least bytes: each column it reads (``READS``) once, and
    each column of its result (`result`: {column: (rows, element bytes)})
    written once."""
    read = 0
    for table, columns in question.READS.items():
        cols = tables[table]
        for name in cols if columns == "*" else columns:
            read += cols[name].numel() * cols[name].element_size()
    return read + sum(rows * size for rows, size in result.values())


def _nbytes(t: torch.Tensor, rows=None) -> int:
    return (t.shape[0] if rows is None else rows) * t.element_size()


# -- the hand-written kernels, as the operators call them (compute.kernels) --
# Each takes the call's arguments and its result and returns (bytes, a 0-d
# device count or None, bytes a counted row): the count is read after the
# window, so no formula makes the host wait.


def radix_sort(out, planes, nbits_or_bits, n=None, digit_bits=None):
    """B3/B4: every plane read and written once, over the rows sorted."""
    return sum(2 * _nbytes(p, n) for p in planes), None, 0


def merge_pass(out, planes, run_len, unique_payload=False):
    """B7: every plane read and written once."""
    return sum(2 * _nbytes(p) for p in planes), None, 0


def segmented_scan(out, vals, flags, op, unsigned=False):
    """B2: the plane and its flags read, the plane written."""
    return 2 * _nbytes(vals) + (0 if flags is None else _nbytes(flags)), None, 0


def segmented_scan_multi(out, planes, flags, op, unsigned=False):
    """B2 over 1-3 planes sharing one flag plane."""
    return sum(2 * _nbytes(p) for p in planes) + (0 if flags is None else _nbytes(flags)), None, 0


def compact_multi(out, vplanes, wplanes, mask_words, n=None):
    """B1: the mask read, the selected rows of each plane read, every output
    row written (the selected rows, then zeros); bitmap planes read whole
    and written unpacked."""
    vouts, wouts, count = out
    rows = (vouts or wouts)[0].shape[0]
    fixed = (rows + 7) // 8 + sum(_nbytes(o) for o in vouts)
    fixed += sum((rows + 7) // 8 + _nbytes(o) for o in wouts)
    return fixed, count, sum(p.element_size() for p in vplanes)


def groupby_dense(out, keys, vals, nlimb, length=None):
    """B5: keys and values read, the 4096-slot table written."""
    return _nbytes(keys, length) + _nbytes(vals, length) + SLOTS * SLOT_BYTES, None, 0


def groupby_region(out, keys, vals, nlimb, nclass):
    """B6: keys and values read, a 4096-slot table a class written."""
    return _nbytes(keys) + _nbytes(vals) + nclass * SLOTS * SLOT_BYTES, None, 0


#: the entry functions of ``arrow_tpu_torch.compute.kernels`` that the
#: operators call, and their formulas
KERNEL_CALLS = {
    f.__name__: f
    for f in (radix_sort, merge_pass, segmented_scan, segmented_scan_multi, compact_multi,
              groupby_dense, groupby_region)
}
