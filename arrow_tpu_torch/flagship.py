"""The flagship query: compare -> filter -> sort group-by.

Counterpart of ``__graft_entry__.py::entry`` and the README quick start:

    mask = K.gt_scalar(batch["v"], 0.0)
    kept = C.filter(batch, mask)
    C.hash_aggregate(kept["k"], [("total", kept["v"], "sum"), ("n", None, "count")])

The batch is ``entry()``'s: u32 keys in [0, 10 000) and standard-normal f32
values, drawn from ``np.random.default_rng(seed)`` in that order.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from . import compute as C
from . import kernels as K
from .array.boolean import BooleanArray
from .table import RecordBatch

NUM_KEYS = 10_000


def make_host_columns(n: int, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, NUM_KEYS, n).astype(np.uint32)
    vals = rng.standard_normal(n).astype(np.float32)
    return {"k": keys, "v": vals}


def make_batch(n: int, seed: int = 0, device=None) -> RecordBatch:
    return RecordBatch.from_numpy(make_host_columns(n, seed), device=device)


def compare_step(batch: RecordBatch) -> BooleanArray:
    return K.gt_scalar(batch["v"], 0.0)


def filter_step(batch: RecordBatch, mask: BooleanArray) -> RecordBatch:
    return C.filter(batch, mask)


def groupby_step(kept: RecordBatch) -> RecordBatch:
    return C.hash_aggregate(kept["k"], [("total", kept["v"], "sum"), ("n", None, "count")])


def flagship_query(batch: RecordBatch) -> Tuple[int, RecordBatch]:
    """Returns (rows kept by the filter, groups with key/total/n columns)."""
    kept = filter_step(batch, compare_step(batch))
    return kept.num_rows, groupby_step(kept)


def numpy_reference(keys: np.ndarray, vals: np.ndarray):
    """The query in numpy: (rows kept, group keys, counts, f32 sums taken in
    float64)."""
    keep = vals > 0
    k, v = keys[keep], vals[keep]
    groups, inv = np.unique(k, return_inverse=True)
    counts = np.bincount(inv, minlength=groups.shape[0])
    sums = np.bincount(inv, weights=v.astype(np.float64), minlength=groups.shape[0])
    return int(keep.sum()), groups, counts, sums.astype(np.float32)
