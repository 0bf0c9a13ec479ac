"""The flagship query (compare -> filter -> sort group-by) and the sort-join
query that extends it.

Counterpart of ``__graft_entry__.py::entry`` and the README quick start:

    mask = K.gt_scalar(batch["v"], 0.0)
    kept = C.filter(batch, mask)
    C.hash_aggregate(kept["k"], [("total", kept["v"], "sum"), ("n", None, "count")])

:func:`sort_join_query` is the single-device body of
``__graft_entry__.py::dryrun_multichip``: that group-by, then the aggregate
joined back against the kept rows and the kept rows sorted by key.

The batch is ``entry()``'s: u32 keys in [0, 10 000) and standard-normal f32
values, drawn from ``np.random.default_rng(seed)`` in that order.

:func:`groupby_query` is the group-by of the BASELINE configuration "GROUP
BY u32 key, SUM/COUNT, 1K-100M distinct keys incl. heavy-hitter skew"
(``BASELINE.json`` configs[2]) on :func:`make_groupby_batch`'s batches: the
key distributions of ``bench.py``'s group-by sweep (1K, 1M, skewed and ~100M
distinct u32 keys) with i32 values in [0, 200), drawn with numpy.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from . import compute as C
from . import kernels as K
from .array.array import ArrowArrayBase
from .array.boolean import BooleanArray
from .table import RecordBatch

NUM_KEYS = 10_000
#: the group-by key distributions: uniform in [0, 2^10) and [0, 2^20), the
#: heavy-hitter skew floor(u^4 * 2^20) for u uniform in [0, 1), uniform in
#: [0, 2^31) (about 100M distinct keys at 2^27 rows)
GROUPBY_DISTS = ("1k", "1m", "skew", "100m")
GROUPBY_VALUE_MAX = 200


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


def sort_join_query(
    batch: RecordBatch,
) -> Tuple[RecordBatch, RecordBatch, RecordBatch, Tuple[ArrowArrayBase, ArrowArrayBase]]:
    """Returns (kept rows, groups, the groups joined back onto the kept rows
    with the groups as the build side, (kept keys, kept values) sorted by
    key)."""
    kept = filter_step(batch, compare_step(batch))
    groups = groupby_step(kept)
    joined = C.hash_join(kept, groups, "k", "key")
    return kept, groups, joined, C.sort_by_key(kept["k"], kept["v"])


def numpy_reference(keys: np.ndarray, vals: np.ndarray):
    """The query in numpy: (rows kept, group keys, counts, f32 sums taken in
    float64)."""
    keep = vals > 0
    k, v = keys[keep], vals[keep]
    groups, inv = np.unique(k, return_inverse=True)
    counts = np.bincount(inv, minlength=groups.shape[0])
    sums = np.bincount(inv, weights=v.astype(np.float64), minlength=groups.shape[0])
    return int(keep.sum()), groups, counts, sums.astype(np.float32)


def make_groupby_columns(n: int, dist: str, seed: int = 0) -> Dict[str, np.ndarray]:
    """u32 keys of distribution `dist` (see GROUPBY_DISTS), then i32 values
    in [0, 200), drawn from ``np.random.default_rng(seed)`` in that order."""
    rng = np.random.default_rng(seed)
    if dist == "skew":
        u = rng.random(n, dtype=np.float32)
        keys = (u * u * u * u * np.float32(1 << 20)).astype(np.uint32)
    else:
        high = {"1k": 1 << 10, "1m": 1 << 20, "100m": 1 << 31}[dist]
        keys = rng.integers(0, high, n, dtype=np.uint32)
    vals = rng.integers(0, GROUPBY_VALUE_MAX, n, dtype=np.int32)
    return {"k": keys, "v": vals}


def make_groupby_batch(n: int, dist: str, seed: int = 0, device=None) -> RecordBatch:
    return RecordBatch.from_numpy(make_groupby_columns(n, dist, seed), device=device)


def groupby_query(batch: RecordBatch) -> RecordBatch:
    """GROUP BY k: SUM(v) as "s", COUNT(v) as "c", on hash_aggregate's auto
    route."""
    return C.hash_aggregate(batch["k"], [("s", batch["v"], "sum"), ("c", batch["v"], "count")])


def groupby_reference(keys: np.ndarray, vals: np.ndarray):
    """The group-by in numpy for keys below 2^22 (the dense distributions):
    (group keys, counts, sums), by bincount; the sums are exact in float64
    (below 2^53)."""
    counts = np.bincount(keys)
    sums = np.bincount(keys, weights=vals)
    groups = np.flatnonzero(counts)
    return groups.astype(np.uint32), counts[groups], sums[groups].astype(np.int64)
