"""The whole sort-join query (filter -> group-by -> join the groups back onto
the kept rows -> sort the kept rows by key) at 2^16 rows in both packages,
the JAX package's composed from the same public calls, fed the same batch
through Arrow buffers.  The port runs with its kernels' wrappers, inside
plain_versions(), and on the merge-expand join emit (the CUDA default)."""

import contextlib

import numpy as np
import pytest

from arrow_tpu import compute as JC
from arrow_tpu import kernels as JK
from arrow_tpu.table import RecordBatch as JBatch
from arrow_tpu_torch import flagship
from arrow_tpu_torch.compute.kernels import plain_versions
from torch_helpers import assert_same, batch_to_torch

N = 1 << 16


@pytest.fixture(scope="module")
def jax_query():
    cols = flagship.make_host_columns(N, seed=0)
    jb = JBatch.from_numpy(cols)
    kept = JC.filter(jb, JK.gt_scalar(jb["v"], 0.0))
    groups = JC.hash_aggregate(kept["k"], [("total", kept["v"], "sum"), ("n", None, "count")])
    joined = JC.hash_join(kept, groups, "k", "key")
    return jb, kept, groups, joined, JC.sort_by_key(kept["k"], kept["v"])


def _rows(batch):
    """The joined rows as a set-comparable array: one row per line, sorted."""
    cols = [batch[c].raw_values() for c in batch.column_names]
    as_u64 = [c.view(np.uint32).astype(np.uint64) if c.dtype.itemsize == 4 else c.view(np.uint64) for c in cols]
    table = np.stack(as_u64, axis=1)
    return table[np.lexsort(table.T[::-1])]


@pytest.mark.parametrize("route", ["kernels", "plain", "merge_emit"])
def test_sort_join_query_matches_jax(jax_query, route, monkeypatch):
    jb, want_kept, want_groups, want_joined, (want_sk, want_sv) = jax_query
    if route == "merge_emit":
        monkeypatch.setenv("ARROW_TPU_JOIN_EMIT", "merge")
    with plain_versions() if route == "plain" else contextlib.nullcontext():
        kept, groups, joined, (sk, sv) = flagship.sort_join_query(batch_to_torch(jb))
    for name in ("k", "v"):
        assert_same(want_kept[name], kept[name])
    assert_same(want_groups["key"], groups["key"])
    assert_same(want_groups["n"], groups["n"])
    assert_same(want_groups["total"], groups["total"], rtol=1e-6)
    assert joined.column_names == want_joined.column_names == ["k", "v", "key", "total", "n"]
    assert joined.num_rows == want_joined.num_rows == kept.num_rows
    np.testing.assert_array_equal(joined["k"].raw_values(), joined["key"].raw_values())
    got_rows, want_rows = _rows(joined), _rows(want_joined)
    total = joined.column_names.index("total")
    np.testing.assert_array_equal(np.delete(got_rows, total, 1), np.delete(want_rows, total, 1))
    np.testing.assert_allclose(
        got_rows[:, total].astype(np.uint32).view(np.float32),
        want_rows[:, total].astype(np.uint32).view(np.float32), rtol=1e-6,
    )
    assert_same(want_sk, sk)
    assert_same(want_sv, sv)
